"""The pure-Python pieces of the port's pipeline (runtime/pipe/schedule.py,
bubble_accounting.py, topology.py and the partitioning of module.py) held
against the JAX package's, which they copy: the compiled instruction
streams instruction by instruction, the tick simulation's reports, the
parallel grid's coordinates and groups, the layer partitions of a GPT-2
pipeline, and the p2p accounting of runtime/comm_accounting.py."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2_pipe import gpt2_pipeline_module as jpipe
from deepspeed_tpu.runtime.pipe import bubble_accounting as jba
from deepspeed_tpu.runtime.pipe import schedule as jsched
from deepspeed_tpu.runtime.pipe import topology as jtopo
from deepspeed_tpu_torch.models.gpt2 import GPT2Config
from deepspeed_tpu_torch.models.gpt2_pipe import gpt2_pipeline_module
from deepspeed_tpu_torch.runtime.pipe import bubble_accounting as ba
from deepspeed_tpu_torch.runtime.pipe import schedule as sched
from deepspeed_tpu_torch.runtime.pipe import topology as topo

# (schedule, virtual stages, stash) x micro-batches x stages; interleaving
# needs micro-batches divisible by the stages
SCHEDULES = [("1f1b", 1, False), ("interleaved", 2, False),
             ("zb-h1", 1, False), ("zb-h1", 1, True)]
GRID = [(name, v, stash, m, s) for name, v, stash in SCHEDULES
        for m in (2, 4, 8) for s in (2, 4)
        if name != "interleaved" or m % s == 0]


def _stream(streams):
    return [[(type(c).__name__, c.kwargs) for c in st] for st in streams]


@pytest.mark.parametrize("name,v,stash,micros,stages", GRID)
def test_compiled_streams_equal_the_jax_ones(name, v, stash, micros, stages):
    got = sched.compile_schedule(name, micros, stages, v, stash=stash)
    want = jsched.compile_schedule(name, micros, stages, v, stash=stash)
    assert _stream(got.streams) == _stream(want.streams)
    assert got.num_buffers == want.num_buffers
    assert got.num_stash_slots == want.num_stash_slots
    assert (got.name, got.num_chunks, got.stash) == \
        (want.name, want.num_chunks, want.stash)


@pytest.mark.parametrize("name,v,stash,micros,stages", GRID)
def test_simulation_and_bubble_report_equal_the_jax_ones(name, v, stash,
                                                         micros, stages):
    got = ba.simulate(sched.compile_schedule(name, micros, stages, v,
                                             stash=stash))
    want = jba.simulate(jsched.compile_schedule(name, micros, stages, v,
                                                stash=stash))
    assert got == want
    if not stash:
        assert ba.bubble_report(name, micros, stages, v) == \
            jba.bubble_report(name, micros, stages, v)


def test_cost_models_and_closed_form_equal_the_jax_ones():
    for s, m in ((2, 4), (4, 4), (4, 8)):
        assert ba.ideal_1f1b_bubble(s, m) == jba.ideal_1f1b_bubble(s, m)
    assert vars(ba.CostModel.stash()) == vars(jba.CostModel.stash())
    assert vars(ba.CostModel.equal_fwd_bwd()) == \
        vars(jba.CostModel.equal_fwd_bwd())


@pytest.mark.parametrize("pp,dp,v", [(2, 1, 1), (2, 2, 1), (4, 2, 2),
                                     (2, 4, 2)])
def test_parallel_grid_equals_the_jax_one(pp, dp, v):
    for rank in range(pp * dp):
        got = topo.PipelineParallelGrid(
            topo.PipeModelDataParallelTopology(num_pp=pp, num_mp=1,
                                               num_dp=dp), rank=rank,
            virtual_stages=v)
        want = jtopo.PipelineParallelGrid(
            jtopo.PipeModelDataParallelTopology(num_pp=pp, num_mp=1,
                                                num_dp=dp), rank=rank,
            virtual_stages=v)
        for attr in ("stage_id", "data_parallel_id", "pp_group", "dp_group",
                     "p2p_groups", "num_model_chunks"):
            assert getattr(got, attr) == getattr(want, attr), attr
        assert [got.chunk_owner_stage(q) for q in range(pp * v)] == \
            [want.chunk_owner_stage(q) for q in range(pp * v)]
        assert (got.is_first_stage(), got.is_last_stage()) == \
            (want.is_first_stage(), want.is_last_stage())


TINY = dict(vocab_size=128, n_positions=32, n_embd=32, n_layer=5, n_head=2)


@functools.lru_cache(maxsize=None)
def _modules(untied):
    jmod = jpipe(JGPT2Config(dtype=jnp.float32, **TINY), untied_head=untied)
    jmod.init(jax.random.PRNGKey(0),
              {"input_ids": np.zeros((1, 8), np.int32)})
    return jmod


@pytest.mark.parametrize("method", ["uniform", "parameters",
                                    "type:GPT2BlockLayer"])
@pytest.mark.parametrize("chunks", [2, 4])
@pytest.mark.parametrize("untied", [False, True])
def test_partitions_equal_the_jax_module(method, chunks, untied):
    jmod = _modules(untied)
    jmod.partition_method = method
    jmod._parts = None
    mod = gpt2_pipeline_module(GPT2Config(dtype=torch.float32, **TINY),
                               partition_method=method, untied_head=untied)
    assert mod.partition_layers(chunks) == jmod.partition_layers(chunks)
    for q in range(chunks):
        assert mod.stage_param_keys(q, chunks) == \
            jmod.stage_param_keys(q, chunks)
    assert mod.tied_groups(chunks) == jmod.tied_groups(chunks)
    assert mod.validate_chunking(2, chunks // 2) == \
        jmod.validate_chunking(2, chunks // 2)
    assert mod.has_tied_layers() == jmod.has_tied_layers()


@pytest.mark.parametrize("stages,v,act,grad", [
    (2, 1, "float32", None), (4, 2, "bfloat16", None),
    (4, 1, "bfloat16", "float32")])
def test_pipe_p2p_accounting_equals_the_jax_one(stages, v, act, grad):
    from dataclasses import asdict

    from deepspeed_tpu.runtime import comm_accounting as jca
    from deepspeed_tpu_torch.runtime import comm_accounting as ca

    kw = dict(stages=stages, virtual_stages=v, act_dtype=act,
              grad_dtype=grad)
    got = ca.pipe_p2p_collectives(4096, 8, **kw)
    want = jca.pipe_p2p_collectives(4096, 8, **kw)
    assert [asdict(c) for c in got] == [asdict(c) for c in want]
    acts, grads = [8192] * (stages * v - 1), [4096] * (stages * v - 1)
    assert ca.pipe_p2p_bytes(acts, grads, 8) == \
        jca.pipe_p2p_bytes(acts, grads, 8)
