"""Data parallelism and ZeRO stages 0-2 of the PyTorch port, in gloo worlds
on the CPU, held against the JAX engine on its virtual CPU devices.

Each world (tests/torch_zero_worker.py: one process per rank, its own
120 s limit, a free port) runs once per test session and serves several
tests; under xdist the first worker to need it starts it, the others wait
on a lock and read its results. Weights: the JAX engine's initial
parameters (seed 42), carried into the port with models/convert.py; token
ids from numpy seeds. fp32 throughout but for the overflow case.

- The port at dp 2 (stages 0, 1, 2) and dp 4 (stage 2), gas 1 and 2,
  5 Adam steps, matches the JAX engine at ``mesh {"data": dp}`` on the same
  global batch: losses and final master weights at rtol 1e-4, atol 1e-5
  (the single-process parity tolerance of tests/test_torch_engine.py).
  The key third of each ``c_attn`` bias is the exception: its gradient is
  zero in exact arithmetic (softmax ignores a shift common to all keys),
  so both engines move it by the sign of rounding noise, up to lr per
  Adam step, and it is held to 2 * steps * lr.
- Port dp 2 against port dp 1 on the same global batch: losses and
  gradient norms at rtol 1e-5; master weights at the JAX parity tolerance
  (an element whose gradient is near zero moves by lr times the ratio of
  two tiny moments, so a summation-order difference moves it by up to
  1e-5 at lr 1e-3), the key biases as above; LAMB at stage 2 likewise.
- A world of one at stage 2 is the stage-0 run bit for bit, and both are
  the single-process engine's.
- Each rank holds 1/dp of every shardable leaf's master and Adam moments
  along the JAX rule's dimension (``mesh.zero_merge_spec`` under GPT-2's
  tensor-parallel spec), and at stage 2 of the accumulator.
- The collectives counted per step equal the port's
  ``comm_volume_report()``, which equals the JAX engine's. At stage 1 the
  JAX report prices no parameter gather while the JAX program gathers
  every sharded leaf after the step (ROADMAP C-w7): the port does what
  the program does, and its counter carries exactly those gathers beyond
  the report.
- A non-finite gradient planted on rank 1 only (it lands in rank 0's
  shard) skips the step on every rank and halves the fp16 loss scale.
- A dp-2 stage-2 checkpoint resumes bit for bit at dp 2 and goes on at
  dp 1; it loads into the JAX engine, and a JAX dp-2 tag loads into the
  port.
- ZeRO-Offload (stage 2, ``cpu_offload``) at dp 2 and 4, gas 2: the
  losses and gradient norms at rtol 1e-4 and the full host master that
  rank 0 writes at save (rebuilt over the group) at rtol 1e-4, atol 5e-5
  (the key biases as above) against the JAX offload engine at ``mesh
  {"data": dp}``. The atol is tests/test_torch_checkpoint.py's: Adam
  moves an element whose gradient is near zero by lr times the ratio of
  two tiny moments, and the JAX engine sums the dp ranks' gradients in
  another order (one element of a 4096-element leaf read 4.5e-5 apart
  at dp 2 on the CPU, 4.5 % of lr). Each rank's host master and moments are its shards
  (it steps only its regions); the norm equals the JAX engine's, whose
  regions count a replicated leaf once; the counted collectives of each
  step are the report's, which is the JAX engine's.

The dp2 and dp4 worlds also carry the pipeline's jobs
(tests/torch_pipe_worlds.py), which tests/test_torch_pipe.py reads.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import torch_pipe_worlds as PW
import torch_zero_worker as W
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2Model as JGPT2Model
from deepspeed_tpu.parallel import mesh as jmesh
from deepspeed_tpu.runtime import comm_accounting as jca
from deepspeed_tpu.runtime.checkpoint_utils import npz_dict_to_leaves
from deepspeed_tpu.runtime.engine import _first_micro
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model

STEPS = 5
LR = 1e-3
RTOL, ATOL = 1e-4, 1e-5
OFFLOAD_ATOL = 5e-5
SEED = 11
CASES = [(2, 0, 1), (2, 0, 2), (2, 1, 1), (2, 1, 2), (2, 2, 1), (2, 2, 2),
         (4, 2, 1), (4, 2, 2)]


# ---------------------------------------------------------------------------
# the worlds, each run once per session
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_init():
    """The JAX engine's initial parameters (seed 42) as numpy."""
    jeng = _jax_engine(1, 0, 1)
    ids = W.global_batches(0, 1, 1, W.MICRO)[0]
    jeng._ensure_state(_first_micro({"input_ids": ids, "labels": ids}))
    return jax.tree_util.tree_map(np.asarray, jax.device_get(jeng.state.params))


def _jax_engine(dp, stage, gas, optimizer="Adam", offload=False):
    cfg = dict(W.ds_config(dp, stage, gas, optimizer, lr=LR,
                           offload=offload),
               mesh={"data": dp, "allow_partial": True})
    return deepspeed_tpu.initialize(
        model=JGPT2Model(JGPT2Config(dtype=jnp.float32, **W.TINY)),
        config_params=cfg)[0]


def _train(name, dp, stage, gas, **kw):
    kw.setdefault("init", _jax_init())
    return (name, "train", dict(dp=dp, stage=stage, gas=gas, steps=STEPS,
                                seed=SEED, **kw))


def _world_dp2(out):
    # a tag of the JAX engine at dp 2 for the port to load
    jtag = os.path.join(out, "jax_tag")
    jeng = _jax_engine(2, 2, 2)
    batches = W.global_batches(SEED, 2, 2, 2 * W.MICRO)
    for b in batches:
        jeng.train_batch(batch={"input_ids": b, "labels": b})
    jeng.save_checkpoint(jtag, backend="npz")
    ptag = os.path.join(out, "port_tag")
    jobs = [_train(f"s{s}g{g}", 2, s, g,
                   **({"save": ptag, "save_at": 3} if (s, g) == (2, 2)
                      else {}))
            for s in (0, 1, 2) for g in (1, 2)]
    jobs += [("resume", "resume", dict(dp=2, stage=2, gas=2, steps=STEPS,
                                        seed=SEED, load=ptag, start=3)),
             ("load_jax", "load", dict(dp=2, stage=2, gas=2, load=jtag)),
             _train("lamb", 2, 2, 1, optimizer="Lamb"),
             ("overflow", "overflow", dict(dp=2, seed=SEED, init=_jax_init(),
                                           plant_rank=1,
                                           param="h.0.mlp.c_fc.weight")),
             ("sampler", "sampler", dict(dp=2, n=21)),
             ("tag_check", "tag_check", dict(dp=2)),
             _offload_job(2, out)] + PW.dp2_jobs(out)
    results = W.run_world(2, jobs, out)
    for r in results:
        r["port_tag"] = ptag
    return results


def _host_master_tree(jeng):
    return jax.tree_util.tree_unflatten(
        jeng._host_treedef, [np.asarray(x) for x in jeng._host_master_flat])


@functools.lru_cache(maxsize=None)
def _jax_offload_init():
    """The JAX offload engine's initial host master (seed 42): its host
    init gives the device init's values within an ulp, not bit for bit."""
    jeng = _jax_engine(1, 2, 1, offload=True)
    ids = W.global_batches(0, 1, 1, W.MICRO)[0]
    jeng._ensure_state(_first_micro({"input_ids": ids, "labels": ids}))
    return _host_master_tree(jeng)


def _offload_job(dp, out):
    """Stage 2 with cpu_offload, gas 2; a save after the last step."""
    return _train("offload", dp, 2, 2, offload=True, init=_jax_offload_init(),
                  save=os.path.join(out, "offload_tag"), save_at=STEPS)


def _world_dp4(out):
    jobs = [_train(f"s2g{g}", 4, 2, g) for g in (1, 2)]
    jobs += [("sampler", "sampler", dict(dp=4, n=21)), _offload_job(4, out)]
    jobs += PW.dp4_jobs()
    return W.run_world(4, jobs, out)


def _world_dp1(out):
    # the dp-2 worlds' global batches, in one process of a world of one
    jobs = [_train(f"s{s}g{g}", 1, s, g, micro=2 * W.MICRO)
            for s in (0, 1, 2) for g in (1, 2)]
    jobs.append(_train("lamb", 1, 2, 1, optimizer="Lamb", micro=2 * W.MICRO))
    return W.run_world(1, jobs, out)


WORLDS = {"dp2": _world_dp2, "dp4": _world_dp4, "dp1": _world_dp1}


@pytest.fixture(scope="session")
def world(tmp_path_factory):
    """world(key) -> one result dict per rank; each world runs once per
    session, shared across xdist workers through a lock file."""
    return W.session_worlds(tmp_path_factory, WORLDS)


def _port_names():
    cfg = GPT2Config(dtype=torch.float32, **W.TINY)
    return GPT2Model(cfg), cfg


def assert_master_close(got, want, rtol, atol, what):
    W.assert_master_close(got, want, rtol, atol, STEPS, LR, what)


def _jax_master(jeng):
    _, cfg = _port_names()
    return {n: t.numpy() for n, t in params_from_jax(
        jax.tree_util.tree_map(np.asarray, jax.device_get(jeng.state.params)),
        cfg).items()}


def _collectives(records):
    return sorted((c["name"], c["op"], c["dtype"], c["elements"],
                   c["axis_size"], c["bytes_per_step"]) for c in records)


# ---------------------------------------------------------------------------
# parity with the JAX engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dp,stage,gas", CASES)
def test_data_parallel_matches_jax_engine(world, dp, stage, gas):
    ranks = world(f"dp{dp}")
    got = ranks[0][f"s{stage}g{gas}"]
    for r in ranks[1:]:
        # every rank saw the same global loss and holds the same weights
        assert r[f"s{stage}g{gas}"]["losses"] == got["losses"]
        for n, m in r[f"s{stage}g{gas}"]["master"].items():
            np.testing.assert_array_equal(m, got["master"][n])
    jeng = _jax_engine(dp, stage, gas)
    batches = W.global_batches(SEED, STEPS, gas, dp * W.MICRO)
    jeng._ensure_state(_first_micro({"input_ids": batches[0],
                                     "labels": batches[0]}))
    init = _jax_init()
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           jax.device_get(jeng.state.params), init)
    jl = [float(jeng.train_batch(batch={"input_ids": b, "labels": b}))
          for b in batches]
    np.testing.assert_allclose(got["losses"], jl, rtol=RTOL)
    assert_master_close(got["master"], _jax_master(jeng), RTOL, ATOL,
                        f"dp {dp} stage {stage} gas {gas}")
    # the port's comm report is the JAX engine's
    jrep = jeng.comm_volume_report()
    assert _collectives(got["report"]["collectives"]) == \
        _collectives(jrep["collectives"])
    for key in ("grad_exchange_bytes_per_step",
                "param_gather_bytes_per_step", "total_bytes_per_step"):
        assert got["report"][key] == jrep[key], key


@pytest.mark.parametrize("stage,gas", [(0, 1), (0, 2), (1, 1), (1, 2),
                                       (2, 1), (2, 2)])
def test_dp2_matches_dp1(world, stage, gas):
    got = world("dp2")[0][f"s{stage}g{gas}"]
    want = world("dp1")[0][f"s{stage}g{gas}"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=1e-5)
    assert_master_close(got["master"], want["master"], RTOL, ATOL,
                        f"stage {stage} gas {gas}")


def test_lamb_at_stage_2_dp2_matches_dp1(world):
    got, want = world("dp2")[0]["lamb"], world("dp1")[0]["lamb"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=1e-5)
    assert_master_close(got["master"], want["master"], RTOL, ATOL, "lamb")


def test_world_of_one_is_the_single_process_engine_bit_for_bit(world):
    """In a world of one nothing is sharded: stage 2 is stage 0, and both
    are the engine without a process group (on one CPU thread, as the
    ranks run: the matmuls' summation order follows the thread count)."""
    ranks = world("dp1")
    s0, s2 = ranks[0]["s0g2"], ranks[0]["s2g2"]
    assert s0["losses"] == s2["losses"]
    for n in s0["master"]:
        np.testing.assert_array_equal(s0["master"][n], s2["master"][n])
    eng = W._engine(W.ds_config(1, 2, 2, micro=2 * W.MICRO), _jax_init())
    assert eng.dp_group is None
    batches = W.global_batches(SEED, STEPS, 2, 2 * W.MICRO)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        losses = [eng.train_batch(batch=W._local(b, 0, 2 * W.MICRO)).item()
                  for b in batches]
    finally:
        torch.set_num_threads(threads)
    assert losses == s2["losses"]
    for n, m in W._full_master(eng).items():
        np.testing.assert_array_equal(m, s2["master"][n])


# ---------------------------------------------------------------------------
# partitioning, bytes, memory
# ---------------------------------------------------------------------------
def _jax_zero_dims(dp):
    """[(JAX leaf path, port parameter name, transposed, dim)]: the dim of
    each JAX leaf that ZeRO shards over ``data`` at dp by the JAX rule
    (zero_merge_spec over GPT-2's tensor-parallel spec), or None."""
    from jax.sharding import PartitionSpec as P

    init = _jax_init()
    jmodel = JGPT2Model(JGPT2Config(dtype=jnp.float32, **W.TINY))
    tp = jax.tree_util.tree_leaves(jmodel.param_partition_spec(init),
                                   is_leaf=lambda x: isinstance(x, P))
    model, _ = _port_names()
    out = []
    for path, (name, transposed), spec, leaf in zip(
            model.reference_leaf_paths(), model.reference_leaf_specs(), tp,
            jax.tree_util.tree_leaves(init)):
        z = jmesh.zero_merge_spec(spec, leaf, dp)
        dims = [d for d, a in enumerate(z) if a == "data"]
        out.append((path, name, transposed, dims[0] if dims else None))
    return out


@pytest.mark.parametrize("dp,stage", [(2, 1), (2, 2), (4, 2)])
def test_each_rank_holds_its_shards(world, dp, stage):
    dims = _jax_zero_dims(dp)
    assert any(d is not None for *_, d in dims)
    assert any(d is None for *_, d in dims)   # the c_attn and c_fc biases
    for rank in world(f"dp{dp}"):
        layout = rank[f"s{stage}g2"]["layout"]
        for _, name, transposed, d in dims:
            full = layout[name]["full"]
            want = list(full)
            if d is not None:
                want[1 - d if transposed else d] //= dp
            want = tuple(want)
            assert layout[name]["master"] == want, name
            assert layout[name]["opt"] == [want, want], name
            assert layout[name]["accum"] == (want if stage == 2 else full), \
                name


@pytest.mark.parametrize("dp,stage,gas", CASES)
def test_counted_collectives_equal_the_report(world, dp, stage, gas):
    """Per step: the counter's collectives are the report's, and at stage 1
    the report's plus the post-step gather of each sharded leaf that the
    JAX program does (C-w7)."""
    got = world(f"dp{dp}")[0][f"s{stage}g{gas}"]
    report = got["report"]
    want = list(report["collectives"])
    if stage == 1:
        assert report["param_gather_bytes_per_step"] == 0
        shapes = [np.shape(x) for x in jax.tree_util.tree_leaves(_jax_init())]
        leaves = [jca.LeafSpec(path, shape, d) for (path, *_, d), shape
                  in zip(_jax_zero_dims(dp), shapes)]
        extra = jca.param_gather_collectives(leaves, dp,
                                             param_dtype="float32")
        assert extra
        want += [dict(vars(c), bytes_per_step=c.bytes_per_step)
                 for c in extra]
    for step in got["comm"]:
        assert _collectives(step["collectives"]) == _collectives(want)
        # one bucket per kind per micro step, one gather per step
        assert step["calls"]["all-reduce"] == gas
        assert step["calls"].get("reduce-scatter", 0) == \
            (gas if stage == 2 else 0)
        assert step["calls"].get("all-gather", 0) == (1 if stage else 0)


def test_analytic_memory_divides_by_dp(world):
    """Master and Adam state at stage 1, and the accumulator too at stage
    2, are the rank's shards; the parameters stay whole."""
    one = world("dp1")[0]
    for stage in (1, 2):
        got = world("dp4")[0]["s2g2"]["memory"]["components"] if stage == 2 \
            else world("dp2")[0]["s1g2"]["memory"]["components"]
        dp = 4 if stage == 2 else 2
        full = one[f"s{stage}g2"]["memory"]["components"]
        layout = one[f"s{stage}g2"]["layout"]
        rep = sum(int(np.prod(layout[name]["full"])) * 4
                  for _, name, _, d in _jax_zero_dims(dp) if d is None)
        assert got["params_bytes"] == full["params_bytes"]
        # fp32: the dp-1 master is the parameters; the shards are separate
        assert full["master_bytes"] == 0
        assert got["master_bytes"] == (full["params_bytes"] - rep) // dp
        opt = full["optimizer_state_bytes"] - 4     # the step counter
        assert got["optimizer_state_bytes"] - 4 == \
            2 * rep + (opt - 2 * rep) // dp
        want_accum = rep + (full["grad_accum_bytes"] - rep) // dp \
            if stage == 2 else full["grad_accum_bytes"]
        assert got["grad_accum_bytes"] == want_accum


# ---------------------------------------------------------------------------
# overflow, checkpoints
# ---------------------------------------------------------------------------
def test_overflow_on_one_rank_skips_the_step_everywhere(world):
    ranks = [r["overflow"] for r in world("dp2")]
    # planted on rank 1, the element lies in rank 0's shard
    assert ranks[0]["holder"] == [0]
    for r in ranks:
        assert r["overflow1"] and r["skipped1"] == 1 and r["unchanged"]
        assert r["scale1"] == r["scale0"] / 2
        assert r["skipped2"] == 1            # the next step is taken


def test_checkpoint_at_dp2_resumes_bit_for_bit(world):
    for rank in world("dp2"):
        straight, resumed = rank["s2g2"], rank["resume"]
        assert resumed["global_steps"] == STEPS
        assert resumed["losses"] == straight["losses"][3:]
        for n, m in straight["master"].items():
            np.testing.assert_array_equal(resumed["master"][n], m)


def test_dp2_tag_resumes_at_dp1(world):
    """A tag written at dp 2 loads into a single process (the full arrays
    are topology-free, as the JAX engine's npz tags), which goes on with
    the dp-2 run's losses over the same global batches."""
    rank0 = world("dp2")[0]
    eng = W._engine(W.ds_config(1, 2, 2, micro=2 * W.MICRO), None)
    path, _ = eng.load_checkpoint(rank0["port_tag"])
    assert path is not None and eng.global_steps == 3
    batches = W.global_batches(SEED, STEPS, 2, 2 * W.MICRO)
    losses = [eng.train_batch(batch=W._local(b, 0, 2 * W.MICRO)).item()
              for b in batches[3:]]
    np.testing.assert_allclose(losses, rank0["s2g2"]["losses"][3:],
                               rtol=1e-5)


def test_port_dp2_tag_loads_into_the_jax_engine(world):
    rank0 = world("dp2")[0]
    jeng = _jax_engine(2, 2, 2)
    batches = W.global_batches(SEED, STEPS, 2, 2 * W.MICRO)
    jeng._ensure_state(_first_micro({"input_ids": batches[0],
                                     "labels": batches[0]}))
    path, _ = jeng.load_checkpoint(rank0["port_tag"])
    assert jeng.global_steps == 3
    with np.load(os.path.join(path, "model_states.npz")) as data:
        saved = npz_dict_to_leaves(data)
    got = jax.tree_util.tree_leaves(jax.device_get(jeng.state))
    assert len(got) == len(saved)
    for i, (x, y) in enumerate(zip(got[:-1], saved[:-1])):   # not the rng
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=str(i))
    loss = float(jeng.train_batch(batch={"input_ids": batches[3],
                                         "labels": batches[3]}))
    np.testing.assert_allclose(loss, rank0["s2g2"]["losses"][3], rtol=RTOL)


def test_jax_dp2_tag_loads_into_the_port(world):
    for rank in world("dp2"):
        got = rank["load_jax"]
        with np.load(os.path.join(got["path"], "model_states.npz")) as data:
            saved = npz_dict_to_leaves(data)
        assert len(got["leaves"]) == len(saved)
        for i, (x, y) in enumerate(zip(got["leaves"][:-1], saved[:-1])):
            np.testing.assert_array_equal(x, np.asarray(y, x.dtype),
                                          err_msg=str(i))
        # and each rank holds its shards of it
        assert got["layout"]["wte"]["master"] == (128, 16)


@pytest.mark.parametrize("dp", [2, 4])
def test_offload_matches_the_jax_offload_engine(world, dp):
    ranks = world(f"dp{dp}")
    got = ranks[0]["offload"]
    for r in ranks[1:]:
        assert r["offload"]["losses"] == got["losses"]
        assert r["offload"]["norms"] == got["norms"]
    jeng = _jax_engine(dp, 2, 2, offload=True)
    batches = W.global_batches(SEED, STEPS, 2, dp * W.MICRO)
    jeng._ensure_state(_first_micro({"input_ids": batches[0],
                                     "labels": batches[0]}))
    assert jeng._offload
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           _host_master_tree(jeng), _jax_offload_init())
    jl, jn = [], []
    for b in batches:
        jl.append(float(jeng.train_batch(batch={"input_ids": b,
                                                "labels": b})))
        jn.append(float(jeng.get_global_grad_norm()))
    np.testing.assert_allclose(got["losses"], jl, rtol=RTOL)
    # a replicated leaf's square counted once over the group
    np.testing.assert_allclose(got["norms"], jn, rtol=RTOL)
    # the full master rank 0 wrote, rebuilt over the group
    with np.load(os.path.join(got["saved"], "offload_states.npz")) as data:
        saved = npz_dict_to_leaves(data)
        assert int(data["opt_step"]) == jeng._host_opt["step"] == STEPS
    n = len(jeng._host_master_flat)
    assert len(saved) == 3 * n
    names = [name for name, _ in _port_names()[0].reference_leaf_specs()]
    for k, (m_saved, m_jax) in enumerate(zip(saved[:n],
                                             jeng._host_master_flat)):
        W.assert_master_close({names[k]: np.asarray(m_saved)},
                              {names[k]: np.asarray(m_jax)}, RTOL,
                              OFFLOAD_ATOL, STEPS, LR, f"offload dp {dp}")
    jrep = jeng.comm_volume_report()
    assert _collectives(got["report"]["collectives"]) == \
        _collectives(jrep["collectives"])
    for key in ("grad_exchange_bytes_per_step",
                "param_gather_bytes_per_step", "total_bytes_per_step"):
        assert got["report"][key] == jrep[key], key
    for step in got["comm"]:
        assert _collectives(step["collectives"]) == \
            _collectives(got["report"]["collectives"])


@pytest.mark.parametrize("job,stage,offload", [
    ("s0g2", 0, False), ("s1g2", 1, False), ("s2g2", 2, False),
    ("offload", 2, True)])
def test_analytic_memory_equals_the_jax_engine_at_dp2(world, job, stage,
                                                      offload):
    """Each rank's component bytes in the gloo world of 2 equal the JAX
    engine's per-device bytes at mesh data 2, byte for byte, but one: at
    fp32 from stage 1 the JAX engine's parameters are its master (it
    updates their shards in place), while the port keeps this rank's fp32
    shards of the sharded leaves as a master of their own, which it prices
    under ``master_bytes``. Under offload the port's device also holds its
    flat compute-dtype buffer, a component the JAX engine does not have."""
    jeng = _jax_engine(2, stage, 2, offload=offload)
    ids = W.global_batches(0, 1, 1, 2 * W.MICRO)[0]
    jeng._ensure_state(_first_micro({"input_ids": ids, "labels": ids}))
    want = dict(jeng._analytic_memory_components()["components"])
    layout = world("dp1")[0]["s1g2"]["layout"]
    rep = sum(int(np.prod(layout[name]["full"])) * 4
              for _, name, _, d in _jax_zero_dims(2) if d is None)
    assert want["master_bytes"] == 0
    if stage and not offload:
        want["master_bytes"] = (want["params_bytes"] - rep) // 2
    for r, rank in enumerate(world("dp2")):
        got = rank[job]["memory"]["components"]
        assert {k: got[k] for k in want} == want, (job, r)


@pytest.mark.parametrize("dp", [2, 4])
def test_offload_ranks_hold_their_regions_on_the_host(world, dp):
    dims = _jax_zero_dims(dp)
    for rank in world(f"dp{dp}"):
        layout = rank["offload"]["layout"]
        for _, name, transposed, d in dims:
            want = list(layout[name]["full"])
            if d is not None:
                want[1 - d if transposed else d] //= dp
            want = tuple(want)
            assert layout[name]["master"] == want, name
            assert layout[name]["opt"] == [want, want], name
            assert layout[name]["accum"] == want, name
        mem = rank["offload"]["memory"]
        assert mem["components"]["master_bytes"] == 0
        assert mem["host"]["master_bytes"] == 4 * sum(
            int(np.prod(layout[name]["master"])) for _, name, _, _ in dims)


def test_distributed_sampler_shards_are_disjoint_and_cover(world):
    for dp in (2, 4):
        ranks = [r["sampler"] for r in world(f"dp{dp}")]
        assert all(r["sampler"] == "DistributedSampler" for r in ranks)
        seen = [set(r["indices"]) for r in ranks]
        for a in range(dp):
            for b in range(a + 1, dp):
                # DistributedSampler pads 21 to a multiple of dp by
                # repeating the first indices; the shards differ elsewhere
                assert len(seen[a] & seen[b]) <= 1
        assert set().union(*seen) == set(range(21))
        assert len({len(r["indices"]) for r in ranks}) == 1


def test_checkpoint_tag_must_agree_across_ranks(world):
    for rank in world("dp2"):
        assert "not consistent across processes" in rank["tag_check"]["error"]


def test_stage1_jax_program_gathers_what_its_report_omits():
    """C-w7, read from the JAX program itself: at stage 1 the compiled step
    on the CPU mesh all-gathers every leaf ZeRO shards (one f32 gather
    each) after the update, while ``comm_volume_report`` prices
    all-reduces of the gradients only."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from tools.graftlint import hlo_contracts as hc

    jeng = _jax_engine(2, 1, 2)
    ids = W.global_batches(SEED, 1, 2, 2 * W.MICRO)[0]
    jeng.train_batch(batch={"input_ids": ids, "labels": ids})
    ops = [op for name in jeng.program_registry.names()
           for op in hc.collective_ops(jeng.program_registry.get(name).hlo())]
    sharded = [(path, d) for path, _, _, d in _jax_zero_dims(2)
               if d is not None]
    shapes = {path: np.shape(x) for path, x in zip(
        _port_names()[0].reference_leaf_paths(),
        jax.tree_util.tree_leaves(_jax_init()))}
    # the parameter gathers: f32 (the CPU backend gathers the master)
    gathers = sorted(op.elements for op in ops
                     if op.op == "all-gather" and op.dtype == "f32")
    assert gathers == sorted(int(np.prod(shapes[p])) for p, _ in sharded)
    report = jeng.comm_volume_report()
    assert report["param_gather_bytes_per_step"] == 0
    assert {c["op"] for c in report["collectives"]} == {"all-reduce"}
