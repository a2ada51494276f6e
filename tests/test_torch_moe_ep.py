"""Expert parallelism of the PyTorch port's MoE GPT-2, in gloo worlds of 2
and 4 ranks on the CPU, held against the JAX engine at ``mesh {"data":
dp}`` on its virtual CPU devices.

The model is the tiny GPT-2 of tests/torch_zero_worker.py with 8 experts
in its odd blocks (``W.MOE``, top-2, capacity factor 1.25), fp32, from
the JAX engine's initial parameters (seed 42) carried over with
models/convert.py; token ids from numpy seeds. Each world (one process per
rank, tests/torch_zero_worker.py ``job_moe``) runs once per session.

- Stages 0 and 2, gas 2, 4 Adam steps: the losses and the gathered master
  at tests/test_torch_zero.py's tolerances (rtol 1e-4, atol 1e-5, the key
  third of each c_attn bias as there); the model's ``moe_aux_loss`` before
  each step at rtol 1e-5 against the JAX model's on the global batch (the
  JAX program is one GSPMD program: its load-balance means are the global
  batch's, ROADMAP hazard H2), and each layer's dropped fraction equal to
  a single process's over the whole global batch.
- Each rank holds E/dp experts of every stack: parameter, master, Adam
  moments, accumulator.
- The comm report equals the JAX engine's; the collectives counted per
  step are the report's without the reduce-scatter and all-gather it
  prices for every expert leaf, and with the all-to-alls the exchange
  posts (ROADMAP C-w12); the JAX program posts all-to-alls too, which its
  report does not price.
- ZeRO-Offload (stage 2) at dp 2 against the JAX offload engine.
- A dp-2 tag loads into the JAX engine, and a JAX dp-2 tag into the port.
- Stage 3 beside expert parallelism at dp 2: the implicit path equals
  stage 2 bit for bit (losses and master), the scheduled int8 gathers
  stay within 1e-3 of stage 2's losses (measured 4.6e-5), and a stage-3
  tag loads at stages 2 and 3 into the leaves it holds.
- The analytic memory equals the JAX engine's; the program lint is clean.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import torch_zero_worker as W
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2Model as JGPT2Model
from deepspeed_tpu.runtime import comm_accounting as jca
from deepspeed_tpu.runtime.checkpoint_utils import npz_dict_to_leaves
from deepspeed_tpu.runtime.engine import _first_micro
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model

STEPS = 4
LR = 1e-3
RTOL, ATOL = 1e-4, 1e-5
OFFLOAD_ATOL = 5e-5
AUX_RTOL = 1e-5
SEED = 13
E = W.MOE["moe_num_experts"]
CASES = [(2, 0), (2, 2), (4, 0), (4, 2)]


def _jax_engine(dp, stage, gas, offload=False):
    cfg = dict(W.ds_config(dp, stage, gas, lr=LR, offload=offload),
               mesh={"data": dp, "allow_partial": True})
    return deepspeed_tpu.initialize(
        model=JGPT2Model(JGPT2Config(dtype=jnp.float32, **W.MOE)),
        config_params=cfg)[0]


def _first_state(jeng, dp=1):
    ids = W.global_batches(0, 1, 1, dp * W.MICRO)[0]
    jeng._ensure_state(_first_micro({"input_ids": ids, "labels": ids}))


@functools.lru_cache(maxsize=None)
def _jax_init():
    """The JAX engine's initial parameters (seed 42) as numpy."""
    jeng = _jax_engine(1, 0, 1)
    _first_state(jeng)
    return jax.tree_util.tree_map(np.asarray,
                                  jax.device_get(jeng.state.params))


@functools.lru_cache(maxsize=None)
def _jax_offload_init():
    """The JAX offload engine's initial host master (ROADMAP C-w8)."""
    jeng = _jax_engine(1, 2, 1, offload=True)
    _first_state(jeng)
    return jax.tree_util.tree_unflatten(
        jeng._host_treedef, [np.asarray(x) for x in jeng._host_master_flat])


def _job(name, dp, stage, gas=2, **kw):
    kw.setdefault("init", _jax_init())
    return (name, "moe", dict(dp=dp, stage=stage, gas=gas, steps=STEPS,
                              seed=SEED, **kw))


def _world_dp2(out):
    jtag = os.path.join(out, "jax_tag")
    jeng = _jax_engine(2, 2, 2)
    for b in W.global_batches(SEED, 2, 2, 2 * W.MICRO):
        jeng.train_batch(batch={"input_ids": b, "labels": b})
    jeng.save_checkpoint(jtag, backend="npz")
    s3tag = os.path.join(out, "s3_tag")
    jobs = [_job("s0", 2, 0, programs=True),
            _job("s2", 2, 2, save=os.path.join(out, "port_tag")),
            _job("offload", 2, 2, offload=True, init=_jax_offload_init()),
            ("load_jax", "load", dict(dp=2, stage=2, gas=2, load=jtag,
                                      model=W.MOE)),
            # stage 3 beside expert parallelism (ROADMAP A13's residue)
            _job("s3_implicit", 2, 3,
                 zero={"stage3_scheduled_gathers": False}),
            _job("s3_scheduled", 2, 3, save=s3tag)]
    jobs += [(f"s3_load{stage}", "load", dict(dp=2, stage=stage, gas=2,
                                              load=s3tag, model=W.MOE))
             for stage in (2, 3)]
    return W.run_world(2, jobs, out)


def _world_dp4(out):
    return W.run_world(4, [_job("s0", 4, 0), _job("s2", 4, 2)], out)


WORLDS = {"moe_dp2": _world_dp2, "moe_dp4": _world_dp4}


@pytest.fixture(scope="session")
def world(tmp_path_factory):
    return W.session_worlds(tmp_path_factory, WORLDS)


def _port_cfg():
    return GPT2Config(dtype=torch.float32, **W.MOE)


def _jax_master(params):
    return {n: t.numpy() for n, t in params_from_jax(
        jax.tree_util.tree_map(np.asarray, jax.device_get(params)),
        _port_cfg()).items()}


def _collectives(records):
    return sorted((c["name"], c["op"], c["dtype"], c["elements"],
                   c["axis_size"], c["bytes_per_step"]) for c in records)


def _jax_run(dp, stage, offload=False):
    """The JAX engine's losses over the worlds' batches and its model's
    aux metric on each step's first micro-batch before the step."""
    jeng = _jax_engine(dp, stage, 2, offload=offload)
    batches = W.global_batches(SEED, STEPS, 2, dp * W.MICRO)
    _first_state(jeng, dp)
    aux_of = jax.jit(lambda p, m: jeng.module.loss(
        p, m, jax.random.PRNGKey(0), train=True)[1]["moe_aux_loss"])
    losses, aux = [], []
    for b in batches:
        micro = {"input_ids": b[0], "labels": b[0]}
        if not offload:
            aux.append(float(aux_of(jeng.state.params, micro)))
        losses.append(float(jeng.train_batch(batch={"input_ids": b,
                                                    "labels": b})))
    return jeng, losses, aux


# ---------------------------------------------------------------------------
# parity with the JAX engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dp,stage", CASES)
def test_expert_parallel_matches_jax_engine(world, dp, stage):
    ranks = world(f"moe_dp{dp}")
    got = ranks[0][f"s{stage}"]
    for r in ranks[1:]:
        assert r[f"s{stage}"]["losses"] == got["losses"]
        assert r[f"s{stage}"]["aux"] == got["aux"]
        for n, m in r[f"s{stage}"]["master"].items():
            np.testing.assert_array_equal(m, got["master"][n])
    jeng, jl, jaux = _jax_run(dp, stage)
    np.testing.assert_allclose(got["losses"], jl, rtol=RTOL)
    # H2: the load-balance loss of the global batch, not a mean of ranks'
    np.testing.assert_allclose(got["aux"], jaux, rtol=AUX_RTOL)
    W.assert_master_close(got["master"], _jax_master(jeng.state.params),
                          RTOL, ATOL, STEPS, LR, f"moe dp {dp} stage {stage}")
    jrep = jeng.comm_volume_report()
    assert _collectives(got["report"]["collectives"]) == \
        _collectives(jrep["collectives"])
    for key in ("grad_exchange_bytes_per_step",
                "param_gather_bytes_per_step", "total_bytes_per_step"):
        assert got["report"][key] == jrep[key], key


@pytest.mark.parametrize("dp", [2, 4])
def test_dropped_fraction_is_the_global_batchs(world, dp):
    """Each MoE layer's dropped fraction at dp ranks equals one process's
    over the whole global batch (the kept count summed over the group),
    before the first step; some tokens drop, and the aux metric there is
    the single process's too."""
    ranks = world(f"moe_dp{dp}")
    b = W.global_batches(SEED, 1, 2, dp * W.MICRO)[0][0]
    model = GPT2Model(_port_cfg())
    model.load_state_dict(params_from_jax(_jax_init(), _port_cfg()))
    seen = []
    hooks = [model.h[i].moe.register_forward_hook(
        lambda mod, args, out: seen.append((mod, args[0])))
        for i in range(1, W.MOE["n_layer"], 2)]
    batch = {k: torch.as_tensor(b).long() for k in ("input_ids", "labels")}
    with torch.no_grad():
        _, metrics = model.loss(batch, train=True)
        want = [float(mod.gate(x, train=True)[-1]["moe_dropped_frac"])
                for mod, x in seen]
    for h in hooks:
        h.remove()
    assert max(want) > 0
    for rank in ranks:
        for stage in (0, 2):
            np.testing.assert_allclose(rank[f"s{stage}"]["dropped"][0], want,
                                       rtol=AUX_RTOL)
            np.testing.assert_allclose(rank[f"s{stage}"]["aux"][0],
                                       float(metrics["moe_aux_loss"]),
                                       rtol=AUX_RTOL)


@pytest.mark.parametrize("dp", [2, 4])
def test_each_rank_holds_its_experts(world, dp):
    for rank in world(f"moe_dp{dp}"):
        for stage in (0, 2):
            layout = rank[f"s{stage}"]["layout"]
            stacks = [n for n in layout if ".moe.experts." in n]
            assert len(stacks) == 4 * (W.MOE["n_layer"] // 2)
            for name in stacks:
                local = layout[name]["full"]
                assert local[0] == E // dp, name
                assert layout[name]["master"] == local, name
                assert layout[name]["opt"] == [local, local], name
                assert layout[name]["accum"] == local, name
            # the router is an ordinary leaf: whole, or ZeRO's shard
            router = layout["h.1.moe.router.weight"]
            assert router["full"] == (E, W.MOE["n_embd"])


# ---------------------------------------------------------------------------
# collectives (ROADMAP C-w12)
# ---------------------------------------------------------------------------
def _expert_priced(report):
    return [c for c in report["collectives"]
            if "/moe/experts/" in c["name"]]


@pytest.mark.parametrize("dp,stage", CASES)
def test_counted_collectives_are_the_report_but_the_expert_exchange(
        world, dp, stage):
    """C-w12: the report (the JAX engine's) prices each expert leaf as a
    data-sharded leaf, a reduce-scatter per micro step and at stage 2 an
    all-gather per step, which the expert-parallel program never posts;
    it posts four all-to-alls per MoE layer and micro step instead (the
    dispatch and the combine, each with its backward), which the report
    does not price. Everything else counted is the report's."""
    got = world(f"moe_dp{dp}")[0][f"s{stage}"]
    report = got["report"]
    priced = _expert_priced(report)
    ops = sorted({c["op"] for c in priced})
    assert ops == (["all-gather", "reduce-scatter"] if stage
                   else ["reduce-scatter"])
    assert not any(c["op"] == "all-to-all" for c in report["collectives"])
    want = [c for c in report["collectives"] if c not in priced]
    layers = W.MOE["n_layer"] // 2
    tokens = W.MICRO * E * 5          # G_local * E * capacity 5
    for step in got["comm"]:
        a2a = [c for c in step["collectives"] if c["op"] == "all-to-all"]
        rest = [c for c in step["collectives"] if c["op"] != "all-to-all"]
        assert _collectives(rest) == _collectives(want)
        assert len(a2a) == 4 * layers
        for c in a2a:
            assert c["count_per_step"] == 2              # gas
            assert c["elements"] == tokens * W.MOE["n_embd"]
            assert c["bytes_per_step"] == 2 * jca.all_to_all_bytes(
                c["elements"], 4, dp)
        assert step["calls"]["all-to-all"] == 2 * 4 * layers


def test_jax_program_exchanges_what_its_report_omits():
    """C-w12, read from the JAX program: at dp 2 its compiled step posts
    all-to-alls, and no reduce-scatter or all-reduce of an expert leaf's
    gradient (each expert's gradient stays on its device), while
    ``comm_volume_report`` prices no all-to-all and an f32 reduce-scatter
    of every expert leaf per micro step."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from tools.graftlint import hlo_contracts as hc

    jeng = _jax_engine(2, 0, 2)
    ids = W.global_batches(SEED, 1, 2, 2 * W.MICRO)[0]
    jeng.train_batch(batch={"input_ids": ids, "labels": ids})
    ops = [op for name in jeng.program_registry.names()
           for op in hc.collective_ops(jeng.program_registry.get(name).hlo())]
    assert any(op.op == "all-to-all" for op in ops)
    stacks = {int(np.prod(np.shape(x))) for path, x in
              jax.tree_util.tree_flatten_with_path(_jax_init())[0]
              if "experts" in jax.tree_util.keystr(path)}
    reduced = {op.elements for op in ops
               if op.op in ("all-reduce", "reduce-scatter")}
    assert not stacks & reduced
    report = jeng.comm_volume_report()
    assert not any(c["op"] == "all-to-all" for c in report["collectives"])
    assert {c["op"] for c in _expert_priced(report)} == {"reduce-scatter"}


# ---------------------------------------------------------------------------
# offload, checkpoints, memory, programs
# ---------------------------------------------------------------------------
def test_offload_dp2_matches_the_jax_offload_engine(world):
    ranks = world("moe_dp2")
    got = ranks[0]["offload"]
    assert ranks[1]["offload"]["losses"] == got["losses"]
    jeng, jl, _ = _jax_run(2, 2, offload=True)
    np.testing.assert_allclose(got["losses"], jl, rtol=RTOL)
    np.testing.assert_allclose(got["norm"],
                               float(jeng.get_global_grad_norm()), rtol=RTOL)
    host = jax.tree_util.tree_unflatten(
        jeng._host_treedef, [np.asarray(x) for x in jeng._host_master_flat])
    W.assert_master_close(got["master"], _jax_master(host), RTOL,
                          OFFLOAD_ATOL, STEPS, LR, "moe offload dp 2")
    for rank in ranks:
        layout = rank["offload"]["layout"]
        for name in (n for n in layout if ".moe.experts." in n):
            local = layout[name]["full"]
            assert local[0] == E // 2
            assert layout[name]["master"] == local
            assert layout[name]["opt"] == [local, local]
    jrep = jeng.comm_volume_report()
    assert _collectives(got["report"]["collectives"]) == \
        _collectives(jrep["collectives"])


def test_port_dp2_tag_loads_into_the_jax_engine(world):
    rank0 = world("moe_dp2")[0]["s2"]
    jeng = _jax_engine(2, 2, 2)
    _first_state(jeng, 2)
    path, _ = jeng.load_checkpoint(os.path.dirname(rank0["saved"]))
    assert jeng.global_steps == STEPS
    with np.load(os.path.join(path, "model_states.npz")) as data:
        saved = npz_dict_to_leaves(data)
    got = jax.tree_util.tree_leaves(jax.device_get(jeng.state))
    assert len(got) == len(saved)
    for i, (x, y) in enumerate(zip(got[:-1], saved[:-1])):   # not the rng
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=str(i))
    # the whole stacks: the port's gathered master, every expert of it
    for n, m in _jax_master(jeng.state.params).items():
        np.testing.assert_array_equal(m, rank0["master"][n], err_msg=n)


def test_jax_dp2_tag_loads_into_the_port(world):
    for r, rank in enumerate(world("moe_dp2")):
        got = rank["load_jax"]
        with np.load(os.path.join(got["path"], "model_states.npz")) as data:
            saved = npz_dict_to_leaves(data)
        assert len(got["leaves"]) == len(saved)
        for i, (x, y) in enumerate(zip(got["leaves"][:-1], saved[:-1])):
            np.testing.assert_array_equal(x, np.asarray(y, x.dtype),
                                          err_msg=str(i))
        # and each rank holds its experts of it
        assert got["layout"]["h.1.moe.experts.w_in"]["master"][0] == E // 2


@pytest.mark.parametrize("stage", [0, 2])
def test_analytic_memory_equals_the_jax_engine_at_dp2(world, stage):
    """Byte for byte but C-w10 (at fp32 from stage 1 the port prices its
    shards of the ZeRO-sharded leaves as a master of its own)."""
    jeng = _jax_engine(2, stage, 2)
    _first_state(jeng, 2)
    want = dict(jeng._analytic_memory_components()["components"])
    got0 = world("moe_dp2")[0][f"s{stage}"]["memory"]["components"]
    if stage:
        assert want["master_bytes"] == 0
        want["master_bytes"] = got0["master_bytes"]
        assert got0["master_bytes"] > 0
    for rank in world("moe_dp2"):
        got = rank[f"s{stage}"]["memory"]["components"]
        assert {k: got[k] for k in want} == want


def test_program_lint_is_clean_at_dp2(world):
    """The lint over the expert-parallel engine's programs: no finding;
    the step's observed collectives hold the all-to-alls (4 per MoE layer
    and micro step) and the scalar all-reduces of the global means."""
    for rank in world("moe_dp2"):
        got = rank["s0"]
        assert got["lint"] == []
        ops = [op for op, _, _ in got["lint_ops"]]
        assert ops.count("all-to-all") == 2 * 4 * (W.MOE["n_layer"] // 2)


def test_stage3_beside_expert_parallelism_at_dp2(world):
    ranks = world("moe_dp2")
    base, implicit = ranks[0]["s2"], ranks[0]["s3_implicit"]
    sched = ranks[0]["s3_scheduled"]
    assert implicit["losses"] == base["losses"]
    for name, m in base["master"].items():
        assert np.array_equal(implicit["master"][name], m), name
    assert not implicit["stage3"]["armed"] and sched["stage3"]["armed"]
    np.testing.assert_allclose(sched["losses"], base["losses"], rtol=1e-3)
    with np.load(os.path.join(sched["saved"], "model_states.npz")) as data:
        saved = npz_dict_to_leaves(data)
    for stage in (2, 3):
        got = ranks[0][f"s3_load{stage}"]["leaves"]
        assert len(got) == len(saved)
        for a, b in zip(got[:-1], saved[:-1]):          # not the rng
            assert np.array_equal(np.asarray(a, np.float64),
                                  np.asarray(b, np.float64)), stage
