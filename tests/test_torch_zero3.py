"""ZeRO stage 3 and the int8 ZeRO collectives (qgZ, qwZ) of the PyTorch
port, in gloo worlds of 2 and 4 ranks on the CPU, held against the JAX
engine at ``mesh {"data": dp}``.

The worlds (tests/torch_zero_worker.py) and the JAX engines
(tests/jax_zero_reference.py, a process of its own: bf16 qgZ aborts the
JAX CPU backend, ROADMAP C-w1) each run once per session. The port starts
from the JAX engine's initial parameters (seed 42); fp32 but where named.

- Stage 3, scheduled (the int8 gathers) at gas 1 and 2 and implicit (the
  dense gathers) at gas 2; qgZ flat at dp 2 and hierarchical at dp 4 (k
  2); qwZ on the offload push; offload at stage 3: losses, grad norms
  and the final master against the JAX engine's at the dense tolerance,
  rtol 1e-4, atol 1e-5 (tests/test_torch_zero.py's; the key third of
  each c_attn bias as there). The int8 weight paths (scheduled stage 3,
  qwZ) are held there because their codes agree: the codes of both
  engines' final masters, blocked as the gathers block them, differ in
  none (``test_int8_weight_codes_agree_with_the_jax_engine``).
- qgZ quantizes the gradients, whose codes inside the JAX program are
  not observable. The two engines' fp32 gradients agree to about 1e-6
  relative (the dense paths), so a code flips only where a gradient lies
  within that of a rounding boundary; a flip moves that element's
  gradient by one code step, a 1/127 of its block's largest, and Adam
  moves an element whose gradient is small against its block by up to
  lr per step for it. Measured over 4 steps at lr 1e-3: 1 to 8 elements
  of a 4096-element leaf beyond the dense tolerance, by at most 4.6e-5
  (dp 4) and 2.9e-5 (dp 2). Held to atol 1e-4 (a tenth of lr) with at
  most 16 elements of a leaf beyond the dense tolerance; losses and
  grad norms at the dense rtol.
- bf16 qgZ (no JAX reference: it aborts there) stays within 2 % of the
  port's own dense stage 2 (the JAX acceptance,
  tests/unit/test_quantization.py:214-222).
- The implicit stage 3 is the port's stage 2 bit for bit, under every
  remat policy too; it gathers layer by layer and its graph keeps no
  gathered weight. Stage 3 in a world of one is stage 0 bit for bit.
- ``stage3_report()``, ``comm_volume_report()`` and the analytic memory
  equal the JAX engine's (C-w10 alone excepted: at fp32 the port keeps
  its master shards apart from the parameters); each step's counted
  collectives equal the report.
- At rest each rank's sharded parameters hold 1/dp of their leaf.
- An overflow planted on one rank skips the stage-3 step everywhere.
- A stage-3 tag loads both ways.
"""
import os

import numpy as np
import pytest
import torch

import jax_zero_reference as JR
import torch_a13b_cases as A
import torch_zero_worker as W
from deepspeed_tpu_torch.runtime import quantization as qz
from deepspeed_tpu_torch.runtime.custom_collectives import (
    leaf_rows, quantized_reduce_scatter_virtual)

STEPS = 4
SEED = 13
RTOL, ATOL = 1e-4, 1e-5
QGZ_ATOL, QGZ_BEYOND = 1e-4, 16
LR = 1e-3
S3_OFF = {"stage3_scheduled_gathers": False}
QGZ = {"quantized_gradients": True}
QGZ_HIER = {"quantized_gradients": True, "hierarchical_allreduce": True,
            "hierarchical_intra_size": 2}
QWZ = {"quantized_weights": True}
# name: (dp, stage, gas, zero, offload)
CONFIGS = {
    "s3g2": (2, 3, 2, None, False),
    "s3g1": (2, 3, 1, None, False),
    "s3ig2": (2, 3, 2, S3_OFF, False),
    "off3": (2, 3, 2, None, True),
    "qgz2": (2, 2, 2, QGZ, False),
    "qgz4h": (4, 2, 2, QGZ_HIER, False),
    "offq": (2, 2, 2, QWZ, True),
    "off3q": (2, 3, 2, QWZ, True),
}
S3_PROGRAMS = ["apply_step", "s3_bwd", "s3_fwd"]
QGZ_PROGRAMS = ["apply_step", "eval_loss", "micro_step"]


def _init(offload=False):
    """The JAX engine's initial parameters (seed 42); under offload its
    host master's (tests/test_torch_zero.py)."""
    from test_torch_zero import _jax_init, _jax_offload_init

    return _jax_offload_init() if offload else _jax_init()


def _port_job(name, **over):
    dp, stage, gas, zero, offload = CONFIGS[name]
    init = _init(offload)
    kw = dict(dp=dp, stage=stage, gas=gas, steps=STEPS, seed=SEED,
              init=init, zero=zero, offload=offload)
    kw.update(over)
    return (name, "train", kw)


def _jax_job(name, **over):
    dp, stage, gas, zero, offload = CONFIGS[name]
    return (name, "train", dict(dp=dp, stage=stage, gas=gas, steps=STEPS,
                                seed=SEED, zero=zero, offload=offload,
                                **over))


def _jax_world(name):
    """The JAX engine of ``name`` in a process of its own (one world per
    engine, so that the session's workers build them side by side)."""
    extra = {"s3g2": dict(programs=S3_PROGRAMS),
             "qgz2": dict(programs=QGZ_PROGRAMS)}.get(name, {})

    def build(out):
        if name == "s3g2":
            extra["save"] = os.path.join(out, "jax_tag")
        return JR.run([_jax_job(name, **extra)], out)
    return build


# the port's jobs, in two worlds of 2 (side by side) and one of 4
S3_JOBS = ("s3g2", "s3g1", "s3ig2", "s2g2", "overflow", "misc", "faults",
           "mfu2", "mfu3", "blocks")
Q_JOBS = ("qgz2", "offq", "off3", "off3q", "bf16_s2", "bf16_qgz")


def _world_dp2_s3(out):
    init = _init()
    jobs = [_port_job("s3g2", save=os.path.join(out, "port_tag"),
                      save_at=STEPS, programs=S3_PROGRAMS),
            _port_job("s3g1"), _port_job("s3ig2"),
            ("s2g2", "train", dict(dp=2, stage=2, gas=2, steps=STEPS,
                                   seed=SEED, init=init)),
            ("overflow", "overflow", dict(dp=2, seed=SEED, init=init,
                                          plant_rank=1, stage=3,
                                          param="h.0.mlp.c_fc.weight")),
            ("misc", "zero3_misc", dict(dp=2, seed=SEED)),
            ("faults", "zero3_faults", dict(dp=2, seed=SEED, init=init)),
            ("blocks", "zero3_blocks", dict(dp=2, seed=SEED, init=init,
                                            steps=STEPS))]
    jobs += [(f"mfu{stage}", "seq", dict(
        kind="gpt2", mesh={"data": 2}, stage=stage, gas=2, steps=1,
        seed=SEED, telemetry=True, master=None)) for stage in (2, 3)]
    return W.run_world(2, jobs, out)


def _world_dp2_q(out):
    init = _init()
    jobs = [_port_job("qgz2", programs=QGZ_PROGRAMS), _port_job("offq"),
            _port_job("off3"), _port_job("off3q"),
            ("bf16_s2", "train", dict(dp=2, stage=2, gas=2, steps=STEPS,
                                      seed=SEED, init=init,
                                      dtype=torch.bfloat16)),
            ("bf16_qgz", "train", dict(dp=2, stage=2, gas=2, steps=STEPS,
                                       seed=SEED, init=init, zero=QGZ,
                                       dtype=torch.bfloat16))]
    # the 1-bit Adam, 0/1 Adam and CSR cases (tests/torch_a13b_cases.py)
    jobs += A.port_jobs(2, out)
    return W.run_world(2, jobs, out)


def _world_dp4(out):
    return W.run_world(4, [_port_job("qgz4h"), _port_job("s3g2", dp=4)]
                       + A.port_jobs(4, out), out)


def _world_load(out):
    """The port loads the JAX engine's stage-3 tag, and the JAX engine the
    port's."""
    tag = os.path.dirname(jax_result(_worlds, "s3g2")["saved"])
    port = W.run_world(2, [("load_jax", "load", dict(dp=2, stage=3, gas=2,
                                                     load=tag))], out)
    ptag = os.path.dirname(_worlds("z3_dp2_s3")[0]["s3g2"]["saved"])
    jax = JR.run([("load_port", "load", dict(dp=2, stage=3, gas=2,
                                             load=ptag, seed=SEED,
                                             step=STEPS))], out)
    return {"port": port, "jax": jax}


WORLDS = dict({f"z3_jax_{name}": _jax_world(name) for name in CONFIGS},
              z3_dp2_s3=_world_dp2_s3, z3_dp2_q=_world_dp2_q,
              z3_dp4=_world_dp4, z3_load=_world_load,
              a13b_jax_dp2=lambda out: JR.run(A.jax_jobs(2, out), out,
                                              timeout=400),
              a13b_jax_dp4=lambda out: JR.run(A.jax_jobs(4, out), out,
                                              timeout=400))
_worlds = None


def worlds(tmp_path_factory):
    """get(key) -> the result of the world ``WORLDS[key]``, each run once
    per session (tests/test_torch_programs.py reads them too)."""
    global _worlds
    if _worlds is None:
        _worlds = W.session_worlds(tmp_path_factory, WORLDS)
    return _worlds


@pytest.fixture(scope="session")
def world(tmp_path_factory):
    return worlds(tmp_path_factory)


def jax_result(world, name):
    return world(f"z3_jax_{name}")[name]


def port_world(world, name):
    """Every rank's results of the port's world that runs job ``name``."""
    if name in CONFIGS and CONFIGS[name][0] == 4:
        return world("z3_dp4")
    return world("z3_dp2_s3" if name in S3_JOBS else "z3_dp2_q")


def port_result(world, name):
    """Rank 0's result of ``name``; every rank saw the same losses."""
    ranks = port_world(world, name)
    for r in ranks[1:]:
        assert r[name]["losses"] == ranks[0][name]["losses"]
    return ranks[0][name]


def _collectives(records):
    return sorted((c["name"], c["op"], c["dtype"], c["elements"],
                   c["axis_size"], c["bytes_per_step"], c["link"])
                  for c in records)


def _leaf_codes(master, dp, block=qz.DEFAULT_BLOCK_SIZE):
    """{param: int8 codes of each rank's shard} of a master (port names),
    each leaf blocked as the gathers block it (rows along its ZeRO dim)."""
    from test_torch_zero import _jax_zero_dims

    out = {}
    for _, name, transposed, d in _jax_zero_dims(dp):
        if d is None:
            continue
        leaf = torch.from_numpy(np.asarray(master[name]))
        if transposed:
            leaf = leaf.t()
        out[name] = qz.quantize_rows(leaf_rows(leaf, d, dp), block)[0]
    return out


def _code_flips(got, want, dp):
    return sum(int((a != b).sum()) for a, b in zip(
        _leaf_codes(got, dp).values(), _leaf_codes(want, dp).values()))


# ---------------------------------------------------------------------------
# parity with the JAX engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(CONFIGS))
def test_matches_the_jax_engine(world, name):
    got, want = port_result(world, name), jax_result(world, name)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL)
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=RTOL)
    if not name.startswith("qgz"):
        W.assert_master_close(got["master"], want["master"], RTOL, ATOL,
                              STEPS, LR, name)
        return
    # qgZ: the measured bound of the module docstring
    W.assert_master_close(got["master"], want["master"], RTOL, QGZ_ATOL,
                          STEPS, LR, name)
    for n, b in want["master"].items():
        if n.endswith("attn.c_attn.bias"):
            continue
        beyond = np.abs(got["master"][n] - b) > ATOL + RTOL * np.abs(b)
        assert beyond.sum() <= QGZ_BEYOND, (n, int(beyond.sum()))


@pytest.mark.parametrize("name", ["s3g2", "s3g1", "offq"])
def test_int8_weight_codes_agree_with_the_jax_engine(world, name):
    """The int8 codes of the two engines' final masters, blocked as the
    gathers block them: none differ."""
    got, want = port_result(world, name), jax_result(world, name)
    assert _code_flips(got["master"], want["master"], CONFIGS[name][0]) == 0


@pytest.mark.parametrize("name", list(CONFIGS))
def test_reports_equal_the_jax_engine(world, name):
    got, want = port_result(world, name), jax_result(world, name)
    assert _collectives(got["report"]["collectives"]) == \
        _collectives(want["report"]["collectives"])
    for key in ("grad_exchange_bytes_per_step", "param_gather_bytes_per_step",
                "param_gather_quantized_bytes_per_step",
                "param_gather_dense_bytes_per_step", "total_bytes_per_step",
                "inter_bytes_per_step", "baseline", "config"):
        if key == "config":
            mine = dict(got["report"][key])
            assert mine == want["report"][key]
        else:
            assert got["report"][key] == want["report"][key], key
    if want["stage3"] is None:
        assert got["stage3"] is None
    else:
        mine = dict(got["stage3"])
        mine.pop("disarmed_by")
        assert mine == want["stage3"]


@pytest.mark.parametrize("name", [n for n in CONFIGS if n != "off3q"])
def test_counted_collectives_equal_the_report(world, name):
    got = port_result(world, name)
    want = _collectives(got["report"]["collectives"])
    for step in got["comm"]:
        assert _collectives(step["collectives"]) == want


def test_offload_stage3_qwz_gathers_dense_where_the_report_prices_int8(
        world):
    """C-w15: under offload at stage 3 with qwZ the JAX report prices
    every use-site gather (2 x gas per step) as int8 codes and scales
    (``qwz_ag`` / ``qwz_scales``), while the gathers at use are dense in
    the compute dtype in both engines (the JAX program gathers the
    sharded parameters where XLA places them); only the push moves int8.
    The port's report is the JAX one; its counter has the dense
    ``param_ag`` gathers instead, leaf for leaf, and the gradient
    exchange as the report prices it."""
    got = port_result(world, "off3q")
    report = got["report"]["collectives"]
    qwz = {c["name"].split(":", 1)[1] for c in report
           if c["name"].startswith("qwz_ag:")}
    assert qwz and all(c["count_per_step"] == 4 for c in report
                       if c["name"].startswith("qwz_"))
    for step in got["comm"]:
        counted = step["collectives"]
        assert not any(c["name"].startswith("qwz_") for c in counted)
        dense = {c["name"].split(":", 1)[1] for c in counted
                 if c["name"].startswith("param_ag:")
                 and c["count_per_step"] == 4}
        assert qwz <= dense
        grads = [c for c in counted if c["name"].startswith("grad_")]
        assert _collectives(grads) == _collectives(
            [c for c in report if c["name"].startswith("grad_")])


@pytest.mark.parametrize("name", ["s3g2", "s3ig2", "qgz2", "off3"])
def test_analytic_memory_equals_the_jax_engine(world, name):
    """Component and transient bytes, byte for byte, but C-w10: at fp32
    the port's master shards are a tensor of their own (the JAX engine's
    fp32 parameters are its master), priced under ``master_bytes``; under
    offload the port's device holds its flat staging buffer beside."""
    got, want = port_result(world, name), jax_result(world, name)
    gm, wm = dict(got["memory"]["components"]), \
        dict(want["memory"]["components"])
    if CONFIGS[name][4]:
        gm.pop("offload_staging_bytes")
    else:
        assert wm["master_bytes"] == 0
        wm["master_bytes"] = gm["master_bytes"]
        assert gm["master_bytes"] > 0
    assert gm == wm
    if not CONFIGS[name][4]:
        assert got["memory"]["transient"] == {
            k: want["memory"]["transient"][k]
            for k in got["memory"]["transient"]}


def test_bf16_qgz_within_2pct_of_dense_stage2(world):
    ranks = port_world(world, "bf16_qgz")
    got = ranks[0]["bf16_qgz"]["losses"]
    assert ranks[1]["bf16_qgz"]["losses"] == got
    dense = ranks[0]["bf16_s2"]["losses"]
    assert np.isfinite(got).all()
    for a, b in zip(got, dense):
        assert abs(a - b) / abs(b) < 0.02, (got, dense)


def test_implicit_stage3_is_stage2_bit_for_bit(world):
    rank0 = port_world(world, "s2g2")[0]
    s3, s2 = rank0["s3ig2"], rank0["s2g2"]
    assert s3["losses"] == s2["losses"] and s3["norms"] == s2["norms"]
    for n in s2["master"]:
        np.testing.assert_array_equal(s3["master"][n], s2["master"][n])


@pytest.mark.parametrize("policy", ["None", "nothing", "attn_out", "dots"])
def test_implicit_stage3_gathers_layer_by_layer(world, policy):
    """The implicit path without remat and under each remat policy: the
    port's stage 2 bit for bit (remat recomputes the same arithmetic);
    one block per layer and one pinned (the embeddings and the final
    LayerNorm), of which at most the pinned block and one layer are whole
    at once; and of the weights a forward gathered, none is alive after
    it (the graph keeps no gathered weight: the backward gathers each
    layer again, as the counted collectives show, 2 x gas per step)."""
    rank0 = port_world(world, "s2g2")[0]
    s2, got = rank0["s2g2"], rank0["blocks"][policy]
    assert got["losses"] == s2["losses"]
    assert got["digest"] == s2["digest"]
    assert got["blocks"] == W.TINY["n_layer"] + 1 and got["pinned"]
    assert got["most"] == 2
    assert got["freed"] > 0 and got["alive"] == 0


def test_stage3_in_a_world_of_one_is_stage0_bit_for_bit():
    """dp 1: nothing is partitioned, the plan is disarmed and says why,
    and the step is stage 0's."""
    init = _init()
    batches = W.global_batches(SEED, 2, 2, W.MICRO)
    out = {}
    for stage in (0, 3):
        eng = W._engine(W.ds_config(1, stage, 2), init)
        out[stage] = ([eng.train_batch(batch=W._local(b, 0, W.MICRO)).item()
                       for b in batches], W._full_master(eng))
    assert out[0][0] == out[3][0]
    for n, m in out[0][1].items():
        np.testing.assert_array_equal(out[3][1][n], m)
    rep = eng.stage3_report()
    assert rep["armed"] is False and rep["n_gathered_leaves"] == 0
    assert rep["disarmed_by"] == ["data-parallel degree is 1 (nothing is "
                                  "partitioned)"]
    assert eng.comm_volume_report()["total_bytes_per_step"] == 0


@pytest.mark.parametrize("dp", [2, 4])
def test_shards_at_rest_are_a_dp_th_of_each_leaf(world, dp):
    from test_torch_zero import _jax_zero_dims

    ranks = world("z3_dp4" if dp == 4 else "z3_dp2_s3")
    dims = _jax_zero_dims(dp)
    assert any(d is None for *_, d in dims)
    for rank in ranks:
        got = rank["s3g2"]
        for _, name, transposed, d in dims:
            want = list(got["layout"][name]["full"])
            if d is not None:
                want[1 - d if transposed else d] //= dp
            assert got["rest"][name] == tuple(want), name
        assert got["stage3"]["armed"]
        assert got["memory"]["transient"]["gathered_stage3_bytes"] == \
            got["stage3"]["peak_gathered_bytes"] > 0


def test_overflow_on_one_rank_skips_the_stage3_step_everywhere(world):
    ranks = [r["overflow"] for r in port_world(world, "overflow")]
    assert ranks[0]["holder"] == [0]
    for r in ranks:
        assert r["overflow1"] and r["skipped1"] == 1 and r["unchanged"]
        assert r["scale1"] == r["scale0"] / 2
        assert r["skipped2"] == 1


def test_quantized_collectives_over_the_world(world):
    """Every rank's gather is the whole leaf, each shard's codes blocked
    on their own; the shard's gradient is the sum over the ranks of their
    cotangents' part for it (one reduce-scatter); the reduce-scatter is
    its virtual composition's bit for bit."""
    ranks = [r["misc"] for r in port_world(world, "misc")]
    full = torch.from_numpy(ranks[0]["full"])
    want = torch.cat([qz.dequantize_rows(*qz.quantize_rows(
        s.reshape(1, -1)), s.numel()).reshape(s.shape)
        for s in full.chunk(2, 0)])
    cot = ranks[0]["cot"].sum(0)
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["gathered"], want.numpy())
        np.testing.assert_allclose(got["grad"], cot[4 * r:4 * (r + 1)],
                                   rtol=1e-6)
        names = {c["name"] for c in got["comm"]["collectives"]}
        assert names == {"qwz_ag:w", "qwz_scales:w", "grad_rs:w",
                         "qgz_a2a:g", "qgz_scales:g"}
        assert "forward() called twice" in got["twice"]
        # the reduce-scatter over the world is its virtual composition's
        # (held against the JAX shard_map in test_torch_quantization.py)
        want_rs = quantized_reduce_scatter_virtual(
            [torch.from_numpy(x) for x in got["xs"]], dim=1, block_size=8)
        np.testing.assert_array_equal(got["reduced"], want_rs[r].numpy())


def test_stage3_tags_load_both_ways(world):
    loaded = world("z3_load")
    jax_tag = jax_result(world, "s3g2")
    for rank in loaded["port"]:
        got = rank["load_jax"]
        from deepspeed_tpu.runtime.checkpoint_utils import npz_dict_to_leaves

        with np.load(os.path.join(got["path"], "model_states.npz")) as data:
            saved = npz_dict_to_leaves(data)
        assert len(got["leaves"]) == len(saved)
        for i, (x, y) in enumerate(zip(got["leaves"][:-1], saved[:-1])):
            np.testing.assert_array_equal(x, np.asarray(y, x.dtype),
                                          err_msg=str(i))
        assert got["layout"]["wte"]["master"] == (128, 16)
    assert jax_tag["saved"]
    # the JAX engine holds the port's leaves and goes on from the tag
    j = loaded["jax"]["load_port"]
    assert j["same"] and j["global_steps"] == STEPS + 1
    assert np.isfinite(j["loss"])


def test_stage3_flop_counts_are_the_whole_models(world):
    """MFU's FLOPs replay the micro step at the parameters' whole shapes,
    not the shards they hold at rest: stage 3's counts are stage 2's."""
    ranks = port_world(world, "mfu3")
    for rank in ranks:
        assert rank["mfu3"]["mfu"] == rank["mfu2"]["mfu"]
        assert rank["mfu3"]["mfu"]["hw_flops_per_step"] > 0


def test_refusals_name_a13b():
    """A13b (1-bit Adam, 0/1 Adam, CSR gradients) is ported: what the
    port refused by that name builds and trains, and what the slice does
    not reach names A13c."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model

    def build(cfg):
        model = GPT2Model(GPT2Config(dtype=torch.float32, **W.TINY))
        return deepspeed_tpu_torch.initialize(model=model, config_params=cfg,
                                              device="cpu")[0]

    batch = W._local(W.global_batches(SEED, 1, 1, W.MICRO)[0], 0, W.MICRO)
    for cfg in (W.ds_config(1, 0, 1, optimizer="OneBitAdam"),
                dict(W.ds_config(1, 2, 1, offload=True),
                     sparse_gradients=True)):
        assert np.isfinite(build(cfg).train_batch(batch=batch).item())
    with pytest.raises(NotImplementedError, match="A13c"):
        build(W.ds_config(1, 2, 1, optimizer="OneBitAdam", offload=True))
