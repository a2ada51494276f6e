"""0/1 Adam of the PyTorch port (ops/onebit/zeroone_adam.py), its wire
(runtime/custom_collectives.py ``quantized_all_reduce`` and
``quantized_error_feedback``) and its comm accounting
(runtime/comm_accounting.py ``zeroone_*``), held against the JAX
package's.

The gloo worlds and the JAX engines beside them are
tests/torch_a13b_cases.py's (riding tests/test_torch_zero3.py's worlds);
inputs from numpy seeds, fp32 throughout.

- ``zeroone_cadence`` takes the JAX function's phases on the JAX tests'
  cases and on a grid of schedules.
- ``quantized_all_reduce`` over gloo worlds of 2 and 4 (bits 1 and 8;
  flat, and at dp 4 over intra groups of 2) equals its ``_virtual`` twin
  bit for bit and the JAX function under shard_map: the int8 wire bit
  for bit (measured: every output and residual), the 1-bit wire within
  1e-6 of the output's largest element and 1e-6 on the residuals (its
  block scales sum in float64 here, in fp32 in XLA; measured 3.6e-7 and
  6e-7). Each round's counted collectives equal
  ``zeroone_grad_exchange_collectives``. ``quantized_error_feedback``
  against the JAX twin likewise.
- ``ZeroOneAdam.update`` leaf by leaf against the JAX optimizer through
  warmup, local and sync phases, rtol 1e-5, atol 1e-6.
- The engine at dp 2 and at dp 4 (hierarchical) against the JAX engine
  through warmup and two rounds of k 2: losses at rtol 1e-5 (measured
  3.3e-6), the master within one sign flip per sync round
  (torch_a13b_cases.assert_within_one_flip, lr * k per round; 2.4 % and
  6.2 % of the elements beyond the dense tolerance, held to 10 %); a
  local round posts no collective, a warmup step one dense all-reduce
  per leaf, a sync round exactly the report's ``optimizer_wire``
  collectives; the comm report equals the JAX engine's after every step.
- The ``zeroone`` lint family: the JAX engine's programs and contracts
  (at dp 4 its budget over groups of 2, C-w17), no finding.
- Checkpoints: the port's tag of step 4 resumes bit for bit through the
  local and sync steps of a run that never stopped, and holds the JAX
  engine's leaves (shapes and dtypes, the residuals as rows of a leading
  dp dim).
- At dp 1 the wire is disarmed and 0/1 Adam is AdamW without bias
  correction bit for bit, for ever.
"""
import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_zero3 as Z3
import torch_a13b_cases as A
import torch_zero_worker as W
from deepspeed_tpu.ops.onebit.zeroone_adam import ZeroOneAdam as JZeroOneAdam
from deepspeed_tpu.ops.onebit.zeroone_adam import \
    zeroone_cadence as jcadence
from deepspeed_tpu.runtime import custom_collectives as jcc
from deepspeed_tpu_torch.ops.onebit.zeroone_adam import (ZeroOneAdam,
                                                         zeroone_cadence)
from deepspeed_tpu_torch.runtime import comm_accounting as ca
from deepspeed_tpu_torch.runtime import custom_collectives as cc
from deepspeed_tpu_torch.runtime.custom_collectives import _Codec


@pytest.fixture(scope="session")
def world(tmp_path_factory):
    return Z3.worlds(tmp_path_factory)


def port_ranks(world, dp):
    return world("z3_dp2_q" if dp == 2 else "z3_dp4")


def jax_side(world, dp):
    return world(f"a13b_jax_dp{dp}")


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_cadence_matches_the_jax_function():
    assert zeroone_cadence(0, 3) == ("warmup", 1)
    assert zeroone_cadence(2, 3) == ("warmup", 1)
    assert [zeroone_cadence(s, 3, local_steps=2) for s in range(3, 9)] == \
        [("local", 2), ("sync", 2)] * 3
    ph = [zeroone_cadence(s, 0, local_steps=1, local_step_scaler=1,
                          local_step_clipper=4) for s in range(11)]
    assert ph[0] == ("sync", 1)
    assert ph[1:3] == [("local", 2), ("sync", 2)]
    assert ph[3:7] == [("local", 4)] * 3 + [("sync", 4)]
    assert ph[7:11] == [("local", 4)] * 3 + [("sync", 4)]
    for args in [(5, 1, 0, 16), (2, 3, 1, 0), (0, 2, 2, 8), (4, 1, 1, 4)]:
        for s in range(40):
            assert zeroone_cadence(s, *args) == jcadence(s, *args)


@pytest.mark.parametrize("bits", [1, 8])
def test_quantized_error_feedback_matches_the_jax_twin(bits):
    rng = np.random.default_rng(A.SEED + bits)
    n = 300
    we = se = torch.zeros(n)
    jwe = jse = jnp.zeros(n)
    for _ in range(3):
        x = rng.standard_normal(n).astype(np.float32)
        got = cc.quantized_error_feedback(t(x), we, se, bits=bits,
                                          block_size=64)
        want = jcc.quantized_error_feedback(jnp.asarray(x), jwe, jse,
                                            bits=bits, block_size=64)
        out, we, se = got
        jout, jwe, jse = want
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-6 * float(jnp.abs(jout).max()))


WIRE_KEYS = {2: ["zeroone_b1_k0", "zeroone_b8_k0"],
             4: ["zeroone_b1_k0", "zeroone_b1_k2", "zeroone_b8_k0",
                 "zeroone_b8_k2"]}


@pytest.mark.parametrize("dp,key", [(dp, k) for dp in (2, 4)
                                    for k in WIRE_KEYS[dp]])
def test_quantized_all_reduce_matches_the_jax_function(world, dp, key):
    bits, k = int(key[9]), int(key[-1])
    want = jax_side(world, dp)[f"wires{dp}"]
    ranks = port_ranks(world, dp)
    x = want["x"]
    n = x.shape[2]
    we = [torch.zeros(n)] * dp
    se = [torch.zeros(n // dp)] * dp
    expect = A.wire_collectives([
        dict(c.__dict__, bytes_per_step=c.bytes_per_step)
        for c in ca.zeroone_grad_exchange_collectives(
            [ca.LeafSpec("x", (n,), None)], dp, bits=bits, block_size=32,
            intra_size=k)])
    for s, (jmean, jwe, jse) in enumerate(want[key]):
        wire = {}
        means, we, se = cc.quantized_all_reduce_virtual(
            [t(x[s, r]) for r in range(dp)], bits=bits, block_size=32,
            intra_size=k, worker_errors=we, server_errors=se, wire=wire)
        assert wire["bytes"] == cc.zeroone_wire_bytes(
            n, dp, _Codec(bits, 32), k)
        for r in range(dp):
            pmean, pwe, pse, comm = ranks[r][f"wires{dp}"][key][s]
            np.testing.assert_array_equal(pmean, means[r].numpy())
            np.testing.assert_array_equal(pwe, we[r].numpy())
            np.testing.assert_array_equal(pse, se[r].numpy())
            if bits == 8:
                for a, b in ((pmean, jmean), (pwe, jwe), (pse, jse)):
                    np.testing.assert_array_equal(a, b[r])
            else:
                np.testing.assert_allclose(
                    pmean, jmean[r], rtol=0,
                    atol=1e-6 * np.abs(jmean[r]).max())
                np.testing.assert_allclose(pwe, jwe[r], rtol=0, atol=1e-6)
                np.testing.assert_allclose(pse, jse[r], rtol=0, atol=1e-6)
            assert A.wire_collectives(comm["collectives"]) == expect


SHAPES = {"a": (4, 8), "b": (16,), "c": (3, 5, 2)}


def test_zeroone_adam_update_matches_the_jax_optimizer():
    rng = np.random.default_rng(A.SEED + 4)
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}
    kw = dict(lr=1e-2, var_freeze_step=2, local_steps=2, weight_decay=0.01,
              quantization_block_size=16)
    jopt = JZeroOneAdam(**kw)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = jopt.init_state(jparams)
    opt = ZeroOneAdam(**kw)
    params = [t(init[k]).clone() for k in SHAPES]
    phases = []
    for step in range(7):
        phase, k = opt.cadence(step)
        assert (phase, k) == jopt.cadence(step)
        phases.append(phase)
        grads = {k_: rng.standard_normal(s).astype(np.float32)
                 for k_, s in SHAPES.items()}
        jparams, jstate = jopt.update(
            {k_: jnp.asarray(v) for k_, v in grads.items()}, jstate,
            jparams, phase=phase, k_round=k)
        before = [p.clone() for p in params]
        opt.update(params, [t(grads[k_]) for k_ in SHAPES],
                   skip=None if phase == "local" else torch.tensor(False),
                   phase=phase, k_round=k)
        if phase == "local":
            assert all(torch.equal(p, q) for p, q in zip(params, before))
        jleaves = {"p": jparams, "m": jstate.m, "v": jstate.v,
                   "we": jstate.worker_error, "se": jstate.server_error,
                   "acc": jstate.local_accum}
        port = {"p": params, "m": opt.m, "v": opt.v,
                "we": opt.worker_error, "se": opt.server_error,
                "acc": opt.local_accum}
        for field, lst in port.items():
            for j, k_ in enumerate(SHAPES):
                np.testing.assert_allclose(
                    lst[j].numpy().reshape(SHAPES[k_]),
                    np.asarray(jleaves[field][k_]), rtol=1e-5, atol=1e-6,
                    err_msg=f"step {step + 1} {phase} {field}/{k_}")
    assert phases == ["warmup"] * 2 + ["local", "sync"] * 2 + ["local"]
    assert int(opt.step) == int(jstate.step) == 7


@pytest.mark.parametrize("dp", [2, 4])
def test_engine_matches_the_jax_engine(world, dp):
    name = f"zo{dp}"
    ranks = port_ranks(world, dp)
    got, want = ranks[0][name], jax_side(world, dp)[name]
    for r in ranks[1:]:
        # a local round's loss is the rank's own (no collective), as the
        # JAX program's; every other step's is the mean over the ranks
        assert [x for x, (ph, _) in zip(r[name]["losses"], got["phases"])
                if ph != "local"] == [x for x, (ph, _) in zip(
                    got["losses"], got["phases"]) if ph != "local"]
        assert r[name]["digest"] == got["digest"]
    assert got["wire"] == "zeroone"
    assert got["phases"] == [("warmup", 1)] * 2 + [("local", 2),
                                                   ("sync", 2)] * 2
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    A.assert_within_one_flip(got["master"], want["master"], got["m"],
                             got["v"], compressed=2 * 2, what=name)
    leaves = [c["name"].split(":", 1)[1] for c in
              got["reports"][0]["collectives"] if c["op"] == "all-reduce"]
    for step, (comm, report, jreport) in enumerate(zip(
            got["comm"], got["reports"], want["reports"])):
        assert report == jreport, step
        phase = got["phases"][step][0]
        if phase == "local":
            assert comm["collectives"] == [] and comm["calls"] == {} \
                and comm["scalars"] == 0, step
        elif phase == "warmup":
            names = sorted(c["name"] for c in comm["collectives"])
            assert names == sorted(f"grad_ar:{n}" for n in leaves)
        else:
            assert A.wire_collectives(comm["collectives"]) == \
                A.wire_collectives(report["optimizer_wire"]["collectives"])
    ow = got["reports"][-1]["optimizer_wire"]
    assert ow["config"]["hierarchical_intra_size"] == (2 if dp == 4 else 0)
    assert ow["sync_round_bytes"] * 8 < \
        ow["warmup_grad_exchange_bytes_per_step"]


def test_zeroone_lint_family_matches_the_jax_engine(world):
    """The ``zeroone`` family of the JAX program lint's corpus
    (tests/unit/test_program_lint.py:385-389): local_k2 collective-free,
    sync_k2 on the u8 / s8 wire within ``optimizer_wire.sync_round_bytes``;
    the JAX engine's contracts, no finding. At dp 4 over intra groups of
    2 the budget's slack is the groups' 2 / (2 - 1), where the JAX
    contract's dp / (dp - 1) falls short of what the gathers move
    (ROADMAP C-w17)."""
    got = port_ranks(world, 2)[0]["zo2"]
    want = jax_side(world, 2)["zo2"]["contracts"]
    assert got["lint"] == []
    assert set(got["contracts"]) == set(want) == {
        "zeroone_fused:warmup_k1", "zeroone_fused:local_k2",
        "zeroone_fused:sync_k2"}
    for name, c in got["contracts"].items():
        norm = lambda d: {k: list(v) if isinstance(v, tuple) else v  # noqa
                          for k, v in d.items()}
        assert norm(c) == norm(want[name]), name
    assert got["contracts"]["zeroone_fused:local_k2"]["collective_free"]
    sync = got["contracts"]["zeroone_fused:sync_k2"]
    assert sorted(sync["wire_dtype"]) == ["s8", "u8"]
    assert sync["comm_budget_key"] == "optimizer_wire.sync_round_bytes"
    hier = port_ranks(world, 4)[0]["zo4"]
    assert hier["lint"] == []
    assert hier["contracts"]["zeroone_fused:sync_k2"]["comm_budget_bytes"] \
        == hier["reports"][-1]["optimizer_wire"]["sync_round_bytes"] * 2 + 1


def test_checkpoints_resume_and_hold_the_jax_layout(world):
    """The port's tag of step 4 at dp 2 resumes bit for bit (the phases of
    steps 5 and 6 re-derived from the counters), and holds the JAX
    engine's tag's leaves: count, shapes (each rank's residual a row of a
    leading dp dim, 0/1 Adam's server residual its chunk) and dtypes.
    Tags crossing the packages: tests/test_torch_onebit.py."""
    from deepspeed_tpu.runtime.checkpoint_utils import npz_dict_to_leaves

    ranks = port_ranks(world, 2)
    run = ranks[0]["zo2"]
    resumed = ranks[0]["zo2_resume"]
    assert resumed["losses"] == run["losses"][A.ZO_SAVE:]
    assert resumed["digest"] == run["digest"]
    assert resumed["phases"] == run["phases"][A.ZO_SAVE:]
    leaves = []
    for tag in (run["saved"], jax_side(world, 2)["zo2"]["saved"]):
        with np.load(os.path.join(tag, "model_states.npz")) as data:
            leaves.append(npz_dict_to_leaves(data))
    got, want = leaves
    assert [(np.shape(x), np.asarray(x).dtype) for x in got] == \
        [(np.shape(x), np.asarray(x).dtype) for x in want]
    assert any(np.shape(x)[:1] == (2,) and np.ndim(x) >= 2 for x in got)


def test_disarmed_at_dp1_is_adamw_without_bias_correction(caplog):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    from deepspeed_tpu_torch.utils.logging import logger

    def engine(optimizer, params):
        cfg = W.ds_config(1, 0, 2, optimizer, opt_params=params)
        return deepspeed_tpu_torch.initialize(
            model=GPT2Model(GPT2Config(dtype=torch.float32, **W.TINY)),
            config_params=cfg, device="cpu")[0]

    logger.propagate = True
    try:
        with caplog.at_level(logging.WARNING):
            eng = engine("ZeroOneAdam", A.ZEROONE)
    finally:
        logger.propagate = False
    assert any("ZeroOneAdam: wire compression DISARMED" in r.message
               and "data-parallel degree is 1" in r.message
               for r in caplog.records)
    ref = engine("AdamW", {"bias_correction": False})
    batches = W.global_batches(A.SEED, 6, 2, W.MICRO)
    for step in range(6):
        batch = W._local(batches[step], 0, W.MICRO)
        assert eng.train_batch(batch=batch).item() == \
            ref.train_batch(batch=batch).item()
    assert all(torch.equal(a, b) for a, b in zip(eng.master, ref.master))
    report = eng.comm_volume_report()
    assert "optimizer_wire" not in report and report["grad_path_modeled"]
