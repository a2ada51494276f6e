"""1-bit Adam of the PyTorch port (ops/onebit/onebit_adam.py) and its wire
(runtime/custom_collectives.py: the sign codes, ``compressed_allreduce``,
``quantize_with_error_feedback``), held against the JAX package's.

The gloo worlds and the JAX engines beside them are
tests/torch_a13b_cases.py's (riding tests/test_torch_zero3.py's worlds);
the functions' inputs come from numpy seeds. fp32 throughout.

- The packed sign bytes equal the JAX ``pack_signs`` bit for bit (most
  significant bit first, sign(0) = +1); the scale ||x|| / sqrt(n) sums
  in float64 here and in fp32 in XLA: within 4 ulps (rtol 5e-7).
- ``compressed_allreduce`` over gloo worlds of 2 and 4 equals its
  ``_virtual`` twin bit for bit, and the JAX function under shard_map
  over 2 and 4 devices within 1e-6 of the output's largest element
  (measured 1.5e-7) and 1e-6 on the residuals (measured 4.8e-7), over 3
  rounds with the residuals carried; the first round's packed worker
  signs are the JAX ``pack_signs`` bytes. The counter names four
  collectives per call, priced at the packed bytes (32x fewer than
  fp32).
- ``OnebitAdam.update`` leaf by leaf against the JAX optimizer through
  its freeze: params and state at rtol 1e-5, atol 1e-6; its warmup is
  the port's FusedAdam(bias_correction=False) bit for bit; v does not
  move after the freeze.
- The engine at dp 2 and 4 (the wire armed) against the JAX engine:
  losses at rtol 1e-5 (measured 3.3e-6) and the master within one sign
  flip per frozen step (``torch_a13b_cases.assert_within_one_flip``:
  a 1-bit step moves an element by lr * m / (sqrt(v) + eps), so an
  element whose momentum lies within rounding noise of 0 moves by twice
  that when the two engines round its sign apart; measured at most
  half of it, and 3.2 % of the elements beyond the dense tolerance at
  dp 2, 3.7 % at dp 4, held to 10 %). A warmup step posts one dense
  all-reduce per leaf, a frozen step the four packed collectives per
  leaf; the comm report equals the JAX engine's (which does not model
  the 1-bit wire). The ``onebit`` lint family's programs and contracts
  are the JAX engine's and lint clean.
- At dp 1 the wire is disarmed with the JAX engine's words, the frozen
  steps run the local twin, and the freeze counts optimizer steps.
"""
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_zero3 as Z3
import torch_a13b_cases as A
import torch_zero_worker as W
from deepspeed_tpu.ops.onebit.onebit_adam import OnebitAdam as JOnebitAdam
from deepspeed_tpu.runtime import custom_collectives as jcc
from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam
from deepspeed_tpu_torch.ops.onebit.onebit_adam import OnebitAdam
from deepspeed_tpu_torch.runtime import comm_accounting as ca
from deepspeed_tpu_torch.runtime import custom_collectives as cc

ONEBIT_NAMES = ("onebit_a2a", "onebit_scales", "onebit_ag",
                "onebit_ag_scales")


@pytest.fixture(scope="session")
def world(tmp_path_factory):
    return Z3.worlds(tmp_path_factory)


def port_ranks(world, dp):
    return world("z3_dp2_q" if dp == 2 else "z3_dp4")


def jax_side(world, dp):
    return world(f"a13b_jax_dp{dp}")


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# the sign codes and the single-device twin
# ---------------------------------------------------------------------------
def test_sign_codes_match_the_jax_functions():
    rng = np.random.default_rng(A.SEED)
    x = rng.standard_normal(1024).astype(np.float32)
    x[::7] = 0.0
    signs = np.where(x >= 0, 1.0, -1.0).astype(np.float32)
    packed = cc.pack_signs(t(signs))
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jcc.pack_signs(jnp.asarray(signs))))
    np.testing.assert_array_equal(cc.unpack_signs(packed).numpy(), signs)
    # most significant bit first, a set bit for +1
    assert cc.pack_signs(torch.tensor([1.0] + [-1.0] * 7)).tolist() == [128]
    scale, s, res = cc.sign_compress(t(x))
    jscale, js, jres = jcc._sign_compress(jnp.asarray(x))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s[0] == 1.0                        # sign(0) = +1
    np.testing.assert_allclose(float(scale), float(jscale), rtol=5e-7)
    np.testing.assert_allclose(res.numpy(), np.asarray(jres), rtol=0,
                               atol=4 * np.spacing(float(jscale)))


def test_quantize_with_error_feedback_matches_jax_and_bounds_the_bias():
    rng = np.random.default_rng(A.SEED + 1)
    we = se = torch.zeros(96)
    jwe = jse = jnp.zeros(96)
    for _ in range(4):
        x = rng.standard_normal(96).astype(np.float32)
        out, we, se = cc.quantize_with_error_feedback(t(x), we, se)
        jout, jwe, jse = jcc.quantize_with_error_feedback(jnp.asarray(x),
                                                          jwe, jse)
        for a, b in ((out, jout), (we, jwe), (se, jse)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)
    # error feedback: the average of the codes of a constant signal
    # approaches it (tests/unit/test_onebit.py:87)
    x = t(rng.standard_normal(64).astype(np.float32))
    we = se = torch.zeros(64)
    acc = torch.zeros(64, dtype=torch.float64)
    for _ in range(200):
        q, we, se = cc.quantize_with_error_feedback(x, we, se)
        acc += q
    err = torch.linalg.norm(acc / 200 - x) / torch.linalg.norm(x)
    assert err < 0.05, float(err)


# ---------------------------------------------------------------------------
# compressed_allreduce over the worlds
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dp", [2, 4])
def test_compressed_allreduce_matches_the_jax_function(world, dp):
    want = jax_side(world, dp)[f"wires{dp}"]
    ranks = port_ranks(world, dp)
    x = want["x"]
    n = x.shape[2]
    we = [torch.zeros(n)] * dp
    se = [torch.zeros(n // dp)] * dp
    for s, (jmean, jwe, jse) in enumerate(want["onebit"]):
        wire = {}
        means, we, se = cc.compressed_allreduce_virtual(
            [t(x[s, r]) for r in range(dp)], we, se, wire=wire)
        if s == 0:
            for r in range(dp):
                np.testing.assert_array_equal(
                    wire["worker_packed"][r].reshape(-1).numpy(),
                    np.asarray(jcc.pack_signs(jnp.where(
                        jnp.asarray(x[0, r]) >= 0, 1.0, -1.0))))
        for r in range(dp):
            pmean, pwe, pse, comm = ranks[r][f"wires{dp}"]["onebit"][s]
            # the process group's wire is its virtual twin bit for bit
            np.testing.assert_array_equal(pmean, means[r].numpy())
            np.testing.assert_array_equal(pwe, we[r].numpy())
            np.testing.assert_array_equal(pse, se[r].numpy())
            np.testing.assert_allclose(pmean, jmean[r], rtol=0,
                                       atol=1e-6 * np.abs(jmean[r]).max())
            np.testing.assert_allclose(pwe, jwe[r], rtol=0, atol=1e-6)
            np.testing.assert_allclose(pse, jse[r], rtol=0, atol=1e-6)
            names = sorted(c["name"] for c in comm["collectives"])
            assert names == sorted(f"{p}:x" for p in ONEBIT_NAMES)
            sent = sum(c["bytes_per_step"] for c in comm["collectives"])
            assert sent == cc.onebit_wire_bytes(n, dp) == wire["bytes"]
            # the packed signs: 32x fewer bytes than an fp32 all-reduce's
            # two phases (the scales ride beside)
            packed = sum(c["bytes_per_step"] for c in comm["collectives"]
                         if "scales" not in c["name"])
            assert packed * 32 == ca.allreduce_bytes(n, 4, dp)


# ---------------------------------------------------------------------------
# the optimizer, leaf by leaf
# ---------------------------------------------------------------------------
SHAPES = {"a": (4, 8), "b": (16,), "c": (3, 5, 2)}


def test_onebit_adam_update_matches_the_jax_optimizer():
    rng = np.random.default_rng(A.SEED + 2)
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}
    kw = dict(lr=1e-2, freeze_step=2, weight_decay=0.01)
    jopt = JOnebitAdam(**kw)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = jopt.init_state(jparams)
    opt = OnebitAdam(**kw)
    params = [t(init[k]).clone() for k in SHAPES]
    ref = FusedAdam(lr=1e-2, bias_correction=False, weight_decay=0.01)
    ref_params = [p.clone() for p in params]
    for step in range(5):
        grads = {k: rng.standard_normal(s).astype(np.float32)
                 for k, s in SHAPES.items()}
        jparams, jstate = jopt.update(
            {k: jnp.asarray(v) for k, v in grads.items()}, jstate, jparams)
        v_before = [v.clone() for v in opt.v] if opt.v else None
        opt.update(params, [t(grads[k]) for k in SHAPES],
                   skip=torch.tensor(False))
        if step < 2:
            # warmup: FusedAdam without bias correction, bit for bit
            ref.update(ref_params, [t(grads[k]) for k in SHAPES])
            for p, q in zip(params, ref_params):
                assert torch.equal(p, q)
        else:
            # frozen: v holds
            for v, w in zip(opt.v, v_before):
                assert torch.equal(v, w)
        jleaves = {"p": jparams, "m": jstate.m, "v": jstate.v,
                   "we": jstate.worker_error, "se": jstate.server_error}
        port = {"p": params, "m": opt.m, "v": opt.v,
                "we": opt.worker_error, "se": opt.server_error}
        for field, lst in port.items():
            for j, k in enumerate(SHAPES):
                np.testing.assert_allclose(
                    lst[j].numpy().reshape(SHAPES[k]),
                    np.asarray(jleaves[field][k]), rtol=1e-5, atol=1e-6,
                    err_msg=f"step {step + 1} {field}/{k}")
    assert int(opt.step) == int(jstate.step) == 5


def test_a_skipped_frozen_step_changes_nothing():
    rng = np.random.default_rng(A.SEED + 3)
    opt = OnebitAdam(lr=1e-2, freeze_step=0)
    params = [t(rng.standard_normal(s).astype(np.float32))
              for s in SHAPES.values()]
    grads = [torch.ones(s) for s in SHAPES.values()]
    opt.update(params, grads, skip=torch.tensor(False))
    before = [[x.clone() for x in lst] for lst in
              (params, opt.m, opt.v, opt.worker_error, opt.server_error)]
    opt.update(params, [torch.zeros(s) for s in SHAPES.values()],
               skip=torch.tensor(True))
    after = (params, opt.m, opt.v, opt.worker_error, opt.server_error)
    for lb, la in zip(before, after):
        for x, y in zip(lb, la):
            assert torch.equal(x, y)
    assert int(opt.step) == 1


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dp", [2, 4])
def test_engine_matches_the_jax_engine(world, dp):
    name = f"ob{dp}"
    ranks = port_ranks(world, dp)
    got, want = ranks[0][name], jax_side(world, dp)[name]
    for r in ranks[1:]:
        assert r[name]["losses"] == got["losses"]
        assert r[name]["digest"] == got["digest"]
    assert got["wire"] == "onebit"
    assert got["phases"] == [("warmup", 1)] * 2 + [("frozen", 1)] * 2
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    A.assert_within_one_flip(got["master"], want["master"], got["m"],
                             got["v"], compressed=2, what=name)
    # the report models no 1-bit wire, as the JAX engine's
    assert got["reports"][-1] == want["reports"][-1]
    assert got["reports"][-1]["grad_path_modeled"] is False
    leaves = [c["name"].split(":", 1)[1] for c in
              got["reports"][-1]["collectives"] if c["op"] == "all-reduce"]
    for step, comm in enumerate(got["comm"]):
        names = sorted(c["name"] for c in comm["collectives"])
        if step < 2:
            # warmup: the dense mean, once per optimizer step
            assert names == sorted(f"grad_ar:{n}" for n in leaves)
            assert all(c["count_per_step"] == 1
                       for c in comm["collectives"])
        else:
            assert names == sorted(f"{p}:{n}" for p in ONEBIT_NAMES
                                   for n in leaves)


def test_onebit_lint_family_matches_the_jax_engine(world):
    """The ``onebit`` family of the JAX program lint's corpus
    (tests/unit/test_program_lint.py:390-392) in the world of 2: the same
    programs and contracts, the frozen step's wire u8 / s8, no finding."""
    got = port_ranks(world, 2)[0]["ob2"]
    want = jax_side(world, 2)["ob2"]["contracts"]
    assert got["lint"] == []
    assert set(got["contracts"]) == set(want) == {"onebit_fused:warmup",
                                                  "onebit_fused:frozen"}
    for name, c in got["contracts"].items():
        c = {k: list(v) if isinstance(v, tuple) else v for k, v in c.items()}
        assert c == {k: list(v) if isinstance(v, tuple) else v
                     for k, v in want[name].items()}, name
    assert sorted(got["contracts"]["onebit_fused:frozen"]["wire_dtype"]) \
        == ["s8", "u8"]


def test_refusals_over_the_world(world):
    got = port_ranks(world, 2)[0]["wire_refusals"]
    assert got["clipping"][0] == "ValueError"
    assert "gradient_clipping is incompatible" in got["clipping"][1]
    assert got["stage1"][0] == "NotImplementedError"
    assert "ROADMAP A13c" in got["stage1"][1]
    assert got["zeroone_csr"] == ("armed", None, ["emb"])


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------
def _tiny_engine(optimizer, params, fp16=False, clipping=0.0):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model

    cfg = W.ds_config(1, 0, 2, optimizer, opt_params=params,
                      clipping=clipping, fp16=fp16)
    dtype = torch.float16 if fp16 else torch.float32
    return deepspeed_tpu_torch.initialize(
        model=GPT2Model(GPT2Config(dtype=dtype, **W.TINY)),
        config_params=cfg, device="cpu")[0]


def test_disarmed_at_dp1_warmup_is_adam_and_frozen_is_the_local_twin(
        caplog):
    from deepspeed_tpu_torch.utils.logging import logger

    logger.propagate = True
    try:
        with caplog.at_level(logging.WARNING):
            eng = _tiny_engine("OneBitAdam", A.ONEBIT, clipping=1.0)
    finally:
        logger.propagate = False
    assert any("OneBitAdam: wire compression DISARMED" in r.message
               and "data-parallel degree is 1" in r.message
               for r in caplog.records)
    ref = _tiny_engine("AdamW", {"bias_correction": False}, clipping=1.0)
    batches = W.global_batches(A.SEED, 4, 2, W.MICRO)
    for step in range(4):
        batch = W._local(batches[step], 0, W.MICRO)
        if step < 2:
            assert eng.train_batch(batch=batch).item() == \
                ref.train_batch(batch=batch).item()
            for a, b in zip(eng.master, ref.master):
                assert torch.equal(a, b)
            continue
        opt = eng.optimizer
        v = [x.clone() for x in opt.v]
        m = [x.clone() for x in opt.m]
        we = [x.clone() for x in opt.worker_error]
        eng.train_batch(batch=batch)
        # the frozen momentum: b1 * m + (1 - b1) * g through the local
        # twin, leaf by leaf (the clip folded into g)
        assert all(torch.equal(a, b) for a, b in zip(opt.v, v))
        for j in range(len(opt.leaf_map.sizes)):
            lm = opt.leaf_map
            got = lm.gather(j, opt.m)
            assert not torch.equal(got, lm.gather(j, m))
            assert torch.unique(got.abs()).numel() == 1
            assert not torch.equal(opt.worker_error[j], we[j])
            # the server stage re-compresses a code of one magnitude: its
            # residual is the scale's rounding, a few ulps
            assert float(opt.server_error[j].abs().max()) <= \
                4 * np.spacing(np.float32(got.abs().max()))


def test_freeze_counts_optimizer_steps_not_engine_steps():
    eng = _tiny_engine("OneBitAdam", A.ONEBIT, fp16=True)
    batches = W.global_batches(A.SEED, 2, 2, W.MICRO)
    for step in range(2):
        eng.train_batch(batch=W._local(batches[step], 0, W.MICRO))
    skipped = eng.skipped_steps
    # one step skipped: two engine steps are one optimizer step
    eng._skipped += 1 - skipped
    assert eng._onebit_frozen() is False
    eng._skipped -= 1
    assert eng._onebit_frozen() is True
    # latched: the count is not read again
    eng._skipped += 5
    assert eng._onebit_frozen() is True


def test_tags_cross_the_packages_and_train_on(tmp_path):
    """1-bit Adam at dp 1 after its freeze (the local twin's residuals
    live): the JAX engine's tag of step 3 loads into the port and the
    port's into the JAX engine, each taking the step 4 the other would
    have taken (loss rtol 1e-5), in the JAX npz layout (OnebitAdamState:
    step, m, v, worker_error, server_error)."""
    import deepspeed_tpu
    import jax
    from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
    from deepspeed_tpu.models.gpt2 import GPT2Model as JGPT2Model
    from deepspeed_tpu.runtime.engine import _first_micro
    from deepspeed_tpu_torch.models.convert import params_from_jax

    cfg = dict(W.ds_config(1, 0, 2, "OneBitAdam", opt_params=A.ONEBIT,
                           clipping=0.0),
               mesh={"data": 1, "allow_partial": True})
    jeng = deepspeed_tpu.initialize(
        model=JGPT2Model(JGPT2Config(dtype=jnp.float32, **W.TINY)),
        config_params=cfg)[0]
    batches = W.global_batches(A.SEED, 4, 2, W.MICRO)
    jeng._ensure_state(_first_micro({"input_ids": batches[0],
                                     "labels": batches[0]}))
    init = jax.tree_util.tree_map(np.asarray,
                                  jax.device_get(jeng.state.params))
    port = _tiny_engine("OneBitAdam", A.ONEBIT)
    port.load_module_state_dict(params_from_jax(init, port.module.config))
    for b in batches[:3]:
        jeng.train_batch(batch={"input_ids": b, "labels": b})
        port.train_batch(batch=W._local(b, 0, W.MICRO))
    jeng.save_checkpoint(str(tmp_path / "jax"), backend="npz")
    port.save_checkpoint(str(tmp_path / "port"))
    b = batches[3]
    jloss = float(jeng.train_batch(batch={"input_ids": b, "labels": b}))
    ploss = port.train_batch(batch=W._local(b, 0, W.MICRO)).item()
    # the JAX tag into a new port engine, the port's into the JAX engine
    other = _tiny_engine("OneBitAdam", A.ONEBIT)
    other.load_checkpoint(str(tmp_path / "jax"))
    assert other.global_steps == 3 and other._onebit_frozen()
    np.testing.assert_allclose(
        other.train_batch(batch=W._local(b, 0, W.MICRO)).item(), jloss,
        rtol=1e-5)
    jeng.load_checkpoint(str(tmp_path / "port"))
    np.testing.assert_allclose(
        float(jeng.train_batch(batch={"input_ids": b, "labels": b})), ploss,
        rtol=1e-5)
