"""fp16 and bf16 mixed precision of the PyTorch port against the JAX
package: the dynamic loss scale, the fp16 and bf16 engine steps, and the
flash kernels' plain versions at fp16.

Tolerances, each with its reason:
- the loss scale: bit-exact (the same integer and power-of-two arithmetic);
- flash plain versions at fp16 against the Pallas kernels in interpret mode
  (same 128-key blocks): at most 1 % of the elements differ, by at most
  one fp16 ulp (2**-10) of the tensor's largest magnitude. Both sides
  round p and dS to fp16 from fp32 values summed in other orders; a value
  on the other side of a rounding boundary moves an output by one fp16
  ulp of p or dS times v (q, k). CPU runs read 0.01-0.23 % differing, by
  at most 2.0e-4. Rounding p to fp32 instead (no rounding) makes about
  40 % of the elements differ at bf16 (tests/test_torch_flash_attention.py),
  which the share catches;
- the fp16 and bf16 engines: see each test.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2Model as JGPT2Model
from deepspeed_tpu.ops.transformer import flash_attention as jfa
from deepspeed_tpu.runtime.fp16 import loss_scaler as jls
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from deepspeed_tpu_torch.ops.transformer import flash_attention as tfa
from deepspeed_tpu_torch.runtime.fp16 import loss_scaler as tls

# ---------------------------------------------------------------------------
# the loss scale
# ---------------------------------------------------------------------------
OVERFLOWS = [False, True, False, False, True, True, False, False, False,
             True, False, False, False, False, True, True, True, False,
             False, False]


@pytest.mark.parametrize("delayed_shift,consecutive", [
    (1, False), (2, False), (2, True)])
def test_update_loss_scale_matches_reference(delayed_shift, consecutive):
    """update_loss_scale over a scripted overflow sequence (scale window 3,
    min scale 2) equals the JAX package's, field by field, bit for bit;
    so does the host DynamicLossScaler."""
    hp = dict(scale_window=3, min_scale=2.0, delayed_shift=delayed_shift,
              consecutive_hysteresis=consecutive)
    mine = tls.make_loss_scale_state(2.0 ** 4, delayed_shift=delayed_shift)
    ref = jls.make_loss_scale_state(2.0 ** 4, delayed_shift=delayed_shift)
    host = tls.DynamicLossScaler(init_scale=2.0 ** 4, scale_window=3,
                                 min_scale=2.0, delayed_shift=delayed_shift,
                                 consecutive_hysteresis=consecutive)
    jhost = jls.DynamicLossScaler(init_scale=2.0 ** 4, scale_window=3,
                                  min_scale=2.0, delayed_shift=delayed_shift,
                                  consecutive_hysteresis=consecutive)
    scales = []
    for flag in OVERFLOWS:
        mine = tls.update_loss_scale(mine, torch.tensor(flag), **hp)
        ref = jls.update_loss_scale(ref, jnp.asarray(flag), **hp)
        for a, b in zip(mine, ref):
            assert a.item() == np.asarray(b).item()
            assert str(a.dtype).split(".")[-1] == str(np.asarray(b).dtype)
        host.update_scale(flag)
        jhost.update_scale(flag)
        assert host.cur_scale == jhost.cur_scale
        assert host.cur_hysteresis == jhost.cur_hysteresis
        scales.append(mine.loss_scale.item())
    # the sequence both halves and doubles the scale
    assert len(set(scales)) >= 3, scales
    static = tls.update_loss_scale(mine, torch.tensor(True), dynamic=False)
    assert static.loss_scale.item() == mine.loss_scale.item()
    assert tls.CreateLossScaler(128).loss_scale == 128
    assert tls.CreateLossScaler(0, {"init_scale": 2 ** 8}).loss_scale == 256


# ---------------------------------------------------------------------------
# flash plain versions at fp16
# ---------------------------------------------------------------------------
B, H, S, D = 2, 2, 256, 64
SEED = 20240611
FP16_CASES = {
    "causal": dict(causal=True),
    "key_bias": dict(causal=False, bias="key"),
    "dropout": dict(causal=True, dropout_rate=0.1),
}
FP16_MAX_DIFFERING = 0.01
FP16_MAX_REL_DIFF = 1e-3   # one fp16 ulp of the largest magnitude
LSE_ATOL = 1e-5     # the fp32 tests' output tolerance


@functools.lru_cache(maxsize=None)
def _fp16_kernels(case):
    """{kernel: [(port, pallas)]} of each kernel at fp16: the forward's out
    and lse, then each backward sweep fed the Pallas forward's residuals."""
    rng = np.random.default_rng(sorted(FP16_CASES).index(case))
    q, k, v, g = (rng.standard_normal((B * H, S, D)).astype(np.float16)
                  for _ in range(4))
    spec = FP16_CASES[case]
    bias = None
    if spec.get("bias") == "key":
        bias = (2.0 * rng.standard_normal((B, S))).astype(np.float32)
        bias[:, -9:] = -1e30
    rate = spec.get("dropout_rate", 0.0)
    common = dict(scale=D ** -0.5, causal=spec["causal"],
                  bias_kind=spec.get("bias", "none"), num_heads=H,
                  dropout_rate=rate)
    block = tfa._PLAIN_BLOCK
    jseed = jnp.asarray([SEED], jnp.int32) if rate else None
    jb = None if bias is None else jnp.asarray(bias)
    j_out, j_lse = jfa._flash_fwd(q, k, v, jb, jseed, **common,
                                  block_q=block, block_k=block,
                                  interpret=True)
    j_dq, j_dk, j_dv = jfa._flash_bwd((q, k, v, jb, jseed, j_out, j_lse), g,
                                      **common, block_q=block,
                                      block_k=block, interpret=True)
    tq, tk, tv, tg = (torch.tensor(x) for x in (q, k, v, g))
    tb = None if bias is None else torch.tensor(bias)
    seed = SEED if rate else None
    out, lse = tfa.flash_fwd(tq, tk, tv, tb, seed, **common)
    # the backward sweeps take the Pallas forward's residuals
    t_out, t_lse = torch.tensor(np.asarray(j_out)), \
        torch.tensor(np.asarray(j_lse))
    delta = (tg.float() * t_out.float()).sum(-1)
    dk, dv = tfa.flash_bwd_dkdv(tq, tk, tv, tg, t_lse, delta, tb, seed,
                                **common)
    dq = tfa.flash_bwd_dq(tq, tk, tv, tg, t_lse, delta, tb, seed, **common)

    def pair(a, b):
        return a.float().numpy(), np.asarray(b).astype(np.float32)

    return {"fwd": [pair(out, j_out)], "lse": [pair(lse, j_lse)],
            "dkdv": [pair(dk, j_dk), pair(dv, j_dv)],
            "dq": [pair(dq, j_dq)]}


@pytest.mark.parametrize("kernel", ["fwd", "dkdv", "dq"])
@pytest.mark.parametrize("case", sorted(FP16_CASES))
def test_plain_kernels_match_pallas_at_fp16(case, kernel):
    """Each kernel's plain version at fp16 against its Pallas kernel in
    interpret mode: p and dS rounded to fp16 on both sides."""
    results = _fp16_kernels(case)
    if kernel == "fwd":
        # lse is fp32 on both sides: summation order only
        (got, want), = results["lse"]
        np.testing.assert_allclose(got, want, rtol=0, atol=LSE_ATOL)
    for got, want in results[kernel]:
        diff = np.abs(got - want)
        differing = float((diff > 0).mean())
        rel = float(diff.max() / np.abs(want).max())
        assert differing <= FP16_MAX_DIFFERING, (differing, rel)
        assert rel <= FP16_MAX_REL_DIFF, (differing, rel)


# ---------------------------------------------------------------------------
# the engines at fp16 and bf16
# ---------------------------------------------------------------------------
TINY = dict(vocab_size=256, n_positions=128, n_embd=128, n_layer=2,
            n_head=2)
STEPS = 4


def _ds_config(precision):
    return {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
            "gradient_accumulation_steps": 2,
            "optimizer": {"type": "Adam",
                          "params": {"lr": 3e-3, "weight_decay": 0.01}},
            "gradient_clipping": 1.0, "steps_per_print": 10 ** 9,
            **precision}


def _run_reference(precision, dtype, batch):
    """Per step (loss, unscaled accumulated gradients by leaf name,
    overflow, loss scale, skipped) of the JAX engine's manual loop, and its
    initial fp32 master weights."""
    from deepspeed_tpu.runtime.engine import _first_micro

    cfg = dict(_ds_config(precision), mesh={"data": 1, "allow_partial": True})
    eng, _, _, _ = deepspeed_tpu.initialize(
        model=JGPT2Model(JGPT2Config(dtype=dtype, **TINY)),
        config_params=cfg)
    eng._ensure_state(_first_micro(batch))
    st = eng.state
    init = jax.device_get(st.master if st.master is not None else st.params)
    steps = []
    for _ in range(STEPS):
        losses = []
        for i in range(2):
            loss = eng({k: v[i] for k, v in batch.items()})
            eng.backward(loss)
            losses.append(float(loss))
        scale = eng.loss_scale() if eng.fp16_enabled() else 1.0
        grads = {k: np.asarray(v, np.float64) / scale
                 for k, v in _flat(jax.device_get(eng.state.accum)).items()}
        eng.step()
        steps.append((np.mean(losses), grads,
                      bool(eng._last_metrics["overflow"]), scale,
                      eng.skipped_steps))
    return init, steps


def _run_port(precision, dtype, batch, init):
    cfg = GPT2Config(dtype=dtype, **TINY)
    eng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=GPT2Model(cfg), config_params=_ds_config(precision),
        device="cpu")
    eng.load_module_state_dict(params_from_jax(init, cfg))
    names = _port_to_reference_names(cfg)
    steps = []
    for _ in range(STEPS):
        losses = []
        for i in range(2):
            loss = eng({k: v[i] for k, v in batch.items()})
            eng.backward(loss)
            losses.append(float(loss.detach()))
        scale = eng.loss_scale() if eng.fp16_enabled() else 1.0
        grads = {}
        for name, g in zip(eng.param_names, eng.accum):
            ref_name, transposed = names[name]
            g = g.double().numpy() / scale
            grads[ref_name] = g.T if transposed else g
        eng.step()
        steps.append((np.mean(losses), grads,
                      bool(eng._last_metrics["overflow"]), scale,
                      eng.skipped_steps))
    return steps


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _port_to_reference_names(cfg):
    """{port parameter name: (reference leaf path, transposed)}."""
    from deepspeed_tpu_torch.models.convert import gpt2_reference_tree

    out = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{path}{k}/")
            else:
                out[v[0]] = (f"{path}{k}", v[1])

    walk(gpt2_reference_tree(cfg), "")
    return out


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@functools.lru_cache(maxsize=None)
def _mixed_runs(kind):
    ids = np.random.default_rng(11).integers(0, TINY["vocab_size"],
                                             (2, 2, 128))
    batch = {"input_ids": ids, "labels": ids.copy()}
    if kind == "fp16":
        # 2**21 overflows fp16 gradients of this model, 2**20 does not: with
        # hysteresis 2 the first step skips at 2**21, the second skips and
        # halves, the rest update
        precision = {"fp16": {"enabled": True, "loss_scale": 0,
                              "initial_scale_power": 21, "hysteresis": 2}}
        jdt, tdt = jnp.float16, torch.float16
    else:
        precision = {"bf16": {"enabled": True}}
        jdt, tdt = jnp.bfloat16, torch.bfloat16
    init, ref = _run_reference(precision, jdt, batch)
    _, ref32 = _run_reference({}, jnp.float32, batch)
    port = _run_port(precision, tdt, batch, init)
    return ref, ref32, port


@pytest.mark.parametrize("kind", ["fp16", "bf16"])
def test_mixed_precision_engine_matches_reference(kind):
    """4 manual-loop steps (gas 2, Adam, clipping) of the port and the JAX
    engine from the same fp32 master at fp16 (dynamic scale, hysteresis 2,
    two forced overflows) or bf16: the same overflows, skipped steps and
    loss scales, and every step's mean loss and accumulated gradients as
    close to the JAX engine's as the JAX engine is to its own fp32 run
    after as many updates (skipped steps leave the parameters as they
    were). That spread, per step the median and the worst rel-L2 over the
    gradient leaves and over the run the largest loss difference, is the
    tolerance, times 1.5: two runs in one low precision differ by both
    runs' roundings (about sqrt(2) of one), the fp32 run by one. CPU
    readings at bf16: gradients 0.92-1.23x the spread."""
    ref, ref32, port = _mixed_runs(kind)
    loss_spread = 0.0
    for step, (jl, _, jov, _, jsk) in enumerate(ref):
        if not jov:
            loss_spread = max(loss_spread, abs(jl - ref32[step - jsk][0]))
    for step, ((jl, jg, jov, jsc, jsk), (tl, tg, tov, tsc, tsk)) in \
            enumerate(zip(ref, port)):
        assert (tov, tsc, tsk) == (jov, jsc, jsk), f"step {step + 1}"
        if jov:
            continue
        g32 = ref32[step - jsk][1]
        spread = sorted(_rel_l2(jg[k], g32[k]) for k in jg)
        mine = sorted(_rel_l2(tg[k], jg[k]) for k in jg)
        assert set(tg) == set(jg)
        assert np.median(mine) <= 1.5 * np.median(spread), (step, mine,
                                                             spread)
        assert mine[-1] <= 1.5 * spread[-1], (step, mine, spread)
        assert abs(tl - jl) <= 1.5 * loss_spread, (step, tl, jl,
                                                   loss_spread)
    if kind == "fp16":
        assert [s[2] for s in port] == [True, True, False, False]
        assert port[-1][3] == 2.0 ** 20 and port[-1][4] == 2


@pytest.mark.parametrize("way", ["load_module_state_dict",
                                 "module.load_state_dict"])
def test_a_bf16_step_starts_from_loaded_weights(way):
    """Weights loaded after initialize() are where the next bf16 step
    starts: through ``load_module_state_dict`` the fp32 master takes the
    state dict's fp32 values, through ``module.load_state_dict`` the bf16
    values the module holds. One step then equals, bit for bit, that of an
    engine whose master and parameters were set to those values by hand."""
    cfg = GPT2Config(dtype=torch.bfloat16, **TINY)
    ds = _ds_config({"bf16": {"enabled": True}})
    sd = GPT2Model(GPT2Config(dtype=torch.float32, **TINY),
                   generator=torch.Generator().manual_seed(7)).state_dict()
    ids = np.random.default_rng(5).integers(0, TINY["vocab_size"],
                                            (2, 2, 128))
    batch = {"input_ids": ids, "labels": ids.copy()}

    eng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=GPT2Model(cfg), config_params=ds, device="cpu")
    if way == "load_module_state_dict":
        eng.load_module_state_dict(sd)
        start = [sd[n] for n in eng.param_names]
    else:
        eng.module.load_state_dict(sd)
        start = [sd[n].to(torch.bfloat16).float() for n in eng.param_names]
    want, _, _, _ = deepspeed_tpu_torch.initialize(
        model=GPT2Model(cfg), config_params=ds, device="cpu")
    with torch.no_grad():
        for m, p, x in zip(want.master, want.params, start):
            m.copy_(x)
            p.copy_(x)
    want._mark_params()     # the hand-set master is the one to keep
    if way == "load_module_state_dict":
        assert all(torch.equal(a, b) for a, b in zip(eng.master, start))
    assert torch.equal(eng.train_batch(batch=batch),
                       want.train_batch(batch=batch))
    for a, b in zip(eng.master + eng.params, want.master + want.params):
        assert torch.equal(a, b)
