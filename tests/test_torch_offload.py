"""ZeRO-Offload of the PyTorch port (``"cpu_offload": true``) on the CPU,
held against the JAX package's offload engine and the port's own device
engine. Weights: the JAX offload engine's initial host master (seed 42),
carried into the port with models/convert.py; token ids from numpy seeds.

Tolerances, each with its reason:
- against the JAX offload engine (fp32, gas 2, clipping 1.0, WarmupLR, 4
  steps): losses and gradient norms at rtol 1e-4, the host master, m and v
  at rtol 1e-4, atol 1e-5, the parity tolerance of the other engine tests
  (tests/test_torch_engine.py): the same host Adam, bit for bit
  (tests/test_torch_cpu_adam.py), over gradients summed in other orders.
  The key third of each ``c_attn`` bias moves by the sign of rounding
  noise (its gradient is zero in exact arithmetic) and is held to
  2 * steps * lr, as in tests/test_torch_zero.py;
- against the port's device engine (FusedAdam on the device, another
  formula for the same update and an fp32 norm): rtol 2e-3, the tolerance
  of the JAX package's own test_engine_offload_e2e;
- fp16 (initial scale 2**21, hysteresis 2: two planted overflows): the
  overflows, skipped steps and loss scales equal the JAX offload
  engine's; losses at rtol 2e-3 (about two fp16 roundings, 2**-10 each);
- checkpoints: a port tag loads into the JAX offload engine and a JAX tag
  into the port with every host array equal bit for bit; a resumed port
  run equals the uninterrupted one bit for bit.
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
from deepspeed_tpu.runtime.engine import _first_micro
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from deepspeed_tpu_torch.ops.adam.cpu_adam import DeepSpeedCPUAdam
from deepspeed_tpu_torch.ops.lamb.fused_lamb import FusedLamb
from deepspeed_tpu_torch.runtime import memory_accounting

TINY = dict(vocab_size=256, n_positions=64, n_embd=64, n_layer=2, n_head=2)
# the fp16 model: 2**21 overflows its fp16 gradients, 2**20 does not
TINY16 = dict(vocab_size=256, n_positions=128, n_embd=128, n_layer=2,
              n_head=2)
STEPS, LR = 4, 3e-3
RTOL, ATOL = 1e-4, 1e-5
FP16 = {"fp16": {"enabled": True, "loss_scale": 0, "initial_scale_power": 21,
                 "hysteresis": 2}}


def _config(offload=True, gas=2, optimizer="Adam", extra=None, **zero):
    cfg = {"train_batch_size": 2 * gas, "train_micro_batch_size_per_gpu": 2,
           "gradient_accumulation_steps": gas,
           "optimizer": {"type": optimizer,
                         "params": {"lr": LR, "weight_decay": 0.01}},
           "scheduler": {"type": "WarmupLR",
                         "params": {"warmup_min_lr": 0.0,
                                    "warmup_max_lr": LR,
                                    "warmup_num_steps": 3}},
           "gradient_clipping": 1.0, "steps_per_print": 10 ** 9,
           "zero_optimization": dict({"stage": 2, "cpu_offload": offload},
                                     **zero)}
    cfg.update(extra or {})
    return cfg


def _batches(seed, steps=STEPS, gas=2, model=TINY):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        ids = rng.integers(0, model["vocab_size"],
                           (gas, 2, model["n_positions"]))
        out.append({"input_ids": ids, "labels": ids.copy()})
    return out


def _jax_engine(config, model=TINY, dtype=jnp.float32):
    eng = deepspeed_tpu.initialize(
        model=JGPT2Model(JGPT2Config(dtype=dtype, **model)),
        config_params=dict(config, mesh={"data": 1, "allow_partial": True}))[0]
    eng._ensure_state(_first_micro(_batches(0, 1, model=model)[0]))
    return eng


def _jax_init(eng):
    """The JAX offload engine's initial fp32 host master, as a tree."""
    return jax.tree_util.tree_unflatten(
        eng._host_treedef, [np.array(x) for x in eng._host_master_flat])


def _port(config, init, model=TINY, dtype=torch.float32):
    cfg = GPT2Config(dtype=dtype, **model)
    eng = deepspeed_tpu_torch.initialize(model=GPT2Model(cfg),
                                         config_params=config,
                                         device="cpu")[0]
    if init is not None:
        eng.load_module_state_dict(params_from_jax(init, cfg))
    return eng


def _host(eng):
    """The port's host master, m and v as the JAX tree's leaves."""
    return [[t.numpy() for t in eng._tree_leaves(lst)]
            for lst in (eng.master, eng._host_m, eng._host_v)]


def _jax_host(eng):
    return [[np.asarray(x) for x in lst] for lst in (
        eng._host_master_flat, eng._host_opt["m"], eng._host_opt["v"])]


def _assert_host_close(got, want, paths, what):
    """master, m and v leaf by leaf; the key third of each c_attn bias's
    master at 2 * steps * lr."""
    for kind, g_list, w_list in zip(("master", "m", "v"), got, want):
        for path, a, b in zip(paths, g_list, w_list):
            if kind == "master" and path.endswith("c_attn/bias"):
                e = a.shape[-1] // 3
                np.testing.assert_allclose(a[e:2 * e], b[e:2 * e], rtol=0,
                                           atol=2 * STEPS * LR)
                a, b = np.delete(a, range(e, 2 * e)), \
                    np.delete(b, range(e, 2 * e))
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what}: {kind} {path}")


@functools.lru_cache(maxsize=None)
def _jax_run(optimizer):
    eng = _jax_engine(_config(optimizer=optimizer))
    init = _jax_init(eng)
    losses, norms = [], []
    for b in _batches(1):
        losses.append(float(eng.train_batch(batch=b)))
        norms.append(float(eng.get_global_grad_norm()))
    return {"init": init, "losses": losses, "norms": norms,
            "host": _jax_host(eng), "step": eng._host_opt["step"],
            "report": eng.comm_volume_report()}


# ---------------------------------------------------------------------------
# parity
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("optimizer", ["Adam", "AdamW"])
def test_offload_matches_the_jax_offload_engine(optimizer):
    ref = _jax_run(optimizer)
    eng = _port(_config(optimizer=optimizer), ref["init"])
    assert eng._offload and isinstance(eng.optimizer, DeepSpeedCPUAdam)
    assert eng.optimizer.adamw_mode == (optimizer == "AdamW")
    losses, norms = [], []
    for b in _batches(1):
        losses.append(eng.train_batch(batch=b).item())
        norms.append(eng.get_global_grad_norm())
    np.testing.assert_allclose(losses, ref["losses"], rtol=RTOL)
    np.testing.assert_allclose(norms, ref["norms"], rtol=RTOL)
    assert eng._host_opt["step"] == ref["step"] == STEPS
    _assert_host_close(_host(eng), ref["host"],
                       eng.module.reference_leaf_paths(), optimizer)


def test_offload_trains_as_the_port_device_engine():
    """6 steps on one repeated batch: the host Adam's losses track the
    device FusedAdam's and both fall."""
    init = _jax_run("Adam")["init"]
    batch = _batches(2, 1)[0]
    runs = {}
    for offload in (True, False):
        eng = _port(_config(offload), init)
        assert eng._offload == offload
        runs[offload] = [eng.train_batch(batch=batch).item()
                         for _ in range(6)]
    assert runs[True][-1] < runs[True][0]
    np.testing.assert_allclose(runs[True], runs[False], rtol=2e-3)


def _fp16_batches():
    """tests/test_torch_fp16.py's batch, every step: at 2**21 its fp16
    gradients overflow from the JAX initial weights, at 2**20 not."""
    ids = np.random.default_rng(11).integers(0, TINY16["vocab_size"],
                                             (2, 2, 128))
    return [{"input_ids": ids, "labels": ids.copy()}] * STEPS


@functools.lru_cache(maxsize=None)
def _fp16_runs():
    jeng = _jax_engine(_config(extra=FP16), TINY16, jnp.float16)
    init = _jax_init(jeng)
    eng = _port(_config(extra=FP16), init, TINY16, torch.float16)
    out = {"init": init}
    for name, e in (("jax", jeng), ("port", eng)):
        seq = []
        for b in _fp16_batches():
            loss = float(e.train_batch(batch=b))
            seq.append((loss, bool(e._last_metrics["overflow"]),
                        e.loss_scale(), e.skipped_steps))
        out[name] = seq
    return out


def test_fp16_skips_and_scales_match_the_jax_offload_engine():
    runs = _fp16_runs()
    assert [s[1:] for s in runs["port"]] == [s[1:] for s in runs["jax"]]
    # the planted overflows: 2**21 skips, hysteresis 2 halves on the second
    assert [s[1] for s in runs["port"]] == [True, True, False, False]
    assert runs["port"][-1][2:] == (2.0 ** 20, 2)
    np.testing.assert_allclose([s[0] for s in runs["port"]],
                               [s[0] for s in runs["jax"]], rtol=2e-3)


@pytest.mark.parametrize("gas", [1, 4])
def test_gas_accumulation_matches_the_device_engine(gas):
    """Each micro step's gradients stream to the host and add up there (no
    device accumulator exists; gas 1 stages through one buffer, gas 4
    through two); the trajectory matches the device engine's, and the
    manual forward / backward / step loop is train_batch bit for bit."""
    init = _jax_run("Adam")["init"]
    batches = _batches(4, gas=gas)
    off = _port(_config(gas=gas), init)
    dev = _port(_config(False, gas=gas), init)
    loop = _port(_config(gas=gas), init)
    assert not hasattr(off, "_flat_accum") and hasattr(dev, "_flat_accum")
    assert len(off._staging) == min(gas, 2)
    got, want, manual = [], [], []
    for b in batches:
        got.append(off.train_batch(batch=b).item())
        want.append(dev.train_batch(batch=b).item())
        assert float(off._host_accum.abs().max()) == 0.0
        losses = []
        for i in range(gas):
            loss = loop({k: v[i] for k, v in b.items()})
            loop.backward(loss)
            loop.step()
            losses.append(loss.detach())
        manual.append(torch.stack(losses).mean().item())
    np.testing.assert_allclose(got, want, rtol=2e-3)
    assert manual == got
    for a, b in zip(off.master, loop.master):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def test_port_tag_loads_into_the_jax_offload_engine(tmp_path):
    init = _jax_run("Adam")["init"]
    batches = _batches(5, 3)
    eng = _port(_config(), init)
    for b in batches[:2]:
        eng.train_batch(batch=b)
    eng.save_checkpoint(str(tmp_path))
    jeng = _jax_engine(_config())
    jeng.load_checkpoint(str(tmp_path))
    assert jeng.global_steps == 2 and jeng._host_opt["step"] == 2
    for got, want in zip(_jax_host(jeng), _host(eng)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    params = jax.tree_util.tree_leaves(jax.device_get(jeng.state.params))
    for a, b in zip(params, eng._tree_leaves(eng.params)):
        np.testing.assert_array_equal(np.asarray(a), b.detach().numpy())
    np.testing.assert_allclose(float(jeng.train_batch(batch=batches[2])),
                               eng.train_batch(batch=batches[2]).item(),
                               rtol=RTOL)


def test_jax_tag_loads_into_the_port(tmp_path):
    jeng = _jax_engine(_config())
    batches = _batches(6, 3)
    for b in batches[:2]:
        jeng.train_batch(batch=b)
    jeng.save_checkpoint(str(tmp_path), backend="npz")
    eng = _port(_config(), None)
    path, _ = eng.load_checkpoint(str(tmp_path))
    assert path is not None and eng.global_steps == 2
    assert eng._host_opt["step"] == jeng._host_opt["step"] == 2
    for got, want in zip(_host(eng), _jax_host(jeng)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(eng.train_batch(batch=batches[2]).item(),
                               float(jeng.train_batch(batch=batches[2])),
                               rtol=RTOL)


@pytest.mark.parametrize("precision", ["fp32", "fp16"])
def test_resumed_run_is_bit_identical(tmp_path, precision):
    """4 steps straight against 2, a save, a new engine loading it and 2
    more: equal losses, master, moments and (fp16, two overflow skips
    before the save) loss scales and skipped steps, bit for bit."""
    if precision == "fp32":
        model, dtype, extra, init = TINY, torch.float32, None, None
        batches = _batches(7)
    else:
        model, dtype, extra = TINY16, torch.float16, FP16
        init, batches = _fp16_runs()["init"], _fp16_batches()

    def steps(eng, bs):
        return [(eng.train_batch(batch=b).item(), eng.loss_scale(),
                 eng.skipped_steps) for b in bs]

    straight = _port(_config(extra=extra), init, model, dtype)
    want = steps(straight, batches)
    first = _port(_config(extra=extra), init, model, dtype)
    got = steps(first, batches[:2])
    first.save_checkpoint(str(tmp_path))
    resumed = _port(_config(extra=extra), None, model, dtype)
    resumed.load_checkpoint(str(tmp_path))
    got += steps(resumed, batches[2:])
    assert got == want
    if precision == "fp16":
        assert want[1][2] == 2
    for a, b in zip(_host(resumed), _host(straight)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_offload_and_device_tags_do_not_mix(tmp_path):
    off, dev = _port(_config(), None), _port(_config(False), None)
    off.save_checkpoint(str(tmp_path / "off"))
    dev.save_checkpoint(str(tmp_path / "dev"))
    with pytest.raises(ValueError, match="with ZeRO-Offload"):
        _port(_config(False), None).load_checkpoint(str(tmp_path / "off"))
    with pytest.raises(ValueError, match="without ZeRO-Offload"):
        _port(_config(), None).load_checkpoint(str(tmp_path / "dev"))


# ---------------------------------------------------------------------------
# configurations, accounting
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("over,item,what", [
    # offload at ZeRO stage 3 and with qwZ run now (A13's ZeRO half):
    # the engine accepts them (item None)
    pytest.param({"zero_optimization": {"stage": 3, "cpu_offload": True}},
                 None, "ZeRO stage 3", id="over0-A13-ZeRO stage 3"),
    pytest.param({"zero_optimization": {"stage": 2, "cpu_offload": True,
                                        "quantized_weights": True}}, None,
                 "qwZ", id="over1-A13-qwZ"),
    # sparse_gradients under offload runs now (A13b); GPT-2 flags no
    # row-sparse parameter (its embedding is tied to the head)
    pytest.param({"sparse_gradients": True}, None, "sparse_gradients",
                 id="over2-A13-sparse_gradients"),
    ({"pipeline": {"stages": 2}}, "A12", "pipeline"),
])
def test_unported_offload_combinations_raise(over, item, what):
    if item is None:
        eng = _port(_config(extra=over), None)
        # a world of one: nothing sharded, so qwZ is disarmed, as the JAX
        # engine disarms it at dp 1
        assert eng._offload and not eng._qwz_armed and not eng._csr_idx
        return
    with pytest.raises(NotImplementedError) as err:
        _port(_config(extra=over), None)
    assert f"ROADMAP {item}" in str(err.value) and what in str(err.value)
    assert "Offload" in str(err.value)


def test_lamb_with_cpu_offload_keeps_its_device_step():
    """As in the JAX engine: only Adam and AdamW step on the host."""
    eng = _port(_config(optimizer="Lamb"), None)
    assert not eng._offload and isinstance(eng.optimizer, FusedLamb)
    jeng = _jax_engine(_config(optimizer="Lamb"))
    assert not jeng._offload
    b = _batches(8, 2)
    losses = [eng.train_batch(batch=x).item() for x in b]
    assert np.isfinite(losses).all()


def test_memory_and_comm_accounting():
    """The device holds no master, accumulator or optimizer state; the
    host holds 4 + 8 + 4 bytes per parameter (master, m and v, the
    accumulator); the comm report is the JAX offload engine's."""
    eng = _port(_config(), None)
    n = sum(p.numel() for p in eng.params)
    mem = eng._analytic_memory_components()
    c = mem["components"]
    assert c["params_bytes"] == 4 * n
    assert c["master_bytes"] == c["grad_accum_bytes"] == \
        c["optimizer_state_bytes"] == 0
    assert c["offload_staging_bytes"] == 4 * n     # the flat buffer
    assert mem["transient"]["grad_tree_bytes"] == 4 * n
    assert mem["host"] == {"master_bytes": 4 * n,
                           "optimizer_state_bytes": 8 * n,
                           "grad_accum_bytes": 4 * n,
                           "pinned_staging_bytes": 8 * n}
    assert mem["host_bytes"] == 24 * n
    # the analytic formula phase 18 of chip_smoke.py prices stage 0 with
    analytic = memory_accounting.train_state_bytes(n, torch.float32,
                                                   cpu_offload=True)
    assert analytic["host"] == {k: mem["host"][k] for k in analytic["host"]}
    assert analytic["persistent_bytes"] == c["params_bytes"]
    dev = _port(_config(False, extra={"bf16": {"enabled": True}}), None,
                dtype=torch.bfloat16)
    stage0 = memory_accounting.train_state_bytes(n, torch.bfloat16)
    got = dev._analytic_memory_components()["components"]
    got["optimizer_state_bytes"] -= 4           # Adam's step counter
    assert stage0["components"] == {k: got[k] for k in stage0["components"]}
    assert stage0["persistent_bytes"] == 18 * n
    got, want = eng.comm_volume_report(), _jax_run("Adam")["report"]
    for key in ("grad_exchange_bytes_per_step", "param_gather_bytes_per_step",
                "total_bytes_per_step"):
        assert got[key] == want[key], key
    assert sorted(c["name"] for c in got["collectives"]) == \
        sorted(c["name"] for c in want["collectives"])
