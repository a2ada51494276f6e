"""Pipeline parallelism of the PyTorch port (runtime/pipe/), held against
the JAX package's PipelineEngine on its virtual CPU devices.

Each configuration trains tiny GPT-2 pipelines (4 blocks; 5 for the
interleaved schedule, whose 8 layers split into pipe 2 x 2 virtual
stages) for 3 steps of gas 4 through both engines from the JAX engine's
initial parameters, carried over by models/convert.py, the port's
in-process (the single-controller layout, as the JAX engine runs).
Gates: every loss within 2e-5 relative (bf16: 5e-5, LOSS_RTOL says why),
every final master leaf within 1e-4 relative L2 (bf16 and fp16: 2e-2:
both engines round the compute-dtype products in another order), and a
leaf that misses it held elementwise, with a counted share of sign
flips in bf16 and fp16 (MASTER_ATOL, FLIP_SHARE). The processes-per-stage layout, ZeRO inside a stage's
data line and the JAX engine at pipe 2 x data 2 run in the gloo worlds of
tests/test_torch_zero.py.
"""
import functools
import logging
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2_pipe import gpt2_pipeline_module as jpipe
from deepspeed_tpu_torch.models.convert import (pipe_params_from_gpt2,
                                                pipe_params_from_jax,
                                                pipe_params_to_jax)
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from deepspeed_tpu_torch.models.gpt2_pipe import gpt2_pipeline_module

TINY = dict(vocab_size=128, n_positions=32, n_embd=32, n_layer=4, n_head=2)
SEQ = 16
MICRO = 2
GAS = 4
STEPS = 3
LR = 1e-3
# bf16: the JAX package's tanh-GeLU is eight bf16 operations with bf16
# constants (0.796875 for sqrt(2/pi)) that XLA may fuse at excess
# precision, the port's one fp32 evaluation rounded once: at the same
# weights the two engines' bf16 losses read up to 1.0e-5 apart, and
# 2.2e-5 from step 2 on, once near-zero gradients have rounded apart
# (ROADMAP C-w18)
LOSS_RTOL = {"fp32": 2e-5, "bf16": 5e-5, "fp16": 2e-5}
MASTER_RTOL = {"fp32": 1e-4, "bf16": 2e-2, "fp16": 2e-2}
# a leaf that misses the relative gate is held elementwise: every element
# within MASTER_ATOL but at most FLIP_SHARE of the leaf's elements, and
# those within 2 * steps * lr. At fp32, MASTER_ATOL is the MoE engine's
# atol (tests/test_torch_moe.py: Adam moves an element whose gradient is
# near zero by lr times the ratio of two tiny moments; measured an MoE
# b_out at 3.7e-4 relative L2, 8.9e-6 elementwise) and no element may
# flip. In bf16 and fp16 the gradients' own rounding flips the sign of a
# near-zero element's update, which moves it by up to 2 * lr a step:
# measured in bf16 at most 2 such elements of 128 in a leaf (1 of 32 in
# an ln_2 bias), none in fp16, and every other element within 0.1 * lr.
# A dropped gradient leaves nearly every element of its leaf beyond
# 0.1 * lr, since Adam moves an element by about lr a step.
MASTER_ATOL = {"fp32": 1e-5, "bf16": 0.1 * LR, "fp16": 0.1 * LR}
FLIP_SHARE = {"fp32": 0.0, "bf16": 1 / 16, "fp16": 1 / 16}

# name -> (model overrides, pipe, schedule, virtual stages, untied head,
#          precision, config extras)
CASES = {
    "1f1b_tied": ({}, 2, "1f1b", 1, False, "fp32", {}),
    "interleaved": ({"n_layer": 5}, 2, "interleaved", 2, False, "fp32", {}),
    "zb_stash": ({}, 2, "zb-h1", 1, True, "fp32", {}),
    "zb_remat": ({}, 2, "zb-h1", 1, True, "fp32",
                 {"activation_stashing": False}),
    "bf16": ({}, 2, "1f1b", 1, False, "bf16", {}),
    "fp16": ({}, 2, "1f1b", 1, False, "fp16", {}),
    "moe": ({"moe_num_experts": 4}, 2, "1f1b", 1, False, "fp32", {}),
}


def ds_config(pipe, schedule="1f1b", v=1, precision="fp32", dp=1,
              pipeline=None, gas=GAS, jax_mesh=False, clipping=1.0,
              **extra):
    cfg = {"train_batch_size": MICRO * gas * dp,
           "train_micro_batch_size_per_gpu": MICRO,
           "gradient_accumulation_steps": gas,
           "optimizer": {"type": "Adam",
                         "params": {"lr": LR, "weight_decay": 0.01}},
           "gradient_clipping": clipping,
           "steps_per_print": 10 ** 9,
           "mesh": {"pipe": pipe, "data": dp},
           "pipeline": dict({"schedule": schedule, "virtual_stages": v},
                            **(pipeline or {}))}
    if jax_mesh:
        cfg["mesh"]["allow_partial"] = True
    if precision == "bf16":
        cfg["bf16"] = {"enabled": True}
    if precision == "fp16":
        cfg["fp16"] = {"enabled": True, "loss_scale": 0,
                       "initial_scale_power": 16, "hysteresis": 1}
    cfg.update(extra)
    return cfg


def batches(seed=0, steps=STEPS, gas=GAS, rows=MICRO, vocab=128):
    ids = np.random.default_rng(seed).integers(0, vocab,
                                               (steps, gas, rows, SEQ))
    return [{"input_ids": b, "labels": b} for b in ids]


def _dtypes(precision):
    return {"fp32": (jnp.float32, torch.float32),
            "bf16": (jnp.bfloat16, torch.bfloat16),
            "fp16": (jnp.float16, torch.float16)}[precision]


def jax_engine(model=None, pipe=2, schedule="1f1b", v=1, untied=False,
               precision="fp32", pipeline=None, dp=1, **extra):
    jdt, _ = _dtypes(precision)
    mod = jpipe(JGPT2Config(dtype=jdt, **dict(TINY, **(model or {}))),
                untied_head=untied)
    cfg = ds_config(pipe, schedule, v, precision, dp, pipeline,
                    jax_mesh=True, **extra)
    return deepspeed_tpu.initialize(model=mod, config_params=cfg)[0]


def jax_init_tree(jeng, batch):
    """The JAX engine's initial parameters (fp32 numpy), the whole tree."""
    jeng._ensure_pipe_state({k: v[0] for k, v in batch.items()})
    tree = {}
    for st in jeng.stage_states:
        src = st.master if st.master is not None else st.params
        for key, sub in jax.device_get(src).items():
            tree.setdefault(key, jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float32), sub))
    return tree


def jax_chunk_masters(jeng):
    """[{layer key: fp32 numpy tree}] of each chunk's final master."""
    out = []
    for st in jeng.stage_states:
        src = st.master if st.master is not None else st.params
        out.append(jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), jax.device_get(src)))
    return out


def port_engine(model=None, pipe=2, schedule="1f1b", v=1, untied=False,
                precision="fp32", pipeline=None, dp=1, init=None,
                module=None, **extra):
    _, tdt = _dtypes(precision)
    mod = module or gpt2_pipeline_module(
        GPT2Config(dtype=tdt, **dict(TINY, **(model or {}))),
        untied_head=untied)
    eng = deepspeed_tpu_torch.initialize(
        model=mod, config_params=ds_config(pipe, schedule, v, precision, dp,
                                           pipeline, **extra),
        device="cpu")[0]
    if init is not None:
        eng.load_module_state_dict(init)
    return eng


def port_chunk_masters(eng):
    """[{layer key: fp32 numpy tree}] of each chunk's master, in the JAX
    chunk's layout."""
    out = []
    for q in range(eng.num_chunks):
        master = eng.chunk_master(q)
        keys = eng.module_pipe.stage_param_keys(q, eng.num_chunks)
        tree = {}
        for key in keys:
            ref = {key: eng.module_pipe.layer_reference_tree(key, f"{key}.")}
            names = {n: master[n] for n in master if n.startswith(key + ".")}
            tree.update(_to_jax(ref, names))
        out.append(tree)
    return out


def _to_jax(ref, state):
    out = {}
    for k, node in ref.items():
        if isinstance(node, dict):
            out[k] = _to_jax(node, state)
        else:
            name, transposed = node
            t = state[name].float()
            out[k] = (t.t() if transposed else t).contiguous().numpy()
    return out


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def assert_masters_close(got, want, precision=None, steps=STEPS):
    """Every leaf equal bit for bit (``precision`` None), or within
    MASTER_RTOL[precision] relative L2 and, if it misses that, held
    elementwise as MASTER_ATOL and FLIP_SHARE say; but the key third of
    each fused QKV bias: its gradient is zero in exact arithmetic (softmax
    ignores a shift common to all keys), so both engines move it by the
    sign of rounding noise, up to lr per Adam step: it is held to 2 *
    steps * lr (tests/torch_zero_worker.py ``assert_master_close``)."""
    flip = 2 * steps * LR
    for q, (g, w) in enumerate(zip(got, want)):
        gl = jax.tree_util.tree_flatten_with_path(g)[0]
        wl = jax.tree_util.tree_flatten_with_path(w)[0]
        assert [p for p, _ in gl] == [p for p, _ in wl]
        for (path, a), (_, b) in zip(gl, wl):
            name = jax.tree_util.keystr(path)
            if precision is None:
                np.testing.assert_array_equal(a, b, err_msg=name)
                continue
            if name.endswith("['c_attn']['bias']"):
                e = a.shape[0] // 3
                np.testing.assert_allclose(a[e:2 * e], b[e:2 * e], rtol=0,
                                           atol=flip, err_msg=name)
                a = np.delete(a, range(e, 2 * e))
                b = np.delete(b, range(e, 2 * e))
            err = rel_l2(a, b)
            if err <= MASTER_RTOL[precision]:
                continue
            d = np.abs(np.asarray(a, np.float64) - b)
            beyond = int((d > MASTER_ATOL[precision]).sum())
            assert beyond <= FLIP_SHARE[precision] * d.size \
                and d.max() <= flip, (q, name, err, beyond, d.size,
                                      float(d.max()))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread per process: the suite's workers share the host's
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _check_converter(init, untied):
    """The converter round-trips the JAX pipeline parameters bit for bit,
    and the port's forward_full equals the JAX module's logits within
    1e-5."""
    mod = gpt2_pipeline_module(GPT2Config(dtype=torch.float32, **TINY),
                               untied_head=untied)
    sd = pipe_params_from_jax(init, mod)
    got = jax.tree_util.tree_flatten_with_path(pipe_params_to_jax(sd, mod))[0]
    want = jax.tree_util.tree_flatten_with_path(init)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    mod.load_state_dict(sd)
    micro = {k: v[0] for k, v in batches()[0].items()}
    jmod = jpipe(JGPT2Config(dtype=jnp.float32, **TINY), untied_head=untied)
    jmod.init(jax.random.PRNGKey(0), micro)
    want_logits = np.asarray(jmod.forward_full(
        init, micro, jax.random.PRNGKey(0), train=False))
    with torch.no_grad():
        got_logits = mod.forward_full(
            {"input_ids": torch.as_tensor(micro["input_ids"])})
    np.testing.assert_allclose(got_logits.numpy(), want_logits, rtol=1e-5,
                               atol=1e-5)


def _check_reports(peng, jeng):
    """pipeline_report() and the analytic per-stage memory components equal
    the JAX engine's."""
    got, want = peng.pipeline_report(), jeng.pipeline_report()
    for key in ("idle_fraction", "bubble_fraction", "peak_live_buffers",
                "peak_live_stash", "makespan", "schedule_blockers",
                "requested_schedule"):
        assert got[key] == want[key], key
    assert got["p2p"] == want["p2p"]
    assert got["stash"]["armed"] == want["stash"]["armed"]
    gm = peng._analytic_memory_components()
    jm = jeng._analytic_memory_components()
    assert gm["worst_stage"] == jm["worst_stage"]
    for s, (a, b) in enumerate(zip(gm["per_stage"], jm["per_stage"])):
        assert a["components"] == b["components"], s
    for key in ("pipe_p2p_bytes_per_step", "pipe_schedule"):
        assert peng._last_metrics[key] == jeng._last_metrics[key], key


def _check_checkpoints(peng, jeng, tmp_path):
    """A port tag loads in the JAX engine and a JAX tag in the port, and
    both go on alike; a tag written at pipe 2 loads at pipe 4 (restage)
    and trains."""
    data = batches()
    ptag, jtag = str(tmp_path / "port"), str(tmp_path / "jax")
    peng.save_checkpoint(ptag, tag="p")
    jeng.save_checkpoint(jtag, tag="j")
    j2 = jax_engine()
    j2._ensure_pipe_state({k: v[0] for k, v in data[0].items()})
    j2.load_checkpoint(ptag, tag="p")
    assert j2.global_steps == peng.global_steps
    assert_masters_close(jax_chunk_masters(j2), port_chunk_masters(peng))
    p2 = port_engine()
    p2.load_checkpoint(jtag, tag="j")
    assert p2.global_steps == jeng.global_steps
    assert_masters_close(port_chunk_masters(p2), jax_chunk_masters(jeng))
    nxt = batches(seed=5, steps=1)[0]
    assert np.isclose(p2.train_batch(batch=nxt), j2.train_batch(batch=nxt),
                      rtol=1e-4)
    p4 = port_engine(pipe=4)
    p4.load_checkpoint(ptag, tag="p")
    full, want = {}, {}
    for q in range(4):
        full.update(p4.chunk_master(q))
    for q in range(2):
        want.update(peng.chunk_master(q))
    assert set(full) == set(want)
    for n in want:
        assert torch.equal(full[n], want[n]), n
    assert np.isfinite(p4.train_batch(batch=data[0]))


@pytest.mark.parametrize("name", sorted(CASES))
def test_pipeline_trains_as_the_jax_engine(name, tmp_path):
    """CASES[name] through both engines from the JAX engine's initial
    parameters: losses and final masters within the gates. Per case too:
    the converter's round trip and forward (the tied and the untied
    head), pipeline_report() and the memory components (1f1b, ZB-H1 with
    the stash, interleaved), the tied copies equal bit for bit and the
    checkpoints crossing between the engines (1f1b), the overflow
    decisions (fp16) and the bf16 boundary."""
    model, pipe, sched, v, untied, prec, pipeline = CASES[name]
    kw = dict(model=model, pipe=pipe, schedule=sched, v=v, untied=untied,
              precision=prec, pipeline=pipeline)
    data = batches()
    jeng = jax_engine(**kw)
    init = jax_init_tree(jeng, data[0])
    if name in ("1f1b_tied", "zb_stash"):
        _check_converter(init, untied)
    jl = [float(jeng.train_batch(batch=b)) for b in data]
    mod = gpt2_pipeline_module(GPT2Config(dtype=_dtypes(prec)[1],
                                          **dict(TINY, **model)),
                               untied_head=untied)
    peng = port_engine(**kw, module=mod, init=pipe_params_from_jax(init, mod))
    pl = [peng.train_batch(batch=b) for b in data]
    assert peng.pipe_schedule == jeng.pipe_schedule
    assert peng._stash_armed == jeng._stash_armed
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL[prec])
    assert_masters_close(port_chunk_masters(peng), jax_chunk_masters(jeng),
                         prec)
    if name in ("1f1b_tied", "zb_stash", "interleaved"):
        _check_reports(peng, jeng)
    if prec == "fp16":
        assert peng.skipped_steps == jeng.skipped_steps == 0
        assert peng.loss_scale() == jeng.loss_scale() == 2.0 ** 16
    if prec == "bf16":
        # the boundary crosses in the compute dtype: half the fp32 bytes
        assert peng._boundary[0][1] == torch.bfloat16
        act = peng.link.edge_bytes[0]["act"]
        assert act == MICRO * SEQ * TINY["n_embd"] * 2
        assert act == jeng._p2p_edge_bytes[0]["act"]
    if name == "1f1b_tied":
        first, last = peng.chunk_master(0), peng.chunk_master(1)
        for n in ("tied_embed.wte", "tied_embed.wpe"):
            assert torch.equal(first[n], last[n])
        _check_checkpoints(peng, jeng, tmp_path)


def test_fp16_overflow_skips_and_halves_as_the_jax_engine():
    """At a dynamic scale of 2^30 every step's fp16 gradients overflow:
    both engines skip all three steps, halve the scale each time, and keep
    their initial weights."""
    fp16 = {"enabled": True, "loss_scale": 0, "initial_scale_power": 30,
            "hysteresis": 1}
    data = batches()
    jeng = jax_engine(precision="fp16", fp16=fp16)
    init = jax_init_tree(jeng, data[0])
    mod = gpt2_pipeline_module(GPT2Config(dtype=torch.float16, **TINY))
    peng = port_engine(precision="fp16", fp16=fp16, module=mod,
                       init=pipe_params_from_jax(init, mod))
    start = port_chunk_masters(peng)
    for b in data:
        jl, pl = jeng.train_batch(batch=b), peng.train_batch(batch=b)
        assert np.isclose(pl, jl, rtol=LOSS_RTOL["fp16"])
        assert peng.loss_scale() == jeng.loss_scale()
    assert peng.skipped_steps == jeng.skipped_steps == STEPS
    assert peng.loss_scale() == 2.0 ** (30 - STEPS)
    assert_masters_close(port_chunk_masters(peng), start)


@pytest.mark.parametrize("schedule,v,untied,model", [
    ("1f1b", 1, False, {}), ("interleaved", 2, False, {"n_layer": 5}),
    ("zb-h1", 1, True, {})])
def test_traced_instructions_replay_the_analytic_bubble(schedule, v, untied,
                                                        model):
    """With the trace armed, one span per executed instruction on lane
    stage<s>: the replay through the simulator (measured_bubble_report)
    equals the compiled plan's idle fractions, and telemetry_report()
    carries both."""
    eng = port_engine(schedule=schedule, v=v, untied=untied, model=model,
                      telemetry={"enabled": True, "trace": True,
                                 "mfu": False, "memory": False})
    for b in batches(steps=2):
        eng.train_batch(batch=b)
    rep = eng.measured_bubble_report()
    assert rep["max_abs_idle_error"] == 0.0
    assert rep["measured"]["replayed_instructions"] == sum(
        len(st) for st in eng._ensure_compiled_schedule().streams)
    assert eng.telemetry_report()["pipeline"]["measured"][
        "max_abs_idle_error"] == 0.0


def _gpt2_state(seed=0, **over):
    return GPT2Model(GPT2Config(dtype=torch.float32,
                                **dict(TINY, **over)),
                     torch.Generator().manual_seed(seed)).state_dict()


@pytest.mark.parametrize("pipe,schedule,v", [(1, "1f1b", 1), (4, "1f1b", 1),
                                             (2, "interleaved", 2)])
def test_pipe_depth_matches_pipe_2_and_the_gpt2_engine(pipe, schedule, v):
    """The JAX test_pipe_4stage_matches_1stage: the pipeline's depth does
    not change the math; and the port's own GPT2Model engine (full-logits
    loss) takes the same steps. No clipping: the norm counts each tied
    copy, so a clipped step depends on how many chunks hold one."""
    over = {"n_layer": 5}
    state = _gpt2_state(**over)

    def pipeline(p, s, vv):
        mod = gpt2_pipeline_module(GPT2Config(dtype=torch.float32,
                                              **dict(TINY, **over)))
        eng = port_engine(pipe=p, schedule=s, v=vv, module=mod,
                          init=pipe_params_from_gpt2(state, mod), clipping=0)
        return [eng.train_batch(batch=b) for b in batches()]

    ref = pipeline(2, "1f1b", 1)
    np.testing.assert_allclose(pipeline(pipe, schedule, v), ref, rtol=2e-5)
    if pipe == 1:
        cfg = ds_config(1, clipping=0)
        cfg.pop("mesh"), cfg.pop("pipeline")
        base = deepspeed_tpu_torch.initialize(
            model=GPT2Model(GPT2Config(dtype=torch.float32,
                                       loss_chunk_tokens=0,
                                       **dict(TINY, **over))),
            config_params=cfg, device="cpu")[0]
        base.load_module_state_dict(state)
        np.testing.assert_allclose(
            [float(base.train_batch(batch=b)) for b in batches()], ref,
            rtol=2e-5)


def _grads(eng, batch):
    """The accumulated gradients of one batch's schedule (fp32 copies)."""
    micros = [eng._to_device(m) for m in eng._collect_micros(None, batch)]
    eng._resolve_shapes(micros[0])
    eng._exec_train_schedule(micros)
    return [a.clone() for a in eng.accum]


def test_dropout_replay_redraws_the_forward_masks():
    """At dropout 0.1: 1f1b re-runs each chunk's forward in its backward,
    ZB-H1 with the stash runs it once; the same gradients prove the re-run
    drew the same masks."""
    state = _gpt2_state()
    mod = gpt2_pipeline_module(GPT2Config(dtype=torch.float32, dropout=0.1,
                                          **TINY), untied_head=True)
    init = pipe_params_from_gpt2(state, mod)
    remat = port_engine(untied=True, init=init,
                        model={"dropout": 0.1})
    stash = port_engine(schedule="zb-h1", untied=True, init=init,
                        model={"dropout": 0.1})
    plain = port_engine(untied=True, init=init)
    b = batches()[0]
    g1, g2, g0 = _grads(remat, b), _grads(stash, b), _grads(plain, b)
    assert stash._stash_armed and remat.pipe_schedule == "1f1b"
    for a, c in zip(g1, g2):
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-7)
    assert any(not torch.allclose(a, c) for a, c in zip(g1, g0))


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _warnings(fn):
    """(fn(), the text of the port logger's warnings while it ran)."""
    from deepspeed_tpu_torch.utils.logging import logger

    rec = _Records()
    logger.addHandler(rec)
    try:
        out = fn()
    finally:
        logger.removeHandler(rec)
    return out, " ".join(rec.messages)


@pytest.mark.parametrize("kw,what", [
    (dict(schedule="interleaved", v=2, model={"n_layer": 5}, gas=3),
     "not divisible by pipe=2"),
    (dict(schedule="zb-h1"), "tied layers present"),
    (dict(schedule="interleaved", v=2), "layer count 7 is not divisible"),
])
def test_schedule_fallbacks_warn_with_the_jax_blockers(kw, what):
    gas = kw.pop("gas", GAS)
    eng, text = _warnings(lambda: port_engine(**kw, gas=gas))
    jeng = jax_engine(**kw, gas=gas)
    assert eng.pipe_schedule == "1f1b" == jeng.pipe_schedule
    assert eng._schedule_blockers == jeng._schedule_blockers
    assert what in text and "DISARMED" in text


@pytest.mark.parametrize("extra,what", [
    ({"zero_optimization": {"stage": 3}}, "ZeRO stage-3 scheduled gathers"),
    ({"progressive_layer_drop": {"enabled": True}},
     "progressive_layer_drop DISARMED"),
])
def test_zero3_and_pld_disarm_with_warnings(extra, what):
    eng, text = _warnings(lambda: port_engine(**extra))
    assert what in text
    assert eng.zero_optimization_stage() <= 2
    assert eng.progressive_layer_drop is None
    loss = eng.train_batch(batch=batches()[0])
    assert np.isfinite(loss)


def test_stash_budget_disarms_the_stash():
    eng = port_engine(schedule="zb-h1", untied=True,
                      pipeline={"stash_budget": 1})
    _, text = _warnings(lambda: eng.train_batch(batch=batches()[0]))
    assert not eng._stash_armed
    assert "stash_budget=1" in text and "activation_stashing DISARMED" in text
    assert eng.pipeline_report()["stash"]["blockers"]


def test_forward_backward_step_raise_and_eval_batch():
    eng = port_engine()
    for call in (lambda: eng.forward({}), lambda: eng.backward(None),
                 eng.step):
        with pytest.raises(RuntimeError, match="train_batch"):
            call()
    b = batches()[0]
    loss = eng.eval_batch(batch=b)
    ref = port_engine(pipe=1)
    assert np.isclose(loss, ref.eval_batch(batch=b), rtol=1e-6)


class _Work:
    def __init__(self):
        self.done = False

    def is_completed(self):
        return self.done

    def wait(self):
        self.done = True


def test_dist_link_releases_each_send_once_it_completes(monkeypatch):
    """One process per stage: a send's tensor is held only while its work
    is in flight. Each Send and Recv drops the sends that completed, the
    end of the batch waits for the rest; peak_held_bytes is the most held
    at once."""
    from deepspeed_tpu_torch.runtime.pipe import p2p

    works = []

    def isend(tensor, dst, group):
        works.append(_Work())
        return works[-1]

    def irecv(buf, src, group):
        return _Work()

    monkeypatch.setattr(p2p.dist, "isend", isend)
    monkeypatch.setattr(p2p.dist, "irecv", irecv)
    groups = {(0, "act"): None, (0, "grad"): None}
    link = p2p.DistLink(groups, lambda chunk: chunk, torch.device("cpu"))
    act = torch.zeros(4, 8)
    nbytes = act.numel() * act.element_size()
    link.begin_batch()
    link.send(act, 0, 1, "act")
    link.send(act.clone(), 0, 1, "act")
    assert len(link._sends) == 2 and link.held_bytes == 2 * nbytes
    works[0].done = True
    link.recv(0, "grad", act.shape, act.dtype)
    assert [w for w, _ in link._sends] == [works[1]]
    assert link.held_bytes == nbytes
    works[1].done = True
    link.send(act, 0, 1, "act")
    assert [w for w, _ in link._sends] == [works[2]]
    assert link.peak_held_bytes == 2 * nbytes
    link.finish_batch()
    assert works[2].done and link._sends == [] and link.held_bytes == 0
    assert link.step_bytes == 3 * nbytes


# ---------------------------------------------------------------------------
# checkpoints: the layer-granular npz-layer layout
# ---------------------------------------------------------------------------
def test_checkpoint_resumes_bit_for_bit(tmp_path):
    state = _gpt2_state()
    data = batches(steps=4)

    def fresh():
        mod = gpt2_pipeline_module(GPT2Config(dtype=torch.float32, **TINY))
        return port_engine(module=mod, init=pipe_params_from_gpt2(state, mod))

    eng = fresh()
    whole = [eng.train_batch(batch=b) for b in data]
    eng = fresh()
    first = [eng.train_batch(batch=b) for b in data[:2]]
    eng.save_checkpoint(str(tmp_path), tag="t2")
    eng = fresh()
    eng.load_checkpoint(str(tmp_path), tag="t2")
    assert eng.global_steps == 2
    rest = [eng.train_batch(batch=b) for b in data[2:]]
    assert first + rest == whole


# ---------------------------------------------------------------------------
# refusals: A12b, A7b, A16
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("extra,item", [
    ({"zero_optimization": {"stage": 2, "cpu_offload": True}}, "A12b"),
    ({"optimizer": {"type": "OneBitAdam", "params": {"lr": 1e-3}}}, "A12b"),
    ({"optimizer": {"type": "ZeroOneAdam", "params": {"lr": 1e-3}}},
     "A12b"),
    # tensor parallelism (A7b) runs beside data alone; beside pipe: A7c
    pytest.param({"mesh": {"pipe": 2, "model": 2}}, "A7c", id="extra3-A7b"),
])
def test_unported_pipeline_configurations_raise(extra, item):
    with pytest.raises(NotImplementedError, match=item):
        port_engine(**extra)


def test_seq_beside_pipe_and_moe_at_dp_2_name_a12b():
    from deepspeed_tpu_torch.parallel.mesh import resolve_grid
    from deepspeed_tpu_torch.runtime.pipe.engine import PipelineEngine

    with pytest.raises(NotImplementedError, match="A12b"):
        resolve_grid({"pipe": 2, "seq": 2}, 4)
    mod = gpt2_pipeline_module(GPT2Config(dtype=torch.float32,
                                          moe_num_experts=4, **TINY))
    with pytest.raises(NotImplementedError, match="A12b"):
        PipelineEngine._refuse_pipeline_unported(ds_config(2), mod, 2)


def test_elastic_and_auto_resume_loads_name_a16(tmp_path):
    """In the single-controller layout both loads run (A16): auto-resume
    of an empty directory loads nothing, an elastic load of the engine's
    own tag returns its plan and data position. With one process per
    stage (a world of several processes) both raise naming A16b."""
    eng = port_engine()
    assert eng.load_checkpoint(str(tmp_path), auto_resume=True) == (None,
                                                                    {})
    eng.save_checkpoint(str(tmp_path))
    path, client = eng.load_checkpoint(str(tmp_path), elastic=True)
    assert path.endswith("global_step0")
    assert client["elastic_reshard"]["changed"] == {}
    assert client["data_position"]["samples_consumed"] == 0
    eng._world_group = types.SimpleNamespace(size=2)
    for kw in ({"elastic": True}, {"auto_resume": True}):
        with pytest.raises(NotImplementedError, match="A16b"):
            eng.load_checkpoint(str(tmp_path), **kw)


def test_the_world_picks_the_layout():
    from deepspeed_tpu_torch.parallel.mesh import (pipe_processes,
                                                   resolve_grid)

    shape = resolve_grid({"pipe": 2}, 1)
    assert shape["pipe"] == 2 and pipe_processes(shape, 1) == 1
    shape = resolve_grid({"pipe": 2}, 2)
    assert shape["data"] == 1 and pipe_processes(shape, 2) == 2
    shape = resolve_grid({"pipe": 2, "data": 2}, 2)
    assert pipe_processes(shape, 2) == 1
    shape = resolve_grid({"pipe": 2, "data": 2}, 4)
    assert pipe_processes(shape, 4) == 2
    with pytest.raises(ValueError, match="pipe=2 data=3 seq=1 over a world "
                       "of 4"):
        resolve_grid({"pipe": 2, "data": 3}, 4)


# ---------------------------------------------------------------------------
# the gloo worlds (tests/torch_pipe_worlds.py): one process per stage, and
# ZeRO inside a stage's data line against the JAX engine at pipe 2 x data 2
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import test_torch_zero as Z
    import torch_zero_worker as W

    return W.session_worlds(tmp_path_factory, Z.WORLDS)


def _world_batches(dp):
    import torch_pipe_worlds as PW
    import torch_zero_worker as W

    ids = W.global_batches(PW.SEED, PW.STEPS, PW.GAS, PW.MICRO * dp)
    return [{"input_ids": b, "labels": b} for b in ids]


def _owned_masters(ranks, job):
    """{chunk: {name: array}} gathered from every rank of data rank 0."""
    out = {}
    for r in ranks:
        if r[job]["dp_rank"] == 0:
            out.update(r[job]["masters"])
    return out


@pytest.mark.parametrize("job,schedule,untied", [
    ("pipe_1f1b", "1f1b", False), ("pipe_zb", "zb-h1", True)])
def test_process_per_stage_matches_one_process(world, job, schedule,
                                               untied):
    """One process per stage (gloo sends between the stages) against the
    single-controller run of the same schedule: losses and every master
    within 1e-6 (the ranks compute on one thread each, this process on
    several: the matmuls sum in another order), the key third of each
    c_attn bias at 2 * steps * lr as above."""
    import torch_zero_worker as W
    import torch_pipe_worlds as PW

    ranks = world("dp2")
    assert sorted(r[job]["stage_id"] for r in ranks) == [0, 1]
    assert all(r[job]["procs"] == 2 for r in ranks)
    eng = port_engine(schedule=schedule, untied=untied, stage=0,
                      init=PW.jax_init(untied),
                      zero_optimization={"stage": 0})
    want = [eng.train_batch(batch=b) for b in _world_batches(1)]
    for r in ranks:
        np.testing.assert_allclose(r[job]["losses"], want, rtol=1e-6)
        assert r[job]["stash"] == eng._stash_armed
        assert r[job]["p2p"]["measured_bytes_per_step"] == \
            eng.pipeline_report()["p2p"]["measured_bytes_per_step"] // 2
    got = _owned_masters(ranks, job)
    for q in range(2):
        W.assert_master_close(
            got[q], {n: t.numpy() for n, t in eng.chunk_master(q).items()},
            1e-6, 1e-7, PW.STEPS, LR, f"{job} chunk {q}")
    if job == "pipe_1f1b":
        # the world's checkpoint (each stage's layers gathered to rank 0)
        # loads into one process: every master as the ranks held it
        tag = os.path.join(os.path.dirname(ranks[0]["port_tag"]),
                           "pipe_tag")
        one = port_engine()
        one.load_checkpoint(tag, tag="last")
        assert one.global_steps == PW.STEPS
        for q in range(2):
            for n, t in one.chunk_master(q).items():
                np.testing.assert_array_equal(t.numpy(), got[q][n], n)


@functools.lru_cache(maxsize=None)
def _jax_dp2(stage):
    import torch_pipe_worlds as PW

    jeng = PW.jax_engine(False, 2, stage)
    data = _world_batches(2)
    jax_init_tree(jeng, data[0])
    losses = [float(jeng.train_batch(batch=b)) for b in data]
    return losses, jax_chunk_masters(jeng)


@pytest.mark.parametrize("key,job,stage", [
    ("dp4", "pipe_z1", 1), ("dp4", "pipe_z2", 2), ("dp2", "pipe_line_z1", 1)])
def test_pipe_with_data_parallel_zero_matches_jax(world, key, job, stage):
    """``{"pipe": 2, "data": 2}`` at ZeRO 1 and 2: one process per stage
    (a world of 4) and one process per pipe line (a world of 2) against
    the JAX engine at the same mesh (JAX test_pipe_zero1,
    test_pipe_with_data_parallel_matches): losses within 2e-5, masters
    within 1e-4 (the key biases as above)."""
    ranks = world(key)
    jl, jm = _jax_dp2(stage)
    mod = gpt2_pipeline_module(GPT2Config(dtype=torch.float32, **TINY))
    for r in ranks:
        np.testing.assert_allclose(r[job]["losses"], jl, rtol=LOSS_RTOL[
            "fp32"])
    got = _owned_masters(ranks, job)
    masters = []
    for q in range(2):
        tree = {}
        for k in mod.stage_param_keys(q, 2):
            ref = {k: mod.layer_reference_tree(k, f"{k}.")}
            tree.update(_to_jax(ref, {n: torch.as_tensor(a)
                                      for n, a in got[q].items()}))
        masters.append(tree)
    assert_masters_close(masters, jm, "fp32")


@pytest.mark.parametrize("family", ["pipe", "pipe-bf16"])
def test_pipe_program_lint_families(world, family):
    """The program lint's pipe families in the dp2 world (each rank drives
    its pipe line at pipe 2 x data 2): every chunk program registered and
    clean; a planted fp32 boundary (pipe-bf16) or a copy of the
    accumulator (pipe) is one finding per program it breaks, of the
    contract's rule."""
    for rank in world("dp2"):
        got = rank[f"lint_{family}"]
        assert got["clean"] == [], got["clean"]
        if family == "pipe":
            assert got["schedule"] == "zb-h1" and got["stash"]
            assert "chunk0:fwd_stash" in got["names"]
            want = {("program-donation", f"<pipe:chunk{q}:bwd_wgrad_stash>")
                    for q in (0, 1)}
        else:
            assert got["schedule"] == "1f1b"
            assert {"chunk0:fwd", "chunk0:bwd_mid",
                    "chunk1:bwd_last"} <= set(got["names"])
            want = {("program-boundary-dtype", "<pipe-bf16:chunk0:fwd>")}
        assert set(got["fault"]) == want, got["fault"]
