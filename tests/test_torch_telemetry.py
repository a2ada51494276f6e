"""Telemetry of the PyTorch port (ROADMAP A17) against the JAX package.

- **Tracer, metrics, stream, TensorBoard**: the same event sequence on an
  injected clock exports the same Chrome JSON (once the process name is
  the same); registries snapshot alike; ``replay`` returns the same
  records from the same torn and damaged files; the TensorBoard records
  are byte-identical for the same scalars, steps and wall time.
- **MFU**: ``model_flops_per_step`` and the report's arithmetic equal the
  JAX versions exactly; the peak table holds the cards' own peaks.
- **Engines**: a tiny fp32 GPT-2 (2 layers, n_embd 64, seq 32, gas 2) on
  the CPU computes bit for bit the same armed and disarmed; its spans
  (lane, name, args) equal the JAX engine's for one config and its JSONL
  records equal the JAX engine's key for key, the numbers within the
  engine parity tolerance of test_torch_engine.py (rtol 1e-4: the same
  fp32 arithmetic in another summation order). The serving engine's
  report has the JAX engine's top-level schema, its spans equal the JAX
  engine's for one greedy fp32 serve, and arming changes no token.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2Model as JGPT2Model
from deepspeed_tpu.serving.engine import InferenceEngine as JEngine
from deepspeed_tpu.telemetry import Telemetry as JTelemetry
from deepspeed_tpu.telemetry import metrics as jmetrics
from deepspeed_tpu.telemetry import mfu as jmfu
from deepspeed_tpu.telemetry import trace as jtrace
from deepspeed_tpu.utils import tb_writer as jtb
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from deepspeed_tpu_torch.serving import InferenceEngine
from deepspeed_tpu_torch.telemetry import Telemetry
from deepspeed_tpu_torch.telemetry import metrics as tmetrics
from deepspeed_tpu_torch.telemetry import mfu as tmfu
from deepspeed_tpu_torch.telemetry import trace as ttrace
from deepspeed_tpu_torch.utils import tb_writer as ttb
from deepspeed_tpu_torch.utils.logging import logger as ds_logger

TINY = dict(vocab_size=256, n_positions=32, n_embd=64, n_layer=2, n_head=1)
RTOL = 1e-4
DS = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
      "gradient_accumulation_steps": 2,
      "optimizer": {"type": "Adam", "params": {"lr": 3e-3}},
      "scheduler": {"type": "WarmupLR",
                    "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 3e-3,
                               "warmup_num_steps": 2}},
      "gradient_clipping": 0.5, "steps_per_print": 10 ** 9}


class Clock:
    """A clock the test advances by hand (seconds)."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _drive_tracer(tr, clock, n):
    """One event sequence: spans on two lanes, instants, labelled args."""
    lt, lc = tr.lane("train"), tr.lane("ckpt")
    tr.intern("optimizer_step", args=("global_step",))
    tr.intern("hbm_in_use", args=("bytes", "peak"))
    rng = np.random.default_rng(0)
    for i in range(n):
        t0 = tr.begin()
        clock.t += float(rng.uniform(1e-4, 5e-3))
        tr.complete("forward_micro", lt, t0)
        t0 = tr.begin()
        clock.t += 2.5e-3
        tr.complete("optimizer_step", lt, t0, a0=i + 1)
        tr.instant("hbm_in_use", lc, a0=1000 + i, a1=2000 + i)
        if i % 7 == 3:
            tr.instant("overflow_skip", lt, a0=i)
        clock.t += 1e-4


@pytest.mark.parametrize("n,capacity", [(20, 256), (200, 256)])
@pytest.mark.parametrize("complete_events", [True, False])
def test_chrome_trace_export_equals_jax(tmp_path, n, capacity,
                                        complete_events):
    """200 steps x 3-4 events overflow a 256-event ring: the same events
    are dropped on both sides."""
    out = []
    for mod, name in ((jtrace, "j"), (ttrace, "t")):
        clock = Clock()
        tr = mod.Tracer(capacity, clock=clock)
        _drive_tracer(tr, clock, n)
        path = str(tmp_path / f"{name}.json")
        tr.export_chrome_trace(path, complete_events=complete_events,
                               process_name="deepspeed")
        out.append((json.load(open(path)), tr.events(), tr.summary(),
                    mod.lane_utilization(tr.events())))
        assert not os.path.exists(path + ".tmp")
    assert out[0] == out[1]
    summary = out[1][2]
    assert summary["dropped"] == max(0, summary["recorded"] - capacity)
    assert (summary["dropped"] > 0) == (n == 200)


def _drive_registry(reg):
    rng = np.random.default_rng(1)
    for i in range(50):
        reg.counter("steps").inc()
        reg.counter("tokens").inc(int(rng.integers(1, 9)))
        reg.gauge("mem").set(int(rng.integers(0, 10 ** 9)))
        reg.histogram("lat", max_samples=16).add(float(rng.random()))
    reg.histogram("empty")
    return reg.snapshot()


def test_registry_snapshot_equals_jax():
    assert _drive_registry(tmetrics.MetricsRegistry()) \
        == _drive_registry(jmetrics.MetricsRegistry())
    for xs, q in (([], .5), ([3.0], .95), ([1, 5, 2, 4], 2.0)):
        assert tmetrics.nearest_rank(xs, q) == jmetrics.nearest_rank(xs, q)


def _write_stream(mod, path):
    clock = iter(float(t) for t in range(1000))
    s = mod.MetricsStream(path, clock=lambda: next(clock))
    for step in range(1, 6):
        s.emit(step, {"loss": 1.0 / step, "overflow": step == 3,
                      "arr": np.arange(step, dtype=np.float32),
                      "n": np.int64(step)})
    s.close()
    s.close()           # idempotent
    return open(path).read()


def test_metrics_stream_and_replay_equal_jax(tmp_path, caplog):
    jp, tp = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    assert _write_stream(jmetrics, jp) == _write_stream(tmetrics, tp)
    assert tmetrics.MetricsStream.replay(tp) \
        == jmetrics.MetricsStream.replay(jp)
    # a torn tail is skipped on both sides
    for p in (jp, tp):
        with open(p, "a") as f:
            f.write('{"step": 6, "t": 9')
    assert len(tmetrics.MetricsStream.replay(tp)) == 5
    assert tmetrics.MetricsStream.replay(tp) \
        == jmetrics.MetricsStream.replay(jp)
    # damage mid-stream raises on both sides
    for p in (jp, tp):
        lines = open(p).read().split("\n")
        lines[2] = lines[2][:10]
        open(p, "w").write("\n".join(lines))
    for mod, p in ((jmetrics, jp), (tmetrics, tp)):
        with pytest.raises(ValueError, match="mid-stream"):
            mod.MetricsStream.replay(p)


def test_json_safe_takes_torch_tensors():
    js = tmetrics._json_safe
    assert js(torch.tensor(2.5)) == 2.5
    assert js(torch.tensor(True)) is True
    assert js(torch.tensor([1, 2, 3])) == [1, 2, 3]
    assert js(torch.tensor([1.5])) == 1.5
    assert js(np.float32(0.5)) == 0.5 and js(np.arange(2)) == [0, 1]
    assert js(object()).startswith("<object")
    line = json.dumps({"g": torch.tensor(0.25), "o": torch.tensor(False)},
                      default=js)
    assert json.loads(line) == {"g": 0.25, "o": False}


def _tb_bytes(mod, log_dir, monkeypatch):
    clock = iter(1.7e9 + 0.125 * i for i in range(100))
    monkeypatch.setattr(mod.time, "time", lambda: next(clock))
    monkeypatch.setattr(mod.socket, "gethostname", lambda: "host")
    w = mod.SummaryWriter(str(log_dir), job_name="job")
    for step in range(1, 4):
        w.add_scalar("Train/Samples/loss", 1.0 / step, step)
        w.add_scalars({"a": float(step), "b": -0.5 * step}, step)
    w.flush()
    w.close()
    return w.path, open(w.path, "rb").read()


def test_tensorboard_records_byte_identical_to_jax(tmp_path, monkeypatch):
    jpath, jb = _tb_bytes(jtb, tmp_path / "j", monkeypatch)
    tpath, tb = _tb_bytes(ttb, tmp_path / "t", monkeypatch)
    assert os.path.basename(jpath) == os.path.basename(tpath)
    assert jb == tb
    events = ttb.read_events(tpath)
    assert events[0]["file_version"] == "brain.Event:2"
    got = [(e["step"], e["scalars"]) for e in events[1:]]
    assert got[0] == (1, {"Train/Samples/loss": 1.0})
    assert got[5] == (3, {"a": 3.0, "b": -1.5})
    # a flipped bit fails its CRC
    bad = bytearray(tb)
    bad[40] ^= 1
    open(tpath, "wb").write(bytes(bad))
    with pytest.raises(ValueError, match="CRC"):
        ttb.read_events(tpath)


def test_telemetry_session_equals_jax():
    out = []
    for cls in (JTelemetry, Telemetry):
        clock = Clock()
        tel = cls(trace=True, mfu=True, clock=clock)
        for step in range(1, 6):
            clock.t += 0.25 * step
            tel.on_step(step, {"x": step})
        out.append((tel.step_time_s(), tel.registry.snapshot()))
        tel.close()
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# MFU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,tokens,fwd", [(118528, 128, False),
                                          (354_823_168, 16384, False),
                                          (354_823_168, 8, True)])
def test_model_flops_equal_jax(n, tokens, fwd):
    assert tmfu.model_flops_per_step(n, tokens, fwd_only=fwd) \
        == jmfu.model_flops_per_step(n, tokens, fwd_only=fwd)


class _Compiled:
    def __init__(self, flops):
        self.flops = flops

    def cost_analysis(self):
        return {"flops": self.flops, "bytes accessed": None}


@pytest.mark.parametrize("step_time,n_dev,peak", [(0.2, 1, 989.4),
                                                  (0.05, 4, 0.0),
                                                  (None, 1, 1.0)])
def test_mfu_report_arithmetic_equals_jax(step_time, n_dev, peak):
    programs = {"micro_step": (2.0e13, 2.0), "apply_step": (1.5e9, 1.0)}
    j = jmfu.MfuAccounting(peak)
    t = tmfu.MfuAccounting(peak)
    for name, (flops, calls) in programs.items():
        j.register(name, lambda f=flops: _Compiled(f), calls)
        t.register(name, lambda f=flops: {"flops": f,
                                          "bytes_accessed": None}, calls)
    kw = dict(step_time_s=step_time, n_devices=n_dev,
              model_flops=6.0 * 354e6 * 16384, device_kind="cpu")
    jr, tr = j.report(**kw), t.report(**kw)
    jr.pop("per_jit")
    tr.pop("per_jit")
    assert jr == tr
    if peak and step_time:
        assert tr["hfu"] >= tr["mfu"] > 0


def test_peak_table_holds_the_cards_own_peaks():
    peak = tmfu.peak_flops_per_device
    assert peak("NVIDIA H100 80GB HBM3") == (989.4e12, True)
    assert peak("NVIDIA H100 PCIe") == (756.5e12, True)
    assert peak("NVIDIA H100 NVL") == (835.5e12, True)
    # no substring match: an unknown H100 variant is not read as SXM
    assert peak("H100") == (None, False)
    assert peak("cpu") == (None, False) and peak(None) == (None, False)
    assert tmfu.device_kind("cpu") == "cpu"
    rep = tmfu.MfuAccounting().report(step_time_s=0.1, n_devices=1,
                                      model_flops=1e12, device_kind="cpu")
    assert rep["mfu"] is None and rep["hfu"] is None \
        and rep["peak_known"] is False


# ---------------------------------------------------------------------------
# the training engines
# ---------------------------------------------------------------------------
def _batches(steps, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, TINY["vocab_size"], (2, 2, 32))
            for _ in range(steps)]


def _armed(tmp_path, name, **extra):
    tel = {"enabled": True, "metrics_jsonl": str(tmp_path / f"{name}.jsonl")}
    tel.update(extra)
    return dict(DS, telemetry=tel)


def _port_engine(cfg, init=None):
    eng = deepspeed_tpu_torch.initialize(
        model=GPT2Model(GPT2Config(dtype=torch.float32, **TINY)),
        config_params=cfg, device="cpu")[0]
    if init is not None:
        eng.load_module_state_dict(init)
    return eng


def _loop(eng, batches):
    """forward/backward x gas, step: the JAX engine's unfused path."""
    for b in batches:
        for i in range(b.shape[0]):
            loss = eng({"input_ids": b[i], "labels": b[i]})
            eng.backward(loss)
        eng.step()


def test_armed_engine_computes_what_the_disarmed_one_does(tmp_path):
    """Every channel armed (trace, stream, MFU, memory, the flops profiler
    at step 2, TensorBoard, wall_clock_breakdown): the losses and every
    parameter after 3 train_batch steps are bit for bit the disarmed
    engine's."""
    cfg = _armed(tmp_path, "a")
    cfg.update(flops_profiler={"enabled": True, "profile_step": 2},
               tensorboard={"enabled": True, "output_path": str(tmp_path)},
               wall_clock_breakdown=True)
    runs = []
    for c in (DS, cfg):
        eng = _port_engine(c)
        losses = [eng.train_batch(batch={"input_ids": b, "labels": b})
                  for b in _batches(3)]
        runs.append((torch.stack(losses), [p.detach().clone()
                                           for p in eng.params], eng))
    (l0, p0, off), (l1, p1, on) = runs
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert off.telemetry is None and off.export_trace("x") is None
    rep = on.telemetry_report()
    assert rep["telemetry_armed"] and rep["metrics"]["counters"]["steps"] == 3
    assert on.flops_profile.get_total_flops() > 0
    recs = tmetrics.MetricsStream.replay(str(tmp_path / "a.jsonl"))
    assert [r["loss"] for r in recs] == l1.tolist()
    names = [e["name"] for e in on.telemetry.tracer.events()]
    assert names == (["forward_micro", "backward_micro"] * 2
                     + ["optimizer_step"]) * 3
    scalars = [e for e in ttb.read_events(on.summary_writer.path)
               if "scalars" in e]
    assert scalars == []        # steps_per_print was never reached


def _jax_engine(cfg):
    return deepspeed_tpu.initialize(
        model=JGPT2Model(JGPT2Config(dtype=jnp.float32, **TINY)),
        config_params=dict(cfg, mesh={"data": 1, "allow_partial": True}))[0]


@pytest.fixture(scope="module")
def both_engines(tmp_path_factory):
    """The JAX engine and the port's, armed alike, 3 steps of the
    forward/backward/step loop from the JAX engine's initial weights, a
    checkpoint at the end."""
    from deepspeed_tpu.runtime.engine import _first_micro

    tmp = tmp_path_factory.mktemp("engines")
    batches = _batches(3, seed=3)
    jeng = _jax_engine(_armed(tmp, "j"))
    jeng._ensure_state(_first_micro({"input_ids": batches[0],
                                     "labels": batches[0]}))
    init = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax.device_get(jeng.state.params)),
        GPT2Config(dtype=torch.float32, **TINY))
    eng = _port_engine(_armed(tmp, "t"), init)
    for e in (jeng, eng):
        _loop(e, batches)
        e.save_checkpoint(str(tmp / type(e).__module__), backend="npz")
    return jeng, eng, tmp


def _spans(tracer):
    return [(e["lane"], e["name"], e["a0"], e["a1"])
            for e in tracer.events()]


def test_training_spans_equal_jax(both_engines):
    jeng, eng, _ = both_engines
    got, want = _spans(eng.telemetry.tracer), _spans(jeng.telemetry.tracer)
    # the chaos observers mark each chaos point of the commit
    # (chaos_point_*) in both engines
    assert any(s[1].startswith("chaos_point_") for s in want)
    assert got == want
    assert [s[1] for s in got].count("optimizer_step") == 3
    assert ("ckpt", "ckpt_sync_commit", 3, -1) in got


def test_training_metrics_records_equal_jax(both_engines):
    jeng, eng, tmp = both_engines
    for e in (jeng, eng):
        e.close_telemetry()
    want = jmetrics.MetricsStream.replay(str(tmp / "j.jsonl"))
    got = tmetrics.MetricsStream.replay(str(tmp / "t.jsonl"))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k, v in w.items():
            if k == "t":
                continue
            if isinstance(v, (bool, int)) or v is None:
                assert g[k] == v, k
            else:
                np.testing.assert_allclose(g[k], v, rtol=RTOL, err_msg=k)


def test_training_report_schema_and_mfu_equal_jax(both_engines):
    """The same top-level keys; the same 6ND model FLOPs, parameter and
    token counts; hardware FLOPs counted (matmuls + the flash kernels'
    formulas) and at least the model FLOPs; HFU >= MFU under a set
    peak."""
    jeng, eng, _ = both_engines
    jr, tr = jeng.telemetry_report(), eng.telemetry_report()
    assert sorted(jr) == sorted(tr)
    assert sorted(jr["memory"]) == sorted(tr["memory"])
    for k in ("model_flops_per_step", "n_params", "tokens_per_step",
              "n_devices", "peak_known", "mfu", "hfu"):
        assert tr["mfu"][k] == jr["mfu"][k], k
    assert tr["mfu"]["hw_flops_per_step"] >= tr["mfu"]["model_flops_per_step"]
    assert tr["mfu"]["per_jit"]["micro_step"]["kernel_launches"] == {
        "flash_fwd": 2, "flash_bwd_dkdv": 2, "flash_bwd_dq": 2}
    eng.telemetry.mfu.peak_tflops_per_device = 1.0
    rep = eng._mfu_report()
    assert rep["peak_known"] and rep["hfu"] >= rep["mfu"] > 0
    assert tr["memory"]["analytic"]["components"] \
        == jr["memory"]["analytic"]["components"]
    assert all(not m["modeled"] for m in tr["memory"]["measured"].values())


def test_disarmed_stream_warns(tmp_path, caplog):
    cfg = dict(DS, telemetry={"enabled": False,
                              "metrics_jsonl": str(tmp_path / "x.jsonl")})
    ds_logger.propagate = True
    try:
        eng = _port_engine(cfg)
    finally:
        ds_logger.propagate = False
    assert eng.telemetry is None
    assert "DISARMED" in caplog.text
    assert not os.path.exists(tmp_path / "x.jsonl")


def test_watchdog_still_names_a16():
    """The watchdog is wired (A16): armed beside the tracer, an overflow
    streak (NaN gradients from the chaos plan) fires its event, traced as
    the JAX engine's ``watchdog_*`` instant; action "continue" keeps
    training."""
    from deepspeed_tpu_torch.runtime.resilience import chaos

    eng = _port_engine(dict(DS, telemetry={"enabled": True},
                            resilience={"watchdog": {
                                "enabled": True, "max_skipped_steps": 2,
                                "action": "continue"}}))
    ids = np.random.default_rng(0).integers(0, 256, (2, 2, 32))
    chaos.arm(nan_grad_steps=2)
    try:
        for _ in range(3):
            eng.train_batch(batch={"input_ids": ids, "labels": ids})
    finally:
        chaos.disarm()
    assert [e.kind for e in eng.watchdog.events] == ["overflow_streak"]
    names = [e["name"] for e in eng.telemetry.tracer.events()]
    assert "watchdog_overflow_streak" in names
    assert eng.consecutive_skipped_steps() == 0


# ---------------------------------------------------------------------------
# the serving engines
# ---------------------------------------------------------------------------
SERVE = dict(vocab_size=97, n_positions=64, n_embd=32, n_layer=2, n_head=4)


@pytest.fixture(scope="module")
def serve_toy():
    jm = JGPT2Model(JGPT2Config(dtype=jnp.float32, loss_chunk_tokens=0,
                                **SERVE))
    ids = np.random.default_rng(0).integers(0, 97, (2, 8))
    jparams = jm.init(jax.random.PRNGKey(0),
                      {"input_ids": ids, "labels": ids})
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    model = GPT2Model(GPT2Config(dtype=torch.float32, loss_chunk_tokens=0,
                                 **SERVE))
    return jm, jparams, model, tree


def _serve(cls, model, params, telemetry, warm=False, **extra):
    clock = Clock()
    eng = cls(model, params, max_slots=3, kv_block_size=4, prefill_chunk=8,
              max_blocks_per_seq=8, clock=clock, telemetry=telemetry,
              **extra)
    if warm:
        eng.warmup()
    rng = np.random.default_rng(5)
    rids = []
    for n in (5, 12, 3, 20, 9):
        rids.append(eng.submit(rng.integers(0, 97, n).astype(np.int32),
                               max_new_tokens=6))
        eng.step()
        clock.t += 1.0
    while eng.scheduler.has_work():
        eng.step()
        clock.t += 1.0
    return eng, [np.asarray(eng.results[r]["tokens"]).tolist() for r in rids]


def test_serving_spans_schema_and_tokens_equal_jax(serve_toy, tmp_path):
    jm, jparams, model, tree = serve_toy
    jeng, jtok = _serve(JEngine, jm, jparams,
                        {"metrics_jsonl": str(tmp_path / "j.jsonl")})
    teng, ttok = _serve(InferenceEngine, model, tree,
                        {"metrics_jsonl": str(tmp_path / "t.jsonl")},
                        device="cpu")
    plain, ptok = _serve(InferenceEngine, model, tree, None, device="cpu")
    assert ttok == jtok == ptok
    assert _spans(teng.telemetry.tracer) == _spans(jeng.telemetry.tracer)
    jr, tr = jeng.telemetry_report(), teng.telemetry_report()
    # the JAX engine's keys, plus the port's serving_report additions
    assert set(tr) - set(jr) == {"dispatch", "tpot_p50_s"}
    assert set(jr) <= set(tr)
    assert sorted(jr["telemetry"]) == sorted(tr["telemetry"])
    assert sorted(jr["memory"]) == sorted(tr["memory"])
    assert tr["memory"]["analytic"] == jr["memory"]["analytic"]
    for k in ("model_flops_per_step", "n_params", "tokens_per_step"):
        assert tr["mfu"][k] == jr["mfu"][k], k
    assert tr["mfu"]["hw_flops_per_step"] > 0
    assert set(tr["mfu"]["per_jit"]) == set(jr["mfu"]["per_jit"])
    for e in (jeng, teng):
        e.close_telemetry()
    want = jmetrics.MetricsStream.replay(str(tmp_path / "j.jsonl"))
    got = tmetrics.MetricsStream.replay(str(tmp_path / "t.jsonl"))
    assert [{k: v for k, v in r.items() if k != "t"} for r in got] \
        == [{k: v for k, v in r.items() if k != "t"} for r in want]
    assert plain.telemetry is None and plain.export_trace("x") is None
    assert plain.telemetry_report()["telemetry_armed"] is False


def test_serving_warmup_emits_no_step_record(serve_toy, tmp_path):
    """Warmup's spans are kept (they are host time the engine spent) but
    no JSONL record; one serving_step span per engine step."""
    _, _, model, tree = serve_toy
    tel = Telemetry(metrics_jsonl=str(tmp_path / "w.jsonl"))
    eng, _ = _serve(InferenceEngine, model, tree, tel, warm=True,
                    device="cpu")
    tel.close()
    recs = tmetrics.MetricsStream.replay(str(tmp_path / "w.jsonl"))
    assert [r["step"] for r in recs] == list(range(1, eng._step_idx + 1))
    names = [e["name"] for e in tel.tracer.events()]
    assert names.count("serving_step") > eng._step_idx
    path = eng.export_trace(str(tmp_path / "serve.json"))
    trace = json.load(open(path))
    lanes = {e["args"]["name"] for e in trace["traceEvents"]
             if e["name"] == "thread_name"}
    assert lanes == {"serve"}


def test_serving_disarmed_configs_warn(serve_toy, caplog):
    _, _, model, tree = serve_toy
    ds_logger.propagate = True
    try:
        eng = InferenceEngine(model, tree, max_slots=2, kv_block_size=4,
                              max_blocks_per_seq=8, device="cpu",
                              telemetry={"enabled": False})
        assert eng.telemetry is None
        InferenceEngine(model, tree, max_slots=2, kv_block_size=4,
                        max_blocks_per_seq=8, device="cpu",
                        telemetry={"trace": False, "mfu": False})
    finally:
        ds_logger.propagate = False
    assert caplog.text.count("DISARMED") == 2
