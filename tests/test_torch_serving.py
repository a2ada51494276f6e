"""Continuous-batching serving engine of the PyTorch port.

The in-scope tests of the JAX package's tests/unit/test_serving.py,
test_serving_reliability.py and test_sampling.py, one for one, on the
port's engine (CPU, fp32), plus the cross-package checks:

- **Parity**: greedy tokens under continuous batching — staggered
  arrivals, mixed lengths, eviction, chaos cancellation, eos, deadlines,
  drain and crash recovery — equal the port's single-sequence
  ``generate()`` bit for bit (exact -1e30 masking: the paged pool's wider
  padded key view scores its padding exactly 0).
- **Fixed shapes**: after ``warmup()``, churn adds no dispatch signature
  (the eager counterpart of the reference's zero recompiles), and the
  pool tensors keep their storage (the counterpart of its donated pool).
- **Against the JAX engine**: the same traffic on a step clock gives the
  same greedy tokens, prefill tokens computed, evictions and step count;
  the int8 row quantizers are bit-exact against the reference's at fp32.
- **Deferred options** raise NotImplementedError naming their ROADMAP
  item (sharded pools and the fleet A10c); telemetry and the program
  registry have their own files, test_torch_telemetry.py and
  test_torch_programs.py. The prefix
  cache, speculation and sparse context (A10b) have their own files:
  test_torch_prefix_cache.py, test_torch_speculative.py and
  test_torch_sparse_context.py.

Latency/deadline tests run on a STEP-COUNT clock (1.0 per serving step),
so TTFT, deadlines and the predicted-TTFT admission model are
deterministic on any host.
"""
import logging
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2Model as JGPT2Model
from deepspeed_tpu.runtime import quantization as jquant
from deepspeed_tpu.serving.engine import InferenceEngine as JEngine
from deepspeed_tpu_torch.models.generation import (_sample, generate,
                                                   generate_beam)
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from deepspeed_tpu_torch.runtime import quantization as tquant
from deepspeed_tpu_torch.runtime.resilience import chaos
from deepspeed_tpu_torch.runtime.resilience.chaos import ChaosInterrupt
from deepspeed_tpu_torch.runtime.resilience.watchdog import (ACTION_CONTINUE,
                                                             EVENT_STALL,
                                                             TrainingWatchdog)
from deepspeed_tpu_torch.serving import (InferenceEngine, PagedKVPool,
                                         Request, Scheduler, ServingMetrics)
from deepspeed_tpu_torch.serving.metrics import DispatchShapes, _pct
from deepspeed_tpu_torch.serving.reliability import RequestJournal
from deepspeed_tpu_torch.utils.logging import logger as ds_logger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY = dict(vocab_size=97, n_positions=64, n_embd=32, n_layer=2, n_head=4)


@pytest.fixture(scope="module")
def toy():
    """The reference's serving toy, its parameters from the JAX init; the
    port's model reads them as the JAX tree."""
    jm = JGPT2Model(JGPT2Config(dtype=jnp.float32, loss_chunk_tokens=0,
                                **TOY))
    ids = np.random.default_rng(0).integers(0, 97, (2, 8))
    jparams = jm.init(jax.random.PRNGKey(0),
                      {"input_ids": ids, "labels": ids})
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    model = GPT2Model(GPT2Config(dtype=torch.float32, loss_chunk_tokens=0,
                                 **TOY))
    refs = {}

    def ref(prompt, max_new):
        key = (tuple(int(t) for t in prompt), max_new)
        if key not in refs:
            refs[key] = generate(model, tree,
                                 np.asarray(prompt, np.int32)[None],
                                 max_new_tokens=max_new, device="cpu")[0]
        return refs[key]

    return model, tree, ref, (jm, jparams)


class StepClock:
    """Deterministic clock: the test advances it 1.0 per serving step,
    so every latency metric is measured in STEPS."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _engine(model, params, **kw):
    kw.setdefault("max_slots", 3)
    kw.setdefault("kv_block_size", 4)
    kw.setdefault("prefill_chunk", 8)
    kw.setdefault("max_blocks_per_seq", 8)
    kw.setdefault("device", "cpu")
    return InferenceEngine(model, params, **kw)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 97, n).astype(np.int32) for n in lens]


class _Propagate:
    """The port's logger into caplog for one block."""

    def __enter__(self):
        ds_logger.propagate = True

    def __exit__(self, *exc):
        ds_logger.propagate = False


# ---------------------------------------------------------------------------
# parity (acceptance)
# ---------------------------------------------------------------------------

def test_parity_staggered_mixed_lengths(toy):
    """Greedy continuous batching == single-sequence generate(), with
    arrivals staggered across steps and mixed prompt/output lengths."""
    model, params, ref, _ = toy
    eng = _engine(model, params)
    prompts = _prompts(1, (5, 11, 3, 9))
    maxnew = [6, 9, 12, 5]
    rids = []
    for p, m in zip(prompts, maxnew):
        rids.append(eng.submit(p, max_new_tokens=m))
        eng.step()                       # stagger arrivals
        eng.step()
    res = eng.serve(max_steps=500)
    for rid, p, m in zip(rids, prompts, maxnew):
        np.testing.assert_array_equal(res[rid]["tokens"], ref(p, m))
    rep = eng.serving_report()
    assert rep["requests"]["completed"] == 4
    assert rep["ttft_s"]["mean"] is not None
    assert rep["throughput"]["tokens_per_slot_step"] > 0


def test_parity_under_eviction_churn(toy):
    """A pool too small for both sequences forces preemption; the evicted
    request re-prefills prompt+generated and must still match
    single-sequence generate() bit for bit."""
    model, params, ref, _ = toy
    eng = _engine(model, params, max_slots=2, kv_blocks=9)
    prompts = _prompts(2, (9, 10))
    rids = [eng.submit(p, max_new_tokens=12) for p in prompts]
    res = eng.serve(max_steps=500)
    for rid, p in zip(rids, prompts):
        np.testing.assert_array_equal(res[rid]["tokens"], ref(p, 12))
    assert eng.serving_report()["requests"]["evictions"] >= 1, \
        "pool sizing failed to exercise eviction"


def test_parity_under_chaos_cancellation(toy):
    """chaos.arm(cancel_request_every=N) drives request cancellation
    through the scheduler; surviving requests stay bit-identical and the
    cancelled ones report partial tokens."""
    model, params, ref, _ = toy
    eng = _engine(model, params)
    prompts = _prompts(3, (5, 11, 3, 9, 6))
    maxnew = [6, 9, 12, 5, 8]
    chaos.arm(cancel_request_every=7)
    try:
        rids = []
        for p, m in zip(prompts, maxnew):
            rids.append(eng.submit(p, max_new_tokens=m))
            eng.step()
            eng.step()
        res = eng.serve(max_steps=500)
    finally:
        plan = chaos.active()
        chaos.disarm()
    assert any(kind == "cancel_request" for kind, _ in plan.fired)
    finished = cancelled = 0
    for rid, p, m in zip(rids, prompts, maxnew):
        r = res[rid]
        if r["status"] == "cancelled":
            cancelled += 1
            # partial output is a prefix of the reference continuation
            np.testing.assert_array_equal(
                r["tokens"], ref(p, m)[:len(r["tokens"])])
        else:
            finished += 1
            np.testing.assert_array_equal(r["tokens"], ref(p, m))
    assert cancelled >= 1 and finished >= 1
    assert eng.serving_report()["requests"]["cancelled"] == cancelled


def test_parity_eos_early_stop(toy):
    """A request that hits eos stops early and matches the eos-latched
    generate() output up to (and including) the first eos."""
    model, params, ref, _ = toy
    prompt = _prompts(4, (6,))[0]
    base = ref(prompt, 10)
    eos = int(base[len(prompt) + 2])     # appears mid-continuation
    eng = _engine(model, params)
    rid = eng.submit(prompt, max_new_tokens=10, eos_token_id=eos)
    res = eng.serve(max_steps=200)
    got = res[rid]["tokens"]
    gen = generate(model, params, prompt[None], max_new_tokens=10,
                   eos_token_id=eos, device="cpu")[0]
    stop = len(prompt) + list(gen[len(prompt):]).index(eos) + 1
    np.testing.assert_array_equal(got, gen[:stop])
    assert got[-1] == eos


def test_sampled_engine_is_deterministic_per_request_seed(toy):
    """Sampling (temperature > 0): a request's tokens are a pure function
    of its seed — the same in another slot, at another step, beside other
    traffic — and equal row 0 of generate() with that seed."""
    model, params, _, _ = toy
    prompt = _prompts(19, (6,))[0]
    want = generate(model, params, prompt[None], 8, temperature=1.0,
                    top_k=20, rng=5, device="cpu")[0]
    eng = _engine(model, params, temperature=1.0, top_k=20)
    for p in _prompts(20, (4, 7)):
        eng.submit(p, max_new_tokens=9, seed=1)
    eng.step()
    rid = eng.submit(prompt, max_new_tokens=8, seed=5)
    res = eng.serve(max_steps=300)
    np.testing.assert_array_equal(res[rid]["tokens"], want)


# ---------------------------------------------------------------------------
# fixed shapes (acceptance)
# ---------------------------------------------------------------------------

def test_no_new_dispatch_signature_after_warmup(toy):
    """>= 20 decode steps of join/leave/complete churn dispatch NOTHING of
    a new shape after warmup."""
    model, params, ref, _ = toy
    eng = _engine(model, params)
    eng.warmup()
    before = dict(eng.dispatch_shapes.signatures)
    prompts = _prompts(5, (5, 11, 3, 9, 6, 4, 7))
    maxnew = [6, 9, 12, 5, 8, 7, 10]
    rids = []
    for p, m in zip(prompts, maxnew):
        rids.append(eng.submit(p, max_new_tokens=m))
        eng.step()
        eng.step()
    eng.serve(max_steps=500)
    assert eng.metrics.decode_steps >= 20, eng.metrics.decode_steps
    assert set(eng.dispatch_shapes.signatures) == set(before), \
        "new dispatch signatures during steady-state churn"
    assert eng.dispatch_shapes.names() == [
        "decode_step", "prefill_chunk4_final", "prefill_chunk8",
        "prefill_chunk8_final"]
    for rid, p, m in zip(rids, prompts, maxnew):
        np.testing.assert_array_equal(eng.results[rid]["tokens"],
                                      ref(p, m))


def test_warmup_covers_multichunk_prompts_on_small_capacity(toy):
    """Capacity too small for chunk+bucket+2 warmup prompts must still
    dispatch the NON-final prefill variant — a post-warmup prompt longer
    than prefill_chunk must not bring a new signature."""
    model, params, ref, _ = toy
    eng = _engine(model, params, max_slots=2, prefill_chunk=16,
                  max_blocks_per_seq=5)
    assert eng.capacity_per_seq == 20    # chunk+4+2 > 20 for every bucket
    eng.warmup()
    n = len(eng.dispatch_shapes)
    prompt = _prompts(14, (17,))[0]      # needs a non-final chunk
    rid = eng.submit(prompt, max_new_tokens=3)
    eng.serve(max_steps=100)
    assert len(eng.dispatch_shapes) == n, \
        "new dispatch signature for an admissible post-warmup prompt"
    np.testing.assert_array_equal(eng.results[rid]["tokens"],
                                  ref(prompt, 3))


def test_steady_state_pool_is_updated_in_place(toy):
    """The pool tensors keep their storage across prefill and decode
    steps: every write lands in place."""
    model, params, _, _ = toy
    eng = _engine(model, params)
    eng.submit(_prompts(6, (5,))[0], max_new_tokens=4)
    before = [t.data_ptr() for t in eng.pool.tensors.arrays]
    k0 = eng.pool.tensors.k.clone()
    eng.step()                            # prefill
    eng.step()                            # decode
    assert [t.data_ptr() for t in eng.pool.tensors.arrays] == before
    assert not torch.equal(eng.pool.tensors.k, k0)


def test_dispatch_shapes_record():
    rec = DispatchShapes()
    a, b = torch.zeros(2, 3), torch.zeros(2, 3, dtype=torch.int32)
    assert rec.record("x", (a, b))
    assert not rec.record("x", (torch.ones(2, 3), b))
    assert rec.record("x", (a, torch.zeros(3, dtype=torch.int32)))
    assert rec.record("y", (a, b))
    assert len(rec) == 3 and rec.dispatches == 4 and rec.names() == ["x",
                                                                      "y"]


# ---------------------------------------------------------------------------
# int8 KV
# ---------------------------------------------------------------------------

def test_int8_kv_arms_and_serves(toy):
    model, params, _, _ = toy
    eng = _engine(model, params, quantize_kv=True)
    assert eng.pool.quantized
    assert eng.n_pool_tensors() == 4
    prompt = _prompts(8, (6,))[0]
    rid = eng.submit(prompt, max_new_tokens=8)
    res = eng.serve(max_steps=200)
    toks = res[rid]["tokens"]
    assert toks.shape == (14,) and toks.max() < 97
    np.testing.assert_array_equal(toks[:6], prompt)
    assert eng.pool.tensors.k.dtype == torch.int8
    assert eng.pool.tensors.k_scale.shape == (2, eng.pool.num_blocks, 4, 4)


def test_int8_kv_disarms_when_unprofitable(caplog):
    """bf16 pool with head_dim <= 4: the f32 scale costs more than int8
    saves — must warn DISARMED and serve full precision."""
    cfg = GPT2Config(vocab_size=32, n_positions=32, n_embd=8, n_layer=1,
                     n_head=2, dtype=torch.bfloat16, loss_chunk_tokens=0)
    with _Propagate(), caplog.at_level(logging.WARNING):
        pool = PagedKVPool(cfg, num_blocks=4, block_size=4,
                           quantize_kv=True, device="cpu")
    assert not pool.quantized
    assert any("DISARMED" in r.message for r in caplog.records)
    assert pool.tensors.k.dtype == torch.bfloat16


@pytest.mark.parametrize("dtype,quantized", [
    (torch.float32, False), (torch.bfloat16, False), (torch.float16, False),
    (torch.bfloat16, True)])
def test_pool_device_bytes_match_the_tensors(dtype, quantized):
    cfg = GPT2Config(vocab_size=32, n_positions=64, n_embd=64, n_layer=2,
                     n_head=4, dtype=dtype, loss_chunk_tokens=0)
    pool = PagedKVPool(cfg, num_blocks=7, block_size=4,
                       quantize_kv=quantized, device="cpu")
    assert pool.quantized == quantized
    nbytes = sum(t.numel() * t.element_size() for t in pool.tensors.arrays)
    assert pool.device_bytes() == nbytes
    assert pool.stats()["pool_device_bytes"] == nbytes


@pytest.mark.parametrize("shape,block", [((6, 32), 32), ((5, 64), 64),
                                         ((3, 100), 32), ((4, 7), 128)])
def test_row_quantizers_bit_exact_against_jax(shape, block):
    x = (np.random.default_rng(sum(shape)).normal(size=shape) * 3.0) \
        .astype(np.float32)
    x[0, :3] = 0.0
    if shape[0] > 3:
        x[3] = 0.0                        # an all-zero row: scale 0
    jq, js = jquant.quantize_rows(jnp.asarray(x), block_size=block)
    tq, ts = tquant.quantize_rows(torch.as_tensor(x), block_size=block)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jd = jquant.dequantize_rows(jq, js, shape[1])
    td = tquant.dequantize_rows(tq, ts, shape[1])
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert tquant.block_layout(shape[1], block) == \
        jquant.block_layout(shape[1], block)


# ---------------------------------------------------------------------------
# scheduler / allocator units (no model)
# ---------------------------------------------------------------------------

def _req(rid, n=4, prio=0, max_new=4):
    return Request(rid=rid, prompt=np.zeros(n, np.int32),
                   max_new_tokens=max_new, priority=prio)


def test_scheduler_priority_then_fcfs():
    s = Scheduler(2)
    for rid, prio in [(0, 1), (1, 0), (2, 1), (3, 0)]:
        s.submit(_req(rid, prio=prio))
    order = []
    while True:
        r = s.start_admission()
        if r is None:
            break
        order.append(r.rid)
        s.promote(r)
    # both slots fill in priority order; FCFS within a class
    assert order == [1, 3]
    assert s.peek_waiting().rid == 0


def test_scheduler_victim_policy():
    s = Scheduler(3)
    for rid, prio in [(0, 0), (1, 1), (2, 1)]:
        s.submit(_req(rid, prio=prio))
        r = s.start_admission()
        s.promote(r)
    newcomer = _req(9, prio=0)
    # admission: only strictly-less-important victims; youngest first
    v = s.victim(for_req=newcomer, admission=True)
    assert v.rid == 2
    # growth of a prio-1 runner may preempt its own class but not rid 0
    v = s.victim(for_req=s.running[1], admission=False)
    assert v.rid == 2
    # a prio-0 grower with only itself and less-important peers
    v = s.victim(for_req=s.running[0], admission=False)
    assert v.rid == 2
    # shard filter
    assert s.victim(for_req=newcomer, admission=True, shard=3) is None


def test_scheduler_static_gate_drains_between_batches():
    s = Scheduler(2, policy="static")
    for rid in range(4):
        s.submit(_req(rid))
    a = s.start_admission()
    s.promote(a)
    b = s.start_admission()
    s.promote(b)
    assert {a.rid, b.rid} == {0, 1}
    # batch formed: the gate closes until the engine drains
    assert s.start_admission() is None
    s.finish(a)
    s.on_drained()
    assert s.start_admission() is None, "gate must stay shut mid-batch"
    s.finish(b)
    s.on_drained()
    c = s.start_admission()
    assert c is not None and c.rid == 2


def test_scheduler_static_budget_restored_on_dropped_prefill():
    """A prefill the engine drops (pool pressure) hands its batch budget
    back — repeated drop/re-admit cycles must not shrink the batch."""
    s = Scheduler(2, policy="static")
    for rid in range(3):
        s.submit(_req(rid))
    a = s.start_admission()
    s.drop_prefill(a, requeue=True)       # engine couldn't fit it
    a2 = s.start_admission()
    assert a2.rid == a.rid                # FCFS: same request retries
    s.promote(a2)
    b = s.start_admission()
    assert b is not None, "budget leaked: batch closed after 1 member"
    s.promote(b)
    assert s.start_admission() is None    # budget of 2 now spent


def test_pool_allocator_occupancy_and_fragmentation():
    cfg = GPT2Config(vocab_size=32, n_positions=64, n_embd=8, n_layer=1,
                     n_head=2, dtype=torch.float32, loss_chunk_tokens=0)
    pool = PagedKVPool(cfg, num_blocks=8, block_size=4, device="cpu")
    assert pool.usable_blocks == 7
    assert pool.alloc(0, 0, 6)           # 2 blocks, 6 positions
    assert pool.blocks_in_use == 2
    assert pool.fragmentation() == pytest.approx(1 - 6 / 8)
    assert pool.alloc(1, 0, 20)          # 5 blocks -> pool full
    assert not pool.alloc(2, 0, 5), "overcommit must fail cleanly"
    assert pool.blocks_in_use == 7 and pool.occupancy() == 1.0
    row = pool.table_row(1, 8)
    assert (row[:5] > 0).all() and (row[5:] == 0).all()
    pool.free(0)
    assert pool.alloc(2, 0, 5)
    pool.free(1)
    pool.free(2)
    assert pool.blocks_in_use == 0 and pool.fragmentation() == 0.0


def test_submit_rejects_oversized_requests(toy):
    model, params, _, _ = toy
    eng = _engine(model, params)          # capacity 8 blocks x 4 = 32
    with pytest.raises(AssertionError, match="capacity"):
        eng.submit(np.zeros(30, np.int32), max_new_tokens=10)


# ---------------------------------------------------------------------------
# metrics / reporting / watchdog
# ---------------------------------------------------------------------------

def test_metrics_ttft_tpot_with_fake_clock():
    t = [0.0]
    m = ServingMetrics(clock=lambda: t[0])
    m.record_submit(7)
    t[0] = 1.5
    m.record_token(7)                     # TTFT = 1.5
    t[0] = 2.0
    m.record_token(7)
    t[0] = 2.5
    m.record_token(7)                     # 2 intervals over 1.0s
    m.record_finish(7)
    m.record_step(queue_depth=2, running=1, slots=4, occupancy=0.5,
                  fragmentation=0.25, decoded=True)
    rep = m.report()
    assert rep["ttft_s"]["mean"] == pytest.approx(1.5)
    assert rep["tpot_s"] == pytest.approx(0.5)
    assert rep["requests"]["completed"] == 1
    assert rep["queue_depth"]["max"] == 2
    assert rep["kv_pool"]["occupancy_max"] == pytest.approx(0.5)


def test_serving_report_and_last_metrics(toy):
    model, params, _, _ = toy
    eng = _engine(model, params)
    rid = eng.submit(_prompts(9, (5,))[0], max_new_tokens=4)
    eng.serve(max_steps=100)
    rep = eng.serving_report()
    assert rep["config"]["max_slots"] == 3
    assert rep["config"]["device"] == "cpu"
    assert rep["tokens"]["generated"] == 4
    assert 0.0 <= rep["kv_pool"]["occupancy_max"] <= 1.0
    assert rep["kv_pool"]["now"]["blocks_in_use"] == 0   # all freed
    assert rep["dispatch"]["dispatches"] == 4    # 1 prefill + 3 decode
    assert eng._last_metrics["step"] == eng.metrics.steps
    assert eng.results[rid]["status"] == "finished"


def test_watchdog_heartbeats_every_step(toy):
    model, params, _, _ = toy
    beats = []
    wd = TrainingWatchdog(stall_timeout=1e9,
                          clock=lambda: beats.append(1) or 0.0)
    eng = _engine(model, params, watchdog=wd)
    eng.submit(_prompts(10, (4,))[0], max_new_tokens=3)
    eng.serve(max_steps=100)
    wd.heartbeat()
    assert wd.last_progress_time is not None
    assert len(beats) >= eng.metrics.steps


def test_continuous_beats_static_batching(toy):
    """Mixed output lengths: static batching burns slot-steps running
    every batch to its slowest member; continuous refills freed lanes
    next step.  >= 1.3x tokens per slot-step."""
    model, params, _, _ = toy
    rng = np.random.default_rng(11)
    prompts = _prompts(11, rng.integers(4, 8, 16))
    maxnew = [2 if i % 2 == 0 else 24 for i in range(16)]

    def run(policy):
        eng = _engine(model, params, max_slots=4, policy=policy)
        for p, m in zip(prompts, maxnew):
            eng.submit(p, max_new_tokens=m)
        eng.serve(max_steps=1000)
        rep = eng.serving_report()
        assert rep["requests"]["completed"] == len(prompts)
        return rep["throughput"]["tokens_per_slot_step"]

    cont, static = run("continuous"), run("static")
    assert cont >= 1.3 * static, (cont, static)


# ---------------------------------------------------------------------------
# deadlines & work budgets
# ---------------------------------------------------------------------------

def test_deadline_expiry_frees_blocks_and_never_wedges(toy):
    """Two requests with a deadline too short to finish expire with
    reason 'expired', their KV blocks ALL return to the allocator, and
    a bystander without a deadline still finishes bit-identically."""
    model, params, ref, _ = toy
    clock = StepClock()
    eng = _engine(model, params, clock=clock)
    prompts = _prompts(1, (5, 7, 4))
    bystander = eng.submit(prompts[2], max_new_tokens=6)
    doomed = [eng.submit(p, max_new_tokens=24, deadline_s=4.0)
              for p in prompts[:2]]
    expired = []
    for _ in range(60):
        if not eng.scheduler.has_work():
            break
        ev = eng.step()
        expired += ev["expired"]
        clock.t += 1.0
    res = eng.results
    assert sorted(expired) == sorted(doomed)
    for rid, p in zip(doomed, prompts[:2]):
        assert res[rid]["status"] == "expired"
        np.testing.assert_array_equal(
            res[rid]["tokens"], ref(p, 24)[:len(res[rid]["tokens"])])
    np.testing.assert_array_equal(res[bystander]["tokens"],
                                  ref(prompts[2], 6))
    assert eng.pool.blocks_in_use == 0
    assert eng.pool.occupancy() == 0.0
    rep = eng.serving_report()
    assert rep["requests"]["aborted"]["expired"] == 2
    assert rep["reliability"]["aborts"]["expired"] == 2
    assert rep["tokens"]["wasted"] > 0


def test_work_budget_bounds_scheduled_tokens(toy):
    """A request whose work budget cannot even cover its prompt aborts
    with reason 'budget' at the next step boundary."""
    model, params, _, _ = toy
    eng = _engine(model, params)
    prompt = _prompts(2, (6,))[0]
    rid = eng.submit(prompt, max_new_tokens=8, work_budget=4)
    eng.serve(max_steps=50)
    assert eng.results[rid]["status"] == "budget"
    assert eng.pool.blocks_in_use == 0
    assert eng.serving_report()["requests"]["aborted"]["budget"] == 1


def test_default_deadline_from_reliability_config(toy):
    model, params, _, _ = toy
    clock = StepClock()
    eng = _engine(model, params, clock=clock,
                  reliability={"default_deadline_s": 3.0})
    rid = eng.submit(_prompts(3, (5,))[0], max_new_tokens=25)
    for _ in range(40):
        if not eng.scheduler.has_work():
            break
        eng.step()
        clock.t += 1.0
    assert eng.results[rid]["status"] == "expired"
    assert eng.serving_report()["reliability"]["armed"]["deadlines"]


def test_deadline_must_be_positive(toy):
    model, params, _, _ = toy
    eng = _engine(model, params)
    with pytest.raises(ValueError, match="deadline_s"):
        eng.submit(_prompts(3, (5,))[0], max_new_tokens=4, deadline_s=0)


# ---------------------------------------------------------------------------
# SLO admission / load shedding (the overload guard)
# ---------------------------------------------------------------------------

def _drive_overload(model, params, *, slo, arrival_every, n_requests,
                    deadline, max_steps=500):
    """Fixed traffic shape on a step clock: one request every
    ``arrival_every`` steps, each wanting 8 new tokens, every request
    carrying ``deadline`` steps of patience.  Returns the engine."""
    clock = StepClock()
    rel = {"slo_ttft_s": slo} if slo is not None else None
    eng = _engine(model, params, max_slots=3, clock=clock,
                  reliability=rel)
    prompts = _prompts(11, [6] * n_requests)
    pending = list(enumerate(prompts))
    steps = 0
    while pending or eng.scheduler.has_work():
        while pending and pending[0][0] * arrival_every <= steps:
            _, p = pending.pop(0)
            eng.submit(p, max_new_tokens=8, deadline_s=deadline)
        eng.step()
        clock.t += 1.0
        steps += 1
        assert steps < max_steps, "overload run did not converge"
    return eng


def test_overload_shedding_guard(toy):
    """The graceful-degradation guard: 2x-capacity traffic. ARMED
    (slo_ttft_s=8 steps): the gate sheds at the door, admitted requests
    keep p95 TTFT within 2x the SLO, nothing expires, and goodput holds
    >= 75% of the steady-state baseline's. DISARMED: the same traffic
    queues unboundedly — TTFT blow-up, deadline expiry, wasted tokens."""
    model, params, _, _ = toy
    steady = _drive_overload(model, params, slo=None, arrival_every=3,
                             n_requests=12, deadline=None)
    armed = _drive_overload(model, params, slo=8.0, arrival_every=1,
                            n_requests=32, deadline=24.0)
    disarmed = _drive_overload(model, params, slo=None, arrival_every=1,
                               n_requests=32, deadline=24.0)

    r_steady = steady.serving_report()
    r_armed = armed.serving_report()
    r_dis = disarmed.serving_report()
    assert r_steady["requests"]["completed"] == 12
    shed = r_armed["reliability"]["aborts"]["shed"]
    assert shed > 0, "overload never tripped the admission gate"
    assert r_armed["reliability"]["armed"]["shedding"]
    assert r_armed["ttft_s"]["p95"] <= 2 * 8.0, r_armed["ttft_s"]
    assert r_armed["requests"]["aborted"].get("expired", 0) == 0
    assert r_armed["tokens"]["wasted"] == 0
    g_steady = r_steady["throughput"]["goodput_tokens_per_slot_step"]
    g_armed = r_armed["throughput"]["goodput_tokens_per_slot_step"]
    assert g_armed >= 0.75 * g_steady, (g_armed, g_steady)
    assert r_dis["reliability"]["aborts"]["shed"] == 0
    assert r_dis["ttft_s"]["p95"] >= 1.5 * r_armed["ttft_s"]["p95"], \
        (r_dis["ttft_s"], r_armed["ttft_s"])
    assert r_dis["requests"]["aborted"].get("expired", 0) > 0
    assert r_dis["tokens"]["wasted"] > 0
    assert r_dis["throughput"]["useful_fraction"] \
        < r_armed["throughput"]["useful_fraction"]
    assert r_dis["throughput"]["goodput_tokens_per_slot_step"] < g_armed
    adm = r_armed["reliability"]["admission"]
    assert adm["rejected"] + shed >= shed > 0
    assert adm["predicted_ttft_s"]["mean"] is not None


def test_shedding_prefers_lowest_priority_victims(toy):
    """Under overload a HIGH-importance newcomer sheds queued
    low-importance work instead of being turned away."""
    model, params, ref, _ = toy
    clock = StepClock()
    eng = _engine(model, params, max_slots=2, clock=clock,
                  reliability={"slo_ttft_s": 6.0})
    warm = [eng.submit(p, max_new_tokens=10)
            for p in _prompts(5, (5, 6))]
    for _ in range(4):
        eng.step()
        clock.t += 1.0
    low = [eng.submit(p, max_new_tokens=8, priority=2)
           for p in _prompts(6, (6, 6, 6, 6, 6, 6))]
    vip_prompt = _prompts(7, (5,))[0]
    vip = eng.submit(vip_prompt, max_new_tokens=6, priority=0)
    shed_rids = [r for r in low if eng.results.get(r, {}).get("status")
                 == "shed"]
    assert shed_rids, "no low-priority work was shed for the VIP"
    assert vip not in eng.results, "the VIP itself must be admitted"
    while eng.scheduler.has_work():
        eng.step()
        clock.t += 1.0
    np.testing.assert_array_equal(eng.results[vip]["tokens"],
                                  ref(vip_prompt, 6))
    for rid in warm:
        assert eng.results[rid]["status"] == "finished"


def test_arm_shedding_disarms_loudly_on_static_policy(toy, caplog):
    model, params, _, _ = toy
    with _Propagate(), caplog.at_level(logging.WARNING):
        eng = _engine(model, params, policy="static",
                      reliability={"slo_ttft_s": 5.0})
    assert not eng.reliability.shedding_armed
    assert any("DISARMED" in r.message for r in caplog.records)


# ---------------------------------------------------------------------------
# graceful drain (engine.drain / SIGTERM)
# ---------------------------------------------------------------------------

def test_drain_finishes_in_flight_and_journals_waiting(toy, tmp_path):
    model, params, ref, _ = toy
    jpath = str(tmp_path / "journal.jsonl")
    eng = _engine(model, params, max_slots=2,
                  reliability={"journal_path": jpath})
    prompts = _prompts(8, (5, 7, 6, 4))
    rids = [eng.submit(p, max_new_tokens=8) for p in prompts]
    for _ in range(4):           # two requests admitted, two waiting
        eng.step()
    in_flight = {r.rid for r in eng.scheduler.running.values()}
    if eng.scheduler.prefilling is not None:
        in_flight.add(eng.scheduler.prefilling.rid)
    assert in_flight and len(in_flight) < len(rids)
    res = eng.drain()
    for rid, p in zip(rids, prompts):
        if rid in in_flight:
            assert res[rid]["status"] == "finished"
            np.testing.assert_array_equal(res[rid]["tokens"], ref(p, 8))
        else:
            assert rid not in res          # still queued, not lost...
    waiting = [rid for rid in rids if rid not in in_flight]
    assert eng.scheduler.queue_depth() == len(waiting)
    assert eng.reliability.journal_depth() == len(waiting)
    assert eng.serving_report()["reliability"]["draining"]
    # ...and a successor picks them up via the journal
    eng2 = _engine(model, params, max_slots=2)
    recovered = eng2.recover(jpath)
    assert sorted(recovered) == sorted(waiting)
    res2 = eng2.serve(max_steps=300)
    for rid, p in zip(rids, prompts):
        if rid in waiting:
            np.testing.assert_array_equal(res2[rid]["tokens"], ref(p, 8))


def test_sigterm_drains_gracefully(toy):
    """install_preemption_handler routes SIGTERM into request_drain:
    serve() finishes in-flight work and returns instead of dying."""
    model, params, ref, _ = toy
    eng = _engine(model, params, max_slots=2)
    prev = signal.getsignal(signal.SIGTERM)
    try:
        eng.install_preemption_handler()
        prompts = _prompts(9, (5, 6, 7, 4))
        rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
        for _ in range(3):
            eng.step()
        os.kill(os.getpid(), signal.SIGTERM)   # the preemption notice
        res = eng.serve(max_steps=300)
    finally:
        signal.signal(signal.SIGTERM, prev)
    assert eng.scheduler.draining
    finished = [rid for rid in rids if rid in res
                and res[rid]["status"] == "finished"]
    assert finished, "drain finished nothing"
    for rid, p in zip(rids, prompts):
        if rid in res and res[rid]["status"] == "finished":
            np.testing.assert_array_equal(res[rid]["tokens"], ref(p, 6))
    assert eng.scheduler.queue_depth() == len(rids) - len(finished)


# ---------------------------------------------------------------------------
# crash recovery (kill-mid-decode + journal replay)
# ---------------------------------------------------------------------------

def test_kill_mid_decode_recover_bit_identical(toy, tmp_path):
    """Chaos kills the host mid-decode (after dispatch, before
    bookkeeping).  A fresh engine replays the journal and every journaled
    request's greedy continuation is BIT-IDENTICAL to the uninterrupted
    run — with no new dispatch signature after warmup."""
    model, params, ref, _ = toy
    jpath = str(tmp_path / "crash.jsonl")
    prompts = _prompts(10, (5, 11, 3, 9, 6))
    maxnew = [6, 9, 12, 5, 8]
    eng = _engine(model, params, reliability={"journal_path": jpath})
    chaos.arm(kill_serving_after_steps=9)
    try:
        with pytest.raises(ChaosInterrupt):
            for p, m in zip(prompts, maxnew):
                eng.submit(p, max_new_tokens=m)
                eng.step()
                eng.step()
            eng.serve(max_steps=300)
        plan = chaos.active()
        assert any(k == "kill_serving" for k, _ in plan.fired)
    finally:
        chaos.disarm()
    survivors = {r.rid for r in eng.scheduler.requests.values()}
    assert survivors, "crash happened after all requests finished"

    eng2 = _engine(model, params,
                   reliability={"journal_path": str(tmp_path / "r2.jsonl")})
    eng2.warmup()
    n = len(eng2.dispatch_shapes)
    recovered = eng2.recover(jpath)
    res = eng2.serve(max_steps=400)
    assert len(eng2.dispatch_shapes) == n, \
        "new dispatch signature during recovery"
    assert sorted(recovered) == sorted(survivors)
    by_rid = {rid: (p, m) for rid, (p, m)
              in enumerate(zip(prompts, maxnew))}
    for rid in recovered:
        p, m = by_rid[rid]
        np.testing.assert_array_equal(res[rid]["tokens"], ref(p, m))
    assert eng2.reliability.journal_depth() == 0


def test_recover_preserves_rids_and_fcfs_order(toy, tmp_path):
    model, params, _, _ = toy
    jpath = str(tmp_path / "j.jsonl")
    eng = _engine(model, params, reliability={"journal_path": jpath})
    prompts = _prompts(12, (5, 6, 7))
    rids = [eng.submit(p, max_new_tokens=6, priority=i % 2)
            for i, p in enumerate(prompts)]
    eng.reliability.on_step_end()          # commit without serving
    eng2 = _engine(model, params)
    recovered = eng2.recover(jpath)
    assert recovered == rids               # original ids, original order
    nxt = eng2.submit(prompts[0], max_new_tokens=2)
    assert nxt == max(rids) + 1
    for rid, i in zip(rids, range(len(rids))):
        assert eng2.scheduler.requests[rid].priority == i % 2


def test_journal_replay_units(tmp_path):
    class R:
        def __init__(self, rid, generated=()):
            self.rid = rid
            self.prompt = np.array([1, 2, 3], np.int32)
            self.max_new_tokens = 5
            self.priority = 1
            self.eos_token_id = None
            self.seed = 7
            self.deadline_s = 2.5
            self.work_budget = 99
            self.generated = list(generated)
            self.work_done = 0

    path = str(tmp_path / "j.jsonl")
    j = RequestJournal(path)
    j.record_submit(R(0))
    j.record_submit(R(1, generated=[4]))
    j.record_token(0, 11)
    j.record_token(0, 12)
    j.record_token(1, 13)
    j.commit()
    assert j.depth == 2
    j.record_end(1, "finished")
    j.commit()
    assert j.depth == 1
    j.close()
    with open(path, "a") as f:
        f.write('{"op": "tok", "rid": 0, "t": [9')   # torn final record
    live = RequestJournal.replay(path)
    assert len(live) == 1 and live[0]["rid"] == 0
    assert live[0]["generated"] == [11, 12]
    assert live[0]["deadline_s"] == 2.5
    assert live[0]["work_budget"] == 99
    assert live[0]["seed"] == 7


# ---------------------------------------------------------------------------
# poison quarantine (per-request fault isolation)
# ---------------------------------------------------------------------------

def test_poison_quarantines_one_lane_not_the_batch(toy):
    """NaN injected into one lane's embedding: THAT request aborts with
    reason 'poisoned'; its batch peers finish bit-identically; its
    freed (NaN-contaminated) blocks are safely reused by a later
    request — the value mask keeps stale NaN out of every product."""
    model, params, ref, _ = toy
    eng = _engine(model, params)
    prompts = _prompts(13, (5, 7, 6))
    chaos.arm(poison_logits_at_step=7)
    try:
        rids = [eng.submit(p, max_new_tokens=10) for p in prompts]
        res = eng.serve(max_steps=300)
        plan = chaos.active()
        poisoned_fired = [rid for k, rid in plan.fired
                          if k == "poison_logits"]
    finally:
        chaos.disarm()
    assert len(poisoned_fired) == 1
    bad = poisoned_fired[0]
    assert res[bad]["status"] == "poisoned"
    for rid, p in zip(rids, prompts):
        if rid != bad:
            assert res[rid]["status"] == "finished"
            np.testing.assert_array_equal(res[rid]["tokens"], ref(p, 10))
    assert eng.pool.blocks_in_use == 0
    assert not torch.isfinite(eng.pool.tensors.k).all(), \
        "the poisoned lane's NaN rows must still sit in the pool"
    p2 = _prompts(14, (8,))[0]
    r2 = eng.submit(p2, max_new_tokens=8)
    res = eng.serve(max_steps=200)
    np.testing.assert_array_equal(res[r2]["tokens"], ref(p2, 8))
    rep = eng.serving_report()
    assert rep["reliability"]["aborts"]["poisoned"] == 1
    assert rep["requests"]["aborted"]["poisoned"] == 1


# ---------------------------------------------------------------------------
# chaos: slow steps (watchdog stall) + burst arrivals
# ---------------------------------------------------------------------------

def test_slow_step_chaos_trips_serving_stall_detector(toy):
    model, params, _, _ = toy
    events = []
    wd = TrainingWatchdog(stall_timeout=0.02)
    wd.add_callback(lambda e: events.append(e) or ACTION_CONTINUE)
    eng = _engine(model, params, watchdog=wd)
    chaos.arm(slow_serving_step_every=2, slow_serving_step_s=0.06)
    try:
        eng.submit(_prompts(15, (5,))[0], max_new_tokens=6)
        eng.serve(max_steps=100)
        plan = chaos.active()
        assert any(k == "slow_serving_step" for k, _ in plan.fired)
    finally:
        chaos.disarm()
    assert any(e.kind == EVENT_STALL for e in events), \
        "slowed serving steps never tripped the stall detector"


def test_burst_arrival_chaos_is_absorbed(toy):
    """Thundering-herd chaos: the armed plan releases extra arrivals in
    bursts; the engine absorbs them and every request stays
    bit-identical."""
    model, params, ref, _ = toy
    eng = _engine(model, params, max_slots=2)
    base = _prompts(16, (5,))[0]
    burst_prompts = _prompts(17, (4, 6, 7, 5, 6, 4))
    chaos.arm(burst_arrival_every=3, burst_arrival_count=2)
    rids = {}
    try:
        rids[eng.submit(base, max_new_tokens=6)] = (base, 6)
        step = 0
        pending = list(burst_prompts)
        while eng.scheduler.has_work() or pending:
            step += 1
            for _ in range(chaos.serving_burst(step)):
                if pending:
                    p = pending.pop(0)
                    rids[eng.submit(p, max_new_tokens=5)] = (p, 5)
            eng.step()
            assert step < 400
        plan = chaos.active()
        assert any(k == "burst_arrival" for k, _ in plan.fired)
    finally:
        chaos.disarm()
    res = eng.results
    for rid, (p, m) in rids.items():
        np.testing.assert_array_equal(res[rid]["tokens"], ref(p, m))


# ---------------------------------------------------------------------------
# metrics edge cases + goodput accounting
# ---------------------------------------------------------------------------

def test_percentiles_total_over_edge_cases():
    assert _pct([], .5) is None and _pct([], .95) is None
    assert _pct([3.0], .5) == 3.0 and _pct([3.0], .95) == 3.0
    assert _pct([1.0, 2.0], 0.0) == 1.0
    assert _pct([1.0, 2.0], 1.0) == 2.0
    assert _pct([1.0, 2.0], 7.5) == 2.0      # clamped, not an IndexError
    m = ServingMetrics(clock=lambda: 0.0)
    rep = m.report()                          # nothing recorded: no raise
    assert rep["ttft_s"]["p95"] is None
    assert rep["throughput"]["tokens_per_slot_step"] is None
    assert rep["throughput"]["goodput_tokens_per_slot_step"] is None
    m.record_submit(0)
    m.record_token(0)
    rep = m.report()                          # single sample: no raise
    assert rep["ttft_s"]["p50"] == rep["ttft_s"]["p95"]


def test_goodput_distinguishes_finished_from_aborted_tokens():
    t = [0.0]
    m = ServingMetrics(clock=lambda: t[0])
    for rid in (1, 2):
        m.record_submit(rid)
        for _ in range(4):
            t[0] += 1.0
            m.record_token(rid)
    m.record_step(queue_depth=0, running=2, slots=4, occupancy=.5,
                  fragmentation=0., decoded=True)
    m.record_finish(1, "finished")
    m.record_finish(2, "shed")
    rep = m.report()
    assert rep["tokens"]["generated"] == 8
    assert rep["tokens"]["useful"] == 4
    assert rep["tokens"]["wasted"] == 4
    assert rep["throughput"]["useful_fraction"] == pytest.approx(0.5)
    assert rep["throughput"]["goodput_tokens_per_slot_step"] \
        == pytest.approx(rep["throughput"]["tokens_per_slot_step"] / 2)
    assert rep["requests"]["aborted"] == {"shed": 1}
    t[0] += 1.0
    m.record_step(queue_depth=0, running=0, slots=4, occupancy=.0,
                  fragmentation=0., decoded=False)
    assert m.step_time() == pytest.approx(1.0)


def test_reliability_report_and_last_metrics_idiom(toy):
    model, params, _, _ = toy
    eng = _engine(model, params)
    eng.submit(_prompts(18, (5,))[0], max_new_tokens=4)
    eng.serve(max_steps=100)
    rel = eng.serving_report()["reliability"]
    assert set(rel) >= {"armed", "aborts", "admission", "journal_depth",
                        "draining"}
    assert rel["aborts"] == {"expired": 0, "budget": 0, "shed": 0,
                             "poisoned": 0}
    assert not rel["armed"]["shedding"] and not rel["armed"]["journal"]
    lm = eng._last_metrics
    for key in ("shed", "expired", "poisoned", "journal_depth",
                "draining"):
        assert key in lm, key
    assert set(lm["events"]) >= {"expired", "budget", "poisoned"}


# ---------------------------------------------------------------------------
# sampling edges (tests/unit/test_sampling.py)
# ---------------------------------------------------------------------------

def _draws(logits, n, temperature, top_k, top_p):
    rows = torch.as_tensor(logits, dtype=torch.float32) \
        .repeat_interleave(n, dim=0)
    seeds = torch.arange(rows.shape[0], dtype=torch.int64)
    return _sample(rows, seeds, torch.zeros_like(seeds), temperature, top_k,
                   top_p).reshape(len(logits), n)


def test_top_k_one_is_greedy():
    """top_k=1 at any temperature can only emit the argmax token."""
    logits = np.random.default_rng(0).normal(size=(4, 23)) \
        .astype(np.float32)
    want = logits.argmax(-1)
    got = _draws(logits, 25, 1.3, 1, 0.0).numpy()
    assert (got == want[:, None]).all()


def test_top_p_exact_mass_boundary_excludes_next_token():
    """With probs (0.5, 0.3, 0.2) and top_p=0.5 the second token's
    exclusive mass is exactly 0.5 — NOT < 0.5 — so only the top token
    survives."""
    logits = np.log(np.array([[0.5, 0.3, 0.2]])).astype(np.float32)
    assert set(_draws(logits, 50, 1.0, 0, 0.5)[0].tolist()) == {0}


def test_top_p_keeps_ties_at_the_cutoff():
    """Two tokens with IDENTICAL logits at the nucleus cutoff: the filter
    keeps both (>= cutoff) and still excludes the tail."""
    logits = np.array([[2.0, 2.0, -1.0]], np.float32)
    assert set(_draws(logits, 200, 1.0, 0, 0.45)[0].tolist()) == {0, 1}


@pytest.fixture(scope="module")
def tiny():
    # the reference's pinned seeds: beam-4 finds a strictly more likely
    # continuation than greedy on this (model, prompt) pair
    kw = dict(vocab_size=13, n_positions=16, n_embd=8, n_layer=1, n_head=2)
    jm = JGPT2Model(JGPT2Config(dtype=jnp.float32, loss_chunk_tokens=0,
                                **kw))
    ids = np.random.default_rng(0).integers(0, 13, (1, 3))
    jparams = jm.init(jax.random.PRNGKey(0),
                      {"input_ids": ids, "labels": ids})
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    model = GPT2Model(GPT2Config(dtype=torch.float32, loss_chunk_tokens=0,
                                 **kw))
    prompt = np.random.default_rng(101).integers(0, 13, (1, 3))
    return model, tree, prompt


def test_eos_on_first_token_stops_immediately(tiny):
    model, tree, prompt = tiny
    base = generate(model, tree, prompt, max_new_tokens=4, device="cpu")
    eos = int(base[0, 3])                 # the first greedy token
    out = generate(model, tree, prompt, max_new_tokens=4, eos_token_id=eos,
                   device="cpu")
    assert out.shape == base.shape
    np.testing.assert_array_equal(out[0, 3:], [eos] * 4)


def _continuation_logp(model, tree, seq, s0):
    from deepspeed_tpu_torch.models.convert import params_from_jax

    model.load_state_dict(params_from_jax(tree, model.config))
    with torch.no_grad():
        logits = model(torch.as_tensor(seq).long())
    lp = torch.log_softmax(logits, dim=-1)
    tgt = torch.as_tensor(seq[:, 1:]).long()
    tok = torch.take_along_dim(lp[:, :-1], tgt[..., None], -1)[..., 0]
    return float(tok[:, s0 - 1:].sum(dim=-1)[0])


def test_beam_beats_greedy_on_forced_distribution(tiny):
    """Greedy takes a locally-best token that leads to a worse
    continuation; beam-4 returns a DIFFERENT sequence with strictly
    higher total log-probability."""
    model, tree, prompt = tiny
    greedy = generate(model, tree, prompt, max_new_tokens=5, device="cpu")
    beam = generate_beam(model, tree, prompt, max_new_tokens=5,
                         num_beams=4, device="cpu")
    assert not np.array_equal(greedy, beam), \
        "seeds regressed: beam == greedy, the test forces nothing"
    g = _continuation_logp(model, tree, greedy, 3)
    b = _continuation_logp(model, tree, beam, 3)
    assert b > g, (b, g)


def test_negative_top_k_rejected(tiny):
    model, tree, prompt = tiny
    with pytest.raises(AssertionError, match="top_k"):
        generate(model, tree, prompt, max_new_tokens=2, temperature=1.0,
                 top_k=-3, device="cpu")
    with pytest.raises(AssertionError, match="temperature"):
        generate(model, tree, prompt, max_new_tokens=2, temperature=-0.5,
                 device="cpu")


# ---------------------------------------------------------------------------
# against the JAX package's engine
# ---------------------------------------------------------------------------

def _serve_on_step_clock(engine_cls, model, params, kind, **extra):
    """One traffic scenario on a step clock; returns (tokens by request,
    prefill tokens computed, evictions, engine steps, decode steps)."""
    clock = StepClock()
    kw = dict(max_slots=3, kv_block_size=4, prefill_chunk=8,
              max_blocks_per_seq=8, clock=clock)
    kw.update(extra)
    if kind == "eviction":
        kw.update(max_slots=2, kv_blocks=9)
    eng = engine_cls(model, params, **kw)
    prompts = _prompts(30, (5, 11, 3, 9, 6) if kind != "eviction"
                       else (9, 10, 7))
    maxnew = [6, 9, 12, 5, 8] if kind != "eviction" else [12, 12, 10]
    rids = []
    for i, (p, m) in enumerate(zip(prompts, maxnew)):
        rids.append(eng.submit(p, max_new_tokens=m, priority=i % 2))
        eng.step()
        clock.t += 1.0
    while eng.scheduler.has_work():
        eng.step()
        clock.t += 1.0
    rep = eng.serving_report()
    return ({r: np.asarray(eng.results[r]["tokens"]).tolist()
             for r in rids},
            rep["prefix_cache"]["prefill_tokens_computed"],
            rep["requests"]["evictions"], rep["steps"]["total"],
            rep["steps"]["decode"], rep["ttft_s"]["p95"], rep["tpot_s"])


@pytest.mark.parametrize("kind", ["staggered", "eviction"])
def test_same_traffic_as_the_jax_engine(toy, kind):
    """Greedy tokens, prefill tokens computed, evictions, step counts and
    the step-clock TTFT/TPOT all equal the JAX engine's."""
    model, tree, _, (jm, jparams) = toy
    want = _serve_on_step_clock(JEngine, jm, jparams, kind)
    got = _serve_on_step_clock(InferenceEngine, model, tree, kind,
                               device="cpu")
    assert got == want
    if kind == "eviction":
        assert got[2] >= 1


def a10b_counters(eng):
    """The step-clock counters the prefix cache, speculation and sparse
    context tests hold the port's engine to the JAX engine's with."""
    rep = eng.serving_report()
    now, pc = rep["kv_pool"]["now"], rep["prefix_cache"]
    sp, sc = rep["speculative"], rep["sparse_context"]
    return {
        "prefill_tokens_computed": pc["prefill_tokens_computed"],
        "prefix_lookups": pc["lookups"], "prefix_hits": pc["hits"],
        "avoided_prefill_tokens": pc["avoided_prefill_tokens"],
        "readmit_avoided": pc["readmit_avoided_prefill_tokens"],
        "cow_splits": now["prefix_cow_splits"],
        "cache_reclaims": now["prefix_cache_reclaims"],
        "cached_blocks": now["prefix_cached_blocks"],
        "shared_refs": now["prefix_shared_refs"],
        "verify_steps": sp["verify_steps"],
        "accepted_tokens": sp["accepted_tokens"],
        "accept_len_hist": {int(k): int(v)
                            for k, v in sp["accept_len_hist"].items()},
        "gathered_pages": sc["gathered_pages"],
        "dense_equivalent_pages": sc["dense_equivalent_pages"],
        "active_pages_per_lane_step": sc["active_pages_per_lane_step"],
        "window_expired_frees": sc["window_expired_frees"],
        "pool_window_frees": now["window_expired_frees"],
        "evictions": rep["requests"]["evictions"],
        "steps": rep["steps"]["total"], "decode_steps": rep["steps"]["decode"],
    }


def serve_both(toy, prompts, maxnew, *, stagger=2, **kw):
    """The same traffic through the JAX engine and the port's, each on a
    step clock (``stagger`` steps after each submit, then to the end).
    The port's tokens and statuses must equal the JAX engine's bit for
    bit and its :func:`a10b_counters` must equal the JAX engine's.
    Returns (port engine, tokens by request)."""
    model, tree, _, (jm, jparams) = toy
    runs = []
    for cls, m, p, extra in ((JEngine, jm, jparams, {}),
                             (InferenceEngine, model, tree,
                              {"device": "cpu"})):
        clock = StepClock()
        args = dict(max_slots=3, kv_block_size=4, prefill_chunk=8,
                    max_blocks_per_seq=8, clock=clock)
        args.update(kw)
        args.update(extra)
        eng = cls(m, p, **args)
        rids = []
        for prompt, n in zip(prompts, maxnew):
            rids.append(eng.submit(prompt, max_new_tokens=n))
            for _ in range(stagger):
                eng.step()
                clock.t += 1.0
        while eng.scheduler.has_work():
            eng.step()
            clock.t += 1.0
        runs.append((eng, [np.asarray(eng.results[r]["tokens"]).tolist()
                           for r in rids],
                     [eng.results[r]["status"] for r in rids]))
    (jeng, jtoks, jstat), (eng, toks, stat) = runs
    assert toks == jtoks
    assert stat == jstat
    assert a10b_counters(eng) == a10b_counters(jeng)
    return eng, toks


# ---------------------------------------------------------------------------
# deferred options
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,item", [
    (dict(shards=2), "A10c"),
    (dict(mesh=object()), "A10c"),
])
def test_deferred_options_raise_naming_their_roadmap_item(toy, kw, item):
    model, params, _, _ = toy
    with pytest.raises(NotImplementedError, match=item):
        _engine(model, params, **kw)


@pytest.mark.parametrize("call,item", [
    # telemetry, traces and the memory report run since A17 was ported
    # (tests/test_torch_telemetry.py), the program registry since A17b
    # (tests/test_torch_programs.py): it returns the registry (item None)
    pytest.param(lambda e: e.program_registry, None, id="call3-A17"),
    pytest.param(lambda e: e.export_request(0), "A10c", id="call4-A10c"),
    pytest.param(lambda e: e.import_request({}), "A10c", id="call5-A10c"),
])
def test_deferred_methods_raise_naming_their_roadmap_item(toy, call, item):
    model, params, _, _ = toy
    eng = _engine(model, params)
    if item is None:
        from deepspeed_tpu_torch.telemetry import ProgramRegistry

        reg = call(eng)
        assert isinstance(reg, ProgramRegistry) and reg.engine == "serving"
        return
    with pytest.raises(NotImplementedError, match=item):
        call(eng)


def test_moe_config_keeps_the_reference_assertion(toy):
    """A MoE GPT-2 is built and decoded by generate() in the port, but the
    serving engine refuses one as the reference's does (chunked prefill
    would change its capacity gating)."""
    model = GPT2Model(GPT2Config(dtype=torch.float32, moe_num_experts=4,
                                 **TOY))
    assert model.h[1].use_moe
    with pytest.raises(AssertionError, match="dense blocks only"):
        InferenceEngine(model, device="cpu")


def test_engine_defaults_to_the_card():
    """No device: the engine takes the card, and without one it raises
    rather than running on the CPU unasked."""
    model = GPT2Model(GPT2Config(dtype=torch.float32, loss_chunk_tokens=0,
                                 **TOY))
    if torch.cuda.is_available():
        assert InferenceEngine(model).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            InferenceEngine(model)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            generate(model, None, np.zeros((1, 3), np.int32), 2)


def test_serving_import_loads_no_jax():
    code = ("import sys, deepspeed_tpu_torch.serving, "
            "deepspeed_tpu_torch.models.generation; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'deepspeed_tpu')]; assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
