"""Self-speculative draft-verify decoding of the PyTorch port (ROADMAP
A10b).

Mirrors the speculation cases of the JAX package's
tests/unit/test_serving.py on the port's engine, on the ``toy`` fixture
of test_torch_serving.py (CPU, fp32):

- greedy tokens with ``speculative=k`` equal the port's ``generate()``
  and the JAX ``InferenceEngine``'s, and the step-clock counters
  (verify steps, accepted tokens, the accept-length histogram, gathered
  pages, evictions, steps) equal the JAX engine's;
- chaos cancellation between draft and verify leaves clean prefixes;
  rigged drafters (an oracle, a constant) move the histogram and never
  the tokens; poisoned lanes are quarantined alone;
- the verify dispatch keeps its one signature after ``warmup()`` and
  lanes near capacity write nothing past their page table;
- sampling and a draft length below 1 disarm with a warning.

Tolerance: exact everywhere (tokens, counters, histograms).
"""
import logging

import numpy as np
import pytest
from test_torch_serving import (_engine, _Propagate, _prompts,  # noqa: F401
                                serve_both, toy)

from deepspeed_tpu_torch.runtime.resilience import chaos
from deepspeed_tpu_torch.serving.engine import _accepted


def _shared_prefix_prompts(seed, n, prefix_len=16, tail=(2, 5)):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, 97, prefix_len).astype(np.int32)
    return [np.concatenate(
        [prefix, rng.integers(0, 97,
                              int(rng.integers(*tail))).astype(np.int32)])
        for _ in range(n)]


@pytest.mark.parametrize("k", [1, 3, 5])
def test_spec_parity_with_generate_and_the_jax_engine(toy, k):
    """The reference's cache-off/spec-on matrix cell at three draft
    lengths: staggered traffic gives generate()'s tokens bit for bit, and
    the verify counters and histogram equal the JAX engine's."""
    _, _, ref, _ = toy
    prompts = _shared_prefix_prompts(21, 5)
    maxnew = [6, 9, 4, 7, 5]
    eng, toks = serve_both(toy, prompts, maxnew, speculative=k)
    for t, p, m in zip(toks, prompts, maxnew):
        np.testing.assert_array_equal(t, ref(p, m))
    rep = eng.serving_report()
    assert rep["config"]["speculative_draft_len"] == k
    sp = rep["speculative"]
    assert sp["verify_steps"] > 0
    assert sum(a * n for a, n in sp["accept_len_hist"].items()) \
        == sp["accepted_tokens"] == sum(maxnew) - len(prompts)
    assert max(sp["accept_len_hist"]) <= k + 1
    assert eng._last_metrics["spec_accept_hist"] == sp["accept_len_hist"]


def test_spec_parity_under_eviction_as_the_jax_engine(toy):
    """Speculative growth (up to k+1 positions a step) under a pool that
    must evict: tokens equal generate()'s and the JAX engine's."""
    _, _, ref, _ = toy
    prompts = _prompts(30, (9, 10, 7))
    eng, toks = serve_both(toy, prompts, [12, 12, 10], stagger=1,
                           max_slots=2, kv_blocks=9, speculative=3)
    for t, p, m in zip(toks, prompts, [12, 12, 10]):
        np.testing.assert_array_equal(t, ref(p, m))
    assert eng.serving_report()["requests"]["evictions"] >= 1


def test_parity_chaos_cancel_mid_draft(toy):
    """Chaos cancellation landing between draft and verify: survivors
    stay bit-identical, cancelled requests report a clean prefix of the
    reference continuation (no half-accepted draft)."""
    model, params, ref, _ = toy
    eng = _engine(model, params, prefix_cache=True, speculative=3)
    prompts = _shared_prefix_prompts(24, 5, prefix_len=12)
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
    assert eng.metrics.spec_verify_steps > 0
    finished = cancelled = 0
    for rid, p, m in zip(rids, prompts, maxnew):
        r = res[rid]
        if r["status"] == "cancelled":
            cancelled += 1
            np.testing.assert_array_equal(
                r["tokens"], ref(p, m)[:len(r["tokens"])])
        else:
            finished += 1
            np.testing.assert_array_equal(r["tokens"], ref(p, m))
    assert cancelled >= 1 and finished >= 1


@pytest.mark.parametrize("drafter", ["oracle", "constant"])
def test_spec_acceptance_histogram_rigged_drafter(toy, drafter):
    """An oracle drafter accepts full k+1 windows (but at the request
    budget's tail); a constant drafter degrades toward 1 token per
    verify; both stay bit-identical, because acceptance re-verifies
    every draft."""
    model, params, ref, _ = toy
    prompts = _prompts(25, (5, 7, 4))
    maxnew = [9, 8, 10]
    eng = _engine(model, params, speculative=3)
    if drafter == "oracle":
        def draft(req, k):
            full = ref(req.prompt, req.max_new_tokens)
            done = len(req.full_tokens)
            nxt = [int(t) for t in full[done:done + k]]
            while len(nxt) < k:
                nxt.append(int(full[-1]))
            return nxt
        eng._draft_tokens = draft
    else:
        eng._draft_tokens = lambda req, k: [96] * k
    rids = [eng.submit(p, max_new_tokens=m) for p, m in zip(prompts, maxnew)]
    res = eng.serve(max_steps=500)
    for rid, p, m in zip(rids, prompts, maxnew):
        np.testing.assert_array_equal(res[rid]["tokens"], ref(p, m))
    hist = dict(eng.metrics.spec_accept_hist)
    # each request's FIRST token comes from the final prefill chunk, so
    # the verifies deliver max_new - 1 tokens per request
    assert sum(a * n for a, n in hist.items()) \
        == eng.metrics.spec_accepted_tokens == sum(maxnew) - len(prompts)
    if drafter == "oracle":
        assert max(hist) == 4, hist          # full k+1 windows accepted
        assert eng.metrics.tokens_per_verify() > 2.0, hist
    else:
        assert hist.get(1, 0) > 0
        assert eng.metrics.tokens_per_verify() < 2.0, hist


def test_accepted_is_the_matched_prefix_plus_the_bonus():
    row = np.array([5, 6, 7, 8])
    assert _accepted(np.array([5, 6, 7]), row, 4) == 4   # all drafts + bonus
    assert _accepted(np.array([5, 9, 7]), row, 4) == 2   # stops at a miss
    assert _accepted(np.array([1, 6, 7]), row, 4) == 1   # bonus only
    assert _accepted(np.array([5, 6, 7]), row, 2) == 2   # the budget caps


def test_spec_lanes_near_capacity_stay_inside_their_table(toy):
    """Requests whose last verify windows reach past the page table
    (prompt + max_new == capacity) mask those positions to the trash
    block and still equal generate()'s tokens."""
    model, params, ref, _ = toy
    eng = _engine(model, params, speculative=5)
    cap = eng.capacity_per_seq
    prompts = _prompts(31, (cap - 12, cap - 7, 5))
    maxnew = [12, 7, cap - 5]
    rids = [eng.submit(p, max_new_tokens=m) for p, m in zip(prompts, maxnew)]
    res = eng.serve(max_steps=500)
    for rid, p, m in zip(rids, prompts, maxnew):
        assert len(res[rid]["tokens"]) == len(p) + m
        np.testing.assert_array_equal(res[rid]["tokens"], ref(p, m))
    assert eng.pool.blocks_in_use == 0


def test_spec_poison_quarantines_one_lane(toy):
    """NaN injected into one lane of a verify dispatch aborts that
    request alone; its peers finish with generate()'s tokens."""
    model, params, ref, _ = toy
    eng = _engine(model, params, speculative=3)
    prompts = _prompts(13, (5, 7, 6))
    chaos.arm(poison_logits_at_step=5)
    try:
        rids = [eng.submit(p, max_new_tokens=10) for p in prompts]
        res = eng.serve(max_steps=300)
        bad = [rid for k, rid in chaos.active().fired
               if k == "poison_logits"]
    finally:
        chaos.disarm()
    assert len(bad) == 1 and res[bad[0]]["status"] == "poisoned"
    for rid, p in zip(rids, prompts):
        if rid != bad[0]:
            assert res[rid]["status"] == "finished"
            np.testing.assert_array_equal(res[rid]["tokens"], ref(p, 10))


def test_spec_verify_keeps_one_signature_after_warmup(toy):
    model, params, ref, _ = toy
    eng = _engine(model, params, speculative=3)
    eng.warmup()
    sigs = dict(eng.dispatch_shapes.signatures)
    assert "spec_verify" in eng.dispatch_shapes.names()
    assert "decode_step" not in eng.dispatch_shapes.names()
    ptrs = [t.data_ptr() for t in eng.pool.tensors.arrays]
    prompts = _prompts(32, (5, 11, 3, 9, 6))
    rids = []
    for p in prompts:
        rids.append(eng.submit(p, max_new_tokens=7))
        eng.step()
    eng.serve(max_steps=300)
    assert set(eng.dispatch_shapes.signatures) == set(sigs)
    assert [t.data_ptr() for t in eng.pool.tensors.arrays] == ptrs
    for rid, p in zip(rids, prompts):
        np.testing.assert_array_equal(eng.results[rid]["tokens"], ref(p, 7))


@pytest.mark.parametrize("kw,blocker", [
    (dict(speculative=3, temperature=0.7, top_k=5), "temperature"),
    (dict(speculative={"draft_len": 0}), "draft_len=0"),
])
def test_spec_disarms_with_a_warning(toy, caplog, kw, blocker):
    """Sampling breaks the bit-identical greedy acceptance rule, and a
    draft length below 1 drafts nothing: speculation warns DISARMED
    naming the blocker and the engine serves the plain decode step."""
    model, params, _, _ = toy
    with _Propagate(), caplog.at_level(logging.WARNING):
        eng = _engine(model, params, **kw)
    assert eng.spec_k == 0
    assert any("speculative decoding: DISARMED" in r.message
               and blocker in r.message for r in caplog.records)
    eng.submit(_prompts(33, (5,))[0], max_new_tokens=3, seed=1)
    eng.serve(max_steps=100)
    assert "spec_verify" not in eng.dispatch_shapes.names()
    assert eng.metrics.spec_verify_steps == 0
