"""The serving prefix cache of the PyTorch port (ROADMAP A10b).

Mirrors the prefix-cache cases of the JAX package's
tests/unit/test_serving.py on the port's engine and pool, on the ``toy``
fixture of test_torch_serving.py (CPU, fp32):

- greedy tokens with ``prefix_cache=True`` (alone and with speculation)
  equal the port's ``generate()`` and the JAX ``InferenceEngine``'s, and
  the step-clock counters (prefill tokens computed, lookups, hits, COW
  splits, reclaims, evictions, steps) equal the JAX engine's;
- the radix tree of the port's ``PagedKVPool`` gives the same block ids,
  refcounts, free lists and counters as the JAX pool under the same
  sequence of operations, and its COW split copies the rows in place;
- after ``warmup()`` cache churn (COW splits included) adds no dispatch
  signature and the pool tensors never move;
- each DISARMED case of the JAX engine disarms here with a warning.

Tolerance: exact everywhere (tokens, counters, block ids, row copies).
"""
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_serving import (_engine, _Propagate, _prompts,  # noqa: F401
                                a10b_counters, serve_both, toy)

from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.serving.kv_cache import PagedKVPool as JPagedKVPool
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from deepspeed_tpu_torch.serving import InferenceEngine, PagedKVPool
from deepspeed_tpu_torch.serving.kv_cache import TRASH_BLOCK


def _shared_prefix_prompts(seed, n, prefix_len=16, tail=(2, 5)):
    """System-prompt traffic in miniature: one shared prefix, short
    random tails (the reference's ``_shared_prefix_prompts``)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, 97, prefix_len).astype(np.int32)
    return [np.concatenate(
        [prefix, rng.integers(0, 97,
                              int(rng.integers(*tail))).astype(np.int32)])
        for _ in range(n)]


@pytest.mark.parametrize("spec", [None, 3])
def test_cache_parity_with_generate_and_the_jax_engine(toy, spec):
    """The reference's cache/spec matrix cells with the cache armed:
    staggered shared-prefix traffic gives generate()'s tokens bit for
    bit, and every counter equals the JAX engine's."""
    _, _, ref, _ = toy
    prompts = _shared_prefix_prompts(21, 5)
    maxnew = [6, 9, 4, 7, 5]
    eng, toks = serve_both(toy, prompts, maxnew, prefix_cache=True,
                           speculative=spec)
    for t, p, m in zip(toks, prompts, maxnew):
        np.testing.assert_array_equal(t, ref(p, m))
    rep = eng.serving_report()
    assert rep["config"]["prefix_cache"] is True
    assert rep["prefix_cache"]["hits"] >= 1
    assert rep["prefix_cache"]["avoided_prefill_tokens"] > 0
    if spec:
        assert rep["speculative"]["verify_steps"] > 0


def test_prefix_cache_prefill_ratio_guard(toy):
    """The reference's tier-1 gate: the radix cache computes >= 2x fewer
    prefill tokens than the cache-off run of the SAME traffic, with
    generate()'s tokens in both and the JAX engine's counters."""
    _, _, ref, _ = toy
    prompts = _shared_prefix_prompts(22, 6)
    maxnew = [4, 6, 3, 5, 4, 6]
    computed = {}
    for cache in (False, True):
        eng, toks = serve_both(toy, prompts, maxnew, stagger=0,
                               prefix_cache=cache)
        for t, p, m in zip(toks, prompts, maxnew):
            np.testing.assert_array_equal(t, ref(p, m))
        computed[cache] = eng.metrics.prefill_computed_tokens
    assert computed[False] == sum(len(p) for p in prompts)
    assert computed[False] >= 2 * computed[True], computed


def test_prefix_cache_parity_under_shared_block_eviction(toy):
    """A pool too small for the working set evicts while shared blocks
    are live: tree blocks survive their owner's eviction (the re-prefill
    re-attaches them), COW splits keep private writes off shared storage,
    and every token equals generate()'s and the JAX engine's."""
    _, _, ref, _ = toy
    prompts = _shared_prefix_prompts(23, 4, prefix_len=10, tail=(2, 4))
    eng, toks = serve_both(toy, prompts, [16] * 4, stagger=0, max_slots=2,
                           kv_blocks=10, prefix_cache=True)
    for t, p in zip(toks, prompts):
        np.testing.assert_array_equal(t, ref(p, 16))
    rep = eng.serving_report()
    assert rep["requests"]["evictions"] >= 1, \
        "pool sizing failed to exercise eviction under sharing"
    assert rep["prefix_cache"]["hits"] >= 1
    assert rep["kv_pool"]["now"]["prefix_cow_splits"] >= 1


def _tree_state(pool):
    """Everything the allocator and the radix tree decide: page lists,
    shared lists, free lists, (block -> tokens, refs, parent block) of
    every node, and the counters."""
    nodes = {b: (n.tokens, n.refs,
                 None if n.parent is None else n.parent.block)
             for b, n in pool._nodes[0].items()}
    return (dict(pool._blocks), dict(pool._shared),
            [list(f) for f in pool._free], nodes, pool.cow_splits,
            pool.cache_reclaims, pool.window_frees, pool.blocks_in_use)


def _pools(num_blocks=10, quantize_kv=False):
    kw = dict(vocab_size=32, n_positions=64, n_embd=16, n_layer=1,
              n_head=2, loss_chunk_tokens=0)
    port = PagedKVPool(GPT2Config(dtype=torch.float32, **kw),
                       num_blocks=num_blocks, block_size=4,
                       quantize_kv=quantize_kv, device="cpu")
    ref = JPagedKVPool(JGPT2Config(dtype=jnp.float32, **kw),
                       num_blocks=num_blocks, block_size=4,
                       quantize_kv=quantize_kv)
    return port, ref


def test_pool_radix_refcount_cow_and_reclaim_as_the_jax_pool():
    """The reference's radix unit (exact-match sharing, the COW split of
    the divergent block, refcounts pinning shared blocks across free(),
    LRU reclaim of unreferenced leaves), each operation applied to the
    port's pool and the JAX pool: block ids, refcounts, free lists and
    counters equal after every one."""
    port, ref = _pools()
    toks0 = tuple(range(12))                 # 3 full blocks
    toks1 = toks0[:10] + (31, 30)            # diverges inside block 3
    toks2 = toks0[:6] + (29,) * 6            # block 1, COW of block 2
    ops = [
        lambda p: p.alloc(0, 0, 12),
        lambda p: p.prefix_insert(0, 0, toks0),
        lambda p: (lambda f: (len(f[0]), f[2]))(p.prefix_lookup(0, toks1)),
        lambda p: p.prefix_attach(1, 0, toks1),
        lambda p: p.blocks_of(1),
        lambda p: p.alloc(1, 0, 14),
        lambda p: p.prefix_attach(2, 0, toks2),
        lambda p: p.free(0),
        lambda p: tuple(p.table_row(1, 4)),
        lambda p: p.prefix_insert(1, 0, toks1),
        lambda p: p.free(1),
        lambda p: p.free(2),
        lambda p: p.cached_blocks(),
        lambda p: p.alloc(3, 0, 36),         # needs the tree's blocks
        lambda p: p.stats()["prefix_cache_reclaims"],
        lambda p: p.free(3),
    ]
    for i, op in enumerate(ops):
        assert op(port) == op(ref), i
        assert _tree_state(port) == _tree_state(ref), i
    assert port.cow_splits == 2 and port.cache_reclaims >= 3
    assert port.cached_blocks() == 0
    keys = ("prefix_cached_blocks", "prefix_shared_refs",
            "prefix_cow_splits", "prefix_cache_reclaims",
            "window_expired_frees", "blocks_in_use", "free_per_shard")
    sp, sr = port.stats(), ref.stats()
    assert {k: sp[k] for k in keys} == {k: sr[k] for k in keys}


@pytest.mark.parametrize("quantize_kv", [False, True])
def test_cow_split_copies_every_pool_tensor_in_place(quantize_kv):
    """The COW split copies the source block's rows into the private
    block in every pool tensor (k, v and, under int8 KV, both scales),
    leaves every other block as it was, and moves no storage."""
    port, _ = _pools(quantize_kv=quantize_kv)
    assert port.quantized == quantize_kv
    gen = torch.Generator().manual_seed(0)
    for t in port.tensors.arrays:
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen,
                                  dtype=torch.int8))
        else:
            t.copy_(torch.randn(t.shape, generator=gen))
    assert port.alloc(0, 0, 8)
    assert port.prefix_insert(0, 0, tuple(range(8))) == 2
    before = [t.clone() for t in port.tensors.arrays]
    ptrs = [t.data_ptr() for t in port.tensors.arrays]
    src = port._blocks[0][1]
    assert port.prefix_attach(1, 0, tuple(range(6)) + (9, 9)) == 6
    dst = port._blocks[1][1]
    assert dst not in (src, TRASH_BLOCK) and port.cow_splits == 1
    assert [t.data_ptr() for t in port.tensors.arrays] == ptrs
    for t, b in zip(port.tensors.arrays, before):
        assert torch.equal(t[:, dst], b[:, src])
        keep = [i for i in range(t.shape[1]) if i != dst]
        assert torch.equal(t[:, keep], b[:, keep])


def test_no_new_dispatch_signature_with_cache_and_spec(toy):
    """Join/leave churn with the prefix cache AND speculation armed adds
    no dispatch signature after warmup (COW splits included), the pool
    never moves, and the tokens equal generate()'s."""
    model, params, ref, _ = toy
    eng = _engine(model, params, prefix_cache=True, speculative=3)
    eng.warmup()
    sigs = dict(eng.dispatch_shapes.signatures)
    assert {"cow_copy", "spec_verify"} <= set(eng.dispatch_shapes.names())
    ptrs = [t.data_ptr() for t in eng.pool.tensors.arrays]
    # prefix 14 = 3 full shareable blocks + a 2-position COW overlap
    prompts = _shared_prefix_prompts(26, 6, prefix_len=14)
    maxnew = [6, 9, 12, 5, 8, 7]
    rids = []
    for p, m in zip(prompts, maxnew):
        rids.append(eng.submit(p, max_new_tokens=m))
        eng.step()
        eng.step()
    eng.serve(max_steps=500)
    assert set(eng.dispatch_shapes.signatures) == set(sigs)
    assert eng.dispatch_shapes.signatures[
        next(s for s in sigs if s[0] == "cow_copy")] > 1
    assert eng.pool.cow_splits >= 1
    assert [t.data_ptr() for t in eng.pool.tensors.arrays] == ptrs
    for rid, p, m in zip(rids, prompts, maxnew):
        np.testing.assert_array_equal(eng.results[rid]["tokens"],
                                      ref(p, m))


def test_recovery_readmission_reuses_cached_prefix(toy, tmp_path):
    """A journal replay re-prefills through the admission probe: the
    replayed requests attach the prompt blocks a cache-warming request
    left in the tree, the savings are attributed to the recovery path,
    and the continuations equal generate()'s."""
    model, params, ref, _ = toy
    journal = str(tmp_path / "journal.jsonl")
    prompts = _shared_prefix_prompts(27, 3, prefix_len=12)
    crashed = _engine(model, params, prefix_cache=True,
                      reliability={"journal_path": journal})
    rids = [crashed.submit(p, max_new_tokens=6) for p in prompts]
    for _ in range(4):
        crashed.step()
    eng = _engine(model, params, prefix_cache=True)
    warm = eng.submit(prompts[0], max_new_tokens=2)
    eng.serve(max_steps=100)
    assert eng.recover(journal) == rids
    eng.serve(max_steps=300)
    for rid, p in zip(rids, prompts):
        np.testing.assert_array_equal(eng.results[rid]["tokens"],
                                      ref(p, 6))
    rep = eng.serving_report()["prefix_cache"]
    assert rep["readmit_avoided_prefill_tokens"] > 0
    assert eng.results[warm]["status"] == "finished"


def test_prefix_cache_disarms_on_disarmed_int8(caplog):
    """int8 KV requested but disarmed by the pool (head_dim 4 at bf16:
    the scale costs what int8 saves): the cache warns DISARMED naming
    int8 and serves without it."""
    model = GPT2Model(GPT2Config(vocab_size=32, n_positions=32, n_embd=8,
                                 n_layer=1, n_head=2, dtype=torch.bfloat16,
                                 loss_chunk_tokens=0))
    with _Propagate(), caplog.at_level(logging.WARNING):
        eng = InferenceEngine(model, max_slots=2, kv_block_size=4,
                              prefill_chunk=8, max_blocks_per_seq=4,
                              quantize_kv=True, prefix_cache=True,
                              device="cpu")
    assert not eng.pool.quantized and not eng.prefix_cache
    assert any("prefix cache: DISARMED" in r.message and "int8" in r.message
               for r in caplog.records)


def test_prefix_cache_disarms_while_draining(toy, caplog):
    model, params, _, _ = toy
    eng = _engine(model, params)
    eng.scheduler.draining = True
    with _Propagate(), caplog.at_level(logging.WARNING):
        armed = eng._arm_prefix_cache(True, False)
    assert not armed
    assert any("DISARMED" in r.message and "draining" in r.message
               for r in caplog.records)


def test_prefix_cache_counters_in_report_and_step_metrics(toy):
    """The report's prefix_cache section and step()'s metrics dict carry
    the reference's keys; a cache-off engine reports no lookups."""
    model, params, _, _ = toy
    prompts = _shared_prefix_prompts(28, 3)
    for cache in (False, True):
        eng = _engine(model, params, prefix_cache=cache)
        for p in prompts:
            eng.submit(p, max_new_tokens=3)
        eng.serve(max_steps=200)
        rep = eng.serving_report()
        assert set(rep["prefix_cache"]) == {
            "lookups", "hits", "hit_rate", "avoided_prefill_tokens",
            "readmit_avoided_prefill_tokens", "prefill_tokens_computed"}
        m = eng._last_metrics
        assert m["prefill_tokens_computed"] \
            == rep["prefix_cache"]["prefill_tokens_computed"]
        assert m["prefix_avoided_tokens"] \
            == rep["prefix_cache"]["avoided_prefill_tokens"]
        if cache:
            assert rep["prefix_cache"]["lookups"] == 3
            assert m["prefix_hit_rate"] == rep["prefix_cache"]["hit_rate"]
            assert a10b_counters(eng)["cached_blocks"] > 0
        else:
            assert rep["prefix_cache"]["lookups"] == 0
            assert m["prefix_hit_rate"] is None
