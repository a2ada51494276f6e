"""Sparse page context of the PyTorch port's serving engine (ROADMAP A10b).

Mirrors the JAX package's tests/unit/test_sparse_context.py on the
port's ``SparseContext``, pool and engine, on the ``toy`` fixture of
test_torch_serving.py (CPU, fp32):

- the port's LUTs, layouts, gather widths and active rows equal the JAX
  ``SparseContext``'s elementwise, and the rows agree with
  ``layout_to_token_mask`` over ``layout()`` at every query position;
- a window covering the whole table gives the dense engine's and
  ``generate()``'s tokens bit for bit; a narrow window gives the JAX
  engine's tokens and is invariant to the prefill chunk length; the
  gathered pages and window-expired frees equal the JAX engine's;
- window-expired frees leave holes and keep the anchors as the JAX pool
  does, and never free a block the prefix tree owns;
- the sparse dispatches keep their signatures after ``warmup()``;
- each DISARMED case of the JAX engine disarms here with a warning.

Tolerance: exact everywhere (tokens, counters, LUT entries, rows).
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
from deepspeed_tpu.serving.sparse_context import \
    SparseContext as JSparseContext
from deepspeed_tpu.serving.sparse_context import \
    _policy_layout as _jpolicy_layout
from deepspeed_tpu_torch.models.gpt2 import GPT2Config
from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import \
    layout_to_token_mask
from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
    BigBirdSparsityConfig, BSLongformerSparsityConfig)
from deepspeed_tpu_torch.serving import PagedKVPool
from deepspeed_tpu_torch.serving.kv_cache import TRASH_BLOCK
from deepspeed_tpu_torch.serving.sparse_context import (SparseContext,
                                                        _policy_layout)

POLICIES = [(4, 8, 3, 2), (4, 16, 3, 1), (4, 16, 2, 0), (16, 64, 16, 1),
            (8, 4, 8, 3)]


def _sparse_engine(model, params, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_blocks_per_seq", 16)
    return _engine(model, params, **kw)


# ---------------------------------------------------------------------------
# policy compilation against the JAX SparseContext
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bs,W,win,g", POLICIES)
def test_luts_layouts_and_rows_equal_the_jax_policy(bs, W, win, g):
    kw = dict(block_size=bs, table_width=W, num_sliding_window_blocks=win,
              num_global_blocks=g)
    p, j = SparseContext(**kw), JSparseContext(**kw)
    assert (p.K, int(p.sentinel)) == (j.K, int(j.sentinel))
    np.testing.assert_array_equal(p.lut, j.lut)
    np.testing.assert_array_equal(p.layout(), j.layout())
    np.testing.assert_array_equal(_policy_layout(win, g, W + 3),
                                  _jpolicy_layout(win, g, W + 3))
    assert p.describe() == j.describe()
    rng = np.random.default_rng(bs * W + win)
    table_row = rng.integers(1, 50, W).astype(np.int32)
    table_row[rng.random(W) < 0.25] = TRASH_BLOCK     # holes
    for pos in range(W * bs):
        assert p.first_active_block(pos) == j.first_active_block(pos)
        for a, b in zip(p.active_row(table_row, pos),
                        j.active_row(table_row, pos)):
            np.testing.assert_array_equal(a, b)
    for chunk in (4, 8, 16):
        assert p.prefill_K(chunk) == j.prefill_K(chunk)
        for start in range(0, W * bs, max(1, chunk // 2)):
            n = min(chunk, W * bs - start)
            for a, b in zip(p.prefill_active_row(table_row, start, n, chunk),
                            j.prefill_active_row(table_row, start, n,
                                                 chunk)):
                np.testing.assert_array_equal(a, b)


def test_lut_shape_and_causal_clipping():
    p = SparseContext(block_size=4, table_width=8,
                      num_sliding_window_blocks=3, num_global_blocks=2)
    assert p.K == 5 and p.lut.shape == (8, 5)
    assert p.lut[0].tolist() == [0, -1, -1, -1, -1]
    assert p.lut[1].tolist() == [0, 1, -1, -1, -1]
    assert p.lut[7].tolist() == [0, 1, 5, 6, 7]
    for qb in range(8):
        act = [b for b in p.lut[qb] if b >= 0]
        assert act == sorted(set(act)) and all(0 <= b <= qb for b in act)
    full = SparseContext(block_size=4, table_width=8,
                         num_sliding_window_blocks=8, num_global_blocks=3)
    assert full.K == 8
    for qb in range(8):
        assert [b for b in full.lut[qb] if b >= 0] == list(range(qb + 1))


def test_active_row_matches_layout_to_token_mask_reference():
    """Decode side: the token positions a lane's active row exposes
    (sentinel pads dropped, causally clipped) equal the port's
    ``layout_to_token_mask`` expansion of ``layout()`` at every query
    position."""
    bs, W = 4, 16
    p = SparseContext(block_size=bs, table_width=W,
                      num_sliding_window_blocks=3, num_global_blocks=2)
    mask = layout_to_token_mask(p.layout(W)[None], bs)[0].numpy()
    table_row = np.arange(1, W + 1, dtype=np.int32)
    for pos in range(W * bs):
        stables, sbase = p.active_row(table_row, pos)
        vis = {int(b) + o for b in sbase if b != p.sentinel
               for o in range(bs) if int(b) + o <= pos}
        assert vis == {j for j in range(pos + 1) if mask[pos, j]}, pos


def test_prefill_union_row_matches_token_mask_reference():
    """Prefill side: the chunk's union row restricted by the per-query
    layout mask equals the token mask reference for every query."""
    bs, W, C = 4, 16, 8
    p = SparseContext(block_size=bs, table_width=W,
                      num_sliding_window_blocks=3, num_global_blocks=1)
    mask = layout_to_token_mask(p.layout(W)[None], bs)[0].numpy()
    lay = p.layout(W) > 0
    table_row = np.arange(1, W + 1, dtype=np.int32)
    for start in range(0, W * bs - C, C):
        stables, sbase = p.prefill_active_row(table_row, start, C, C)
        assert len(stables) == p.prefill_K(C)
        for q in range(C):
            pos = start + q
            qb = min(pos // bs, W - 1)
            vis = {int(b) + o for b in sbase if b != p.sentinel
                   for o in range(bs)
                   if int(b) + o <= pos
                   and lay[qb, min((int(b) + o) // bs, W - 1)]}
            assert vis == {j for j in range(pos + 1) if mask[pos, j]}


def test_active_row_maps_holes_and_pads_to_trash_sentinel():
    p = SparseContext(block_size=4, table_width=8,
                      num_sliding_window_blocks=2, num_global_blocks=1)
    table_row = np.asarray([7, TRASH_BLOCK, TRASH_BLOCK, 5, 9, 0, 0, 0],
                           np.int32)
    stables, sbase = p.active_row(table_row, 17)     # query block 4
    assert stables.tolist() == [7, 5, 9]
    assert sbase.tolist() == [0, 12, 16]
    stables, sbase = p.active_row(table_row, 9)      # holes in-window
    assert stables.tolist() == [7, TRASH_BLOCK, TRASH_BLOCK]
    assert sbase.tolist() == [0, int(p.sentinel), int(p.sentinel)]


def test_from_the_ports_sparsity_configs():
    """The port's own BSLongformer / BigBird configs compile into the
    JAX policy's window and anchors; non-leading globals raise."""
    lf = BSLongformerSparsityConfig(num_heads=2, block=4,
                                    num_sliding_window_blocks=4,
                                    global_block_indices=[0],
                                    global_block_end_indices=[2])
    p = SparseContext.from_sparsity_config(lf, block_size=4, table_width=16)
    j = JSparseContext.from_sparsity_config(lf, block_size=4,
                                            table_width=16)
    assert (p.win, p.g) == (j.win, j.g) == (3, 2)
    np.testing.assert_array_equal(p.lut, j.lut)
    bb = BigBirdSparsityConfig(num_heads=2, block=4,
                               num_sliding_window_blocks=5)
    p = SparseContext.from_sparsity_config(bb, block_size=4, table_width=16)
    assert (p.win, p.g) == (3, 1)
    bad = BSLongformerSparsityConfig(num_heads=2, block=4,
                                     num_sliding_window_blocks=4,
                                     global_block_indices=[0, 5])
    with pytest.raises(ValueError, match="leading prefix"):
        SparseContext.from_sparsity_config(bad, block_size=4,
                                           table_width=16)


# ---------------------------------------------------------------------------
# engine parity
# ---------------------------------------------------------------------------

def test_full_window_sparse_is_bit_identical_to_dense(toy):
    """globals + window >= W makes every gather row the dense table:
    greedy tokens equal the dense engine's, generate()'s and the JAX
    sparse engine's, with its counters."""
    model, params, ref, _ = toy
    prompts = _prompts(3, (5, 11, 3, 9))
    maxnew = [6, 9, 12, 5]
    sc = {"num_sliding_window_blocks": 16, "num_global_blocks": 0}
    sparse, toks = serve_both(toy, prompts, maxnew, max_slots=2,
                              max_blocks_per_seq=16, sparse_context=sc)
    assert sparse.sparse is not None and sparse.sparse.K == 16
    dense = _sparse_engine(model, params)
    rids = [dense.submit(p, max_new_tokens=m)
            for p, m in zip(prompts, maxnew)]
    dense.serve(max_steps=500)
    for rid, t, p, m in zip(rids, toks, prompts, maxnew):
        np.testing.assert_array_equal(dense.results[rid]["tokens"], t)
        np.testing.assert_array_equal(t, ref(p, m))
    rep = sparse.serving_report()
    assert rep["config"]["sparse_context"]["active_pages_per_lane"] == 16
    assert rep["sparse_context"]["active_page_fraction"] == 1.0


def test_narrow_window_equals_the_jax_engine_and_ignores_chunking(toy):
    """A genuinely narrow window: the tokens equal the JAX sparse
    engine's (counters too) at prefill chunks of 8, 16 and 64, equal one
    another (per-query masking hides chunk boundaries), and part from
    the dense continuation once the prompt outgrows the window."""
    _, _, ref, _ = toy
    prompt = _prompts(5, (37,))[0]
    sc = {"num_sliding_window_blocks": 3, "num_global_blocks": 1}
    outs = []
    for chunk in (8, 16, 64):
        eng, toks = serve_both(toy, [prompt], [8], max_slots=2,
                               max_blocks_per_seq=16, prefill_chunk=chunk,
                               sparse_context=sc)
        outs.append(toks[0])
        frac = eng.serving_report()["sparse_context"]["active_page_fraction"]
        assert frac is not None and frac < 1.0
    assert outs[0] == outs[1] == outs[2]
    assert outs[0] != ref(prompt, 8).tolist()        # sparsity engaged


def test_narrow_window_staggered_traffic_as_the_jax_engine(toy):
    """Several lanes at once under a narrow window, with staggered
    arrivals: tokens, gathered pages and window frees equal the JAX
    engine's."""
    prompts = _prompts(7, (29, 11, 3, 40, 6))
    eng, _ = serve_both(toy, prompts, [6, 9, 12, 5, 7], max_slots=2,
                        max_blocks_per_seq=16,
                        sparse_context={"num_sliding_window_blocks": 2,
                                        "num_global_blocks": 1})
    c = a10b_counters(eng)
    assert c["window_expired_frees"] > 0
    assert c["gathered_pages"] < c["dense_equivalent_pages"]


def test_sparse_no_new_dispatch_signature_after_warmup(toy):
    model, params, _, _ = toy
    eng = _sparse_engine(model, params,
                         sparse_context={"num_sliding_window_blocks": 2,
                                         "num_global_blocks": 1})
    eng.warmup()
    sigs = dict(eng.dispatch_shapes.signatures)
    names = set(eng.dispatch_shapes.names())
    assert "sparse_decode_step" in names and "decode_step" not in names
    assert any(n.startswith("sparse_prefill_chunk") for n in names)
    assert not any(n.startswith("prefill_chunk") for n in names)
    ptrs = [t.data_ptr() for t in eng.pool.tensors.arrays]
    prompts = _prompts(7, (5, 11, 3, 9, 6, 40))
    for p in prompts:
        eng.submit(p, max_new_tokens=8)
        eng.step()
        eng.step()
    eng.serve(max_steps=500)
    assert eng.metrics.decode_steps >= 20
    assert set(eng.dispatch_shapes.signatures) == set(sigs)
    assert [t.data_ptr() for t in eng.pool.tensors.arrays] == ptrs


def test_window_expired_frees_shrink_resident_blocks(toy):
    """As decode slides past the window, expired private pages go back
    to the allocator while the request is still running."""
    model, params, _, _ = toy
    eng = _sparse_engine(model, params, max_slots=1,
                         sparse_context={"num_sliding_window_blocks": 2,
                                         "num_global_blocks": 1})
    rid = eng.submit(_prompts(9, (30,))[0], max_new_tokens=16)
    free_during = []
    while eng.scheduler.has_work():
        eng.step()
        if rid not in eng.results:
            free_during.append(eng.pool.free_blocks(0))
    assert eng.results[rid]["tokens"].size == 46
    assert eng.pool.window_frees > 0
    assert eng.pool.stats()["window_expired_frees"] == eng.pool.window_frees
    assert max(free_during) > min(free_during)
    assert eng.serving_report()["sparse_context"][
        "window_expired_frees"] > 0
    assert eng._last_metrics["window_expired_frees"] > 0


def test_pool_window_expired_free_keeps_holes_and_anchors_as_jax():
    """The same allocations and sweeps on the port's pool and the JAX
    pool: the same holes, page lists, table rows and free lists."""
    kw = dict(vocab_size=97, n_positions=64, n_embd=32, n_layer=1,
              n_head=2, loss_chunk_tokens=0)
    port = PagedKVPool(GPT2Config(dtype=torch.float32, **kw),
                       num_blocks=16, block_size=4, device="cpu")
    ref = JPagedKVPool(JGPT2Config(dtype=jnp.float32, **kw),
                       num_blocks=16, block_size=4)
    ops = [lambda p: p.alloc(1, 0, 24),
           lambda p: p.alloc(2, 0, 12),
           lambda p: p.window_expired_free(1, 4, keep_blocks=1),
           lambda p: p.window_expired_free(1, 4, keep_blocks=1),
           lambda p: tuple(p.table_row(1, 8)),
           lambda p: p.blocks_of(1),
           lambda p: p.fragmentation(),
           lambda p: p.alloc(1, 0, 32),
           lambda p: p.window_expired_free(2, 9, keep_blocks=0),
           lambda p: p.free(1),
           lambda p: p.free(2),
           lambda p: p.free_blocks(0)]
    for i, op in enumerate(ops):
        assert op(port) == op(ref), i
        assert port._blocks == ref._blocks, i
        assert port._free == ref._free, i
    assert port.window_frees == ref.window_frees == 6
    assert port.free_blocks(0) == 15


def test_window_free_skips_prefix_shared_blocks_engine_level(toy):
    """A cached prefix that lies partly outside the window: the tree's
    blocks are never window-freed, refcounts stay consistent, and the
    pool balances after both requests finish."""
    model, params, _, _ = toy
    eng = _sparse_engine(model, params, max_slots=1, prefix_cache=True,
                         sparse_context={"num_sliding_window_blocks": 2,
                                         "num_global_blocks": 1})
    free0 = eng.pool.free_blocks(0)
    shared = _prompts(11, (16,))[0]
    r1 = eng.submit(shared, max_new_tokens=4)
    eng.serve(max_steps=300)
    assert len(eng.pool.prefix_lookup(0, shared)[0]) > 0
    r2 = eng.submit(np.concatenate([shared, _prompts(12, (8,))[0]])
                    .astype(np.int32), max_new_tokens=6)
    eng.serve(max_steps=300)
    assert eng.results[r1]["tokens"].size == 20
    assert eng.results[r2]["tokens"].size == 30
    assert len(eng.pool.prefix_lookup(0, shared)[0]) > 0
    held = free0 - eng.pool.free_blocks(0)
    assert 0 < held <= 6
    assert eng.pool.stats()["prefix_shared_refs"] == 0
    assert eng.pool.fragmentation() >= 0.0


def test_full_window_sparse_with_prefix_cache_matches_dense(toy):
    """Prefix sharing and the sparse gather compose bit for bit at full
    window: COW-attached pages are gathered through the same rows."""
    model, params, ref, _ = toy
    shared = _prompts(13, (9,))[0]
    p2 = np.concatenate([shared, _prompts(14, (4,))[0]]).astype(np.int32)
    outs = {}
    for name, kw in (("dense", {}),
                     ("sparse", {"sparse_context":
                                 {"num_sliding_window_blocks": 16}})):
        eng = _sparse_engine(model, params, prefix_cache=True, **kw)
        ra = eng.submit(shared, max_new_tokens=5)
        eng.serve(max_steps=300)
        rb = eng.submit(p2, max_new_tokens=5)
        eng.serve(max_steps=300)
        outs[name] = (eng.results[ra]["tokens"], eng.results[rb]["tokens"])
        if name == "sparse":
            assert eng.metrics.prefix_hits >= 1
    np.testing.assert_array_equal(outs["dense"][0], outs["sparse"][0])
    np.testing.assert_array_equal(outs["dense"][1], outs["sparse"][1])
    np.testing.assert_array_equal(outs["sparse"][0], ref(shared, 5))
    np.testing.assert_array_equal(outs["sparse"][1], ref(p2, 5))


def test_narrow_window_with_prefix_cache_as_the_jax_engine(toy):
    """The cache and a narrow window together: shared prompt blocks the
    window has passed stay in the tree, and tokens and counters equal
    the JAX engine's."""
    shared = _prompts(15, (21,))[0]
    prompts = [np.concatenate([shared, t]).astype(np.int32)
               for t in _prompts(16, (3, 6, 2))]
    eng, _ = serve_both(toy, [shared] + prompts, [5, 6, 4, 7], stagger=3,
                        max_slots=2, max_blocks_per_seq=16,
                        prefix_cache=True,
                        sparse_context={"num_sliding_window_blocks": 2,
                                        "num_global_blocks": 1})
    c = a10b_counters(eng)
    assert c["prefix_hits"] >= 1 and c["window_expired_frees"] > 0


# ---------------------------------------------------------------------------
# DISARMED discipline
# ---------------------------------------------------------------------------

class _NonPrefixGlobals:
    num_sliding_window_blocks = 4
    global_block_indices = [0, 7]


@pytest.mark.parametrize("kw,blocker", [
    (dict(sparse_context={"window_tokens": 10}), "Round the window"),
    (dict(sparse_context={"num_sliding_window_blocks": 2, "beam_width": 4}),
     "beam_width=4"),
    (dict(speculative=3, sparse_context={"num_sliding_window_blocks": 2}),
     "draft-k"),
    (dict(sparse_context=SparseContext(block_size=8, table_width=4,
                                       num_sliding_window_blocks=2)),
     "block_size=8"),
    (dict(sparse_context=_NonPrefixGlobals()), "leading prefix"),
    (dict(sparse_context={"num_sliding_window_blocks": 0,
                          "num_global_blocks": 1}), "< 1"),
])
def test_sparse_disarms_with_a_warning(toy, caplog, kw, blocker):
    """Each blocker of the JAX engine warns DISARMED naming itself, and
    the engine serves the dense decode step."""
    model, params, ref, _ = toy
    with _Propagate(), caplog.at_level(logging.WARNING):
        eng = _sparse_engine(model, params, **kw)
    assert any("sparse context: DISARMED" in r.message
               and blocker in r.message for r in caplog.records)
    assert eng.sparse is None and eng._decode_name == "decode_step"
    if kw.get("speculative"):
        assert eng.spec_k == 3                       # speculation wins
    p = _prompts(17, (9,))[0]
    rid = eng.submit(p, max_new_tokens=4)
    eng.serve(max_steps=100)
    np.testing.assert_array_equal(eng.results[rid]["tokens"], ref(p, 4))


def test_window_tokens_arms_when_block_aligned(toy):
    model, params, _, _ = toy
    eng = _sparse_engine(model, params, sparse_context={"window_tokens": 12})
    assert eng.sparse is not None and eng.sparse.win == 3
    assert eng._decode_name == "sparse_decode_step"
