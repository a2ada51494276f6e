"""Sparse page attention policies for the paged KV pool.

Port of deepspeed_tpu/serving/sparse_context.py (numpy only). Long-context
serving pays O(total pages) per decode step on the dense path: the
fixed-shape decode step gathers EVERY page of every lane's page table
(``W`` blocks) however long the sequence is. This module is the policy
layer that closes that gap: a ``SparsityConfig``-style layout (sliding
window + global anchor blocks, the BigBird / BSLongformer shapes of
``ops/sparse_attention/sparsity_config.py``) compiled down to per-lane
ACTIVE-PAGE lists whose block granularity IS the KV pool's block size.

The contract with the serving engine:

- **Fixed K.** Every lane gathers exactly ``K = min(W, globals +
  window)`` pages per dispatch, whatever its length, so the sparse
  decode and prefill dispatches keep fixed shapes (no new dispatch
  signature after warmup). Padded entries point at the trash block with
  a sentinel view position the engine's masks reject.
- **LUT at arm time, row maintenance per step.** ``_compile_luts`` builds
  the (W, K) query-block -> active-logical-blocks table once when the
  policy arms. Per decode step the engine calls :meth:`active_row` (pure
  numpy, no device work) to refresh each lane's physical gather row
  before the upload, like ``_pos``/``_tok``.
- **Bit-identity escape hatch.** With a window covering the whole
  context (``globals + window >= W``) every active row is exactly the
  dense page table in dense order, the view positions are the dense
  positions, and the masks reduce to the dense causal masks: sparse
  greedy decode equals the dense path bit for bit. At long context the
  reference is ``layout_to_token_mask`` over :meth:`layout`.

Pages that fall out of every lane's active set become early-freeable:
``PagedKVPool.window_expired_free`` returns them to the allocator while
prefix-cache-shared blocks stay resident (the radix tree's refcounts
win).
"""
from typing import Optional

import numpy as np

from deepspeed_tpu_torch.serving.kv_cache import TRASH_BLOCK


def _policy_layout(win: int, g: int, nb: int) -> np.ndarray:
    """(nb, nb) 0/1 block layout of the causal sliding-window + global
    policy: query block ``qb`` attends key blocks ``[qb-win+1 .. qb]``
    plus the ``g`` leading global anchor blocks. This is the
    BSLongformer shape of ``sparsity_config.py`` restricted to its
    causal (lower-triangular) half: decode only ever looks backward."""
    rows = np.arange(nb)[:, None]
    cols = np.arange(nb)[None, :]
    window = (cols <= rows) & (cols > rows - win)
    anchors = (cols < g) & (cols <= rows)
    return (window | anchors).astype(np.int64)


class SparseContext:
    """One armed sparse-attention policy over a ``W``-block page table.

    ``num_sliding_window_blocks`` (``win``) and ``num_global_blocks``
    (``g``) are in POOL blocks: the policy's block granularity is the KV
    pool's ``block_size`` by construction, so an active block maps 1:1
    onto a gatherable page. ``K`` is the fixed per-lane gather width;
    ``sentinel`` is the view position padded entries carry (``W *
    block_size``, beyond every valid query and maxpos, so the causal and
    validity masks reject padded pages unconditionally)."""

    def __init__(self, *, block_size: int, table_width: int,
                 num_sliding_window_blocks: int, num_global_blocks: int = 1):
        assert num_sliding_window_blocks >= 1, \
            "the sliding window must cover at least the current block"
        assert num_global_blocks >= 0
        self.bs = int(block_size)
        self.W = int(table_width)
        self.win = int(num_sliding_window_blocks)
        self.g = int(num_global_blocks)
        self.K = min(self.W, self.g + self.win)
        self.sentinel = np.int32(self.W * self.bs)
        self.lut = self._compile_luts()

    @classmethod
    def from_sparsity_config(cls, sc, *, block_size: int, table_width: int):
        """Compile an ``ops/sparse_attention`` SparsityConfig-style object
        (BSLongformer / BigBird) into a serving policy. The symmetric
        ``num_sliding_window_blocks`` window of those configs spans ``w //
        2`` blocks on each side; causally clipped that is a backward
        window of ``w // 2 + 1`` blocks (self included). Global anchors
        must be the LEADING blocks: decode can only anchor on pages every
        sequence has already written."""
        w = int(getattr(sc, "num_sliding_window_blocks"))
        idx = list(getattr(sc, "global_block_indices", [0]) or [0])
        ends = getattr(sc, "global_block_end_indices", None)
        if ends is not None:
            blocks = sorted({b for s, e in zip(idx, ends)
                             for b in range(int(s), int(e))})
        else:
            blocks = sorted({int(b) for b in idx})
        g = len(blocks)
        if blocks != list(range(g)):
            raise ValueError(
                f"global blocks {blocks} are not a leading prefix: the "
                f"serving policy anchors on pages every lane has written, "
                f"i.e. blocks [0..g)")
        return cls(block_size=block_size, table_width=table_width,
                   num_sliding_window_blocks=w // 2 + 1,
                   num_global_blocks=g)

    # -- arm-time compile -----------------------------------------------
    def _compile_luts(self) -> np.ndarray:
        """(W, K) int32: row ``qb`` lists the ACTIVE logical block indices
        (ascending) of a query in block ``qb``, padded with -1. Padded
        entries point at block 0 and are skipped through the sentinel
        view position, never through a data-dependent shape."""
        lut = np.full((self.W, self.K), -1, np.int32)
        for qb in range(self.W):
            lo = max(0, qb - self.win + 1)
            act = list(range(min(self.g, qb + 1)))
            act += list(range(max(lo, self.g), qb + 1))
            lut[qb, :len(act)] = act
        return lut

    def layout(self, nb: Optional[int] = None) -> np.ndarray:
        """The policy as a (nb, nb) 0/1 block layout: the input
        ``layout_to_token_mask`` consumes (a dense forward masked with it
        is the reference the sparse engine is held against)."""
        return _policy_layout(self.win, self.g, int(nb or self.W))

    def prefill_K(self, chunk: int) -> int:
        """Fixed gather width of a ``chunk``-token prefill dispatch: the
        union of every chunk query's active set is the globals plus one
        CONTIGUOUS block run (windows of consecutive query blocks
        overlap), so ``g + win + blocks-spanned-by-the-chunk`` bounds
        it. Fixed per bucket, so one signature per (bucket, final)."""
        span = (int(chunk) + self.bs - 1) // self.bs + 1
        return min(self.W, self.g + self.win + span)

    # -- per-step row maintenance (hot path: pure numpy) ----------------
    def active_row(self, table_row: np.ndarray, pos: int):
        """Physical gather row of ONE decode lane at absolute position
        ``pos``: ``(stables, sbase)`` of width K, the physical page ids
        to gather and the absolute view position of each page's first
        token. Pads (and window-expired holes, which ``table_row``
        already maps to the trash block) carry the sentinel position, so
        the dispatch's masks zero them like dense trash padding."""
        qb = min(int(pos) // self.bs, self.W - 1)
        row = self.lut[qb]
        phys = table_row[np.maximum(row, 0)].astype(np.int32)
        live = (row >= 0) & (phys != TRASH_BLOCK)
        stables = np.where(live, phys, np.int32(TRASH_BLOCK))
        sbase = np.where(live, row.astype(np.int32) * self.bs,
                         self.sentinel)
        return stables, sbase

    def prefill_active_row(self, table_row: np.ndarray, start: int,
                           n: int, bucket: int):
        """Gather row of ONE prefill chunk covering absolute positions
        ``[start, start+n)``, padded to the fixed ``prefill_K(bucket)``
        width: the union of the chunk queries' active sets, the globals
        plus the contiguous run from the FIRST query's window start to
        the last query's block. The per-query window restriction happens
        in the dispatch (the layout mask); this row only bounds what is
        gathered."""
        K = self.prefill_K(bucket)
        qb0 = int(start) // self.bs
        qb1 = min((int(start) + max(int(n), 1) - 1) // self.bs, self.W - 1)
        lo = max(0, qb0 - self.win + 1)
        act = list(range(min(self.g, qb1 + 1)))
        act += list(range(max(lo, self.g), qb1 + 1))
        row = np.full(K, -1, np.int32)
        row[:len(act)] = act
        phys = table_row[np.maximum(row, 0)].astype(np.int32)
        live = (row >= 0) & (phys != TRASH_BLOCK)
        stables = np.where(live, phys, np.int32(TRASH_BLOCK))
        sbase = np.where(live, row.astype(np.int32) * self.bs,
                         self.sentinel)
        return stables, sbase

    def first_active_block(self, pos: int) -> int:
        """Lowest logical block index still inside the window of a query
        at ``pos``: everything below it (but the global anchors) is
        window-expired and early-freeable."""
        return max(0, int(pos) // self.bs - self.win + 1)

    def describe(self) -> dict:
        return {
            "num_sliding_window_blocks": self.win,
            "num_global_blocks": self.g,
            "active_pages_per_lane": self.K,
            "table_width": self.W,
            "block_size": self.bs,
        }
