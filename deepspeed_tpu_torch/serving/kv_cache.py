"""Paged KV cache: fixed block pool + per-sequence page tables.

Port of deepspeed_tpu/serving/kv_cache.py. KV lives in a fixed pool of
``block_size``-token blocks, each sequence holds an ordered page table of
block ids (vLLM's PagedAttention, arXiv 2309.06180), and the decode and
prefill steps write the pool tensors in place: steady-state serving
allocates no pool memory and the tensors keep their storage
(``data_ptr()``) for the engine's life.

Layout: ``k``/``v`` are ``(L, num_blocks, H, block_size, D)`` on the
engine's device; the gathered per-sequence view reassembles
``(H, W*block_size, D)`` in absolute-position order, so the attention math
(``generation._attn_core``) is the contiguous cache's.

Block 0 is a reserved TRASH block: masked lanes (inactive slots, prefill
padding) route their writes there, which keeps every scatter dense.

Optional int8 storage (``quantize_kv=True``) stores one symmetric fp32
scale per (token, head) row via runtime/quantization.py's row quantizers
(per-row layout ``block_layout(D, D)``, so the scale tensor is exactly
``(L, num_blocks, H, block_size)``). Arming follows the DISARMED
discipline: when the configuration cannot profit (scale overhead >= byte
savings, or an unsupported pool dtype) the pool warns naming the blocker
and serves full precision instead.

Prefix caching (SGLang-style RadixAttention, arXiv 2312.07104): the pool
also keeps a radix tree over block CONTENT, a node per physical block
keyed by the token tuple whose KV the block holds, chained parent to
child in position order. A new request walks the tree
(:meth:`prefix_lookup`), maps every fully matching block read-only into
its page table (:meth:`prefix_attach`, refcounted) and COW-splits the
first divergent block: the partial match is copied on the device into a
private block the request may write into, one in-place row copy per pool
tensor (no host sync, no storage moves). Finished prefills publish their
prompt blocks back into the tree (:meth:`prefix_insert`). A shared block
returns to the free list only when every mapping request has freed it
AND the cache reclaims its node (LRU, unreferenced leaves first), and the
trash block is never cached.

Window-expired reclamation (serving/sparse_context.py): under a
sliding-window policy, pages below every remaining query's window can
never be gathered again; :meth:`window_expired_free` returns those
PRIVATE blocks to the allocator early and leaves a ``None`` hole in the
page list so logical position and list index stay aligned
(``table_row`` maps holes to the trash block). Tree-owned blocks are
never window-freed: the prefix cache's refcounts outrank the window.

Not ported yet: pools split into shards (ROADMAP A10c).
"""
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.runtime.memory_accounting import kv_pool_bytes
from deepspeed_tpu_torch.telemetry.programs import NO_OBSERVER
from deepspeed_tpu_torch.utils.logging import logger

TRASH_BLOCK = 0          # block 0 absorbs masked writes


class PoolTensors(NamedTuple):
    """The device-side pool state the decode/prefill steps write in
    place. ``k_scale``/``v_scale`` are None unless int8 KV is armed."""
    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def arrays(self):
        return tuple(t for t in self if t is not None)


class _PrefixNode:
    """One physical block in the prefix tree. ``tokens`` is the (at most
    block_size) token tuple whose KV rows the block holds; ``refs``
    counts live requests mapping the block read-only. The node keeps the
    block resident after refs drop to zero (that is the cache) until LRU
    reclaim returns it to the free list."""
    __slots__ = ("tokens", "block", "parent", "children", "refs", "tick")

    def __init__(self, tokens, block, parent, tick):
        self.tokens = tokens
        self.block = block
        self.parent = parent
        self.children = {}
        self.refs = 0
        self.tick = tick


def _common_prefix_len(a, b):
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


class PagedKVPool:
    """Fixed device block pool + host-side block allocator/page tables.

    ``num_blocks`` counts the trash block, so the usable capacity is
    ``num_blocks - 1`` blocks. The allocator keeps the reference's
    per-shard interface with one shard (pools split into shards are
    ROADMAP A10c)."""

    def __init__(self, cfg, *, num_blocks, block_size=16, quantize_kv=False,
                 device=None):
        assert num_blocks >= 2, \
            "need at least one usable block beyond the trash block"
        assert block_size >= 1
        from deepspeed_tpu_torch.runtime.engine import resolve_device

        self.cfg = cfg
        self.block_size = int(block_size)
        self.shards = 1
        self.num_blocks = int(num_blocks)
        self.blocks_per_shard = self.num_blocks
        self.dtype = cfg.dtype
        self.device = resolve_device(device)
        self.quantized = self._arm_quantized_kv(quantize_kv)

        L, H, D = cfg.n_layer, cfg.n_head, cfg.head_dim
        kv_shape = (L, self.num_blocks, H, self.block_size, D)
        store = torch.int8 if self.quantized else self.dtype
        k = torch.zeros(kv_shape, dtype=store, device=self.device)
        v = torch.zeros(kv_shape, dtype=store, device=self.device)
        sk = sv = None
        if self.quantized:
            sk = torch.zeros(kv_shape[:-1], dtype=torch.float32,
                             device=self.device)
            sv = torch.zeros_like(sk)
        self.tensors = PoolTensors(k, v, sk, sv)

        # host-side allocator: sorted free lists (popping the smallest id
        # keeps runs deterministic); the trash block is never handed out
        self._free: List[List[int]] = [list(range(1, self.num_blocks))]
        self._blocks: Dict[int, List[Optional[int]]] = {}  # rid -> blocks
        self._shard_of: Dict[int, int] = {}
        self._positions: Dict[int, int] = {}       # rid -> covered positions

        # prefix cache: a radix tree over block content. The sentinel
        # root holds no block; ``_nodes`` maps block id -> node;
        # ``_shared`` lists, per rid, the tree-owned blocks the rid maps
        # read-only (free() derefs these instead of recycling them).
        self._roots: List[_PrefixNode] = [_PrefixNode((), None, None, 0)]
        self._nodes: List[Dict[int, _PrefixNode]] = [{}]
        self._shared: Dict[int, List[int]] = {}
        self._tick = 0
        self.cow_splits = 0
        self.cache_reclaims = 0
        self.window_frees = 0      # blocks early-freed by window expiry
        # the owning engine's DispatchShapes: the COW copy records its
        # signature there like the engine's own dispatches (None: a
        # standalone pool records nothing)
        self.dispatch_shapes = None
        self.programs = None        # the serving engine's ProgramRegistry

    # -- arming ---------------------------------------------------------
    def _arm_quantized_kv(self, requested):
        """int8 KV arms only where it actually saves bytes; every blocked
        request warns loudly (the armed-or-warns DISARMED discipline)."""
        if not requested:
            return False
        elem = torch.empty((), dtype=self.dtype).element_size()
        D = self.cfg.head_dim
        if self.dtype == torch.float64:
            logger.warning(
                "PagedKVPool: int8 KV quantization DISARMED — pool dtype "
                "float64 is not supported by the symmetric per-row scheme "
                "(scales are f32); serving full-precision KV instead.")
            return False
        if D * (elem - 1) <= 4:
            logger.warning(
                "PagedKVPool: int8 KV quantization DISARMED — head_dim=%d "
                "at %s saves %d bytes/row but the per-(token,head) f32 "
                "scale costs 4; int8 would GROW the pool. Serving "
                "full-precision KV instead.",
                D, str(self.dtype).replace("torch.", ""), D * (elem - 1))
            return False
        return True

    # -- allocator ------------------------------------------------------
    def blocks_needed(self, n_positions: int) -> int:
        return -(-int(n_positions) // self.block_size)

    def alloc(self, rid: int, shard: int, n_positions: int) -> bool:
        """Ensure ``rid`` owns enough blocks to cover ``n_positions``
        absolute positions. Returns False — with NOTHING changed — when
        the free list cannot cover the growth; the caller preempts a
        victim and retries."""
        assert 0 <= shard < self.shards
        have = self._blocks.setdefault(rid, [])
        prev = self._shard_of.setdefault(rid, shard)
        assert prev == shard, f"rid {rid} moved shards {prev}->{shard}"
        need = self.blocks_needed(n_positions) - len(have)
        while need > len(self._free[shard]) and self._reclaim_block(shard):
            pass
        if need > len(self._free[shard]):
            if not have:
                self._drop(rid)
            return False
        for _ in range(max(0, need)):
            have.append(self._free[shard].pop(0))
        self._positions[rid] = max(self._positions.get(rid, 0),
                                   int(n_positions))
        return True

    def free(self, rid: int) -> None:
        """Release every block of ``rid``: private blocks return to the
        free list; tree-owned (prefix-shared) blocks are DEREFED instead
        and stay resident in the cache until LRU reclaim."""
        blocks = self._blocks.pop(rid, [])
        shard = self._shard_of.pop(rid, 0)
        self._positions.pop(rid, None)
        shared = set(self._shared.pop(rid, ()))
        nodes = self._nodes[shard]
        recycled = []
        for b in blocks:
            if b is None:             # window-expired hole, already freed
                continue
            node = nodes.get(b) if b in shared else None
            if node is not None:
                node.refs -= 1
            else:
                recycled.append(b)
        self._free[shard] = sorted(self._free[shard] + recycled)

    def window_expired_free(self, rid: int, first_active_block: int, *,
                            keep_blocks: int = 0) -> int:
        """Early-free the PRIVATE blocks of ``rid`` whose logical index
        has fallen below ``first_active_block``: under a sliding-window
        policy no remaining query can gather them again. The first
        ``keep_blocks`` logical blocks (the policy's global anchors) are
        always kept. Freed slots become ``None`` holes so the page list
        keeps its positional indexing; tree-owned blocks are skipped,
        refs untouched. Returns the number of blocks freed."""
        blocks = self._blocks.get(rid)
        if not blocks:
            return 0
        shard = self._shard_of[rid]
        shared = set(self._shared.get(rid, ()))
        nodes = self._nodes[shard]
        hi = min(int(first_active_block), len(blocks))
        recycled = []
        for i in range(max(0, int(keep_blocks)), hi):
            b = blocks[i]
            if b is None or b in shared or b in nodes:
                continue
            blocks[i] = None
            recycled.append(b)
        if recycled:
            self._free[shard] = sorted(self._free[shard] + recycled)
            self.window_frees += len(recycled)
        return len(recycled)

    def _drop(self, rid):
        self._blocks.pop(rid, None)
        self._shard_of.pop(rid, None)
        self._positions.pop(rid, None)
        self._shared.pop(rid, None)

    def table_row(self, rid: int, width: int) -> np.ndarray:
        """Block ids of ``rid`` padded with the trash block to the fixed
        table width (the decode step's W). Window-expired holes map to
        the trash block too: the policy masks their positions before
        they could be gathered."""
        blocks = self._blocks.get(rid, [])
        assert len(blocks) <= width, \
            f"rid {rid} holds {len(blocks)} blocks > table width {width}"
        row = np.full(width, TRASH_BLOCK, np.int32)
        row[:len(blocks)] = [TRASH_BLOCK if b is None else b
                             for b in blocks]
        return row

    def free_blocks(self, shard: int) -> int:
        """Free blocks of one shard (the admission slot-ranking signal)."""
        return len(self._free[shard])

    def blocks_of(self, rid: int) -> int:
        """Blocks currently allocated to ``rid`` (0 when unknown).
        Window-expired holes no longer hold pool capacity."""
        return sum(1 for b in self._blocks.get(rid, ()) if b is not None)

    # -- prefix cache (copy-on-write shared blocks) ---------------------
    def _touch(self, node):
        self._tick += 1
        node.tick = self._tick

    def prefix_lookup(self, shard: int, tokens) -> tuple:
        """Walk the radix tree along ``tokens``. Returns ``(full_nodes,
        cow_node, cow_len)``: the chain of exactly matching full blocks,
        then the child sharing the longest strict prefix of the next
        block (the COW-split candidate, ``cow_len`` trusted positions).
        Coverage is capped at ``len(tokens) - 1`` so the final prompt
        position is always computed: the final prefill chunk must still
        run to produce the first token's logits."""
        bs = self.block_size
        limit = len(tokens) - 1
        node = self._roots[shard]
        full = []
        pos = 0
        while pos + bs <= limit:
            key = tuple(int(t) for t in tokens[pos:pos + bs])
            child = node.children.get(key)
            if child is None:
                break
            full.append(child)
            node = child
            pos += bs
        rest = tuple(int(t) for t in tokens[pos:min(pos + bs, limit)])
        cow, cow_len = None, 0
        for child in node.children.values():
            p = _common_prefix_len(child.tokens, rest)
            if p > cow_len:
                cow, cow_len = child, p
        return full, cow, cow_len

    def prefix_attach(self, rid: int, shard: int, tokens) -> int:
        """Map the longest cached prefix of ``tokens`` into ``rid``'s
        (empty) page table: fully matching blocks are shared read-only
        (refcounted); the first divergent block is COW-split, its rows
        copied on the device into a private block the request may write
        into. Returns the number of positions covered, which the
        request's prefill skips."""
        assert not self._blocks.get(rid), \
            f"prefix_attach on rid {rid} with blocks already allocated"
        full, cow, cow_len = self.prefix_lookup(shard, tokens)
        if not full and cow_len == 0:
            return 0
        covered = len(full) * self.block_size
        blocks = []
        for node in full:
            node.refs += 1
            self._touch(node)
            blocks.append(node.block)
        if cow is not None and cow_len > 0:
            if not self._free[shard]:
                self._reclaim_block(shard)
            if self._free[shard]:
                dst = self._free[shard].pop(0)
                self._cow_copy(cow.block, dst)
                self._touch(cow)
                blocks.append(dst)
                covered += cow_len
                self.cow_splits += 1
        self._blocks[rid] = blocks
        self._shard_of[rid] = shard
        self._positions[rid] = covered
        self._shared[rid] = [n.block for n in full]
        return covered

    def prefix_insert(self, rid: int, shard: int, tokens) -> int:
        """Publish ``rid``'s prompt blocks into the radix tree so later
        requests can share them. Blocks already attached from the tree
        descend without re-insertion; content already cached under a
        DIFFERENT physical block keeps the existing entry (rid's copy
        stays private). Returns the number of blocks newly shared."""
        bs = self.block_size
        blocks = self._blocks.get(rid, [])
        node = self._roots[shard]
        nodes = self._nodes[shard]
        inserted = 0
        pos = 0
        i = 0
        n = len(tokens)
        while pos < n and i < len(blocks):
            chunk = tuple(int(t) for t in tokens[pos:pos + bs])
            child = node.children.get(chunk)
            if child is not None:
                node = child          # cached already (ours or a twin's)
                self._touch(node)
            else:
                blk = blocks[i]
                if blk is None:       # window-expired hole: its content
                    break             # is gone, nothing past it publishes
                if blk in nodes:      # published earlier under another
                    break             # key: never double-own a block
                child = _PrefixNode(chunk, blk, node, 0)
                child.refs = 1        # rid still maps it
                node.children[chunk] = child
                nodes[blk] = child
                self._touch(child)
                self._shared.setdefault(rid, []).append(blk)
                node = child
                inserted += 1
            pos += bs
            i += 1
        return inserted

    def _cow_copy(self, src: int, dst: int) -> None:
        """The COW split on the device: block ``src``'s rows copied into
        block ``dst`` of every pool tensor (k, v and, under int8 KV, both
        scale tensors), in place: no host sync, and no tensor's storage
        moves."""
        arrays = self.tensors.arrays
        if self.dispatch_shapes is not None:
            self.dispatch_shapes.record("cow_copy", arrays)
        # the COW split is pure device work, collective-free, and updates
        # the pool in place (JAX kv_cache.py:455-465)
        obs = NO_OBSERVER if self.programs is None else \
            self.programs.dispatch(
                "cow_copy", (lambda: self.tensors, src, dst),
                {"host_transfer_free": True, "collective_free": True,
                 "donates_argnums": (0,)})
        with torch.no_grad(), obs:
            for t in arrays:
                t[:, dst].copy_(t[:, src])

    def warm_cow(self) -> None:
        """Dispatch the COW copy once up front (a trash-block self-copy,
        bit-neutral) so the first real split adds no dispatch
        signature."""
        self._cow_copy(TRASH_BLOCK, TRASH_BLOCK)

    def _reclaim_block(self, shard: int) -> bool:
        """Evict ONE least-recently-used unreferenced leaf from the
        prefix tree, returning its block to the free list. Blocks still
        mapped by a live request (refs > 0) are never reclaimed."""
        best = None
        stack = [self._roots[shard]]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if (node.block is not None and not node.children
                    and node.refs <= 0):
                if best is None or node.tick < best.tick:
                    best = node
        if best is None:
            return False
        del best.parent.children[best.tokens]
        self._nodes[shard].pop(best.block, None)
        self._free[shard] = sorted(self._free[shard] + [best.block])
        self.cache_reclaims += 1
        return True

    def cached_blocks(self, shard: Optional[int] = None) -> int:
        """Blocks currently owned by the prefix tree (shared + resident)."""
        if shard is not None:
            return len(self._nodes[shard])
        return sum(len(n) for n in self._nodes)

    # -- accounting -----------------------------------------------------
    def device_bytes(self) -> int:
        """Device bytes of the pool tensors, priced through the analytic
        builder (``memory_accounting.kv_pool_bytes``) — byte-exact against
        the allocated k/v (+ scale) tensors."""
        cfg = self.cfg
        return kv_pool_bytes(
            cfg.n_layer, self.num_blocks, cfg.n_head, self.block_size,
            cfg.head_dim, kv_dtype=self.dtype, quantized=self.quantized,
            shards=self.shards)

    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - self.shards          # minus trash blocks

    @property
    def blocks_in_use(self) -> int:
        """Distinct blocks not on a free list: a shared block counts once
        however many page tables map it, and cache-resident blocks (refs
        0, awaiting reclaim) count too."""
        return self.usable_blocks - sum(len(f) for f in self._free)

    def occupancy(self) -> float:
        return self.blocks_in_use / max(1, self.usable_blocks)

    def fragmentation(self) -> float:
        """Internal fragmentation: fraction of MAPPED pool positions not
        covered by live tokens (tail slack of each sequence's last
        block). Shared blocks count once per mapping request on both
        sides of the ratio. 0 = every mapped slot holds a token; clamped
        at 0 because window-expired frees can leave more live positions
        than mapped slots."""
        allocated = sum(
            sum(1 for blk in b if blk is not None)
            for b in self._blocks.values()) * self.block_size
        if allocated == 0:
            return 0.0
        used = sum(self._positions.values())
        return max(0.0, 1.0 - used / allocated)

    def stats(self) -> dict:
        return {
            "pool_device_bytes": self.device_bytes(),
            "blocks_total": self.usable_blocks,
            "blocks_in_use": self.blocks_in_use,
            "occupancy": self.occupancy(),
            "fragmentation": self.fragmentation(),
            "block_size": self.block_size,
            "shards": self.shards,
            "quantized": self.quantized,
            "free_per_shard": [len(f) for f in self._free],
            "prefix_cached_blocks": self.cached_blocks(),
            "prefix_shared_refs": sum(
                n.refs for nodes in self._nodes for n in nodes.values()),
            "prefix_cow_splits": self.cow_splits,
            "prefix_cache_reclaims": self.cache_reclaims,
            "window_expired_frees": self.window_frees,
        }
