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

Not ported yet: pools split into shards (ROADMAP A10c), and the prefix
radix tree with copy-on-write blocks and window-expired frees (A10b).
"""
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.runtime.memory_accounting import kv_pool_bytes
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
        self._blocks: Dict[int, List[int]] = {}    # rid -> block ids
        self._shard_of: Dict[int, int] = {}
        self._positions: Dict[int, int] = {}       # rid -> covered positions

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
        """Return every block of ``rid`` to the free list."""
        blocks = self._blocks.pop(rid, [])
        shard = self._shard_of.pop(rid, 0)
        self._positions.pop(rid, None)
        self._free[shard] = sorted(self._free[shard] + blocks)

    def _drop(self, rid):
        self._blocks.pop(rid, None)
        self._shard_of.pop(rid, None)
        self._positions.pop(rid, None)

    def table_row(self, rid: int, width: int) -> np.ndarray:
        """Block ids of ``rid`` padded with the trash block to the fixed
        table width (the decode step's W)."""
        blocks = self._blocks.get(rid, [])
        assert len(blocks) <= width, \
            f"rid {rid} holds {len(blocks)} blocks > table width {width}"
        row = np.full(width, TRASH_BLOCK, np.int32)
        row[:len(blocks)] = blocks
        return row

    def blocks_of(self, rid: int) -> int:
        """Blocks currently allocated to ``rid`` (0 when unknown)."""
        return len(self._blocks.get(rid, ()))

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
        return self.usable_blocks - sum(len(f) for f in self._free)

    def occupancy(self) -> float:
        return self.blocks_in_use / max(1, self.usable_blocks)

    def fragmentation(self) -> float:
        """Internal fragmentation: fraction of MAPPED pool positions not
        covered by live tokens (tail slack of each sequence's last
        block). 0 = every mapped slot holds a token."""
        allocated = sum(len(b) for b in self._blocks.values()) \
            * self.block_size
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
        }
