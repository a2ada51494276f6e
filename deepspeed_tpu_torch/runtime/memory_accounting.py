"""Analytic device bytes of the serving KV pool and of the train state.

Port of ``kv_pool_bytes`` of deepspeed_tpu/runtime/memory_accounting.py,
the builder ``PagedKVPool.stats()`` prices the pool through, and of the
training engine's analytic components (per rank, ZeRO shards included);
the measured side comes with ROADMAP A17.
"""
import torch


def _itemsize(dtype) -> int:
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return torch.empty((), dtype=dtype).element_size()


def kv_pool_bytes(n_layer: int, num_blocks: int, n_head: int,
                  block_size: int, head_dim: int, *,
                  kv_dtype="bfloat16", quantized: bool = False,
                  shards: int = 1, shared_blocks: int = 0,
                  shared_refs: int = 1) -> int:
    """Per-shard device bytes of the serving paged KV pool: k + v of
    ``(L, num_blocks/shards, H, block_size, D)`` (int8 when quantized,
    else ``kv_dtype``, a torch dtype or its name) plus the two fp32
    per-(token, head)-row scale tensors int8 storage carries — byte-exact
    against the allocated tensors.

    Under prefix sharing, ``num_blocks`` may be the LOGICAL block demand
    of the workload: ``shared_blocks`` distinct blocks each mapped
    read-only by ``shared_refs`` requests are stored ONCE, so the
    physical pool shrinks by ``shared_blocks * (shared_refs - 1)``.  The
    defaults (no sharing) price exactly the allocated tensors."""
    assert shared_blocks >= 0 and shared_refs >= 1, \
        (shared_blocks, shared_refs)
    physical = num_blocks - shared_blocks * (shared_refs - 1)
    assert physical > 0, (num_blocks, shared_blocks, shared_refs)
    assert physical % shards == 0, (physical, shards)
    bps = physical // shards
    store = 1 if quantized else _itemsize(kv_dtype)
    kv = 2 * n_layer * bps * n_head * block_size * head_dim * store
    scales = 2 * n_layer * bps * n_head * block_size * 4 if quantized else 0
    return kv + scales


def tensor_bytes(tensors) -> int:
    """Device bytes of ``tensors`` (views of one buffer each by their own
    elements): the analytic components of the training engine's state
    (``DeepSpeedEngine._analytic_memory_components``)."""
    return sum(t.numel() * t.element_size() for t in tensors)

