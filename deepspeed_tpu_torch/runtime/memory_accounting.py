"""Analytic device bytes of the serving KV pool and of the train state.

Port of ``kv_pool_bytes`` of deepspeed_tpu/runtime/memory_accounting.py,
the builder ``PagedKVPool.stats()`` prices the pool through, of the
training engine's analytic components (per rank, ZeRO shards included)
and of ``train_memory_report``'s persistent components at dp 1 with its
``cpu_offload`` branch; the measured side comes with ROADMAP A17.
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



def train_state_bytes(numel: int, compute_dtype, *, optimizer_slots=2,
                      cpu_offload: bool = False) -> dict:
    """Analytic persistent bytes of one training process at dp 1 for
    ``numel`` parameters (the JAX package's ``train_memory_report`` at dp
    1, without transients): on the device the compute-dtype parameters,
    the fp32 gradient accumulator, the fp32 master under mixed precision
    and ``optimizer_slots`` fp32 slots (Adam's m and v); under
    ``cpu_offload`` the last three are host bytes instead, the master at
    any precision (the host Adam steps a copy of its own)."""
    compute = _itemsize(compute_dtype)
    fp32 = 4 * numel
    state = {"grad_accum_bytes": fp32,
             "master_bytes": fp32 if compute < 4 or cpu_offload else 0,
             "optimizer_state_bytes": optimizer_slots * fp32}
    device = dict({"params_bytes": compute * numel},
                  **({k: 0 for k in state} if cpu_offload else state))
    host = state if cpu_offload else {k: 0 for k in state}
    return {"components": device,
            "persistent_bytes": sum(device.values()),
            "host": host, "host_bytes": sum(host.values())}
