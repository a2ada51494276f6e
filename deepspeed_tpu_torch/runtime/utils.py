"""Runtime helpers: layer partitioning, partitioned tensors, and the
overflow check, global norm and clipping over a data-parallel group.

Port of deepspeed_tpu/runtime/utils.py (reference
deepspeed/runtime/utils.py: partition_uniform / partition_balanced
:311-377, PartitionedTensor :395, CheckOverflow :63-133, norms :170-294).
Partitioning is pure Python; the tensor helpers take torch tensors.

``group`` below is the engine's ``DataParallelGroup`` (parallel/mesh.py),
or None for a single process. ``partitioned[i]`` says whether ``grads[i]``
is this rank's shard of a leaf split over the group: its squared norm is
summed over the ranks, while a replicated tensor counts once.
"""
import math

import numpy as np
import torch
import torch.distributed as dist


# ---------------------------------------------------------------------------
# layer partitioning (pure python)
# ---------------------------------------------------------------------------
def partition_uniform(num_items: int, num_parts: int):
    """Split ``num_items`` into ``num_parts`` contiguous chunks as evenly as
    possible: ``num_parts + 1`` boundaries, part p owns
    ``[parts[p], parts[p+1])``; the first ``num_items % num_parts`` parts
    get one extra item."""
    if num_items <= num_parts:
        return [min(p, num_items) for p in range(num_parts + 1)]
    chunksize, residual = divmod(num_items, num_parts)
    return [p * chunksize + min(p, residual) for p in range(num_parts + 1)]


def prefix_sum_inc(weights):
    """Inclusive prefix sum."""
    out = list(weights)
    for i in range(1, len(out)):
        out[i] += out[i - 1]
    return out


def _lprobe(weights, num_parts, bottleneck):
    """Greedy probe: can ``weights`` (a prefix sum) be split into
    ``num_parts`` chains each <= bottleneck?"""
    num_items = len(weights)
    total_weight = weights[-1]
    parts = [0] * (num_parts + 1)
    bsum = bottleneck
    chunksize = num_items // num_parts
    step = chunksize
    for p in range(1, num_parts):
        while step < num_items and weights[step] < bsum:
            step += chunksize
        lo = max(0, step - chunksize)
        idx = int(np.searchsorted(weights[lo:step], bsum)) + lo
        if idx >= num_items:
            parts[p:num_parts] = [num_items] * (num_parts - p)
            break
        parts[p] = idx
        bsum = weights[idx - 1] + bottleneck if idx > 0 else bottleneck
    parts[num_parts] = num_items
    return parts, bsum >= total_weight


def _rb_partition_balanced(weights, num_parts, eps):
    """Binary search over the bottleneck value."""
    lower, upper = weights[-1] / num_parts, weights[-1]
    while upper > lower + eps:
        mid = lower + (upper - lower) / 2
        if _lprobe(weights, num_parts, mid)[1]:
            upper = mid
        else:
            lower = mid
    return upper


def partition_balanced(weights, num_parts, eps=1e-3):
    """Boundaries of ``num_parts`` contiguous parts of items with
    ``weights`` minimizing the heaviest part (reference
    runtime/utils.py:326-375)."""
    if len(weights) <= num_parts:
        return partition_uniform(len(weights), num_parts)
    weights_ = prefix_sum_inc(weights)
    bottleneck = _rb_partition_balanced(weights_, num_parts, eps=eps)
    parts, success = _lprobe(weights_, num_parts, bottleneck + eps)
    assert success
    return parts


# ---------------------------------------------------------------------------
# tensor helpers
# ---------------------------------------------------------------------------
class PartitionedTensor:
    """A tensor flattened, zero-padded to a multiple of ``axis_size`` and
    cut into equal parts; this rank keeps part ``axis_index`` and
    ``full()`` reassembles it from all the parts (reference
    runtime/utils.py:395-505)."""

    def __init__(self, tensor, axis_size: int, axis_index: int):
        self.orig_shape = tuple(tensor.shape)
        self.orig_size = int(np.prod(self.orig_shape))
        self.axis_size = axis_size
        self.axis_index = axis_index
        flat = tensor.reshape(-1)
        padded = self.padded_size(self.orig_size, axis_size)
        if padded != self.orig_size:
            flat = torch.nn.functional.pad(flat, (0, padded - self.orig_size))
        self.part_size = padded // axis_size
        start = axis_index * self.part_size
        self.local_data = flat[start:start + self.part_size].clone()

    @staticmethod
    def padded_size(numel: int, parts: int) -> int:
        return math.ceil(numel / parts) * parts

    def to_meta(self):
        return {"orig_shape": self.orig_shape, "orig_size": self.orig_size,
                "axis_size": self.axis_size, "part_size": self.part_size}

    @classmethod
    def from_parts(cls, parts_list, meta):
        obj = cls.__new__(cls)
        obj.orig_shape = tuple(meta["orig_shape"])
        obj.orig_size = meta["orig_size"]
        obj.axis_size = meta["axis_size"]
        obj.part_size = meta["part_size"]
        obj.axis_index = None
        obj.local_data = torch.cat([p.reshape(-1) for p in parts_list])
        return obj

    def data(self):
        return self.local_data

    def full(self, gathered_parts=None):
        """The original tensor from every rank's part, in rank order (a
        world of one needs none)."""
        if gathered_parts is None:
            assert self.axis_size == 1
            gathered_parts = [self.local_data]
        flat = torch.cat([p.reshape(-1) for p in gathered_parts])
        return flat[:self.orig_size].reshape(self.orig_shape)


def global_norm_from_tree(grads, group=None, partitioned=None,
                          model_group=None, model_split=None):
    """The L2 norm over the list ``grads`` (fp32 device scalar): the
    per-tensor norms' norm, with the squared norms of the ``partitioned``
    shards summed over ``group`` (one SUM all-reduce) and each replicated
    tensor counted once. Without shards, no collective. Under tensor
    parallelism, ``model_split[i]`` says whether ``grads[i]`` is this
    rank's part of a leaf split over ``model_group`` (the model line):
    those squares are summed over it too (a second all-reduce), so a leaf
    split over both lines counts every element once."""
    if not grads:
        return torch.zeros(())
    if model_split is not None and any(model_split):
        return _norm_over_data_and_model(grads, group, partitioned,
                                         model_group, model_split)
    if partitioned is None or not any(partitioned):
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    shards = [g for g, p in zip(grads, partitioned) if p]
    whole = [g for g, p in zip(grads, partitioned) if not p]
    sq = torch.stack(torch._foreach_norm(shards)).square().sum().reshape(1)
    group.all_reduce(sq)
    if whole:
        sq = sq + torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(whole))).square()
    return sq.sqrt().reshape(())


_NORM_MASKS = {}


def _norm_masks(partitioned, model_split, device):
    """(4, n) fp32 rows selecting the tensors split over data only, over
    both lines, over model only and over neither; built once per layout
    and device, so a step moves nothing from the host."""
    key = (tuple(partitioned), tuple(model_split), str(device))
    if key not in _NORM_MASKS:
        d = np.asarray(partitioned, bool)
        m = np.asarray(model_split, bool)
        rows = np.stack([d & ~m, d & m, ~d & m, ~d & ~m]).astype(np.float32)
        _NORM_MASKS[key] = torch.from_numpy(rows).to(device)
    return _NORM_MASKS[key]


def _norm_over_data_and_model(grads, group, partitioned, model_group,
                              model_split):
    """``global_norm_from_tree`` under tensor parallelism: the squares of
    the data-split parts (and of the parts split over both lines) summed
    over ``group``, then those of the model-split parts over
    ``model_group``; a replicated tensor counted once."""
    partitioned = partitioned or [False] * len(grads)
    sq = torch.stack(torch._foreach_norm(grads)).square()
    # (data only, both, model only, neither)
    parts = _norm_masks(partitioned, model_split, sq.device) @ sq
    if group is not None and any(partitioned):
        group.all_reduce(parts[:2])
    by_model = parts[1:3].sum().reshape(1)
    model_group.all_reduce(by_model)
    return (parts[0] + by_model[0] + parts[3]).sqrt().reshape(())


def has_overflow(grads, group=None, inv_scale=None):
    """A device bool: whether any element of ``grads`` is inf or nan on
    any rank (a MAX all-reduce over ``group``), found in one fused pass
    that also multiplies every element by ``inv_scale`` (a 1-element
    fp32 tensor; the fp16 unscale) when one is given (reference
    CheckOverflow, utils.py:63-133). No host sync."""
    device = grads[0].device
    found = torch.zeros(1, device=device)
    if inv_scale is None:
        inv_scale = torch.ones(1, device=device)
    torch._amp_foreach_non_finite_check_and_unscale_(grads, found, inv_scale)
    if group is not None:
        group.all_reduce(found, op=dist.ReduceOp.MAX)
    return found[0] > 0


def clip_grad_by_global_norm(grads, max_norm, global_norm=None, group=None,
                             partitioned=None):
    """Scale ``grads`` in place by min(1, max_norm / (norm + 1e-6));
    returns the global norm (computed over ``group`` when not given)."""
    if global_norm is None:
        global_norm = global_norm_from_tree(grads, group, partitioned)
    factor = torch.clamp(max_norm / (global_norm + 1e-6), max=1.0)
    torch._foreach_mul_(grads, factor)
    return global_norm
