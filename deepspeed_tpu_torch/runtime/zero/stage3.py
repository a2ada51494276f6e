"""Scheduled ZeRO stage 3: the parameter-gather plan.

Port of deepspeed_tpu/runtime/zero/stage3.py (pure shape math, copied):
the partitioned parameter leaves grouped into per-layer blocks in the JAX
tree's flatten order (``block_key``: a leaf path's first component), each
leaf priced by its int8 wire (payload and fp32 scales, byte-exact against
``quantization.block_layout`` through ``comm_accounting``'s ring
all-gather) and by its gathered footprint in the compute dtype. The engine
decides ONCE, when it arms stage 3, whether the plan fits
``zero_optimization.stage3_prefetch_budget``; armed, each micro step
gathers every planned leaf once, in the plan's block order, through
``custom_collectives.quantized_all_gather``, and the gathered weights stay
live until that micro step's backward has exchanged the gradients, so the
whole plan (``GatherPlan.gathered_bytes``) is the transient the budget
bounds. The names are the JAX leaf paths (``ZeroPartition.leaves``).
"""
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from deepspeed_tpu_torch.runtime.comm_accounting import all_gather_bytes
from deepspeed_tpu_torch.runtime.quantization import (DEFAULT_BLOCK_SIZE,
                                                      block_layout)

_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "float64": 8}


@dataclass
class GatherLeaf:
    """One partitioned parameter leaf in the plan."""
    name: str               # tree path, e.g. "h_3/attn/qkv"
    index: int              # flat leaf index in the JAX tree's order
    shape: tuple
    shard_dim: int          # dim the ZeRO spec shards over 'data'
    elements: int
    gathered_bytes: int     # replicated footprint in the compute dtype
    wire_bytes: int         # int8 blocks + fp32 scales each rank SENDS


@dataclass
class GatherBlock:
    """One per-layer gather unit: leaves that become live together."""
    key: str
    leaves: List[GatherLeaf] = field(default_factory=list)

    @property
    def gathered_bytes(self) -> int:
        return sum(l.gathered_bytes for l in self.leaves)

    @property
    def wire_bytes(self) -> int:
        return sum(l.wire_bytes for l in self.leaves)


@dataclass
class GatherPlan:
    """The compile-time schedule: ``blocks`` in forward order, plus the
    leaf indices that stay replicated (too small/indivisible to shard —
    nothing to gather)."""
    blocks: List[GatherBlock]
    replicated: List[int]
    dp: int
    block_size: int
    param_dtype: str

    @property
    def n_gathered_leaves(self) -> int:
        return sum(len(b.leaves) for b in self.blocks)

    @property
    def gathered_bytes(self) -> int:
        """Peak transient footprint of the gathered weights: they persist
        from their forward gather to their micro step's gradient exchange,
        so the whole plan is live at once — the number the prefetch budget
        bounds."""
        return sum(b.gathered_bytes for b in self.blocks)

    @property
    def wire_bytes_per_gather(self) -> int:
        return sum(b.wire_bytes for b in self.blocks)

    def within_budget(self, budget: int) -> bool:
        """budget <= 0 means unbounded (armed)."""
        return budget <= 0 or self.gathered_bytes <= budget

    def report(self) -> dict:
        """The docs/metrics rendering: per-block bytes + totals, for
        prefetch-budget sizing from the peak-bytes numbers."""
        return {
            "dp": self.dp,
            "block_size": self.block_size,
            "param_dtype": self.param_dtype,
            "n_blocks": len(self.blocks),
            "n_gathered_leaves": self.n_gathered_leaves,
            "n_replicated_leaves": len(self.replicated),
            "peak_gathered_bytes": self.gathered_bytes,
            "wire_bytes_per_gather": self.wire_bytes_per_gather,
            "blocks": [{"key": b.key,
                        "leaves": [l.name for l in b.leaves],
                        "gathered_bytes": b.gathered_bytes,
                        "wire_bytes": b.wire_bytes}
                       for b in self.blocks],
        }


def block_key(name: str) -> str:
    """Layer-block key of a leaf path: its first path component — for the
    repo's models ("h_3/attn/qkv", "wte") that is exactly the per-layer
    grouping the forward consumes in order."""
    return name.split("/", 1)[0]


def leaf_wire_bytes(elements: int, dp: int, block_size: int) -> int:
    """int8 + fp32-scale bytes ONE rank sends to gather one leaf: its
    local shard quantized, through comm_accounting's own ring all-gather
    model — the agreement with param_gather_collectives' qwZ pricing is
    structural, not a re-derived formula."""
    if dp <= 1:
        return 0
    _, nb, npad = block_layout(elements // dp, block_size)
    return all_gather_bytes(dp * npad, 1, dp) + all_gather_bytes(dp * nb,
                                                                 4, dp)


def build_gather_plan(names: Sequence[str], shapes: Sequence[tuple],
                      shard_dims: Sequence[Optional[int]], dp: int, *,
                      block_size: int = DEFAULT_BLOCK_SIZE,
                      param_dtype: str = "float32") -> GatherPlan:
    """Build the plan from flat leaf facts, in the JAX tree's flatten order.

    ``shard_dims[i]`` is the dim the ZeRO param spec shards over 'data'
    (None = replicated leaf, excluded from the plan).  Consecutive leaves
    sharing a :func:`block_key` form one block, so the emitted gather
    order is the forward traversal of the model tree.
    """
    es = _DTYPE_BYTES.get(param_dtype, 4)
    blocks: List[GatherBlock] = []
    replicated: List[int] = []
    for i, (name, shape, dim) in enumerate(zip(names, shapes, shard_dims)):
        n = 1
        for d in shape:
            n *= int(d)
        if dim is None or dp <= 1 or shape[dim] % dp != 0:
            replicated.append(i)
            continue
        key = block_key(name)
        if not blocks or blocks[-1].key != key:
            blocks.append(GatherBlock(key=key))
        blocks[-1].leaves.append(GatherLeaf(
            name=name, index=i, shape=tuple(shape), shard_dim=dim,
            elements=n, gathered_bytes=n * es,
            wire_bytes=leaf_wire_bytes(n, dp, block_size)))
    return GatherPlan(blocks=blocks, replicated=replicated, dp=dp,
                      block_size=block_size, param_dtype=param_dtype)
