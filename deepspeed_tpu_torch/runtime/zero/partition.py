"""ZeRO stages 1-3: which elements of each leaf a rank owns.

The JAX engine (deepspeed_tpu/runtime/engine.py:562-685,
``_build_shardings``) shards each leaf of the master weights and the
optimizer state over the ``data`` axis along one dimension
(``mesh.zero_merge_spec``: the largest that the tensor-parallel spec
leaves free and the data-parallel size divides), and at stage 2 the fp32
gradient accumulator too; a leaf with no such dimension stays replicated.
This module is that rule over the port's parameters. A JAX leaf is one
parameter, transposed for a Dense kernel, or, for a scanned stack, the
(L,)-stacked parameters of every layer; its shard dimension maps back onto
the parameters: a slice of each along the matching dimension, or, when
the stack's layer dimension is the one sharded, whole layers.

Expert parallelism (moe/sharded_moe.py ``expert_parallel``): an MoE
expert stack's leaf is split over ``data`` along its expert dimension
(``moe_leaf_spec``), the parameter itself holding this rank's experts. Its
``data`` dimension is taken, so ZeRO leaves it alone at every stage (as
``zero_merge_spec`` does), and its master, optimizer state and gradient
accumulator are this rank's experts too.

A rank's shards of all the sharded parameters pack into one flat
segment of ``seg_size`` elements, the same size on every rank; a buffer
of ``dp`` segments, rank-major, is what one ``reduce_scatter_tensor`` or
``all_gather_into_tensor`` moves for all the leaves at once, and the
packing does not change which elements a rank owns.

Stage 3 keeps only this rank's shards of the compute-dtype parameters
at rest, packed in the same segment; the int8 collectives
(runtime/custom_collectives.py) move each JAX leaf as the JAX package
does, its rank-r part flattened with the shard dimension first:
``leaf_row`` builds this rank's row from its shards, ``leaf_rows`` every
rank's rows from full-shaped tensors, and ``leaf_views`` maps a whole
leaf in the JAX layout back onto the port's parameters.
"""
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from deepspeed_tpu_torch.parallel.mesh import zero_merge_dim


@dataclass
class Leaf:
    """One leaf of the JAX parameter tree: its name and shape there, the
    dimension ZeRO shards it along (None: replicated), the indices of the
    port's parameters it holds, whether it is their transpose (a Dense
    kernel) and whether it stacks them (a scanned stack), and the
    dimension expert parallelism splits over ``data`` (None: not an
    expert stack)."""
    name: str
    shape: Tuple[int, ...]
    shard_dim: Optional[int]
    params: List[int]
    transposed: bool = False
    stacked: bool = False
    expert_dim: Optional[int] = None
    # the dims the tensor-parallel spec gives to ``model``
    tp_taken: Tuple[int, ...] = ()

    @property
    def elements(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n


class ZeroPartition:
    """The per-leaf partition of ``params`` over a data-parallel world of
    ``dp`` ranks at ZeRO ``stage`` (none below stage 1 or at dp 1), seen
    from rank ``rank``. ``slices[i]``: None for a replicated parameter,
    else each rank's (dim, start, length) of parameter i. ``experts``:
    the names of the parameters that hold this rank's experts of a stack
    split over the ``dp`` ranks (``expert[i]``)."""

    def __init__(self, module, param_names, params, dp, rank, stage,
                 experts=()):
        self.dp, self.rank = dp, rank
        self.shapes = [tuple(p.shape) for p in params]
        self.expert = [n in experts for n in param_names]
        self.expert_idx = [i for i, e in enumerate(self.expert) if e]
        self.leaves = _leaves(module, param_names, self.shapes,
                              dp if stage >= 1 else 1, self.expert, dp)
        self.slices = [None] * len(params)
        for leaf in self.leaves:
            if leaf.shard_dim is not None:
                self._split(leaf)
        self.sharded = [s is not None for s in self.slices]
        self.sharded_idx = [i for i, s in enumerate(self.sharded) if s]
        sizes = [sum(self._numel(i, r) for i in self.sharded_idx)
                 for r in range(dp)]
        assert len(set(sizes)) <= 1, sizes
        self.seg_size = sizes[0] if sizes else 0

    def _split(self, leaf):
        d = leaf.shard_dim
        if leaf.stacked and d == 0:
            # the layer dimension: each rank owns whole layers
            per = len(leaf.params) // self.dp
            for j, i in enumerate(leaf.params):
                full = self.shapes[i][0]
                self.slices[i] = [(0, 0, full if r == j // per else 0)
                                  for r in range(self.dp)]
            return
        d -= 1 if leaf.stacked else 0
        for i in leaf.params:
            ndim = len(self.shapes[i])
            tdim = ndim - 1 - d if leaf.transposed else d
            size = self.shapes[i][tdim] // self.dp
            self.slices[i] = [(tdim, r * size, size) for r in range(self.dp)]

    def _numel(self, i, r):
        dim, _, length = self.slices[i][r]
        n = length
        for k, s in enumerate(self.shapes[i]):
            if k != dim:
                n *= s
        return n

    def full_shape(self, i):
        """Parameter i's shape in the whole model: an expert stack's local
        shape with its expert dim times dp."""
        shape = list(self.shapes[i])
        if self.expert[i]:
            shape[0] *= self.dp
        return tuple(shape)

    def expert_local(self, t, i):
        """This rank's experts of ``t``, the whole of parameter i (a view);
        ``t`` itself for any other parameter."""
        if not self.expert[i]:
            return t
        per = self.shapes[i][0]
        return t.narrow(0, self.rank * per, per)

    def slice_shape(self, i, r=None):
        r = self.rank if r is None else r
        shape = list(self.shapes[i])
        dim, _, length = self.slices[i][r]
        shape[dim] = length
        return tuple(shape)

    def narrow(self, t, i, r=None):
        """Rank ``r``'s (default: this rank's) part of parameter i's
        full-shaped tensor ``t``: a view."""
        dim, start, length = self.slices[i][self.rank if r is None else r]
        return t.narrow(dim, start, length)

    def local(self, t, i):
        """This rank's part of ``t`` (full-shaped like parameter i): the
        shard of a sharded parameter, else ``t`` itself."""
        return self.narrow(t, i) if self.sharded[i] else t

    def segment_views(self, buf, r=None):
        """Views into ``buf`` (``seg_size`` elements) shaped as rank
        ``r``'s shards, one per sharded parameter, in order."""
        r = self.rank if r is None else r
        out, at = [], 0
        for i in self.sharded_idx:
            n = self._numel(i, r)
            out.append(buf[at:at + n].view(self.slice_shape(i, r)))
            at += n
        return out

    def rank_major_views(self, buf):
        """[(rank, views)] into ``buf`` (``dp * seg_size`` elements)."""
        s = self.seg_size
        return [(r, self.segment_views(buf[r * s:(r + 1) * s], r))
                for r in range(self.dp)]

    def pack(self, buf, tensors):
        """Copy every rank's part of the full-shaped ``tensors`` (indexed
        like the parameters; None reads as zeros) into ``buf``,
        rank-major: the input of a reduce-scatter."""
        dst, src = [], []
        for r, views in self.rank_major_views(buf):
            for i, v in zip(self.sharded_idx, views):
                if tensors[i] is None:
                    v.zero_()
                else:
                    dst.append(v)
                    src.append(self.narrow(tensors[i], i, r))
        if dst:
            torch._foreach_copy_(dst, src)

    def unpack(self, buf, tensors):
        """Write ``buf`` (rank-major, the output of an all-gather) into
        each rank's part of the full-shaped ``tensors``."""
        dst, src = [], []
        for r, views in self.rank_major_views(buf):
            for i, v in zip(self.sharded_idx, views):
                dst.append(self.narrow(tensors[i], i, r))
                src.append(v)
        if dst:
            torch._foreach_copy_(dst, src)

    def leaf_tensor(self, leaf, tensors, local=False):
        """The JAX-layout leaf (``local``: this rank's shard of it) from
        the port's ``tensors`` (full-shaped, or this rank's parts); None
        in ``tensors`` reads as zeros."""
        ref = next(t for t in tensors if t is not None)
        parts = []
        for i in leaf.params:
            if local and leaf.stacked and leaf.shard_dim == 0 \
                    and self.slices[i][self.rank][2] == 0:
                continue            # a whole layer another rank owns
            t = tensors[i]
            if t is None:
                t = torch.zeros(self.slice_shape(i) if local
                                else self.shapes[i], dtype=ref.dtype,
                                device=ref.device)
            parts.append(_reverse(t) if leaf.transposed else t)
        return torch.stack(parts) if leaf.stacked else parts[0]

    def leaf_row(self, leaf, tensors):
        """This rank's shard of ``leaf`` from ``tensors`` (this rank's
        parts of the parameters, e.g. the shards at rest), flattened with
        the shard dimension first: (n / dp,)."""
        return self.leaf_tensor(leaf, tensors, True) \
            .movedim(leaf.shard_dim, 0).reshape(-1)

    def leaf_rows(self, leaf, tensors):
        """Every rank's shard of ``leaf`` from full-shaped ``tensors`` (a
        gradient tree), one row each: (dp, n / dp)."""
        return self.leaf_tensor(leaf, tensors, False) \
            .movedim(leaf.shard_dim, 0).reshape(self.dp, -1)

    def leaf_views(self, leaf, full):
        """[(parameter index, view)] of ``full``, a tensor in the layout
        of the JAX leaf (or of this rank's shard of it), as the port's
        parameters."""
        parts = full.unbind(0) if leaf.stacked else [full]
        if leaf.stacked and leaf.shard_dim == 0 \
                and len(parts) < len(leaf.params):
            idx = [i for i in leaf.params
                   if self.slices[i][self.rank][2] > 0]
        else:
            idx = leaf.params
        return [(i, _reverse(t) if leaf.transposed else t)
                for i, t in zip(idx, parts)]

    def leaf_map(self):
        """The JAX tree's leaves as a leaf map of the 1-bit optimizers
        (ops/onebit): each leaf flattened in its JAX layout from the
        port's full-shaped tensors, and written back."""
        return LeafMap(self)

    def leaf_elements(self, sharded):
        """[(leaf name, elements)] of the sharded (or the replicated)
        leaves: what a collective over them carries, for the counter."""
        return [(leaf.name, leaf.elements) for leaf in self.leaves
                if (leaf.shard_dim is not None) == sharded]


class LeafMap:
    """``names``, ``shapes`` and ``sizes`` of the JAX leaves; ``gather(j,
    tensors)``: leaf j flat in its JAX layout (a copy where that differs
    from the parameter's), ``scatter(j, tensors, flat)``: written back
    into the port's tensors in place."""

    def __init__(self, partition):
        self.partition = partition
        self.leaves = partition.leaves
        self.names = [leaf.name for leaf in self.leaves]
        self.shapes = [tuple(leaf.shape) for leaf in self.leaves]
        self.sizes = [leaf.elements for leaf in self.leaves]

    def gather(self, j, tensors):
        return self.partition.leaf_tensor(self.leaves[j], tensors) \
            .reshape(-1)

    def scatter(self, j, tensors, flat):
        leaf = self.leaves[j]
        for i, v in self.partition.leaf_views(leaf, flat.view(leaf.shape)):
            tensors[i].copy_(v)


def _reverse(t):
    """``t`` with its dims reversed: a Dense kernel's JAX layout (a
    view)."""
    return t.permute(*reversed(range(t.dim())))


def _leaves(module, param_names, shapes, dp, expert, world):
    """The JAX tree's leaves over the port's parameters, each with its
    ZeRO dimension at ``dp`` (None for an expert stack split over the
    ``world`` ranks, whose shape is the whole stack's). A model without
    ``reference_leaf_specs`` has one leaf per parameter, with no
    tensor-parallel spec (as a JAX model without
    ``param_partition_spec``)."""
    index = {n: i for i, n in enumerate(param_names)}
    if hasattr(module, "reference_leaf_specs"):
        specs = module.reference_leaf_specs()
        paths = module.reference_leaf_paths()
    else:
        specs = [(n, False) for n in param_names]
        paths = list(param_names)
    out = []
    for path, (names, transposed) in zip(paths, specs):
        stacked = isinstance(names, tuple)
        idx = [index[n] for n in (names if stacked else (names,))]
        shape = shapes[idx[0]][::-1] if transposed else shapes[idx[0]]
        if stacked:
            shape = (len(idx),) + shape
        if expert[idx[0]]:
            edim = module.expert_dim(path)
            shape = tuple(s * world if d == edim else s
                          for d, s in enumerate(shape))
            out.append(Leaf(path, shape, None, idx, transposed, stacked,
                            edim))
            continue
        taken = module.tp_taken(path, len(shape), stacked) \
            if hasattr(module, "tp_taken") else ()
        out.append(Leaf(path, tuple(shape),
                        zero_merge_dim(shape, dp, taken), idx, transposed,
                        stacked, tp_taken=tuple(taken)))
    covered = sorted(i for leaf in out for i in leaf.params)
    if covered != list(range(len(param_names))):
        raise ValueError("the model's reference_leaf_specs do not cover "
                         "each trainable parameter exactly once")
    return out
