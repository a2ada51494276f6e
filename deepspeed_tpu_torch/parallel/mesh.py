"""The mesh's axes as a process grid: one ``torch.distributed`` process
group per line of each axis.

Port of deepspeed_tpu/parallel/mesh.py. The JAX package lays one named-
axis mesh over all chips, in the axis order ``AXIS_ORDER`` (pipe, data,
seq, model); here each process owns one device, and rank r holds the
mesh coordinates of JAX device r: r = ((p * D + d) * N + s) * M + m
(``ProcessGrid``), so that it feeds the batch rows and holds the sequence
chunk that JAX device r holds. ``resolve_grid`` holds the config's mesh
to the world with the JAX package's ``resolve_mesh_shape``; the ``model``
and ``pipe`` axes still raise, naming the ROADMAP item that ports each.
utils/distributed.py builds each line's group. ``zero_merge_dim`` is
``zero_merge_spec``'s rule (mesh.py:171-197): a leaf shards over
``data`` along its largest dimension that the tensor-parallel spec leaves
free and the data-parallel size divides, and nothing shards over ``seq``.

``DataParallelGroup`` (a ``data`` line) and ``SequenceParallelGroup``
(a ``seq`` line) issue the engine's and the model's collectives on the
current stream (no host sync) and record each in one
``CollectiveCounter``. ``expert_exchange`` is the MoE layer's token
exchange over the data group (the all-to-all GSPMD inserts where the JAX
layer's dispatched activations flip from batch-sharded to
expert-sharded), ``global_mean`` the mean of a rank's statistics over a
group, both differentiable.
"""
import numpy as np
import torch
import torch.distributed as dist

from deepspeed_tpu_torch.runtime.comm_accounting import (CollectiveCounter,
                                                         zero_shard_dim)

PIPE_AXIS = "pipe"
DATA_AXIS = "data"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"
# seq sits between data and model (the JAX package's order): a rank's
# sequence neighbours are its nearest ranks
AXIS_ORDER = (PIPE_AXIS, DATA_AXIS, SEQ_AXIS, MODEL_AXIS)
# the mesh axes still to come, and the ROADMAP item that ports each
UNPORTED_AXES = {MODEL_AXIS: "A7b", PIPE_AXIS: "A12"}


def resolve_mesh_shape(mesh_shape: dict, n_devices: int):
    """Fill in the -1 axis; the product must be ``n_devices``. The JAX
    package's function and messages, as ValueError, but the port has no
    partial mesh: each process owns one device, and every process of the
    world must hold a place in the mesh."""
    shape = {PIPE_AXIS: mesh_shape.get(PIPE_AXIS, 1),
             DATA_AXIS: mesh_shape.get(DATA_AXIS, -1),
             SEQ_AXIS: mesh_shape.get(SEQ_AXIS, 1),
             MODEL_AXIS: mesh_shape.get(MODEL_AXIS, 1)}
    free_axes = [a for a, s in shape.items() if s == -1]
    fixed = int(np.prod([s for s in shape.values() if s != -1]))
    if len(free_axes) > 1:
        raise ValueError(f"at most one mesh axis may be -1, got {shape}")
    if free_axes:
        if n_devices % fixed != 0:
            raise ValueError(f"{n_devices} devices not divisible by fixed "
                             f"axes product {fixed}")
        shape[free_axes[0]] = n_devices // fixed
    total = int(np.prod(list(shape.values())))
    if total != n_devices:
        raise ValueError(
            f"mesh {shape} covers {total} of the world's {n_devices} "
            f"processes: the mesh must cover the world exactly (one "
            f"process per device; the port has no partial mesh, whatever "
            f'mesh["allow_partial"] says)')
    return shape


def resolve_grid(mesh_shape: dict, world_size: int) -> dict:
    """The config's mesh over a world of ``world_size`` processes (one per
    device): {axis: size}, whose product is the world. ``model`` or
    ``pipe`` above 1 raises NotImplementedError naming its ROADMAP item;
    ``data`` (-1: what the other axes leave) and ``seq`` must cover the
    world exactly (a partial mesh would leave processes idle)."""
    for axis, item in UNPORTED_AXES.items():
        size = mesh_shape.get(axis, 1)
        if size not in (1, -1):
            raise NotImplementedError(
                f"mesh axis {axis!r} of size {size} is not ported yet "
                f"(ROADMAP {item})")
    data = mesh_shape.get(DATA_AXIS, -1)
    if mesh_shape.get(SEQ_AXIS, 1) == 1 and data not in (-1, world_size):
        raise ValueError(
            f"mesh data={data}, but the world has {world_size} "
            f"process(es): start {data} processes (one per device) and "
            f"call init_distributed(), or set data to -1")
    return resolve_mesh_shape({DATA_AXIS: data,
                               SEQ_AXIS: mesh_shape.get(SEQ_AXIS, 1)},
                              world_size)


class ProcessGrid:
    """The mesh ``shape`` ({axis: size}, ``resolve_grid``) over the world's
    ranks in the JAX mesh's device order: ``coords`` of ``rank`` and the
    ranks of each axis's lines."""

    def __init__(self, shape: dict, rank: int):
        self.shape = {a: int(shape[a]) for a in AXIS_ORDER}
        self.sizes = tuple(self.shape[a] for a in AXIS_ORDER)
        self.world = int(np.prod(self.sizes))
        self.rank = rank
        self.coords = dict(zip(AXIS_ORDER, (int(c) for c in np.unravel_index(
            rank, self.sizes))))

    def lines(self, axis):
        """Every line along ``axis``: the ranks that differ in ``axis``
        alone, in coordinate order; the lines in rank order."""
        ranks = np.arange(self.world).reshape(self.sizes)
        k = AXIS_ORDER.index(axis)
        return [list(map(int, line))
                for line in np.moveaxis(ranks, k, -1).reshape(
                    -1, self.sizes[k])]

    def line(self, axis):
        """This rank's line along ``axis``."""
        return next(line for line in self.lines(axis) if self.rank in line)


def zero_merge_dim(shape, dp: int, taken=()):
    """The dimension ZeRO shards a leaf of ``shape`` along over ``data``
    (None: it stays replicated). ``taken``: the dims the tensor-parallel
    spec gives to ``model`` (its size does not matter, as in the JAX
    package's spec)."""
    if dp == 1 or len(shape) == 0:
        return None
    return zero_shard_dim(shape, dp, taken)


class DataParallelGroup:
    """The data-parallel process group (a ``data`` line; None: the world):
    its size and this process's rank, and the collectives the engine
    issues over it, each recorded leaf by leaf in ``counter`` (shared with
    the grid's other groups). Every call enqueues on the current stream."""

    def __init__(self, group=None, counter=None):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = dist.get_backend(group)
        self.counter = CollectiveCounter() if counter is None else counter

    def all_reduce(self, tensor, leaves=(), op=dist.ReduceOp.SUM):
        """In place; ``leaves`` [(name, elements)] of gradients names what
        the call carries, else it counts as a scalar reduction."""
        if leaves:
            self.counter.record("all-reduce", "grad_ar", tensor.dtype,
                                leaves, self.size)
        else:
            self.counter.record_scalar()
        dist.all_reduce(tensor, op=op, group=self.group)
        return tensor

    def reduce_scatter(self, out, inp, leaves):
        """Sum ``inp`` (rank-major, ``size * out.numel()`` elements) over
        the group; this rank's part into ``out``."""
        self.counter.record("reduce-scatter", "grad_rs", inp.dtype, leaves,
                            self.size)
        dist.reduce_scatter_tensor(out, inp, group=self.group)
        return out

    def all_gather(self, out, inp, leaves=()):
        """Every rank's ``inp`` into ``out``, rank-major; ``leaves`` names
        the parameters it carries (none: a checkpoint's gather, not part of
        the step and not counted)."""
        if leaves:
            self.counter.record("all-gather", "param_ag", inp.dtype, leaves,
                                self.size)
        dist.all_gather_into_tensor(out, inp, group=self.group)
        return out

    def all_to_all(self, out, inp, leaves=()):
        """Chunk j of ``inp`` (split evenly along dim 0) to rank j; rank
        j's chunk for this rank into chunk j of ``out``. ``leaves`` [(name,
        elements)] names what the call carries for the counter."""
        if leaves:
            self.counter.record("all-to-all", "moe_a2a", inp.dtype, leaves,
                                self.size)
        dist.all_to_all_single(out, inp, group=self.group)
        return out

    def quantized_all_to_all(self, out, inp, prefix, leaves, link="flat"):
        """An all-to-all of a quantized wire (int8 codes or their fp32
        scales), counted as ``<prefix>:<leaf>`` per entry of ``leaves``
        [(name, elements, wire elements)]."""
        self.counter.record("all-to-all", prefix, inp.dtype, leaves,
                            self.size, link)
        dist.all_to_all_single(out, inp, group=self.group)
        return out

    def quantized_all_gather(self, out, inp, prefix, leaves, link="flat"):
        """An all-gather of a quantized wire into ``out`` (rank-major),
        counted as ``<prefix>:<leaf>`` per entry of ``leaves``."""
        self.counter.record("all-gather", prefix, inp.dtype, leaves,
                            self.size, link)
        dist.all_gather_into_tensor(out, inp, group=self.group)
        return out

    def hierarchy(self, k):
        """(intra, inter): this rank's group of k consecutive ranks of
        the line and its group of the ranks with its intra index, each a
        ``DataParallelGroup`` on this group's counter (the two hops of
        hierarchical qgZ). Built at the first call, which every rank of
        the line makes alike."""
        cached = getattr(self, "_hierarchy", None)
        if cached is not None and cached[0] == k:
            return cached[1]
        from deepspeed_tpu_torch.utils.distributed import hierarchical_groups

        ranks = [dist.get_global_rank(self.group, i)
                 if self.group is not None else i for i in range(self.size)]
        intra, inter = hierarchical_groups(ranks, k, dist.get_rank())
        pair = (DataParallelGroup(intra, self.counter),
                DataParallelGroup(inter, self.counter))
        self._hierarchy = (k, pair)
        return pair

    def all_gather_ints(self, values):
        """A host list of int64 from every rank: (size, len(values)) (a
        checkpoint's check, not counted)."""
        dev = "cuda" if self.backend == "nccl" else "cpu"
        mine = torch.tensor(values, dtype=torch.int64, device=dev)
        out = torch.empty(self.size * mine.numel(), dtype=torch.int64,
                          device=dev)
        dist.all_gather_into_tensor(out, mine, group=self.group)
        return out.view(self.size, -1).cpu()

    def barrier(self):
        dist.barrier(group=self.group)


class SequenceParallelGroup(DataParallelGroup):
    """A ``seq`` line's process group (None: the world): its size, this
    process's sequence rank, and the collectives of sequence parallelism,
    recorded in ``counter`` under their own names: the gradient all-reduce
    over the line (``sp_grad_ar:<leaf>``), the Ulysses all-to-alls
    (``sp_a2a:<name>``) and the ring's hops (``sp_ring:<name>``). Every
    call enqueues on the current stream."""

    def __init__(self, group=None, counter=None):
        super().__init__(group, counter)
        self.ranks = [dist.get_global_rank(group, i) if group is not None
                      else i for i in range(self.size)]

    def all_reduce(self, tensor, leaves=()):
        """SUM in place; ``leaves`` [(name, elements)] names the gradients
        the call carries, else it counts as a scalar reduction."""
        if leaves:
            self.counter.record("all-reduce", "sp_grad_ar", tensor.dtype,
                                leaves, self.size)
        else:
            self.counter.record_scalar()
        dist.all_reduce(tensor, group=self.group)
        return tensor

    def all_to_all(self, out, inp, name):
        """Chunk j of ``inp`` (even along dim 0) to sequence rank j; rank
        j's chunk for this rank into chunk j of ``out``."""
        self.counter.record("all-to-all", "sp_a2a", inp.dtype,
                            [(name, inp.numel())], self.size)
        dist.all_to_all_single(out, inp, group=self.group)
        return out

    def broadcast(self, tensor, name):
        """Sequence rank 0's ``tensor`` into every rank's, in place
        (``sp_bcast:<name>``)."""
        self.counter.record("broadcast", "sp_bcast", tensor.dtype,
                            [(name, tensor.numel())], self.size)
        dist.broadcast(tensor, self.ranks[0], group=self.group)
        return tensor

    def offset(self, s_local):
        """The whole sequence's position of this rank's first, each rank
        holding ``s_local`` positions."""
        return self.rank * s_local

    def chunk(self, x, dim=1, shift=0):
        """This rank's chunk of ``x``, whose ``dim`` is the whole sequence
        (a view): its positions moved by ``shift`` (1: each position's next
        label), clipped at the sequence's end."""
        n = x.shape[dim]
        if n % self.size != 0:
            raise ValueError(
                f"Batch dim1 (sequence)={n} is not divisible by the 'seq' "
                f"mesh axis size {self.size}; pad the sequence so each "
                f"seq-parallel rank gets equal tokens")
        s = n // self.size
        start = self.offset(s) + shift
        return x.narrow(dim, start, min(s, n - start))

    def shift(self, sends, recvs, names):
        """One hop around the ring: each of ``sends`` to sequence rank
        (r + 1) mod N, each of ``recvs`` from (r - 1) mod N, posted
        together; returns the requests to wait on."""
        nxt = self.ranks[(self.rank + 1) % self.size]
        prv = self.ranks[(self.rank - 1) % self.size]
        ops = []
        for t, name in zip(sends, names):
            self.counter.record("collective-permute", "sp_ring", t.dtype,
                                [(name, t.numel())], self.size)
            ops.append(dist.P2POp(dist.isend, t, nxt, self.group))
        ops += [dist.P2POp(dist.irecv, t, prv, self.group) for t in recvs]
        return dist.batch_isend_irecv(ops)


def _exchange(x, group, name, to_experts):
    """to_experts: (E, G_l, ...) -> (E/dp, dp*G_l, ...): the chunk of
    experts [j*E/dp, (j+1)*E/dp) goes to rank j, and the groups come back
    in rank order (the global batch's). Else the reverse: (E/dp, dp*G_l,
    ...) -> (E, G_l, ...), each rank's groups back to it."""
    w = group.size
    rest = tuple(x.shape[2:])
    if to_experts:
        E, Gl = x.shape[:2]
        send = x.contiguous()
    else:
        El, G = x.shape[:2]
        E, Gl = El * w, G // w
        send = x.reshape((El, w, Gl) + rest).transpose(0, 1).contiguous()
    out = torch.empty_like(send)
    if not send.is_meta:     # a FLOP count's replay moves nothing
        group.all_to_all(out, send, leaves=[(name, send.numel())])
    if to_experts:
        return out.view((w, E // w, Gl) + rest).transpose(0, 1) \
            .reshape((E // w, w * Gl) + rest)
    return out.view((E, Gl) + rest)


class _ExpertExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, name, to_experts):
        ctx.group, ctx.name, ctx.to_experts = group, name, to_experts
        return _exchange(x, group, name, to_experts)

    @staticmethod
    def backward(ctx, grad):
        # an even all-to-all is its own transpose: the gradient goes back
        # by the reverse exchange
        return _exchange(grad, ctx.group, f"{ctx.name}_bwd",
                         not ctx.to_experts), None, None, None


def expert_exchange(x, group, name, to_experts):
    """The MoE token exchange over ``group`` (one all-to-all, counted as
    ``moe_a2a:<name>``): ``to_experts`` takes the dispatched tokens (E,
    G_local, C, M) of this rank's batch rows to (E/dp, G, C, M), this
    rank's experts over the whole batch; the reverse takes the experts'
    outputs back. Its backward is the opposite exchange (``<name>_bwd``)."""
    return _ExpertExchange.apply(x, group, name, to_experts)


class _GlobalMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.size = group.size
        out = x.detach().clone()
        if not out.is_meta:
            group.all_reduce(out)
        return out / group.size

    @staticmethod
    def backward(ctx, grad):
        # d mean / d x_r is 1/dp: every rank's loss reads the mean alike
        # (the whole micro-batch's loss, ``group_ratio``), and the engine
        # sums the ranks' gradients, so this rank's term is its own
        # incoming gradient over dp, and no exchange is needed
        return grad / ctx.size, None


def global_mean(x, group):
    """The elementwise mean of ``x`` over ``group``'s ranks (one SUM
    all-reduce, a scalar reduction for the counter), differentiable for
    a loss that every rank evaluates alike and whose gradients the engine
    sums over the group (a model's whole-micro-batch loss)."""
    return _GlobalMean.apply(x, group)


class _SumOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.detach().clone()
        if not out.is_meta:
            group.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        # every rank's loss reads the sum alike, and the engine sums the
        # ranks' parameter gradients over the group: each rank's own term
        # takes the gradient once
        return grad, None


def group_ratio(num, den, group):
    """sum(num) / sum(den) over ``group``'s ranks (one scalar all-reduce of
    the pair): the whole micro-batch's loss, Σnll / Σcount over the rows of
    every data rank and the positions of every seq rank, as the JAX
    engine's one program computes it. Differentiable in ``num`` (``den``
    is a count): each rank takes the gradient of its own tokens' terms,
    and the engine's sum of the ranks' gradients is the loss's."""
    both = _SumOverGroup.apply(torch.stack((num, den.detach().to(num.dtype))),
                               group)
    return both[0] / both[1].clamp(min=1.0)


def from_first_rank(x, group, name):
    """``x`` of the group's rank 0 on every rank (one broadcast,
    ``sp_bcast:<name>``): rank 0's own tensor (its graph intact), elsewhere
    the broadcast copy, which takes no gradient (a term computed from it
    must take its gradient on rank 0 only)."""
    # a copy: the broadcast writes it in place, and x may view the model's
    # activations
    out = x.detach().clone(memory_format=torch.contiguous_format)
    if not out.is_meta:
        group.broadcast(out, name)
    return x if group.rank == 0 else out
