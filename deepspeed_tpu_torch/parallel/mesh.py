"""The data axis of the mesh: one ``torch.distributed`` process group.

Port of the data-axis part of deepspeed_tpu/parallel/mesh.py. The JAX
package lays one named-axis mesh over all chips; here each process owns
one device, and the ``data`` axis is the process group (the world).
``resolve_data_axis`` holds the config's mesh to that world;
``zero_merge_dim`` is ``zero_merge_spec``'s rule (mesh.py:171-197): a
leaf shards over ``data`` along its largest dimension that the tensor-
parallel spec leaves free and the data-parallel size divides.

``DataParallelGroup`` issues the engine's collectives on the current
stream (no host sync) and records each in a ``CollectiveCounter``.
``expert_exchange`` is the MoE layer's token exchange over the group (the
all-to-all GSPMD inserts where the JAX layer's dispatched activations
flip from batch-sharded to expert-sharded), ``global_mean`` the mean of
a rank's statistics over the group, both differentiable.
"""
import torch
import torch.distributed as dist

from deepspeed_tpu_torch.runtime.comm_accounting import (CollectiveCounter,
                                                         zero_shard_dim)

PIPE_AXIS = "pipe"
DATA_AXIS = "data"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"
# the mesh axes still to come, and the ROADMAP item that ports each
UNPORTED_AXES = {MODEL_AXIS: "A7b", PIPE_AXIS: "A12", SEQ_AXIS: "A15"}


def resolve_data_axis(mesh_shape: dict, world_size: int) -> int:
    """The data-parallel size: the config's ``data`` (-1: the whole world)
    must be the world's size; another axis above 1 raises, naming the
    ROADMAP item that ports it."""
    for axis, item in UNPORTED_AXES.items():
        size = mesh_shape.get(axis, 1)
        if size not in (1, -1):
            raise NotImplementedError(
                f"mesh axis {axis!r} of size {size} is not ported yet "
                f"(ROADMAP {item})")
    data = mesh_shape.get(DATA_AXIS, -1)
    if data not in (-1, world_size):
        raise ValueError(
            f"mesh data={data}, but the world has {world_size} "
            f"process(es): start {data} processes (one per device) and "
            f"call init_distributed(), or set data to -1")
    return world_size


def zero_merge_dim(shape, dp: int, taken=()):
    """The dimension ZeRO shards a leaf of ``shape`` along over ``data``
    (None: it stays replicated). ``taken``: the dims the tensor-parallel
    spec gives to ``model`` (its size does not matter, as in the JAX
    package's spec)."""
    if dp == 1 or len(shape) == 0:
        return None
    return zero_shard_dim(shape, dp, taken)


class DataParallelGroup:
    """The data-parallel process group: its size and this process's rank,
    and the collectives the engine issues over it, each recorded leaf by
    leaf in ``counter``. Every call enqueues on the current stream."""

    def __init__(self, group=None):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = dist.get_backend(group)
        self.counter = CollectiveCounter()

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
        out = x.detach().clone()
        if not out.is_meta:
            group.all_reduce(out)
        return out / group.size

    @staticmethod
    def backward(ctx, grad):
        # d mean / d x_r is 1/dp, summed over the dp ranks whose losses
        # read the mean: every rank's loss reads it alike (the engine
        # scales each rank's loss alike), so the sum of the dp incoming
        # gradients over dp is this rank's own, and no exchange is needed
        return grad, None


def global_mean(x, group):
    """The elementwise mean of ``x`` over ``group``'s ranks (one SUM
    all-reduce, a scalar reduction for the counter), differentiable for
    an objective that every rank evaluates on the mean alike, as a data-
    parallel loss does."""
    return _GlobalMean.apply(x, group)
