"""Tensor parallelism over the mesh's ``model`` axis (Megatron-style).

The JAX package has no module of this name: its models state a layout
(``param_partition_spec``: deepspeed_tpu/models/gpt2.py
``gpt2_tp_leaf_spec``, models/bert.py ``param_partition_spec``) and
GSPMD inserts the collectives that keep the one-device semantics. Each
process of the port holds one model rank's shards, so the collectives
GSPMD would insert are written here, each standing for one resharding:

- ``copy_to_model`` (identity forward, all-reduce backward): a replicated
  tensor entering a computation split by column (heads, FFN columns,
  vocabulary rows). GSPMD's partial-sum of its cotangent, which every
  rank holds in part, reduced to replicated. ``column_linear`` is the
  pair fused with the layer's product, so that the partials are fp32.
- ``reduce_from_model`` (all-reduce forward, identity backward): the
  output of a layer whose input is split (``c_proj``'s ``P("model",
  None)`` kernel times heads-split activations), a partial sum per rank
  reduced to the replicated activation the next LayerNorm reads.
- ``ColumnParallelDense``: a Dense whose output dim is split. Rank m
  holds output columns [m*n/M, (m+1)*n/M) of each of its ``fused``
  blocks: for the fused QKV projection (``fused=3``) that is its heads'
  q, k and v columns, where the JAX spec ``P(None, "model")`` would hand
  it a contiguous third of [q|k|v] and GSPMD then moves the data to the
  heads (``P("data", "model", ...)`` on the attention's inputs). Same
  shard size, permuted columns: ``TensorParallelLayout`` maps between
  the two. A bias the JAX spec replicates (BERT's ``qkv`` and
  ``ffn_inter`` biases, ``bias_replicated``) stays whole on every rank;
  the rank adds its part, and the bias passes ``copy_to_model`` first, so
  that its gradient, a partial on each rank, is summed over the line
  (``tp_grad_ar:<leaf>``).
- ``RowParallelDense``: a Dense whose input dim is split; its bias is
  replicated and added after the reduction, as ``c_proj``'s ``P()`` bias.

Below fp32 every partial sum over the line (the row-parallel outputs, the
column-parallel layers' and the tied head's input gradients) is kept in
fp32 (operands in the compute dtype, fp32 accumulation), all-reduced in
fp32 and rounded once: the one-device GEMM accumulates in fp32 and rounds
once, where a partial rounded to bf16 before the sum rounds M + 1 times.
- ``vocab_parallel_embedding``: rows of the table split by vocabulary
  (``wte``: ``P("model", None)``): ids outside the rank's rows look up 0,
  then one all-reduce (GSPMD's masked gather plus psum).
- ``vocab_parallel_chunked_nll`` / ``vocab_parallel_logz_gold``: the
  softmax cross-entropy over logits split by vocabulary: the row max is a
  MAX all-reduce, the sum of exponentials and the target logit (taken on
  the rank that owns it) one SUM all-reduce; the backward runs on the
  rank's local logits only.

At M = 1 (``group`` None) every function is the identity on the
single-process path and every layer is a plain Dense.
"""
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from deepspeed_tpu_torch.models.convert import (fused_join, fused_local,
                                                tp_param_specs)
from deepspeed_tpu_torch.ops.transformer.transformer import Dense


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, name, prefix):
        ctx.group, ctx.name, ctx.prefix = group, name, prefix
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        if not grad.is_meta:
            ctx.group.all_reduce(grad, ctx.name, ctx.prefix)
        return grad, None, None, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, name, prefix):
        out = x.contiguous().clone()
        if not out.is_meta:
            group.all_reduce(out, name, prefix)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None, None


def copy_to_model(x, group, name, prefix="tp_ar"):
    """``x`` itself forward; its gradient summed over ``group`` (the
    ``model`` line) backward, counted as ``<prefix>:<name>``."""
    if group is None:
        return x
    return _CopyToModel.apply(x, group, name, prefix)


def reduce_from_model(x, group, name, prefix="tp_ar"):
    """``x`` summed over ``group`` forward (``<prefix>:<name>``); the
    gradient passes unchanged backward."""
    if group is None:
        return x
    return _ReduceFromModel.apply(x, group, name, prefix)


class ColumnParallelDense(Dense):
    """A Dense with its output split over the ``model`` line (module
    docstring). ``fused``: the blocks of the output (3 for a fused QKV)
    each split alike; ``bias_replicated``: the bias stays whole (the JAX
    spec's ``P()``) and the rank adds its part. ``name`` names the site
    for the counter. At ``group`` None a plain Dense."""
    group = None

    def __init__(self, in_features, out_features, fused=1,
                 bias_replicated=False, name=""):
        super().__init__(in_features, out_features)
        self.fused = fused
        self.bias_replicated = bias_replicated
        self.site = name

    def local_bias(self):
        if not (self.bias_replicated and self.group is not None):
            return self.bias
        b = copy_to_model(self.bias, self.group, f"{self.site}/bias",
                          "tp_grad_ar")
        return fused_local(b, (0, self.fused), self.group.rank,
                           self.group.size)

    def forward(self, x):
        if self.group is None:
            return super().forward(x)
        return column_linear(x, self.weight.to(x.dtype),
                             self.local_bias().to(x.dtype), self.group,
                             f"{self.site}_bwd")


def _mm_f32(a, b):
    """a @ b of compute-dtype operands with an fp32 result (fp32
    accumulation, no rounding to the compute dtype)."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a.reshape(-1, a.shape[-1]), b,
                        out_dtype=torch.float32).view(
            a.shape[:-1] + (b.shape[-1],))
    return a.float() @ b.float()


def _sum_partial(t, group, name, dtype):
    """The fp32 partial ``t`` summed over ``group`` and rounded once to
    ``dtype``."""
    if not t.is_meta:
        group.all_reduce(t, name)
    return t.to(dtype)


class _PartialProduct(torch.autograd.Function):
    """x @ w.T from compute-dtype operands with an fp32 result (fp32
    accumulation); the backward's gradient, the fp32 image of a
    compute-dtype one, runs the compute-dtype products."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm_f32(x, w.t())

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        gw = g.reshape(-1, g.shape[-1]).t() @ x.reshape(-1, x.shape[-1])
        return g @ w, gw


class _ColumnLinear(torch.autograd.Function):
    """F.linear(x, w, b) of a replicated ``x`` against this rank's output
    columns; the backward sums the input's gradient over the line (the
    ``copy_to_model`` pair) from fp32 partials."""

    @staticmethod
    def forward(ctx, x, w, b, group, name):
        ctx.save_for_backward(x, w)
        ctx.group, ctx.name, ctx.bias = group, name, b is not None
        return F.linear(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = _sum_partial(_mm_f32(g, w), ctx.group, ctx.name, x.dtype)
        g2 = g.reshape(-1, g.shape[-1])
        dw = g2.t() @ x.reshape(-1, x.shape[-1])
        db = g2.sum(0) if ctx.bias else None
        return dx, dw, db, None, None


def column_linear(x, w, b, group, name):
    """F.linear(x, w, b) with ``w`` (and ``b``) this rank's output columns
    and ``x`` replicated over ``group``; its gradient is summed over the
    line backward (``tp_ar:<name>``). At ``group`` None a plain F.linear."""
    if group is None:
        return F.linear(x, w, b)
    return _ColumnLinear.apply(x, w, b, group, name)


class RowParallelDense(Dense):
    """A Dense with its input split over the ``model`` line: this rank's
    columns of the kernel times its part of the input, summed over the
    line, then the replicated bias. At ``group`` None a plain Dense."""
    group = None

    def __init__(self, in_features, out_features, name=""):
        super().__init__(in_features, out_features)
        self.site = name

    def forward(self, x):
        if self.group is None:
            return super().forward(x)
        w = self.weight.to(x.dtype)
        if x.dtype == torch.float32 or x.is_meta:
            y = F.linear(x, w)
        else:
            # the partial sums in fp32, rounded once after the sum
            y = _PartialProduct.apply(x, w)
        y = reduce_from_model(y, self.group, self.site).to(x.dtype)
        return y + self.bias.to(x.dtype)


def vocab_parallel_embedding(ids, table, group, dtype, name="wte"):
    """Rows ``ids`` of the whole table, of which ``table`` holds this
    rank's (a contiguous 1/M of the vocabulary), in ``dtype``: ids outside
    them look up 0, and one all-reduce (``tp_vocab:<name>``) sums the
    ranks' lookups. At ``group`` None a plain lookup."""
    if group is None:
        return F.embedding(ids, table).to(dtype)
    n = table.shape[0]
    start = group.rank * n
    local = ids - start
    own = (local >= 0) & (local < n)
    x = F.embedding(local.clamp(0, n - 1), table).to(dtype)
    x = x.masked_fill(~own[..., None], 0.0)
    return reduce_from_model(x, group, name, "tp_vocab")


def vocab_parallel_logz_gold(logits, labels, group, name="loss",
                             valid_vocab: Optional[int] = None):
    """(logz, gold) of the rows of ``logits`` (..., V/M), this rank's
    vocabulary columns in fp32, against ``labels`` (whole-vocabulary ids;
    any outside [0, V) gathers 0): the row max a MAX all-reduce, the sum
    of exponentials and the target logit one SUM all-reduce, all counted
    as ``tp_vocab:<name>``. Differentiable in ``logits``: each rank's
    gradient is its own columns' part. ``valid_vocab``: columns at or
    beyond it are masked (-1e9)."""
    n = logits.shape[-1]
    start = group.rank * n
    if valid_vocab is not None and valid_vocab < start + n:
        cols = torch.arange(start, start + n, device=logits.device)
        logits = torch.where(cols < valid_vocab, logits,
                             torch.full((), -1e9, device=logits.device))
    mx = logits.detach().amax(-1)
    if not mx.is_meta:
        group.all_reduce(mx, f"{name}/max", "tp_vocab",
                         op=dist.ReduceOp.MAX)
    local = labels.long() - start
    own = (local >= 0) & (local < n)
    gold = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = torch.where(own, gold, torch.zeros_like(gold))
    se = torch.exp(logits - mx[..., None]).sum(-1)
    both = reduce_from_model(torch.stack((se, gold)), group, f"{name}/sum",
                             "tp_vocab")
    return torch.log(both[0]) + mx, both[1]


class _VocabParallelChunk(torch.autograd.Function):
    """Σ m·nll of one token chunk (its hidden states replicated over the
    line) against the rank's rows of the tied head; the backward
    recomputes the rank's logits and sums the hidden states' gradient over
    the line from fp32 partials (``tp_ar:head_bwd``)."""

    @staticmethod
    def forward(ctx, x, wte, y, m, valid_vocab, group, name):
        logits = (x @ wte.to(x.dtype).t()).float()
        n = wte.shape[0]
        start = group.rank * n
        if valid_vocab is not None and valid_vocab < start + n:
            logits[:, max(valid_vocab - start, 0):] = -1e9
        mx = logits.amax(-1)
        meta = mx.is_meta        # a FLOP count's replay moves nothing
        if not meta:
            group.all_reduce(mx, f"{name}/max", "tp_vocab",
                             op=dist.ReduceOp.MAX)
        local = y.long() - start
        own = (local >= 0) & (local < n) & (m > 0)
        idx = local.clamp(0, n - 1)
        gold = torch.where(own, torch.gather(logits, -1, idx[:, None])[:, 0],
                           torch.zeros_like(mx))
        both = torch.stack((torch.exp(logits - mx[:, None]).sum(-1), gold))
        if not meta:
            group.all_reduce(both, f"{name}/sum", "tp_vocab")
        logz = torch.log(both[0]) + mx
        ctx.save_for_backward(x, wte, idx, own, m, logz)
        ctx.valid, ctx.start, ctx.group = valid_vocab, start, group
        return ((logz - both[1]) * m).sum()

    @staticmethod
    def backward(ctx, g):
        x, wte, idx, own, m, logz = ctx.saved_tensors
        w = wte.to(x.dtype)
        logits = (x @ w.t()).float()
        valid, start = ctx.valid, ctx.start
        if valid is not None and valid < start + wte.shape[0]:
            logits[:, max(valid - start, 0):] = -1e9
        d = torch.exp(logits - logz[:, None]) * (m * g)[:, None]
        d.scatter_add_(1, idx[:, None],
                       -(own.float() * m * g)[:, None])
        d = d.to(x.dtype)
        dx = _sum_partial(_mm_f32(d, w), ctx.group, "head_bwd", x.dtype)
        return dx, (d.t() @ x).to(wte.dtype), None, None, None, None, None


def vocab_parallel_chunked_nll(x, wte, y, valid, chunk, group,
                               valid_vocab=None, name="loss"):
    """(Σ valid·nll, Σ valid) of the rows of ``x`` (n, E; replicated over
    the line) against this rank's rows ``wte`` of the tied head, ``chunk``
    rows at a time (models/api.py ``chunked_lm_cross_entropy`` over a
    vocabulary split by ``model``)."""
    nll = torch.zeros((), device=x.device)
    for i in range(0, x.shape[0], chunk):
        nll = nll + _VocabParallelChunk.apply(
            x[i:i + chunk], wte, y[i:i + chunk], valid[i:i + chunk],
            valid_vocab, group, name)
    return nll, valid.sum()


def shard_module(module, group, specs):
    """Keep model rank ``group.rank``'s part (``fused_local``) of each
    parameter of the whole ``module`` that ``specs`` (models/convert.py
    ``tp_param_specs``) splits, and hand ``group`` to its column- and
    row-parallel layers."""
    with torch.no_grad():
        for name, spec in specs.items():
            owner, _, leaf = name.rpartition(".")
            mod = module.get_submodule(owner)
            setattr(mod, leaf, torch.nn.Parameter(fused_local(
                getattr(mod, leaf), spec, group.rank, group.size)))
    for m in module.modules():
        if isinstance(m, (ColumnParallelDense, RowParallelDense)):
            m.group = group


class TensorParallelLayout:
    """Which parameters of a module are split over the ``model`` line and
    how: ``spec[i]`` None (replicated) or (dim, fused) for parameter i
    (models/convert.py ``tp_param_specs``). ``local`` takes a whole
    parameter's rank part, ``gather`` rebuilds the whole from every
    rank's (an all-gather over ``group``, not counted: a checkpoint's),
    ``full_shape`` is the whole parameter's shape."""

    def __init__(self, module, param_names, group):
        self.group = group
        self.size = 1 if group is None else group.size
        specs = tp_param_specs(module) if group is not None else {}
        self.spec = [specs.get(n) for n in param_names]

    def full_shape(self, i, shape):
        s = self.spec[i]
        if s is None:
            return tuple(shape)
        shape = list(shape)
        shape[s[0]] *= self.size
        return tuple(shape)

    def local(self, full, i):
        s = self.spec[i]
        if s is None:
            return full
        return fused_local(full, s, self.group.rank, self.size)

    def gather(self, t, i):
        s = self.spec[i]
        if s is None:
            return t
        dim, fused = s
        t = t.movedim(dim, 0).contiguous()
        out = torch.empty((self.size * t.shape[0],) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        self.group.all_gather(out, t)
        return fused_join(list(out.chunk(self.size)), (0, fused)) \
            .movedim(0, dim)

    def split(self):
        """Whether each parameter is this rank's part of a leaf split
        over the line (its squared norm sums over it)."""
        return [s is not None for s in self.spec]
