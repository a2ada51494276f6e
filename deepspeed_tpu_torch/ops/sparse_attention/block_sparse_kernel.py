"""Block-sparse attention: hand-written Hopper kernels and their plain versions.

Port of deepspeed_tpu/ops/sparse_attention/block_sparse_kernel.py. The three
Pallas TPU kernels there (``_fwd_kernel``, ``_bwd_dq_kernel``,
``_bwd_dkdv_kernel``) are CUDA kernels here, in
``csrc/block_sparse_attention.cu``, built for sm_90a at first use
(ops/op_builder.py) and launched through ctypes on PyTorch's current stream.
At bf16 and block 64 or 128 all three run on the tensor cores (wgmma, TMA),
with p and dS split into two bf16 parts for their second products so that
they keep the fp32 accuracy of the Pallas kernels; fp32 and blocks 16 and 32
run scalar fp32 kernels.

A (H, S/block, S/block) 0/1 layout becomes lookup tables (``build_luts``):
the forward and dQ sweeps walk, per (batch*head, query block), only the
active key blocks ``cols[h, qb, :nnz]``; the dK/dV sweep walks, per key
block, the transpose table ``rows_t[h, kb, :nnz_t]``, taking the key blocks
of each head longest first (``order_t``: by descending ``nnz_t``). The
tables are built once per layout and device and kept on the device
(``luts_for``), so a layer call makes no host-to-device copy and no host
sync.

Each kernel has one wrapper (``sparse_fwd``, ``sparse_bwd_dq``,
``sparse_bwd_dkdv``) and one plain PyTorch version of the same function
(``sparse_fwd_plain`` ...), which walks the same tables with the same -1e30
arithmetic. A wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches the kernel or raises. ``LAUNCHES`` counts kernel
launches per kernel, and only kernel launches. Each kernel also states the
FLOPs one launch computes (``sparse_fwd_flops`` ...), summed over the
layout's active blocks; meta tensors inside the telemetry's FLOP count
(telemetry/mfu.py ``count_flops``) run neither kernel nor plain version
and add those FLOPs to the count.

The forward saves the per-row logsumexp; the backward computes
``delta = rowsum(dO * O)`` in fp32 and runs the dQ and dK/dV sweeps, as
the JAX package's ``_sparse_bwd`` does. The per-key bias (key padding) is a
constant and gets no gradient.
"""
from typing import NamedTuple, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.telemetry.mfu import add_kernel_flops, counting

NEG_INF = -1e30
HEAD_DIMS = (64, 96, 128)
BLOCKS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# launches of each CUDA kernel since the last reset (plain runs not counted)
LAUNCHES = {"sparse_fwd": 0, "sparse_bwd_dq": 0, "sparse_bwd_dkdv": 0}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# FLOPs of one launch (two per multiply-add), from the shapes and the layout
# alone: each kernel's products over every active (query block, key block)
# pair, block x block x head_dim each. The tensor-core kernels (bf16 at
# block 64 or 128) split p and dS into two bf16 parts for their second
# products, so each of those is computed twice (csrc/block_sparse_
# attention.cu): forward S and 2 x P.V; dQ S, dP and 2 x dS.K; dK/dV S^T,
# dP^T, 2 x P^T.dO and 2 x dS^T.Q. The scalar kernels take each product
# once.
# ---------------------------------------------------------------------------
_PRODUCTS = {"sparse_fwd": (3, 2), "sparse_bwd_dq": (4, 3),
             "sparse_bwd_dkdv": (6, 4)}


def _sparse_flops(kernel, batch, layout, block, d, dtype):
    tc = dtype == torch.bfloat16 and block in (64, 128)
    products = _PRODUCTS[kernel][0 if tc else 1]
    active = int((np.asarray(layout) != 0).sum())
    return products * 2 * block * block * d * active * batch


def sparse_fwd_flops(batch, layout, block, d, dtype) -> int:
    """B5 over ``batch`` sequences of the (H, nb, nb) ``layout``."""
    return _sparse_flops("sparse_fwd", batch, layout, block, d, dtype)


def sparse_bwd_dq_flops(batch, layout, block, d, dtype) -> int:
    """B6 over ``batch`` sequences of the (H, nb, nb) ``layout``."""
    return _sparse_flops("sparse_bwd_dq", batch, layout, block, d, dtype)


def sparse_bwd_dkdv_flops(batch, layout, block, d, dtype) -> int:
    """B7 over ``batch`` sequences of the (H, nb, nb) ``layout``."""
    return _sparse_flops("sparse_bwd_dkdv", batch, layout, block, d, dtype)


FLOPS = {"sparse_fwd": sparse_fwd_flops, "sparse_bwd_dq": sparse_bwd_dq_flops,
         "sparse_bwd_dkdv": sparse_bwd_dkdv_flops}


def build_luts(layout):
    """layout (H, nb, nb) 0/1 -> (cols, nnz, rows_t, nnz_t) int32 arrays.

    cols: (H, nb, max_nnz) forward LUT; rows_t: (H, nb, max_nnz_t)
    transpose LUT. Padding entries are 0 (skipped via the nnz counts)."""
    layout = np.asarray(layout) != 0
    H, nb, _ = layout.shape
    nnz = layout.sum(-1).astype(np.int32)                  # (H, nb)
    nnz_t = layout.sum(1).astype(np.int32)                 # (H, nb)
    max_nnz = max(1, int(nnz.max()))
    max_nnz_t = max(1, int(nnz_t.max()))
    cols = np.zeros((H, nb, max_nnz), np.int32)
    rows_t = np.zeros((H, nb, max_nnz_t), np.int32)
    for h in range(H):
        for qb in range(nb):
            idx = np.flatnonzero(layout[h, qb])
            cols[h, qb, :len(idx)] = idx
        for kb in range(nb):
            idx = np.flatnonzero(layout[h, :, kb])
            rows_t[h, kb, :len(idx)] = idx
    return cols, nnz, rows_t, nnz_t


def key_order(nnz_t):
    """(H, nb) nnz_t -> (H, nb) int32: each head's key blocks by descending
    nnz_t (ties in block order), the order in which the tensor-core dK/dV
    sweep takes its key tiles, so that the longest start first."""
    return np.argsort(-np.asarray(nnz_t), axis=-1,
                      kind="stable").astype(np.int32)


class Luts(NamedTuple):
    """The lookup tables of one layout, int32 tensors on one device."""
    cols: torch.Tensor      # (H, nb, max_nnz)
    nnz: torch.Tensor       # (H, nb)
    rows_t: torch.Tensor    # (H, nb, max_nnz_t)
    nnz_t: torch.Tensor     # (H, nb)
    order_t: torch.Tensor   # (H, nb), key_order(nnz_t)


_LUT_CACHE = {}


def luts_for(layout, device) -> Luts:
    """The tables of ``layout`` on ``device``, built and copied on the
    first call for a layout's content and kept for every later one."""
    mask = np.asarray(layout) != 0
    key = (mask.shape, mask.tobytes(), str(torch.device(device)))
    if key not in _LUT_CACHE:
        tables = build_luts(mask)
        _LUT_CACHE[key] = Luts(*(torch.from_numpy(a).to(device) for a in
                                 (*tables, key_order(tables[3]))))
    return _LUT_CACHE[key]


# ---------------------------------------------------------------------------
# plain versions: (bh, S, d) operands cut into (B, H, nb, block, ...) blocks;
# each step of a loop over LUT entries handles every (b, h, block) at once
# ---------------------------------------------------------------------------
def _blocks(x, num_heads, block):
    """(bh, S, ...) -> (B, H, S/block, block, ...) in fp32."""
    bh, s = x.shape[:2]
    return x.float().reshape(bh // num_heads, num_heads, s // block, block,
                             *x.shape[2:])


def _gather(xb, idx):
    """xb (B, H, nb, ...), idx (H, nb) -> out[b, h, i] = xb[b, h, idx[h, i]]."""
    b, h, nb = xb.shape[:3]
    rest = xb.shape[3:]
    index = idx.long().reshape(1, h, nb, *([1] * len(rest)))
    return torch.gather(xb, 2, index.expand(b, h, nb, *rest))


def _key_bias_blocks(key_bias, num_heads, block):
    """(B, S) key bias -> (B, H, nb, block) fp32, or None."""
    if key_bias is None:
        return None
    b, s = key_bias.shape
    return key_bias.float().reshape(b, 1, s // block, block).expand(
        b, num_heads, s // block, block)


def sparse_fwd_plain(q, k, v, luts, key_bias, *, scale, block, num_heads):
    """Plain version of the forward kernel: an online softmax over the
    active key blocks of each query block, fp32 running max (from -1e30)
    and denominator. Differentiable by autograd. Returns (out (bh, S, d) in
    q's dtype, lse (bh, S) fp32); a row with no active block gives 0 and
    lse -1e30."""
    bh, s, d = q.shape
    qf, kf, vf = (_blocks(t, num_heads, block) for t in (q, k, v))
    bias = _key_bias_blocks(key_bias, num_heads, block)
    shape = qf.shape[:4]
    m = torch.full((*shape, 1), NEG_INF, device=q.device)
    l = torch.zeros((*shape, 1), device=q.device)
    acc = torch.zeros(qf.shape, device=q.device)
    for a in range(luts.cols.shape[-1]):
        kb = luts.cols[:, :, a]
        active = (a < luts.nnz)[None, :, :, None, None]
        sc = torch.einsum("bhiqd,bhikd->bhiqk", qf, _gather(kf, kb)) * scale
        if bias is not None:
            sc = sc + _gather(bias, kb)[:, :, :, None, :]
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l_new = l * alpha + p.sum(-1, keepdim=True)
        acc_new = acc * alpha + torch.einsum("bhiqk,bhikd->bhiqd", p,
                                             _gather(vf, kb))
        m = torch.where(active, m_new, m)
        l = torch.where(active, l_new, l)
        acc = torch.where(active, acc_new, acc)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.where(l > 0.0, acc / l_safe, torch.zeros_like(acc))
    lse = (m + torch.log(l_safe))[..., 0]
    return out.to(q.dtype).reshape(bh, s, d), lse.reshape(bh, s)


def _bwd_probs(qf, kf, vf, dof, lse, delta, bias, scale):
    """(p, ds) fp32 for blocks of query rows against blocks of key rows:
    p = exp(s - lse), ds = p * (dO.v^T - delta) * scale."""
    sc = torch.einsum("bhiqd,bhikd->bhiqk", qf, kf) * scale
    if bias is not None:
        sc = sc + bias[:, :, :, None, :]
    p = torch.exp(sc - lse)
    dp = torch.einsum("bhiqd,bhikd->bhiqk", dof, vf)
    return p, p * (dp - delta) * scale


def sparse_bwd_dq_plain(q, k, v, do, lse, delta, luts, key_bias, *, scale,
                        block, num_heads):
    """Plain version of the dQ kernel: walk the forward LUT."""
    bh, s, d = q.shape
    qf, kf, vf, dof = (_blocks(t, num_heads, block) for t in (q, k, v, do))
    lse_b, delta_b = (_blocks(t, num_heads, block)[..., None]
                      for t in (lse, delta))
    bias = _key_bias_blocks(key_bias, num_heads, block)
    dq = torch.zeros(qf.shape, device=q.device)
    for a in range(luts.cols.shape[-1]):
        kb = luts.cols[:, :, a]
        active = (a < luts.nnz)[None, :, :, None, None]
        kg = _gather(kf, kb)
        _, ds = _bwd_probs(qf, kg, _gather(vf, kb), dof, lse_b, delta_b,
                           None if bias is None else _gather(bias, kb),
                           scale)
        dq = dq + torch.where(active, torch.einsum("bhiqk,bhikd->bhiqd", ds,
                                                   kg), torch.zeros_like(dq))
    return dq.to(q.dtype).reshape(bh, s, d)


def sparse_bwd_dkdv_plain(q, k, v, do, lse, delta, luts, key_bias, *, scale,
                          block, num_heads):
    """Plain version of the dK/dV kernel: walk the transpose LUT; the bias
    row of each key block broadcasts over the query rows."""
    bh, s, d = q.shape
    qf, kf, vf, dof = (_blocks(t, num_heads, block) for t in (q, k, v, do))
    lse_b, delta_b = (_blocks(t, num_heads, block)[..., None]
                      for t in (lse, delta))
    bias = _key_bias_blocks(key_bias, num_heads, block)
    dk = torch.zeros(kf.shape, device=k.device)
    dv = torch.zeros(vf.shape, device=v.device)
    for a in range(luts.rows_t.shape[-1]):
        qb = luts.rows_t[:, :, a]
        active = (a < luts.nnz_t)[None, :, :, None, None]
        qg, dog = _gather(qf, qb), _gather(dof, qb)
        p, ds = _bwd_probs(qg, kf, vf, dog, _gather(lse_b, qb),
                           _gather(delta_b, qb), bias, scale)
        zero = torch.zeros_like(dk)
        dv = dv + torch.where(active, torch.einsum("bhiqk,bhiqd->bhikd", p,
                                                   dog), zero)
        dk = dk + torch.where(active, torch.einsum("bhiqk,bhiqd->bhikd", ds,
                                                   qg), zero)
    return (dk.to(k.dtype).reshape(bh, s, d),
            dv.to(v.dtype).reshape(bh, s, d))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _library():
    from deepspeed_tpu_torch.ops.op_builder import load

    return load("block_sparse_attention")


def _route(q, name):
    """True for the kernel (a CUDA tensor), False for the plain version (a
    CPU tensor); anything else raises."""
    if q.device.type == "cuda":
        return True
    if q.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel or plain version for device "
                     f"{q.device}")


def kernel_refusal(q, block):
    """Why the kernels cannot take (B, H, S, D) or (bh, S, D) tensor ``q``
    at this layout block (None = they can)."""
    s, d = q.shape[-2], q.shape[-1]
    if q.dtype not in _DTYPES:
        later = " (float16 is ROADMAP B10)" if q.dtype == torch.float16 \
            else ""
        return f"dtype {q.dtype} is not float32 or bfloat16{later}"
    if d not in HEAD_DIMS:
        return f"head_dim {d} is not one of the kernels' {HEAD_DIMS}"
    if block not in BLOCKS:
        return f"block {block} is not one of the kernels' {BLOCKS}"
    if s % block != 0:
        return f"sequence length {s} is not a multiple of block {block}"
    return None


def _check_cuda(tensors, luts, key_bias, block, num_heads, stats=()):
    """Raise unless the kernels take these (bh, S, d) tensors as they are:
    the kernels index every operand from q's extents and the LUTs."""
    q = tensors[0]
    if q.dim() != 3:
        raise ValueError("block-sparse kernels take (batch*heads, seq, "
                         "head_dim) tensors")
    why = kernel_refusal(q, block)
    if why is not None:
        raise ValueError(f"block-sparse kernels: {why}")
    bh, s, d = q.shape
    if bh % num_heads != 0 or bh > 65535:
        raise ValueError(f"block-sparse kernels: batch*heads {bh} must be a "
                         f"multiple of heads {num_heads} and <= 65535")
    for t in tensors:
        if tuple(t.shape) != (bh, s, d) or t.dtype != q.dtype:
            raise ValueError(f"block-sparse kernels: operand {tuple(t.shape)}"
                             f" {t.dtype}, expected {(bh, s, d)} {q.dtype}")
    for t in stats:
        if tuple(t.shape) != (bh, s) or t.dtype != torch.float32:
            raise ValueError("block-sparse kernels: lse and delta must be "
                             f"float32 {(bh, s)}")
    nb = s // block
    for t in luts:
        if t.dtype != torch.int32 or tuple(t.shape[:2]) != (num_heads, nb):
            raise ValueError(f"block-sparse kernels: LUTs must be int32 with "
                             f"leading shape {(num_heads, nb)}")
    if key_bias is not None:
        if tuple(key_bias.shape) != (bh // num_heads, s) \
                or key_bias.dtype != torch.float32:
            raise ValueError(f"block-sparse kernels: key_bias must be float32 "
                             f"{(bh // num_heads, s)}")
    for t in list(tensors) + list(stats) + list(luts) + [key_bias]:
        if t is None:
            continue
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("block-sparse kernels take contiguous tensors on "
                             "the device of q")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in tensors):
        # the tensor-core kernels read bf16 tiles by TMA
        raise ValueError("block-sparse kernels: bf16 q/k/v/do must start at "
                         "a 16-byte-aligned address")


def _args(q, block, num_heads, max_nnz, scale, scalar):
    bh, s, d = q.shape
    return [_DTYPES[q.dtype], d, bh, num_heads, s, block, max_nnz,
            float(scale), int(scalar),
            torch.cuda.current_stream(q.device).cuda_stream]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(err, name):
    if err != 0:
        why = {-1: "unsupported head_dim", -2: "unsupported dtype",
               -3: "unsupported block", -4: "sequence not a multiple of the "
               "block", -5: "no TMA tensor map for a bf16 operand (unaligned "
               "pointer, or no cuTensorMapEncodeTiled in the driver)"
               }.get(err, f"cudaError {err}")
        raise RuntimeError(f"{name} kernel launch failed: {why}")


def sparse_fwd(q, k, v, luts, key_bias, *, scale, block, num_heads,
               scalar=False):
    """Forward over (bh, S, d) tensors -> (out, lse (bh, S) fp32).
    ``scalar`` launches the scalar kernel at bf16 too (the route the
    tensor-core kernel replaced, to time the two side by side); the model
    never asks for it."""
    kw = dict(scale=scale, block=block, num_heads=num_heads)
    if not _route(q, "sparse_fwd"):
        return sparse_fwd_plain(q, k, v, luts, key_bias, **kw)
    _check_cuda((q, k, v), luts, key_bias, block, num_heads)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    err = _library().ds_bsa_fwd(
        _ptr(q), _ptr(k), _ptr(v), _ptr(key_bias), _ptr(luts.cols),
        _ptr(luts.nnz), _ptr(out), _ptr(lse),
        *_args(q, block, num_heads, luts.cols.shape[-1], scale, scalar))
    _raise_on(err, "sparse_fwd")
    LAUNCHES["sparse_fwd"] += 1
    return out, lse


def sparse_bwd_dq(q, k, v, do, lse, delta, luts, key_bias, *, scale, block,
                  num_heads, scalar=False):
    """dQ sweep -> dq in the dtype of q. ``scalar`` as in ``sparse_fwd``."""
    kw = dict(scale=scale, block=block, num_heads=num_heads)
    if not _route(q, "sparse_bwd_dq"):
        return sparse_bwd_dq_plain(q, k, v, do, lse, delta, luts, key_bias,
                                   **kw)
    _check_cuda((q, k, v, do), luts, key_bias, block, num_heads,
                stats=(lse, delta))
    dq = torch.empty_like(q)
    err = _library().ds_bsa_bwd_dq(
        _ptr(q), _ptr(k), _ptr(v), _ptr(key_bias), _ptr(do), _ptr(lse),
        _ptr(delta), _ptr(luts.cols), _ptr(luts.nnz), _ptr(dq),
        *_args(q, block, num_heads, luts.cols.shape[-1], scale, scalar))
    _raise_on(err, "sparse_bwd_dq")
    LAUNCHES["sparse_bwd_dq"] += 1
    return dq


def sparse_bwd_dkdv(q, k, v, do, lse, delta, luts, key_bias, *, scale, block,
                    num_heads, scalar=False):
    """dK/dV sweep -> (dk, dv) in the dtype of k/v. ``scalar`` as in
    ``sparse_fwd``."""
    kw = dict(scale=scale, block=block, num_heads=num_heads)
    if not _route(q, "sparse_bwd_dkdv"):
        return sparse_bwd_dkdv_plain(q, k, v, do, lse, delta, luts, key_bias,
                                     **kw)
    _check_cuda((q, k, v, do), luts, key_bias, block, num_heads,
                stats=(lse, delta))
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    err = _library().ds_bsa_bwd_dkdv(
        _ptr(q), _ptr(k), _ptr(v), _ptr(key_bias), _ptr(do), _ptr(lse),
        _ptr(delta), _ptr(luts.rows_t), _ptr(luts.nnz_t), _ptr(luts.order_t),
        _ptr(dk), _ptr(dv),
        *_args(q, block, num_heads, luts.rows_t.shape[-1], scale, scalar))
    _raise_on(err, "sparse_bwd_dkdv")
    LAUNCHES["sparse_bwd_dkdv"] += 1
    return dk, dv


class _BlockSparseAttention(torch.autograd.Function):
    """Kernel forward saving lse; kernel backward (dQ, then dK/dV). The key
    bias is a constant additive mask and gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, luts, scale, block, num_heads):
        kw = dict(scale=scale, block=block, num_heads=num_heads)
        out, lse = sparse_fwd(q, k, v, luts, key_bias, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.key_bias, ctx.luts, ctx.kw = key_bias, luts, kw
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        do = g.contiguous()
        # delta_i = rowsum(dO_i * O_i), fp32, before the two sweeps
        delta = (do.float() * out.float()).sum(-1)
        dq = sparse_bwd_dq(q, k, v, do, lse, delta, ctx.luts, ctx.key_bias,
                           **ctx.kw)
        dk, dv = sparse_bwd_dkdv(q, k, v, do, lse, delta, ctx.luts,
                                 ctx.key_bias, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


class _CountedBlockSparseAttention(torch.autograd.Function):
    """The kernels' stand-in on meta tensors (see flash_attention.py's):
    the output's shape, each launch's FLOPs added to the replay's count."""

    @staticmethod
    def forward(ctx, q, k, v, layout, block, batch):
        out = torch.empty_like(q)
        ctx.save_for_backward(q, k, v, out)
        ctx.layout, ctx.block, ctx.batch = layout, block, batch
        add_kernel_flops("sparse_fwd", sparse_fwd_flops(
            batch, layout, block, q.shape[-1], q.dtype))
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, _ = ctx.saved_tensors
        for name in ("sparse_bwd_dq", "sparse_bwd_dkdv"):
            add_kernel_flops(name, FLOPS[name](ctx.batch, ctx.layout,
                                               ctx.block, q.shape[-1],
                                               q.dtype))
        return (torch.empty_like(q), torch.empty_like(k),
                torch.empty_like(v), None, None, None)


def _prepare(q, layout, block, scale, key_bias):
    """(B, H, S, D) inputs -> (bh, S, D) operands, LUTs, scale, key bias."""
    b, h, s, d = q.shape
    if s % block != 0:
        raise ValueError(f"sequence length {s} is not a multiple of block "
                         f"{block}")
    if tuple(np.shape(layout)) != (h, s // block, s // block):
        raise ValueError(f"layout {tuple(np.shape(layout))} does not match "
                         f"{h} heads x seq {s} / block {block}")
    if key_bias is not None:
        if tuple(key_bias.shape) != (b, s):
            raise ValueError(f"key_bias must be (B, S) = {(b, s)}, got "
                             f"{tuple(key_bias.shape)}")
        key_bias = key_bias.float().contiguous()
    scale = (d ** -0.5) if scale is None else scale
    return luts_for(layout, q.device), scale, key_bias


def _flat(t):
    b, h, s, d = t.shape
    return t.reshape(b * h, s, d).contiguous()


def pallas_block_sparse_attention(q, k, v, layout, block: int,
                                  scale: Optional[float] = None,
                                  key_bias=None):
    """(B, H, S, D) block-sparse attention over a (H, S/block, S/block)
    layout through the LUT-driven kernels (the name and signature of the
    JAX package's entry). Differentiable in q/k/v. CUDA tensors launch the
    kernels; CPU tensors run their plain versions; meta tensors inside a
    FLOP count count the kernels' FLOPs (module docstring).

    key_bias: optional (B, S) ADDITIVE per-key bias (key padding, -1e30 for
    a padded key), a constant (no gradient)."""
    b, h, s, d = q.shape
    if q.device.type == "meta" and counting():
        # the FLOP replay: no kernel, no plain version (module docstring)
        out = _CountedBlockSparseAttention.apply(q, k, v, layout, block, b)
        return out.reshape(b, h, s, d)
    luts, scale, key_bias = _prepare(q, layout, block, scale, key_bias)
    out = _BlockSparseAttention.apply(_flat(q), _flat(k), _flat(v), key_bias,
                                      luts, scale, block, h)
    return out.reshape(b, h, s, d)


def block_sparse_attention_reference(q, k, v, layout, block: int,
                                     scale: Optional[float] = None,
                                     key_bias=None):
    """Plain PyTorch block-sparse attention (same signature and function as
    ``pallas_block_sparse_attention``): the plain forward, gradients by
    autograd. Runs on any device."""
    b, h, s, d = q.shape
    luts, scale, key_bias = _prepare(q, layout, block, scale, key_bias)
    out, _ = sparse_fwd_plain(_flat(q), _flat(k), _flat(v), luts, key_bias,
                              scale=scale, block=block, num_heads=h)
    return out.reshape(b, h, s, d)
