"""Flash attention: hand-written Hopper kernels and their plain versions.

Port of deepspeed_tpu/ops/transformer/flash_attention.py. The three Pallas
TPU kernels there (``_fwd_kernel``, ``_bwd_dkdv_kernel``, ``_bwd_dq_kernel``)
are CUDA kernels here, in ``csrc/flash_attention.cu``, built for sm_90a at
first use (ops/op_builder.py) and launched through ctypes on PyTorch's
current stream. bf16 inputs run the forward and both backward sweeps on the
tensor cores (wgmma, TMA); fp32 inputs run scalar fp32 kernels. At bf16, p
and dS enter their second products rounded to
bf16, in the kernels and in the plain versions alike, as the Pallas kernels
round them.

Each kernel has one wrapper (``flash_fwd``, ``flash_bwd_dkdv``,
``flash_bwd_dq``) and one plain PyTorch version of the same function
(``flash_fwd_plain`` ...). A wrapper given CPU tensors runs the plain
version; given CUDA tensors it launches the kernel or raises. ``LAUNCHES``
counts kernel launches per kernel, and only kernel launches.

The forward saves the per-row logsumexp; the backward recomputes the
probabilities blockwise in two sweeps (dK/dV, then dQ), with
``delta = rowsum(dO * O)`` computed in fp32 between them, as the JAX
package's ``_flash_bwd`` does. Attention dropout is the same
murmur3-finalizer hash of (seed, batch*head, q, k) as ``_dropout_keep``, so
the keep mask is a pure function of the seed and both backward sweeps
regenerate it; nothing is stored.
"""
from typing import Optional

import torch

NEG_INF = -1e30
HEAD_DIMS = (64, 96, 128)
BIAS_KINDS = {"none": 0, "key": 1, "full": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# launches of each CUDA kernel since the last reset (plain runs not counted)
LAUNCHES = {"flash_fwd": 0, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}
# block of the plain versions' loops: at fp32 any size gives the same
# function; at bf16 p is rounded relative to its block's running max, and
# 128 keys is the tensor-core forward's k tile
_PLAIN_BLOCK = 128


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def dropout_threshold(rate: float) -> int:
    """uint32 keep threshold: keep where hash >= threshold (the JAX
    kernel's ``uint32(min(rate, 0.9999) * 2**32)``)."""
    return int(min(rate, 0.9999) * 4294967296.0)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
_M32 = 0xFFFFFFFF


def _mul32(h, c: int):
    """(h * c) mod 2**32 for int64 tensors holding uint32 values, without
    overflowing int64: c is split into 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _M32


def _mix32(h):
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def dropout_keep_mask(seed: int, bh: int, q_start: int, q_len: int,
                      k_start: int, k_len: int, rate: float, device):
    """(bh, q_len, k_len) keep mask of the dropout hash at global positions
    q_start.., k_start.. for batch*head indices 0..bh-1."""
    rows = torch.arange(q_start, q_start + q_len, device=device,
                        dtype=torch.int64)
    cols = torch.arange(k_start, k_start + k_len, device=device,
                        dtype=torch.int64)
    heads = torch.arange(bh, device=device, dtype=torch.int64)
    s = (int(seed) & _M32) + _mul32(heads, 0x9E3779B9)
    s = s & _M32
    rh = _mix32(s[:, None] ^ rows[None, :])                  # (bh, q)
    h = _mix32(rh[:, :, None] ^ _mul32(cols, 0x27D4EB2F)[None, None, :])
    return h >= dropout_threshold(rate)


def _block_scores(q, k, bias, *, scale, causal, bias_kind, num_heads,
                  q_start, k_start):
    """fp32 scores of q rows (bh, bq, d) against k rows (bh, bk, d) at
    global offsets q_start, k_start: scaled, biased, causally masked."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    bq, bk = q.shape[1], k.shape[1]
    if bias_kind == "key":
        b = bias[:, k_start:k_start + bk]                        # (B, bk)
        s = s + b.repeat_interleave(num_heads, dim=0)[:, None, :]
    elif bias_kind == "full":
        s = s + bias[:, q_start:q_start + bq, k_start:k_start + bk]
    if causal:
        rows = torch.arange(q_start, q_start + bq, device=s.device)
        cols = torch.arange(k_start, k_start + bk, device=s.device)
        s = torch.where(rows[:, None] >= cols[None, :], s,
                        torch.full_like(s, NEG_INF))
    return s


def flash_fwd_plain(q, k, v, bias, seed, *, scale, causal, bias_kind,
                    num_heads, dropout_rate):
    """Plain version of the forward kernel: a blockwise online softmax
    over k blocks with fp32 running max and denominator. Differentiable by
    autograd. Returns (out (bh, s_q, d) in q's dtype, lse (bh, s_q) fp32)."""
    bh, s_q, d = q.shape
    s_k = k.shape[1]
    m = torch.full((bh, s_q, 1), NEG_INF, device=q.device)
    l = torch.zeros((bh, s_q, 1), device=q.device)
    acc = torch.zeros((bh, s_q, d), device=q.device)
    for k0 in range(0, s_k, _PLAIN_BLOCK):
        if causal and k0 > s_q - 1:
            break
        kb = k[:, k0:k0 + _PLAIN_BLOCK]
        vb = v[:, k0:k0 + _PLAIN_BLOCK].float()
        s = _block_scores(q, kb, bias, scale=scale, causal=causal,
                          bias_kind=bias_kind, num_heads=num_heads,
                          q_start=0, k_start=k0)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        # the denominator takes the undropped p; dropout scales only the
        # value accumulation
        l = l * alpha + p.sum(-1, keepdim=True)
        if dropout_rate > 0.0:
            keep = dropout_keep_mask(seed, bh, 0, s_q, k0, kb.shape[1],
                                     dropout_rate, q.device)
            p = torch.where(keep, p / (1.0 - dropout_rate),
                            torch.zeros_like(p))
        # p enters the second product in the storage dtype, as the Pallas
        # kernel's p_acc.astype(v.dtype) and the tensor-core kernel's bf16
        # A operand do (a no-op at fp32)
        p = p.to(q.dtype).float()
        acc = acc * alpha + torch.einsum("bqk,bkd->bqd", p, vb)
        m = m_new
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (acc / l_safe).to(q.dtype)
    lse = (m + torch.log(l_safe))[..., 0]
    return out, lse


def _bwd_block(q, k, v, do, lse, delta, bias, seed, *, scale, causal,
               bias_kind, num_heads, dropout_rate, q_start, k_start):
    """(p_drop, ds) for one (q block, k block) pair: computed in fp32 and
    rounded to the storage dtype, in which the Pallas kernels feed both to
    their second products (back in fp32 for the einsums)."""
    s = _block_scores(q, k, bias, scale=scale, causal=causal,
                      bias_kind=bias_kind, num_heads=num_heads,
                      q_start=q_start, k_start=k_start)
    p = torch.exp(s - lse[:, :, None])
    dp = torch.einsum("bqd,bkd->bqk", do.float(), v.float())
    p_drop = p
    if dropout_rate > 0.0:
        keep = dropout_keep_mask(seed, q.shape[0], q_start, q.shape[1],
                                 k_start, k.shape[1], dropout_rate, q.device)
        inv = 1.0 / (1.0 - dropout_rate)
        p_drop = torch.where(keep, p * inv, torch.zeros_like(p))
        dp = torch.where(keep, dp * inv, torch.zeros_like(dp))
    ds = p * (dp - delta[:, :, None]) * scale
    return p_drop.to(q.dtype).float(), ds.to(q.dtype).float()


def flash_bwd_dkdv_plain(q, k, v, do, lse, delta, bias, seed, *, scale,
                         causal, bias_kind, num_heads, dropout_rate):
    """Plain version of the dK/dV kernel: sweep q blocks against all keys."""
    s_q = q.shape[1]
    dk = torch.zeros(k.shape, device=k.device)
    dv = torch.zeros(v.shape, device=v.device)
    for q0 in range(0, s_q, _PLAIN_BLOCK):
        sl = slice(q0, q0 + _PLAIN_BLOCK)
        p_drop, ds = _bwd_block(
            q[:, sl], k, v, do[:, sl], lse[:, sl], delta[:, sl], bias, seed,
            scale=scale, causal=causal, bias_kind=bias_kind,
            num_heads=num_heads, dropout_rate=dropout_rate, q_start=q0,
            k_start=0)
        dv += torch.einsum("bqk,bqd->bkd", p_drop, do[:, sl].float())
        dk += torch.einsum("bqk,bqd->bkd", ds, q[:, sl].float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_plain(q, k, v, do, lse, delta, bias, seed, *, scale,
                       causal, bias_kind, num_heads, dropout_rate):
    """Plain version of the dQ kernel: sweep k blocks against all queries."""
    s_k = k.shape[1]
    dq = torch.zeros(q.shape, device=q.device)
    for k0 in range(0, s_k, _PLAIN_BLOCK):
        sl = slice(k0, k0 + _PLAIN_BLOCK)
        _, ds = _bwd_block(
            q, k[:, sl], v[:, sl], do, lse, delta, bias, seed, scale=scale,
            causal=causal, bias_kind=bias_kind, num_heads=num_heads,
            dropout_rate=dropout_rate, q_start=0, k_start=k0)
        dq += torch.einsum("bqk,bkd->bqd", ds, k[:, sl].float())
    return dq.to(q.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _library():
    from deepspeed_tpu_torch.ops.op_builder import load

    return load("flash_attention")


def _check_shapes(q, k, v, do, lse, delta, bias, bias_kind, num_heads):
    """Raise unless the shapes agree with q's (bh, s_q, d): the kernels
    index every operand from q's and k's extents alone."""
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError("flash attention kernels take (batch*heads, seq, "
                         "head_dim) tensors")
    bh, s_q, d = q.shape
    s_k = k.shape[1]
    want = {"k": (k, (bh, s_k, d)), "v": (v, (bh, s_k, d)),
            "do": (do, (bh, s_q, d)), "lse": (lse, (bh, s_q)),
            "delta": (delta, (bh, s_q))}
    if bias_kind == "key":
        want["bias"] = (bias, (bh // max(num_heads, 1), s_k))
    elif bias_kind == "full":
        want["bias"] = (bias, (bh, s_q, s_k))
    for name, (t, shape) in want.items():
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"flash attention: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    if (lse is None) != (delta is None) or (do is None) != (lse is None):
        raise ValueError("flash attention backward needs do, lse and delta")
    if (lse is not None and lse.dtype != torch.float32) \
            or (delta is not None and delta.dtype != torch.float32):
        raise TypeError("flash attention lse and delta must be float32")
    if do is not None and do.dtype != q.dtype:
        raise TypeError(f"flash attention do must be {q.dtype}")
    if bh % max(num_heads, 1) != 0:
        raise ValueError(f"batch*heads {bh} is not a multiple of heads "
                         f"{num_heads}")


def _check_cuda(tensors, bias, bias_kind, num_heads):
    """Raise unless the kernels take these (bh, s, d) tensors as they are."""
    q = tensors[0]
    padded = list(tensors) + [None] * (6 - len(tensors))
    _check_shapes(*padded, bias, bias_kind, num_heads)
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"flash attention: tensors on {t.device} and "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError("flash attention: the kernels take contiguous "
                             "(batch*heads, seq, head_dim) tensors")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype
                                     for t in tensors[:3]):
        raise TypeError(f"flash attention kernels take float32 or bfloat16 "
                        f"q/k/v of one dtype, got "
                        f"{[t.dtype for t in tensors[:3]]}")
    bh, _, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash attention kernels take head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    if bh > 65535:
        raise ValueError(f"flash attention kernels take batch*heads <= "
                         f"65535, got {bh}")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in tensors if t.dim() == 3):
        # the tensor-core kernels read bf16 tiles by TMA
        raise ValueError("flash attention: bf16 q/k/v/do must start at a "
                         "16-byte-aligned address")
    if bias_kind != "none":
        if bias is None or bias.dtype != torch.float32 \
                or bias.device != q.device or not bias.is_contiguous():
            raise ValueError("flash attention bias must be a contiguous "
                             "float32 tensor on the device of q")


def _common_args(q, k, bias, seed, scale, causal, bias_kind, num_heads,
                 dropout_rate):
    bh, s_q, d = q.shape
    use_dropout = dropout_rate > 0.0
    return [_DTYPES[q.dtype], d, bh, num_heads, s_q, k.shape[1],
            float(scale), int(bool(causal)), BIAS_KINDS[bias_kind],
            int(use_dropout),
            dropout_threshold(dropout_rate) if use_dropout else 0,
            1.0 / (1.0 - dropout_rate) if use_dropout else 1.0,
            (int(seed) & _M32) if use_dropout else 0,
            torch.cuda.current_stream(q.device).cuda_stream]


def _ptr(t):
    return None if t is None else t.data_ptr()


_LAUNCH_ERRORS = {-1: "unsupported head_dim", -2: "unsupported dtype",
                  -3: "no TMA tensor map for a bf16 operand (unaligned "
                      "pointer, or no cuTensorMapEncodeTiled in the driver)"}


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{_LAUNCH_ERRORS.get(err, f'cudaError {err}')}")


def _route(q, name):
    """True for the kernel (a CUDA tensor), False for the plain version (a
    CPU tensor); anything else raises."""
    if q.device.type == "cuda":
        return True
    if q.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel or plain version for device "
                     f"{q.device}")


def flash_fwd(q, k, v, bias, seed, *, scale, causal, bias_kind, num_heads,
              dropout_rate):
    """Forward over (bh, s, d) tensors -> (out, lse (bh, s_q) fp32)."""
    kw = dict(scale=scale, causal=causal, bias_kind=bias_kind,
              num_heads=num_heads, dropout_rate=dropout_rate)
    if not _route(q, "flash_fwd"):
        return flash_fwd_plain(q, k, v, bias, seed, **kw)
    _check_cuda((q, k, v), bias, bias_kind, num_heads)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    err = _library().ds_flash_fwd(
        _ptr(q), _ptr(k), _ptr(v), _ptr(bias), _ptr(out), _ptr(lse),
        *_common_args(q, k, bias, seed, scale, causal, bias_kind, num_heads,
                      dropout_rate))
    _raise_on(err, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return out, lse


def flash_bwd_dkdv(q, k, v, do, lse, delta, bias, seed, *, scale, causal,
                   bias_kind, num_heads, dropout_rate):
    """dK/dV sweep -> (dk, dv) in the dtype of k/v."""
    kw = dict(scale=scale, causal=causal, bias_kind=bias_kind,
              num_heads=num_heads, dropout_rate=dropout_rate)
    if not _route(q, "flash_bwd_dkdv"):
        return flash_bwd_dkdv_plain(q, k, v, do, lse, delta, bias, seed,
                                    **kw)
    _check_cuda((q, k, v, do, lse, delta), bias, bias_kind, num_heads)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    err = _library().ds_flash_bwd_dkdv(
        _ptr(q), _ptr(k), _ptr(v), _ptr(bias), _ptr(do), _ptr(lse),
        _ptr(delta), _ptr(dk), _ptr(dv),
        *_common_args(q, k, bias, seed, scale, causal, bias_kind, num_heads,
                      dropout_rate))
    _raise_on(err, "flash_bwd_dkdv")
    LAUNCHES["flash_bwd_dkdv"] += 1
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, bias, seed, *, scale, causal,
                 bias_kind, num_heads, dropout_rate, scalar=False):
    """dQ sweep -> dq in the dtype of q. ``scalar`` launches the scalar
    kernel at bf16 too (the route the tensor-core kernel replaced, to time
    the two side by side); the model never asks for it."""
    kw = dict(scale=scale, causal=causal, bias_kind=bias_kind,
              num_heads=num_heads, dropout_rate=dropout_rate)
    if not _route(q, "flash_bwd_dq"):
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, bias, seed, **kw)
    _check_cuda((q, k, v, do, lse, delta), bias, bias_kind, num_heads)
    dq = torch.empty_like(q)
    lib = _library()
    err = (lib.ds_flash_bwd_dq_scalar if scalar else lib.ds_flash_bwd_dq)(
        _ptr(q), _ptr(k), _ptr(v), _ptr(bias), _ptr(do), _ptr(lse),
        _ptr(delta), _ptr(dq),
        *_common_args(q, k, bias, seed, scale, causal, bias_kind, num_heads,
                      dropout_rate))
    _raise_on(err, "flash_bwd_dq")
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


class _FlashAttention(torch.autograd.Function):
    """Kernel forward saving lse; kernel backward (dK/dV then dQ). The bias
    is a constant additive mask and gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, scale, causal, bias_kind,
                num_heads, dropout_rate):
        kw = dict(scale=scale, causal=causal, bias_kind=bias_kind,
                  num_heads=num_heads, dropout_rate=dropout_rate)
        out, lse = flash_fwd(q, k, v, bias, seed, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.bias, ctx.seed, ctx.kw = bias, seed, kw
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        do = g.contiguous()
        # delta_i = rowsum(dO_i * O_i), fp32, between the two sweeps
        delta = (do.float() * out.float()).sum(-1)
        dk, dv = flash_bwd_dkdv(q, k, v, do, lse, delta, ctx.bias, ctx.seed,
                                **ctx.kw)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, ctx.bias, ctx.seed,
                          **ctx.kw)
        return dq, dk, dv, None, None, None, None, None, None, None


def _prepare(q, k, v, bias, causal, scale, dropout_rate, dropout_seed):
    """JAX-layout (B, H, S, D) inputs -> (bh, s, d) operands + statics."""
    b, h, s_q, d = q.shape
    s_k = k.shape[2]
    # the causal mask is top-left aligned (q_idx >= k_idx from 0)
    if causal and s_q != s_k:
        raise ValueError(f"causal flash attention requires equal q/k "
                         f"lengths, got ({s_q}, {s_k})")
    scale = (d ** -0.5) if scale is None else scale
    bias_kind, bias3 = "none", None
    if bias is not None:
        if bias.dim() != 4:
            raise ValueError(f"bias must be 4D, got shape "
                             f"{tuple(bias.shape)}")
        if bias.shape[1] == 1 and bias.shape[2] == 1:
            # key-padding bias: one row per batch, broadcast over heads/rows
            bias_kind = "key"
            bias3 = bias[:, 0, 0, :].float().expand(b, s_k).contiguous()
        else:
            bias_kind = "full"
            bias3 = bias.float().expand(b, h, s_q, s_k).reshape(
                b * h, s_q, s_k).contiguous()
    dropout_rate = float(dropout_rate)
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"bad dropout_rate {dropout_rate}")
    seed = None
    if dropout_rate > 0.0:
        if dropout_seed is None:
            raise ValueError("dropout_rate > 0 requires dropout_seed")
        seed = int(dropout_seed)
    q3 = q.reshape(b * h, s_q, d).contiguous()
    k3 = k.reshape(b * h, s_k, d).contiguous()
    v3 = v.reshape(b * h, s_k, d).contiguous()
    return q3, k3, v3, bias3, seed, scale, bias_kind, h, dropout_rate


def flash_attention(q, k, v, *, bias=None, causal: bool = False,
                    scale: Optional[float] = None, dropout_rate: float = 0.0,
                    dropout_seed: Optional[int] = None):
    """Flash attention over [batch, heads, seq, head_dim] tensors.

    bias: optional ADDITIVE bias, (B, 1, 1, S_k) key-padding form or any
    shape broadcastable to (B, H, S_q, S_k); a constant (no gradient).
    dropout_rate/dropout_seed: in-kernel attention dropout; the int seed
    fully determines the keep mask. Differentiable in q/k/v. CUDA tensors
    run the kernels; CPU tensors run their plain versions.
    """
    b, h, s_q, d = q.shape
    q3, k3, v3, bias3, seed, scale, kind, heads, rate = _prepare(
        q, k, v, bias, causal, scale, dropout_rate, dropout_seed)
    out = _FlashAttention.apply(q3, k3, v3, bias3, seed, scale, causal, kind,
                                heads, rate)
    return out.reshape(b, h, s_q, d)


def flash_attention_reference(q, k, v, *, bias=None, causal: bool = False,
                              scale: Optional[float] = None,
                              dropout_rate: float = 0.0,
                              dropout_seed: Optional[int] = None):
    """Plain PyTorch flash attention (same signature and function as
    ``flash_attention``), blockwise online softmax with the same -1e30
    masking and dropout hash; gradients by autograd. Runs on any device."""
    b, h, s_q, d = q.shape
    q3, k3, v3, bias3, seed, scale, kind, heads, rate = _prepare(
        q, k, v, bias, causal, scale, dropout_rate, dropout_seed)
    out, _ = flash_fwd_plain(q3, k3, v3, bias3, seed, scale=scale,
                             causal=causal, bias_kind=kind, num_heads=heads,
                             dropout_rate=rate)
    return out.reshape(b, h, s_q, d)
