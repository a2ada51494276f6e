"""Attention and fused-elementwise functional ops: the dispatch point between
the plain PyTorch attention path and the flash-attention kernels.

Port of deepspeed_tpu/ops/transformer/functional.py. A CUDA tensor reaching
``scaled_dot_product_attention`` launches the flash kernels or raises; the
plain (einsum) attention path runs on CPU tensors only.
"""
from typing import Optional

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops.transformer.flash_attention import (
    HEAD_DIMS, flash_attention)
from deepspeed_tpu_torch.telemetry.mfu import counting


def _key_padding_shaped(m):
    return m is not None and m.dim() == 4 and m.shape[1] == 1 \
        and m.shape[2] == 1


def _flash_refusal(q, k, mask, bias, dropout_rate, dropout_rng):
    """Why the flash kernels cannot serve this call (None = they can)."""
    if dropout_rate > 0.0 and dropout_rng is None:
        return "dropout_rate > 0 needs a dropout_rng to seed the kernel"
    d = q.shape[-1]
    if d not in HEAD_DIMS:
        return f"head_dim {d} is not one of the kernels' {HEAD_DIMS}"
    if q.shape[2] != k.shape[2]:
        return f"q/k lengths differ ({q.shape[2]} vs {k.shape[2]})"
    for name, m in (("bias", bias), ("mask", mask)):
        if m is not None and not _key_padding_shaped(m):
            # the kernels treat a bias as a constant: a full (possibly
            # learned) bias must say that it is one
            return (f"a full-shaped {name} needs use_pallas=True (a constant "
                    f"that gets no gradient)")
    return None


def scaled_dot_product_attention(q, k, v, *, mask=None, bias=None,
                                 causal=False, dropout_rng=None,
                                 dropout_rate=0.0,
                                 scale: Optional[float] = None,
                                 use_pallas: Optional[bool] = None,
                                 head_offset: int = 0,
                                 total_heads: Optional[int] = None):
    """Attention over [batch, heads, seq, head_dim] tensors.

    use_pallas: for CPU tensors, None or False takes the plain einsum path
    and True takes ``flash_attention`` (whose CPU route is the kernels'
    plain versions). Any other tensor takes the flash kernels: None or True
    launches them or raises when they cannot serve the call, and False
    raises, since the plain path runs on CPU tensors only. Meta tensors
    inside the FLOP count of telemetry/mfu.py count the flash kernels'
    FLOPs.
    dropout_rng: a ``torch.Generator`` for the dropout randomness.
    head_offset/total_heads: q holds heads [head_offset, head_offset + H)
    of ``total_heads`` (a Ulysses rank's, parallel/ulysses.py): the
    dropout keep mask is those heads' rows of the whole model's (default:
    heads 0.. of H).
    """
    if q.device.type == "meta" and counting():
        # the telemetry's FLOP replay: the kernels' count, whichever route
        # the tensors' real device takes (flash_attention.py)
        return flash_attention(q, k, v, causal=causal)
    if q.device.type != "cpu":
        if use_pallas is False:
            raise ValueError(f"use_pallas=False: the plain attention path "
                             f"runs on CPU tensors only, not on {q.device}")
        if use_pallas is None:
            why = _flash_refusal(q, k, mask, bias, dropout_rate, dropout_rng)
            if why is not None:
                raise ValueError(f"flash attention cannot take this "
                                 f"{q.device.type} call: {why}")
        use_pallas = True
    if use_pallas:
        if dropout_rate > 0.0 and dropout_rng is None:
            raise ValueError("flash attention dropout needs a dropout_rng "
                             "to derive the in-kernel counter seed")
        if mask is not None:
            # boolean keep-mask -> additive bias, combined with any bias
            mask_bias = torch.where(
                mask, torch.zeros((), device=mask.device),
                torch.full((), -1e30, device=mask.device))
            bias = mask_bias if bias is None else bias + mask_bias
        seed = None
        if dropout_rate > 0.0:
            # per-call seed for the in-kernel counter-based hash: drawn on
            # the generator's device and read there by the kernels, so the
            # host never waits for it (the JAX package passes an array too)
            seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=dropout_rng,
                                 device=dropout_rng.device,
                                 dtype=torch.int32)
        return flash_attention(q, k, v, bias=bias, causal=causal,
                               scale=scale, dropout_rate=dropout_rate,
                               dropout_seed=seed, head_offset=head_offset,
                               total_heads=total_heads)

    head_dim = q.shape[-1]
    scale = (head_dim ** -0.5) if scale is None else scale
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias
    if causal:
        q_len, k_len = logits.shape[-2], logits.shape[-1]
        keep = torch.ones((q_len, k_len), dtype=torch.bool,
                          device=q.device).tril(k_len - q_len)
        logits = logits.masked_fill(~keep, -1e30)
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout_rate > 0.0 and dropout_rng is not None:
        heads = q.shape[1]
        total = heads if total_heads is None else total_heads
        probs = dropout(probs, dropout_rng, dropout_rate,
                        within=(1, head_offset, total))
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def gelu(x, approximate=True):
    return F.gelu(x, approximate="tanh" if approximate else "none")


def bias_gelu(x, bias):
    """bias + GeLU (reference csrc/transformer/gelu_kernels.cu)."""
    return F.gelu(x + bias, approximate="tanh")


def layer_norm(x, gamma, beta, eps=1e-12):
    """LayerNorm with fp32 statistics, output in x's dtype (reference
    normalize_kernels.cu)."""
    y = F.layer_norm(x.float(), (x.shape[-1],), gamma.float(), beta.float(),
                     eps)
    return y.to(x.dtype)


def bias_residual_layer_norm(x, bias, residual, gamma, beta, eps=1e-12):
    """bias + residual + LayerNorm (reference: fused add+LN in
    normalize_kernels.cu)."""
    return layer_norm(x + bias + residual, gamma, beta, eps)


def seq_dropout(x, generator, rate, group=None):
    """``dropout`` of a (B, S, ...) activation; under sequence parallelism
    (``group``: the seq group, x this rank's chunk of S/N positions) the
    chunk's slice of the whole sequence's mask."""
    if group is None:
        return dropout(x, generator, rate)
    s = x.shape[1]
    return dropout(x, generator, rate,
                   within=(1, group.offset(s), group.size * s))


def dropout(x, generator, rate, deterministic=False, within=None):
    """Inverted dropout with the keep mask drawn from ``generator``.

    within: (dim, start, size): x is the slice [start, start +
    x.shape[dim]) along ``dim`` of a tensor whose ``dim`` has ``size``
    (a sequence-parallel rank's chunk): the mask is that slice of the whole
    tensor's, drawn whole, so every rank draws the generator alike and the
    ranks' masks make up the single process's."""
    if deterministic or rate == 0.0:
        return x
    if within is None:
        u = torch.rand(x.shape, generator=generator, device=generator.device)
    else:
        dim, start, size = within
        shape = list(x.shape)
        shape[dim] = size
        u = torch.rand(shape, generator=generator,
                       device=generator.device).narrow(dim, start,
                                                       x.shape[dim])
    keep = u.to(x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x)).to(
        x.dtype)
