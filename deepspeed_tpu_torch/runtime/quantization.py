"""Row-wise symmetric int8 quantization: the int8 KV pool's storage.

Port of the row quantizers of deepspeed_tpu/runtime/quantization.py
(``block_layout``, ``quantize_rows``, ``dequantize_rows``); the blockwise
wire formats of the ZeRO collectives and the 1-bit sign codes come with
ROADMAP A13.

Scheme: symmetric per-block scales.  For each block b of ``block_size``
contiguous elements: ``scale_b = max|x_b| / 127``, ``q = clip(round(x /
scale_b), -127, 127)`` stored as int8 (round half to even, as jnp.round).
A block containing inf/nan gets a non-finite scale (the abs-max
propagates), so dequantized values come back non-finite.
"""
import torch

DEFAULT_BLOCK_SIZE = 128
_QMAX = 127.0


def block_layout(n: int, block_size: int = DEFAULT_BLOCK_SIZE):
    """(effective_block, n_blocks, padded_n) for a row of ``n`` elements.
    The effective block is clamped to the row length so small rows don't
    pay a full block of zero padding."""
    assert n > 0, "cannot lay out an empty row"
    bs = max(1, min(int(block_size), n))
    nb = -(-n // bs)
    return bs, nb, nb * bs


def quantize_rows(x, block_size: int = DEFAULT_BLOCK_SIZE):
    """Quantize each row of ``x`` (r, n) independently.

    Returns ``(q, scales)``: ``q`` int8 of shape (r, npad) (rows padded with
    zeros to a block multiple), ``scales`` fp32 of shape (r, nb).
    """
    r, n = x.shape
    bs, nb, npad = block_layout(n, block_size)
    xf = x.float()
    if npad != n:
        xf = torch.nn.functional.pad(xf, (0, npad - n))
    blocks = xf.reshape(r, nb, bs)
    amax = blocks.abs().amax(dim=-1)                  # inf/nan propagate
    scales = amax / _QMAX
    safe = torch.where(scales > 0, scales, torch.ones_like(scales))
    q = torch.clamp(torch.round(blocks / safe[:, :, None]), -_QMAX, _QMAX)
    return q.to(torch.int8).reshape(r, npad), scales


def dequantize_rows(q, scales, n: int, dtype=torch.float32):
    """Inverse of quantize_rows: (r, npad) int8 + (r, nb) -> (r, n)."""
    r, npad = q.shape
    nb = scales.shape[1]
    blocks = q.reshape(r, nb, npad // nb).float()
    out = (blocks * scales[:, :, None]).reshape(r, npad)
    return out[:, :n].to(dtype)
