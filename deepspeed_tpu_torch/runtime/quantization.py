"""Blockwise int8 and 1-bit sign quantization: the wire formats of the
ZeRO collectives (qgZ, qwZ) and the int8 KV pool's storage.

Port of deepspeed_tpu/runtime/quantization.py: the row quantizers
(``block_layout``, ``quantize_rows``, ``dequantize_rows``), the flat
blockwise ones with their error-feedback variant, the 1-bit sign codes of
the 0/1 Adam wire (``sign_pack_layout``, ``quantize_signs_rows``,
``dequantize_signs_rows``), and the host twins of the ZeRO-Offload qwZ
push (``*_np``), which take and return CPU tensors here (numpy arrays are
accepted as input).

Scheme: symmetric per-block scales.  For each block b of ``block_size``
contiguous elements: ``scale_b = max|x_b| / 127``, ``q = clip(round(x /
scale_b), -127, 127)`` stored as int8 (round half to even, as jnp.round).
The device functions compute the scale as ``max|x_b| * fl(1/127)``, as
XLA compiles the JAX functions inside the JAX engine's programs (it folds
a division by a constant into a multiplication by its reciprocal, which
moves some scales by one ulp); the host twins divide, as numpy does.
A block containing inf/nan gets a non-finite scale (the abs-max
propagates), so dequantized values come back non-finite and the loss
scaler still trips; its codes are written as 0 (an int8 cast of nan is
platform-defined, so a CPU and a CUDA code could otherwise differ).

Sign codes: one bit per element (set = non-negative, MSB first, 8 per
byte) and one fp32 scale per block, ``scale_b = mean|x_b|``; a code
decodes to ``±scale_b``.
"""
import numpy as np
import torch

DEFAULT_BLOCK_SIZE = 128
_QMAX = 127.0
_RECIP = float(np.float32(1.0) / np.float32(_QMAX))


def block_layout(n: int, block_size: int = DEFAULT_BLOCK_SIZE):
    """(effective_block, n_blocks, padded_n) for a row of ``n`` elements.
    The effective block is clamped to the row length so small rows don't
    pay a full block of zero padding."""
    assert n > 0, "cannot lay out an empty row"
    bs = max(1, min(int(block_size), n))
    nb = -(-n // bs)
    return bs, nb, nb * bs


def _as_f32(x):
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    return x.float()


def quantize_rows(x, block_size: int = DEFAULT_BLOCK_SIZE, divide=False):
    """Quantize each row of ``x`` (r, n) independently.

    Returns ``(q, scales)``: ``q`` int8 of shape (r, npad) (rows padded with
    zeros to a block multiple), ``scales`` fp32 of shape (r, nb).
    ``divide``: the scale as ``max / 127`` (the host twins) rather than
    ``max * fl(1/127)`` (the compiled JAX functions).
    """
    r, n = x.shape
    bs, nb, npad = block_layout(n, block_size)
    xf = _as_f32(x)
    if npad != n:
        xf = torch.nn.functional.pad(xf, (0, npad - n))
    blocks = xf.reshape(r, nb, bs)
    amax = blocks.abs().amax(dim=-1)                  # inf/nan propagate
    scales = amax / _QMAX if divide else amax * _RECIP
    safe = torch.where(scales > 0, scales, torch.ones_like(scales))
    q = torch.clamp(torch.round(blocks / safe[:, :, None]), -_QMAX, _QMAX)
    q = torch.where(torch.isfinite(q), q, torch.zeros_like(q))
    return q.to(torch.int8).reshape(r, npad), scales


def dequantize_rows(q, scales, n: int, dtype=torch.float32):
    """Inverse of quantize_rows: (r, npad) int8 + (r, nb) -> (r, n)."""
    r, npad = q.shape
    nb = scales.shape[1]
    blocks = q.reshape(r, nb, npad // nb).float()
    out = (blocks * scales[:, :, None]).reshape(r, npad)
    return out[:, :n].to(dtype)


def quantize_blockwise(x, block_size: int = DEFAULT_BLOCK_SIZE):
    """Flatten-and-quantize a whole tensor: (q[npad] int8, scales[nb])."""
    q, scales = quantize_rows(x.reshape(1, -1), block_size)
    return q[0], scales[0]


def dequantize_blockwise(q, scales, shape, dtype=torch.float32):
    """Inverse of quantize_blockwise back to ``shape``."""
    n = int(np.prod(shape))
    return dequantize_rows(q[None], scales[None], n, dtype)[0].reshape(shape)


def quantize_blockwise_ef(x, residual, block_size: int = DEFAULT_BLOCK_SIZE):
    """Error-feedback variant: quantize ``x + residual`` and return
    ``(q, scales, new_residual)``, the new residual being the quantization
    error to add back next round: ``comp - q * scale`` with one rounding,
    as the compiled JAX function fuses it (the int8 x fp32 product is
    exact in float64)."""
    comp = x.float() + residual
    q, scales = quantize_blockwise(comp, block_size)
    n = comp.numel()
    nb = scales.shape[0]
    prod = (q.reshape(nb, -1).double() * scales.double()[:, None])
    resid = comp.reshape(-1).double() - prod.reshape(-1)[:n]
    return q, scales, resid.float().reshape(comp.shape)


# ---------------------------------------------------------------------------
# 1-bit sign codes (the 0/1 Adam wire)
# ---------------------------------------------------------------------------

def sign_pack_layout(n: int, block_size: int = DEFAULT_BLOCK_SIZE):
    """(effective_block, n_blocks, padded_n, packed_bytes) for a row of
    ``n`` elements under the 1-bit wire: ``block_layout`` with the padded
    row rounded up again to a multiple of 8 for the byte packing."""
    bs, nb, npad = block_layout(n, block_size)
    npack = -(-npad // 8) * 8
    return bs, nb, npad, npack // 8


def _pow2(device):
    """128, 64, ..., 1 as uint8 on ``device``, made there (no copy from
    the host: the step makes no host sync)."""
    return (2 ** torch.arange(7, -1, -1, device=device)).to(torch.uint8)


def quantize_signs_rows(x, block_size: int = DEFAULT_BLOCK_SIZE):
    """1-bit quantize each row of ``x`` (r, n) independently.

    Returns ``(packed, scales)``: ``packed`` uint8 of shape (r, packed_bytes)
    with 8 MSB-first sign bits per byte (bit set = non-negative), ``scales``
    fp32 of shape (r, nb) holding per-block mean magnitudes.
    """
    r, n = x.shape
    bs, nb, npad, nbytes = sign_pack_layout(n, block_size)
    xf = _as_f32(x)
    if npad != n:
        xf = torch.nn.functional.pad(xf, (0, npad - n))
    # the mean summed in float64: the same fp32 scale on the CPU and the
    # card, whatever order each sums in
    scales = (xf.reshape(r, nb, bs).abs().sum(dim=-1, dtype=torch.float64)
              / bs).float()
    bits = (xf >= 0).to(torch.uint8)                  # nan -> sign bit 0
    if nbytes * 8 != npad:
        bits = torch.nn.functional.pad(bits, (0, nbytes * 8 - npad))
    packed = (bits.reshape(r, nbytes, 8) * _pow2(xf.device)).sum(
        dim=-1, dtype=torch.int32).to(torch.uint8)
    return packed, scales


def dequantize_signs_rows(packed, scales, n: int, dtype=torch.float32,
                          block_size: int = DEFAULT_BLOCK_SIZE):
    """Inverse of quantize_signs_rows: (r, packed_bytes) uint8 + (r, nb)
    scales -> (r, n) with each element ``±scale_of_its_block``."""
    r = packed.shape[0]
    bs, nb, npad, nbytes = sign_pack_layout(n, block_size)
    bits = (packed[:, :, None] & _pow2(packed.device)[None, None, :]) > 0
    signs = bits.reshape(r, nbytes * 8)[:, :npad].float() * 2.0 - 1.0
    out = signs.reshape(r, nb, bs) * scales[:, :, None]
    return out.reshape(r, npad)[:, :n].to(dtype)


# ---------------------------------------------------------------------------
# host twins: the ZeRO-Offload qwZ push quantizes this rank's shard on the
# host, copies the int8 codes and scales up, and the device dequantizes
# after the gather. They take CPU tensors (or numpy arrays) and return CPU
# tensors; the arithmetic is the device functions'.
# ---------------------------------------------------------------------------

def quantize_blockwise_np(x, block_size: int = DEFAULT_BLOCK_SIZE):
    """Quantize a flat CPU tensor: (q[npad] int8, scales[nb] f32)."""
    q, scales = quantize_rows(_as_f32(x).cpu().reshape(1, -1), block_size,
                              divide=True)
    return q[0], scales[0]


def dequantize_blockwise_np(q, scales, n: int, dtype=torch.float32):
    """Inverse of quantize_blockwise_np: the first ``n`` elements."""
    nb = scales.shape[0]
    return dequantize_rows(torch.as_tensor(q).reshape(1, -1),
                           torch.as_tensor(scales).reshape(1, nb), n,
                           dtype)[0]


def quantize_signs_rows_np(x, block_size: int = DEFAULT_BLOCK_SIZE):
    """quantize_signs_rows of a CPU tensor (the same packing layout)."""
    return quantize_signs_rows(_as_f32(x).cpu(), block_size)


def dequantize_signs_rows_np(packed, scales, n: int, dtype=torch.float32,
                             block_size: int = DEFAULT_BLOCK_SIZE):
    return dequantize_signs_rows(torch.as_tensor(packed),
                                 torch.as_tensor(scales), n, dtype,
                                 block_size)
