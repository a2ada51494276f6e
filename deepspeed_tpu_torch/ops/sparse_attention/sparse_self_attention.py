"""Block-sparse self-attention over a SparsityConfig layout: the dispatch
point between the masked dense path and the block-sparse kernels.

Port of deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py. A CUDA
tensor reaching ``block_sparse_attention`` launches the block-sparse kernels
(block_sparse_kernel.py) or raises ``ValueError`` saying why; the masked
dense path (O(S^2), with rpe, ``attn_mask`` and both mask modes) runs on
CPU tensors only.

Masks follow the reference semantics: ``key_padding_mask_mode`` /
``attn_mask_mode`` are 'add' (additive logits) or 'mul' (multiplicative
0/1) (reference sparse_self_attention.py:27-43); ``rpe`` is added to the
scores. On the kernels, key padding becomes the in-kernel per-key bias:
'mul' -> 0 / -1e30, 'add' -> as is.
"""
from typing import Optional

import numpy as np
import torch
from torch import nn

from deepspeed_tpu_torch.ops.sparse_attention.block_sparse_kernel import (
    NEG_INF, kernel_refusal, pallas_block_sparse_attention)
from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
    FixedSparsityConfig, SparsityConfig)

_MODES = ("add", "mul")


def layout_to_token_mask(layout, block: int, device=None):
    """(H, nb, nb) 0/1 block layout -> (H, S, S) boolean token mask."""
    mask = torch.as_tensor(np.asarray(layout) != 0, device=device)
    return mask.repeat_interleave(block, 1).repeat_interleave(block, 2)


def sparse_refusal(q, block, rpe=None, attn_mask=None):
    """Why the block-sparse kernels cannot serve this call (None = they
    can): rpe and attn_mask are dense S x S structures that only the masked
    path takes."""
    if rpe is not None:
        return "rpe (a dense S x S bias) needs the masked path"
    if attn_mask is not None:
        return "attn_mask (a dense S x S mask) needs the masked path"
    return kernel_refusal(q, block)


def _key_bias(key_padding_mask, mode):
    """(B, S) key padding mask -> (B, S) fp32 additive key bias."""
    if key_padding_mask is None:
        return None
    kpm = key_padding_mask.float()
    if mode == "mul":
        return torch.where(kpm != 0, torch.zeros_like(kpm),
                           torch.full_like(kpm, NEG_INF))
    if mode == "add":
        return kpm
    raise ValueError(f"unknown key_padding_mask_mode {mode!r}")


def block_sparse_attention(q, k, v, layout, block: int,
                           rpe=None, key_padding_mask=None, attn_mask=None,
                           key_padding_mask_mode: str = "add",
                           attn_mask_mode: str = "mul",
                           scale: Optional[float] = None,
                           use_pallas: Optional[bool] = None):
    """Masked block-sparse attention.

    q/k/v: (B, H, S, D); layout: (H, S/block, S/block) 0/1;
    rpe: (S, S) or broadcastable additive bias;
    key_padding_mask: (B, S) - 'add': float additions (-1e30 for pad),
        'mul': 0/1 multiplier; attn_mask: (S, S) likewise.
    use_pallas: for CPU tensors, None or False takes the masked dense path
    and True the kernels' plain versions. Any other tensor takes the
    kernels: None or True launches them or raises when they cannot serve
    the call, and False raises, since the masked path runs on CPU tensors
    only.
    """
    if q.device.type != "cpu":
        if use_pallas is False:
            raise ValueError(f"use_pallas=False: the masked block-sparse path "
                             f"runs on CPU tensors only, not on {q.device}")
        why = sparse_refusal(q, block, rpe, attn_mask)
        if why is not None:
            raise ValueError(f"block-sparse kernels cannot take this "
                             f"{q.device.type} call: {why}")
        use_pallas = True
    if use_pallas:
        if rpe is not None or attn_mask is not None:
            raise ValueError("the block-sparse kernels take no rpe or "
                             "attn_mask: use the masked path (use_pallas=None"
                             " or False, CPU tensors)")
        return pallas_block_sparse_attention(
            q, k, v, layout, block, scale=scale,
            key_bias=_key_bias(key_padding_mask, key_padding_mask_mode))

    B, H, S, D = q.shape
    nb = S // block
    if np.shape(layout)[-1] != nb:
        raise ValueError(f"layout {np.shape(layout)} does not match seq {S} /"
                         f" block {block}")
    scale = (D ** -0.5) if scale is None else scale
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if rpe is not None:
        scores = scores + rpe.float()
    if attn_mask is not None:
        am = attn_mask.float()
        if attn_mask_mode == "mul":
            scores = scores.masked_fill(am[None, None] == 0, NEG_INF)
        elif attn_mask_mode == "add":
            scores = scores + am[None, None]
        else:
            raise ValueError(f"unknown attn_mask_mode {attn_mask_mode!r}")
    if key_padding_mask is not None:
        kpm = key_padding_mask.float()
        if key_padding_mask_mode == "mul":
            scores = scores.masked_fill(kpm[:, None, None, :] == 0, NEG_INF)
        elif key_padding_mask_mode == "add":
            scores = scores + kpm[:, None, None, :]
        else:
            raise ValueError(f"unknown key_padding_mask_mode "
                             f"{key_padding_mask_mode!r}")

    tok_mask = layout_to_token_mask(layout, block, q.device)   # (H, S, S)
    scores = scores.masked_fill(~tok_mask[None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    # rows with no active block would spread uniform probabilities over
    # -1e30 logits; zero them like the kernels' empty-row rule
    any_active = tok_mask.any(-1)                              # (H, S)
    probs = probs * any_active[None, :, :, None]
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v.float())
    return out.to(q.dtype)


class SparseSelfAttention(nn.Module):
    """Module with the reference's call signature (reference
    sparse_self_attention.py:14-60, forward :110-164); it has no
    parameters and keeps one layout per sequence length."""

    def __init__(self, sparsity_config: Optional[SparsityConfig] = None,
                 key_padding_mask_mode: str = "add",
                 attn_mask_mode: str = "mul"):
        super().__init__()
        if key_padding_mask_mode not in _MODES \
                or attn_mask_mode not in _MODES:
            raise ValueError(f"mask modes must be one of {_MODES}")
        self.sparsity_config = sparsity_config or \
            FixedSparsityConfig(num_heads=4)
        self.key_padding_mask_mode = key_padding_mask_mode
        self.attn_mask_mode = attn_mask_mode
        self._layout_cache = {}   # seq_len -> layout (reference master_layout)

    def get_layout(self, seq_len):
        if seq_len not in self._layout_cache:
            self._layout_cache[seq_len] = np.asarray(
                self.sparsity_config.make_layout(seq_len))
        return self._layout_cache[seq_len]

    def forward(self, query, key, value, rpe=None, key_padding_mask=None,
                attn_mask=None):
        heads = query.shape[1]
        if heads != self.sparsity_config.num_heads:
            raise ValueError(f"input has {heads} heads, sparsity config has "
                             f"{self.sparsity_config.num_heads}")
        return block_sparse_attention(
            query, key, value, self.get_layout(query.shape[2]),
            self.sparsity_config.block, rpe=rpe,
            key_padding_mask=key_padding_mask, attn_mask=attn_mask,
            key_padding_mask_mode=self.key_padding_mask_mode,
            attn_mask_mode=self.attn_mask_mode)
