"""Ulysses sequence parallelism: the head/sequence all-to-all around a
full-sequence attention kernel.

Port of deepspeed_tpu/parallel/ulysses.py. Activations flow through the
network sharded over the sequence: sequence rank s of N holds tokens
[s * S/N, (s + 1) * S/N) of every row. For the attention, one all-to-all
over the ``seq`` group (parallel/mesh.py ``SequenceParallelGroup``) takes
q, k and v from (B, H, S/N, D) to (B, H/N, S, D): rank s then holds heads
[s * H/N, (s + 1) * H/N) over the whole sequence, and any full-sequence
attention runs on them unchanged (the flash kernels B1-B3, or the block-
sparse kernels B5-B7 on the layout's rows of those heads). A second
all-to-all takes the output back to sequence sharding. Where the JAX
package states the flips as sharding constraints and GSPMD inserts the
all-to-alls, here they are posted by hand: q, k and v go in one stacked
all-to-all (``sp_a2a:qkv``), the output in another (``sp_a2a:out``), and
the backward of each is the opposite all-to-all (``qkv_bwd``,
``out_bwd``), as the MoE exchange's is (mesh.py ``_ExpertExchange``).

Requires heads % N == 0 (the classic Ulysses constraint); otherwise use
ring attention (parallel/ring_attention.py). Nothing switches between
the two on its own.
"""
from typing import Callable, Optional

import torch


def _flip(x, group, name, to_heads):
    """to_heads: (..., H, S_l, D) sequence chunks -> (..., H/N, N*S_l, D)
    this rank's heads over the whole sequence. Else the reverse: (..., H_l,
    S, D) -> (..., N*H_l, S/N, D). Leading dims ride along."""
    n = group.size
    lead = x.shape[:-3]
    h, s, d = x.shape[-3:]
    k = len(lead)
    if to_heads:
        # chunk j of the send buffer: heads [j*H/N, (j+1)*H/N)
        send = x.reshape(lead + (n, h // n, s, d)).movedim(k, 0)
    else:
        # chunk j of the send buffer: sequence chunk j
        send = x.reshape(lead + (h, n, s // n, d)).movedim(k + 1, 0)
    send = send.contiguous()
    out = torch.empty_like(send)
    if send.is_meta:          # a FLOP count's replay moves nothing
        out = send
    else:
        group.all_to_all(out, send, name)
    # chunk j of out came from sequence rank j
    if to_heads:       # its sequence chunk of this rank's heads
        return out.movedim(0, k + 1).reshape(lead + (h // n, n * s, d))
    # its heads of this rank's sequence chunk
    return out.movedim(0, k).reshape(lead + (n * h, s // n, d))


class _Flip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, name, to_heads):
        ctx.group, ctx.name, ctx.to_heads = group, name, to_heads
        return _flip(x, group, name, to_heads)

    @staticmethod
    def backward(ctx, grad):
        # an even all-to-all's transpose is the opposite all-to-all
        return _flip(grad, ctx.group, f"{ctx.name}_bwd",
                     not ctx.to_heads), None, None, None


def seq_to_heads(x, group, name):
    """(..., H, S/N, D) sequence-sharded -> (..., H/N, S, D) head-sharded,
    differentiable (one counted all-to-all ``sp_a2a:<name>`` each way)."""
    return _Flip.apply(x, group, name, True)


def heads_to_seq(x, group, name):
    """(..., H/N, S, D) head-sharded -> (..., H, S/N, D) sequence-sharded,
    differentiable."""
    return _Flip.apply(x, group, name, False)


def check_heads(heads, group):
    assert heads % group.size == 0, (
        f"ulysses needs heads ({heads}) divisible by axis 'seq' size "
        f"({group.size}); use ring attention otherwise")


def ulysses_attention(q, k, v, *, group, attention_fn: Optional[Callable]
                      = None, **attn_kw):
    """Sequence-parallel attention over this rank's (B, H, S/N, D) shards
    of sequence-sharded q, k, v; returns this rank's (B, H, S/N, D) shard
    of the output.

    attention_fn(q, k, v, head_offset=, total_heads=, **attn_kw) -> (B,
    H/N, S, D) runs on this rank's heads over the whole sequence; it is
    told which heads those are (``head_offset`` of ``total_heads``), so a
    dropout mask or a layout indexes them globally. Default:
    ops.transformer.functional.scaled_dot_product_attention (the flash
    kernels on CUDA tensors)."""
    if attention_fn is None:
        from deepspeed_tpu_torch.ops.transformer.functional import \
            scaled_dot_product_attention

        attention_fn = scaled_dot_product_attention
    heads = q.shape[1]
    check_heads(heads, group)
    qkv = seq_to_heads(torch.stack((q, k, v)), group, "qkv")
    out = attention_fn(qkv[0], qkv[1], qkv[2],
                       head_offset=group.rank * (heads // group.size),
                       total_heads=heads, **attn_kw)
    return heads_to_seq(out, group, "out")


def make_ulysses_attention(group, causal: bool = True,
                           scale: Optional[float] = None,
                           attention_fn: Optional[Callable] = None):
    """Ulysses attention over this rank's sequence shards (B, H, S/N, D)
    of q, k, v, over the sequence group ``group``: the API twin of
    make_ring_attention. The number of heads must be divisible by the
    group's size."""

    def fn(q, k, v):
        return ulysses_attention(q, k, v, group=group,
                                 attention_fn=attention_fn, causal=causal,
                                 scale=scale)

    return fn
