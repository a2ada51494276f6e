"""Ring attention: sequence parallelism with K/V blocks passed around the
``seq`` group.

Port of deepspeed_tpu/parallel/ring_attention.py (Liu et al. 2023, "Ring
Attention with Blockwise Transformers"). Sequence rank i of N holds the
(B, H, S/N, D) chunk i of q, k and v. Round r computes this rank's queries
against the K/V block that started on rank (i - r) mod N, folding it into
an fp32 online softmax (running max m, denominator l, accumulator acc),
while the block moves one hop on: to (i + 1) mod N, from (i - 1) mod N
(``SequenceParallelGroup.shift``, posted before the round's products so
the two overlap). The JAX recurrence is kept: q in fp32 times the scale,
the causal mask from global positions (src * S/N + arange) at -1e30,
``l == 0 -> 1``, the output cast to q's dtype. A block that lies wholly
above the causal diagonal is skipped: its p is exactly 0, so m, l and acc
are unchanged bit for bit.

The backward (``_Ring``) goes around the ring once more: each round
recomputes p = exp(s - lse) for the block it holds, adds dQ, and adds the
block's dK/dV into an fp32 buffer that travels with the block; a last hop
takes each block's dK/dV home. Memory stays O(S/N) per rank: no rotated
block is saved. The gradients are the JAX ring's ``jax.grad``.

``ring_forward_round`` and ``ring_backward_round`` are the round bodies on
tensors (plain torch: the JAX package's are jnp einsums, not a Pallas
kernel); the distributed loop and ``ring_virtual``, their composition for
N virtual ranks on one device, both call them. Ring attention has no
dropout path, as in the JAX model.
"""
from typing import Optional

import torch

NEG_INF = -1e30


def _scores(q32, k_blk, q_start, k_start, causal):
    """fp32 scores of the (scaled) queries against one K block, causally
    masked at global positions."""
    s = torch.matmul(q32, k_blk.float().transpose(-1, -2))
    if causal:
        rows = torch.arange(q_start, q_start + q32.shape[-2],
                            device=s.device)
        cols = torch.arange(k_start, k_start + k_blk.shape[-2],
                            device=s.device)
        s = torch.where(rows[:, None] >= cols[None, :], s,
                        torch.full_like(s, NEG_INF))
    return s


def masked_out(q_start, q_len, k_start, causal):
    """True when every key of a block starting at ``k_start`` lies above
    the causal diagonal of queries [q_start, q_start + q_len)."""
    return causal and k_start > q_start + q_len - 1


def ring_forward_round(q32, k_blk, v_blk, m, l, acc, *, q_start, k_start,
                       causal):
    """One round: the fp32 running (m, l, acc) of queries ``q32`` ((..., S_q,
    D), already times the scale) after the block (k_blk, v_blk) at global
    key offset ``k_start``. m and l are (..., S_q, 1)."""
    s = _scores(q32, k_blk, q_start, k_start, causal)
    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
    p = torch.exp(s - m_new)
    correction = torch.exp(m - m_new)
    l_new = l * correction + p.sum(-1, keepdim=True)
    acc_new = acc * correction + torch.matmul(p, v_blk.float())
    return m_new, l_new, acc_new


def ring_finish(m, l, acc):
    """(fp32 output, fp32 lse (..., S_q, 1)) from the last round's running
    values; the caller casts the output to q's dtype. The backward's delta
    reads the fp32 output, as ``jax.grad`` of the JAX ring differentiates
    through the cast."""
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return acc / l_safe, m + torch.log(l_safe)


def ring_backward_round(q32, k_blk, v_blk, do32, lse, delta, *, q_start,
                        k_start, causal, scale):
    """One backward round: (dQ, dK, dV) in fp32 of the block (k_blk,
    v_blk) at global key offset ``k_start``, from the output's fp32
    gradient ``do32``, the forward's lse and delta = rowsum(dO * O), both
    (..., S_q, 1)."""
    s = _scores(q32, k_blk, q_start, k_start, causal)
    p = torch.exp(s - lse)
    dv = torch.matmul(p.transpose(-1, -2), do32)
    dp = torch.matmul(do32, v_blk.float().transpose(-1, -2))
    ds = p * (dp - delta)
    dq = torch.matmul(ds, k_blk.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q32)
    return dq, dk, dv


def _hop(group, sends, names):
    """Post one hop of ``sends``; returns (received buffers, requests)."""
    recvs = [torch.empty_like(t) for t in sends]
    if sends[0].is_meta:      # a FLOP count's replay moves nothing
        return sends, []
    return recvs, group.shift(sends, recvs, names)


def _wait(reqs):
    for r in reqs:
        r.wait()


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        n, idx = group.size, group.rank
        s_l = q.shape[-2]
        q32 = q.float() * scale
        m = torch.full(q.shape[:-1] + (1,), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(q.shape, device=q.device)
        kv = torch.stack((k, v))
        for r in range(n):
            src = (idx - r) % n
            nxt, reqs = _hop(group, [kv], ["kv"]) if r < n - 1 \
                else (None, [])
            if not masked_out(idx * s_l, s_l, src * s_l, causal):
                m, l, acc = ring_forward_round(
                    q32, kv[0], kv[1], m, l, acc, q_start=idx * s_l,
                    k_start=src * s_l, causal=causal)
            _wait(reqs)
            if nxt is not None:
                kv = nxt[0]
        out32, lse = ring_finish(m, l, acc)
        ctx.save_for_backward(q, k, v, out32, lse)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return out32.to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v, out32, lse = ctx.saved_tensors
        group, causal, scale = ctx.group, ctx.causal, ctx.scale
        n, idx = group.size, group.rank
        s_l = q.shape[-2]
        q32 = q.float() * scale
        do32 = g.float()
        delta = (do32 * out32).sum(-1, keepdim=True)
        dq = torch.zeros(q.shape, device=q.device)
        kv = torch.stack((k, v))
        # this round's block's dK/dV, travelling with it
        dkv = torch.zeros(kv.shape, device=q.device)
        for r in range(n):
            src = (idx - r) % n
            nxt, reqs = _hop(group, [kv], ["kv_bwd"]) if r < n - 1 \
                else (None, [])
            if not masked_out(idx * s_l, s_l, src * s_l, causal):
                dq_r, dk, dv = ring_backward_round(
                    q32, kv[0], kv[1], do32, lse, delta, q_start=idx * s_l,
                    k_start=src * s_l, causal=causal, scale=scale)
                dq += dq_r
                dkv[0] += dk
                dkv[1] += dv
            # the block's dK/dV on to the next rank; after the last round
            # that is the block's home
            got, dreqs = _hop(group, [dkv], ["dkv_bwd"])
            _wait(reqs + dreqs)
            dkv = got[0]
            if nxt is not None:
                kv = nxt[0]
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None)


def ring_attention(q, k, v, *, group, causal: bool = True,
                   scale: Optional[float] = None):
    """Sequence-parallel attention over this rank's (B, H, S/N, D) shards
    of sequence-sharded q, k, v over the sequence group ``group``;
    returns this rank's shard of the output, differentiable in q, k, v.
    Posts N - 1 hops of the stacked K/V forward (``sp_ring:kv``), N - 1
    of K/V and N of their gradients backward."""
    scale = (q.shape[-1] ** -0.5) if scale is None else scale
    return _Ring.apply(q, k, v, group, causal, scale)


def make_ring_attention(group, causal: bool = True,
                        scale: Optional[float] = None):
    """Ring attention over this rank's sequence shards, over ``group``:
    the drop-in replacement for dense attention under sequence
    parallelism."""

    def fn(q, k, v):
        return ring_attention(q, k, v, group=group, causal=causal,
                              scale=scale)

    return fn


def ring_virtual(q, k, v, n, *, causal=True, scale=None, do=None):
    """The ring's rounds composed on one device for ``n`` virtual ranks
    over whole (B, H, S, D) tensors: every rank's forward rounds, then,
    given the output gradient ``do``, every rank's backward rounds. Returns
    (out, lse (B, H, S, 1)) and, with ``do``, (dq, dk, dv) in q's dtype:
    what the distributed ring computes over a group of n, without the
    hops."""
    scale = (q.shape[-1] ** -0.5) if scale is None else scale
    s_l = q.shape[-2] // n
    chunks = [slice(i * s_l, (i + 1) * s_l) for i in range(n)]
    outs, lses = [], []
    for i in range(n):
        q32 = q[..., chunks[i], :].float() * scale
        m = torch.full(q32.shape[:-1] + (1,), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(q32)
        for r in range(n):
            src = (i - r) % n
            if masked_out(i * s_l, s_l, src * s_l, causal):
                continue
            m, l, acc = ring_forward_round(
                q32, k[..., chunks[src], :], v[..., chunks[src], :], m, l,
                acc, q_start=i * s_l, k_start=src * s_l, causal=causal)
        out32, lse = ring_finish(m, l, acc)
        outs.append(out32)
        lses.append(lse)
    out32, lse = torch.cat(outs, -2), torch.cat(lses, -2)
    out = out32.to(q.dtype)
    if do is None:
        return out, lse
    do32 = do.float()
    delta = (do32 * out32).sum(-1, keepdim=True)
    dq = torch.zeros(q.shape, device=q.device)
    dk = torch.zeros(k.shape, device=q.device)
    dv = torch.zeros(v.shape, device=q.device)
    for i in range(n):
        qi = chunks[i]
        q32 = q[..., qi, :].float() * scale
        for r in range(n):
            src = (i - r) % n
            if masked_out(i * s_l, s_l, src * s_l, causal):
                continue
            kj = chunks[src]
            a, b, c = ring_backward_round(
                q32, k[..., kj, :], v[..., kj, :], do32[..., qi, :],
                lse[..., qi, :], delta[..., qi, :], q_start=i * s_l,
                k_start=src * s_l, causal=causal, scale=scale)
            dq[..., qi, :] += a
            dk[..., kj, :] += b
            dv[..., kj, :] += c
    return (out, lse), (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
