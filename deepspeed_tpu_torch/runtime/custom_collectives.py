"""The int8 ZeRO collectives (ZeRO++, arxiv 2306.10209): qgZ, the
quantized gradient reduce-scatter, and qwZ, the quantized parameter
all-gather.

Port of the ZeRO half of deepspeed_tpu/runtime/custom_collectives.py
(:96-257). The JAX functions run inside ``shard_map`` over the ``data``
axis; here each rank is a process and the wire is its
``DataParallelGroup`` (parallel/mesh.py): int8 codes and fp32 per-block
scales (runtime/quantization.py) through ``all_to_all_single`` and
``all_gather_into_tensor``, counted leaf by leaf under the JAX report's
names (``qgz_a2a``, ``qgz_scales``, ``*_intra`` / ``*_inter``,
``qwz_ag``, ``qwz_scales``).

A leaf's rank-r part is its shard along ``dim``, flattened with ``dim``
moved to the front (the JAX functions' ``moveaxis``): one row of the
quantizer, so the blocks, and with them the codes, are the JAX
package's. Many leaves ride one collective as a bucket: the rows of
every leaf side by side, each quantized on its own.

``*_virtual`` compose the same arithmetic for n virtual ranks on one
device, with no wire (as parallel/ring_attention.py ``ring_virtual``
does): the CPU tests hold them against the JAX functions, and the chip
check runs them at full width.

The 1-bit wire (``compressed_allreduce``, ``quantized_all_reduce``, the
error-feedback twins) belongs to 1-bit and 0/1 Adam, ROADMAP A13b.
"""
import torch

from deepspeed_tpu_torch.runtime.quantization import (DEFAULT_BLOCK_SIZE,
                                                      block_layout,
                                                      dequantize_rows,
                                                      quantize_rows)


def leaf_rows(x, dim, w):
    """(w, n / w): row r is rank r's shard of ``x`` along ``dim``, with
    ``dim`` moved to the front and flattened."""
    if x.shape[dim] % w:
        raise ValueError(f"dim {dim} (size {x.shape[dim]}) must divide the "
                         f"group size {w}")
    return x.movedim(dim, 0).reshape(w, -1)


def rows_to_leaf(rows, shape, dim):
    """Inverse of ``leaf_rows``: (w, n / w) -> ``shape``."""
    moved = (shape[dim],) + tuple(shape[:dim]) + tuple(shape[dim + 1:])
    return rows.reshape(moved).movedim(0, dim)


def hierarchical_size(w, intra_size):
    """The intra-group size k the two-hop scheme runs with, or 0 (flat):
    1 < k < w and k divides w."""
    k = int(intra_size or 0)
    return k if 1 < k < w and w % k == 0 else 0


#: the most elements (over every row) that one pass of the bucketed codec
#: codes or decodes: it bounds the pass's fp32 and float64 transients
BUCKET_PASS_ELEMENTS = 1 << 25


def _bucket_layout(lengths, block_size, rows=1):
    """The codes and scales of leaves of ``lengths`` elements (each in
    ``rows`` rows) side by side: each leaf's (code offset, npad, scale
    offset, nb, n), and the passes [(block, code start, code end, scale
    start, scale end)], a pass being consecutive leaves of one effective
    block size (``block_layout`` clamps it to a short row) within
    BUCKET_PASS_ELEMENTS (a longer leaf takes a pass of its own)."""
    lay = [None] * len(lengths)
    passes, qa, sa = [], 0, 0
    sizes = [block_layout(n, block_size) for n in lengths]
    for bs in dict.fromkeys(b for b, _, _ in sizes):
        q0, s0 = qa, sa
        for j, (b, nb, npad) in enumerate(sizes):
            if b != bs:
                continue
            if qa > q0 and rows * (qa + npad - q0) > BUCKET_PASS_ELEMENTS:
                passes.append((bs, q0, qa, s0, sa))
                q0, s0 = qa, sa
            lay[j] = (qa, npad, sa, nb, lengths[j])
            qa, sa = qa + npad, sa + nb
        passes.append((bs, q0, qa, s0, sa))
    return lay, passes


def _quantize_bucket(rows_list, block_size):
    """The (w, n_i) row blocks of ``rows_list`` quantized, each row of
    each leaf on its own, one pass per pass of ``_bucket_layout``: the
    codes and scales side by side, ((w, sum npad), (w, sum nb)), and each
    leaf's layout entry. A leaf's zero padding ends on a block boundary,
    so every block, and with it every code, is the leaf's own."""
    w = rows_list[0].shape[0]
    lay, passes = _bucket_layout([r.shape[1] for r in rows_list], block_size,
                                 w)
    qs, ss = [], []
    for bs, q0, q1, _, _ in passes:
        buf = rows_list[0].new_zeros((w, q1 - q0), dtype=torch.float32)
        dst, src = [], []
        for rows, (qa, _, _, _, n) in zip(rows_list, lay):
            if q0 <= qa < q1:
                dst.append(buf[:, qa - q0:qa - q0 + n])
                src.append(rows)
        torch._foreach_copy_(dst, src)
        q, sc = quantize_rows(buf, bs)
        qs.append(q)
        ss.append(sc)
    return torch.cat(qs, 1), torch.cat(ss, 1), lay, passes


def dequantize_sum(q, s, n):
    """The sum over rows of ``dequantize_rows(q, s, n)`` as the JAX
    package's compiled programs compute it: the first row's products,
    then each next row's added by a fused multiply-add (one rounding per
    row). Each int8 x fp32 product is exact in float64, so the float64
    add rounded to fp32 is that multiply-add, on the CPU and the card
    alike."""
    w, npad = q.shape
    nb = s.shape[1]
    bs = npad // nb

    def prod(j):
        return (q[j].reshape(nb, bs).double()
                * s[j].double()[:, None]).reshape(npad)

    acc = prod(0).float()
    for j in range(1, w):
        acc = (acc.double() + prod(j)).float()
    return acc[:n]


def _dequantize_sum(q, s, lay, passes):
    """Each leaf's rows dequantized and summed over dim 0, in the passes
    of ``_bucket_layout``: [(n_i,)]."""
    sums = [(q0, dequantize_sum(q[:, q0:q1], s[:, s0:s1], q1 - q0))
            for _, q0, q1, s0, s1 in passes]
    out = []
    for qa, _, _, _, n in lay:
        q0, acc = next((q0, a) for q0, a in reversed(sums) if q0 <= qa)
        out.append(acc[qa - q0:qa - q0 + n])
    return out


def _hop(group, rows_list, names, elements, block_size, prefix, link):
    """One all-to-all hop of row blocks ``rows_list`` [(w, n_i)] over
    ``group`` (size w): quantized, exchanged (codes and scales, counted
    under ``prefix``), dequantized and summed: this rank's [(n_i,)]."""
    w = group.size
    q, s, lay, passes = _quantize_bucket(rows_list, block_size)
    qr, sr = torch.empty_like(q), torch.empty_like(s)
    group.quantized_all_to_all(
        qr, q, f"qgz_a2a{prefix}",
        [(nm, e, w * npad) for nm, e, (_, npad, _, _, _) in zip(
            names, elements, lay)], link)
    group.quantized_all_to_all(
        sr, s, f"qgz_scales{prefix}",
        [(nm, e, w * nb) for nm, e, (_, _, _, nb, _) in zip(
            names, elements, lay)], link)
    return _dequantize_sum(qr, sr, lay, passes)


def quantized_reduce_scatter_rows(rows_list, group, names, *,
                                  block_size=DEFAULT_BLOCK_SIZE,
                                  intra_size=0, mean=True):
    """qgZ over ``group`` of the leaves whose rows are ``rows_list`` [(w,
    n_i)] (``leaf_rows``; ``names`` for the counter): this rank's
    (n_i,) part of the sum (``mean``: the mean) over the ranks.

    Flat: each row quantized, one int8 all-to-all and one of the fp32
    scales, dequantized, summed. Hierarchical (``intra_size`` k, 1 < k <
    w): the two-hop of JAX :150-169 over ``group.hierarchy(k)``, the
    partial sums of the intra hop re-quantized for the inter hop."""
    w = group.size
    elements = [r.numel() for r in rows_list]
    k = hierarchical_size(w, intra_size)
    if not k:
        out = _hop(group, rows_list, names, elements, block_size, "", "flat")
    else:
        m = w // k
        intra, inter = group.hierarchy(k)
        # hop 1: the m outer chunks of each intra destination together
        x1 = [r.reshape(m, k, -1).transpose(0, 1).reshape(k, -1)
              for r in rows_list]
        partial = _hop(intra, x1, names, elements, block_size, "_intra",
                       "intra")
        # hop 2: the group-reduced 1/k over the m outer ranks
        x2 = [p.reshape(m, -1) for p in partial]
        out = _hop(inter, x2, names, [e // k for e in elements], block_size,
                   "_inter", "inter")
    return [t / w for t in out] if mean else out


def quantized_reduce_scatter(x, group, *, dim=0, block_size=None,
                             intra_size=0, mean=True, name="x"):
    """qgZ: this rank's shard along ``dim`` of the mean (or, ``mean`` off,
    the sum) over ``group`` of every rank's full-shaped ``x``, moved as
    blockwise int8 + fp32 scales (JAX ``quantized_reduce_scatter``).
    Non-finite inputs give non-finite block scales, so the result is
    non-finite and the loss scaler still trips."""
    w = group.size
    rows = leaf_rows(x, dim, w)
    out, = quantized_reduce_scatter_rows(
        [rows], group, [name], block_size=block_size or DEFAULT_BLOCK_SIZE,
        intra_size=intra_size, mean=mean)
    shape = list(x.shape)
    shape[dim] //= w
    return rows_to_leaf(out, shape, dim)


def quantized_gather_rows(shard_rows, group, names, out_dtype,
                          block_size=DEFAULT_BLOCK_SIZE):
    """qwZ over ``group`` of the leaves whose shards (this rank's part,
    flattened as ``leaf_rows`` rows) are ``shard_rows`` [(n_i,)]: [(w,
    n_i)] in ``out_dtype``. The shards are coded and dequantized in the
    passes of ``_bucket_layout``; the wire is one int8
    all-gather and one of the fp32 scales per leaf, in order (counted as
    ``qwz_ag`` / ``qwz_scales``; the JAX program's, whose contract counts
    one s8 gather per leaf), each into its leaf's region of one receive
    buffer, rank-major within it."""
    w = group.size
    q, s, lay, passes = _quantize_bucket(
        [r.reshape(1, -1) for r in shard_rows], block_size)
    q, s = q.reshape(-1), s.reshape(-1)
    qg = torch.empty(w * q.numel(), dtype=q.dtype, device=q.device)
    sg = torch.empty(w * s.numel(), dtype=s.dtype, device=s.device)
    for name, (qa, npad, sa, nb, _) in zip(names, lay):
        group.quantized_all_gather(qg[w * qa:w * (qa + npad)],
                                   q[qa:qa + npad], "qwz_ag",
                                   [(name, w * npad)])
        group.quantized_all_gather(sg[w * sa:w * (sa + nb)],
                                   s[sa:sa + nb], "qwz_scales",
                                   [(name, w * nb)])
    # leaf-major, rank-major within a leaf: block k of rank r of a leaf
    # lies beside its scale, so each pass dequantizes at once
    full = [(q0, (qg[w * q0:w * q1].view(-1, bs).float()
                  * sg[w * s0:w * s1].view(-1, 1)).to(out_dtype).view(-1))
            for bs, q0, q1, s0, s1 in passes]
    out = []
    for qa, npad, _, _, n in lay:
        q0, f = next((q0, f) for q0, f in reversed(full) if q0 <= qa)
        out.append(f[w * (qa - q0):w * (qa - q0 + npad)].view(w, npad)[:, :n])
    return out


class _QuantizedAllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, group, dim, block_size, out_dtype, name):
        ctx.group, ctx.dim, ctx.name = group, dim, name
        ctx.in_dtype = shard.dtype
        w = group.size
        row = shard.movedim(dim, 0).reshape(-1)
        full, = quantized_gather_rows([row], group, [name], out_dtype,
                                      block_size)
        shape = list(shard.shape)
        shape[dim] *= w
        return rows_to_leaf(full, shape, dim)

    @staticmethod
    def backward(ctx, grad):
        # straight-through: round's derivative (0) is not applied; the
        # cotangent goes back as the shard's gradient, summed over the
        # ranks by the reduce-scatter of the dense gradient exchange
        group, dim = ctx.group, ctx.dim
        rows = leaf_rows(grad.to(ctx.in_dtype), dim, group.size)
        out = torch.empty(rows.shape[1], dtype=rows.dtype,
                          device=rows.device)
        group.reduce_scatter(out, rows.contiguous().view(-1),
                             leaves=[(ctx.name, grad.numel())])
        shape = list(grad.shape)
        shape[dim] //= group.size
        return rows_to_leaf(out, shape, dim), None, None, None, None, None


def quantized_all_gather(shard, group, *, dim=0, block_size=None,
                         out_dtype=None, name="x"):
    """qwZ: the whole leaf from every rank's ``shard`` (this rank's part
    along ``dim``), moved as int8 codes + fp32 per-block scales and
    dequantized to ``out_dtype`` (default the shard's dtype); JAX
    ``quantized_all_gather``. Differentiable, straight-through: the
    cotangent reaches the shard unchanged by the quantizer, reduce-
    scattered over the group."""
    return _QuantizedAllGather.apply(
        shard, group, dim, block_size or DEFAULT_BLOCK_SIZE,
        out_dtype or shard.dtype, name)


# ---------------------------------------------------------------------------
# n virtual ranks on one device: the same arithmetic, no wire
# ---------------------------------------------------------------------------

def quantized_reduce_scatter_virtual(xs, *, dim=0, block_size=None,
                                     intra_size=0, mean=True):
    """What ``quantized_reduce_scatter`` gives each of n = len(xs)
    virtual ranks, rank j holding the full-shaped ``xs[j]``: [rank r's
    shard]. The hops' exchanges are index permutations here."""
    n = len(xs)
    bs = block_size or DEFAULT_BLOCK_SIZE
    rows = [leaf_rows(x, dim, n) for x in xs]

    def hop(blocks):
        # blocks[j]: rank j's (w, L) rows; rank r gets row r of each
        w = len(blocks)
        coded = [quantize_rows(b, bs) for b in blocks]
        L = blocks[0].shape[1]
        return [dequantize_sum(torch.cat([q[r:r + 1] for q, _ in coded]),
                               torch.cat([s[r:r + 1] for _, s in coded]), L)
                for r in range(w)]

    k = hierarchical_size(n, intra_size)
    if not k:
        out = hop(rows)
    else:
        m = n // k
        x1 = [r.reshape(m, k, -1).transpose(0, 1).reshape(k, -1)
              for r in rows]
        partial = [None] * n
        for o in range(m):                 # each intra group o*k .. o*k+k-1
            got = hop([x1[o * k + i] for i in range(k)])
            for i in range(k):
                partial[o * k + i] = got[i]
        out = [None] * n
        for i in range(k):                 # each inter group i, k+i, ...
            got = hop([partial[o * k + i].reshape(m, -1) for o in range(m)])
            for o in range(m):
                out[o * k + i] = got[o]
    shape = list(xs[0].shape)
    shape[dim] //= n
    return [rows_to_leaf(t / n if mean else t, shape, dim) for t in out]


class _QuantizedAllGatherVirtual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, block_size, out_dtype, *shards):
        ctx.dim, ctx.n = dim, len(shards)
        ctx.in_dtype = shards[0].dtype
        rows = []
        for sh in shards:
            q, s = quantize_rows(sh.movedim(dim, 0).reshape(1, -1),
                                 block_size)
            rows.append(dequantize_rows(q, s, sh.numel(), out_dtype))
        shape = list(shards[0].shape)
        shape[dim] *= len(shards)
        return rows_to_leaf(torch.cat(rows), shape, dim)

    @staticmethod
    def backward(ctx, grad):
        # straight-through: virtual rank r's shard takes part r of the
        # cotangent (one replica: nothing to sum)
        rows = leaf_rows(grad.to(ctx.in_dtype), ctx.dim, ctx.n)
        shape = list(grad.shape)
        shape[ctx.dim] //= ctx.n
        return (None, None, None) + tuple(
            rows_to_leaf(rows[r], shape, ctx.dim) for r in range(ctx.n))


def quantized_all_gather_virtual(shards, *, dim=0, block_size=None,
                                 out_dtype=None):
    """What ``quantized_all_gather`` gives every rank when virtual rank r
    holds ``shards[r]``: the whole leaf, each shard quantized on its own
    and dequantized to ``out_dtype``. Straight-through backward."""
    return _QuantizedAllGatherVirtual.apply(
        dim, block_size or DEFAULT_BLOCK_SIZE,
        out_dtype or shards[0].dtype, *shards)

