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

The 1-bit wire of 1-bit Adam and 0/1 Adam (JAX :20-93, :260-399,
:466-522): the sign codes (``pack_signs``, ``unpack_signs``,
``sign_compress``), ``compressed_allreduce`` (worker signs scattered to
their servers by all-to-all, the servers' re-compressed chunks
all-gathered; counted as ``onebit_a2a`` / ``onebit_scales`` /
``onebit_ag`` / ``onebit_ag_scales``) and ``quantized_all_reduce`` (the
0/1 Adam wire at bits 1 or 8, flat or over ``hierarchical_size``
groups; counted under the JAX report's ``zeroone_*`` names), each with
its ``*_virtual`` twin, and the single-device error-feedback twins
``quantize_with_error_feedback`` and ``quantized_error_feedback``. No
caller differentiates through these wires (the optimizers call them
under ``no_grad``), so the JAX ``quantized_all_reduce_gspmd``'s
straight-through vjp has no counterpart here.

Their arithmetic is laid out so that the CPU and the card compute the
same bits: a norm or a block's mean magnitude sums in float64 before it
rounds to fp32 (order-free to within a float64 rounding), the servers
add the ranks' decoded rows one after the other, and an int8 residual or
sum takes its product in float64 and rounds once, as the JAX programs'
fused multiply-adds do.
"""
import torch

from deepspeed_tpu_torch.runtime import comm_accounting as ca
from deepspeed_tpu_torch.runtime.quantization import (DEFAULT_BLOCK_SIZE,
                                                      _pow2, block_layout,
                                                      dequantize_rows,
                                                      dequantize_signs_rows,
                                                      quantize_rows,
                                                      quantize_signs_rows,
                                                      sign_pack_layout)


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



# ---------------------------------------------------------------------------
# the 1-bit wire of 1-bit Adam (JAX :20-93, :510-522)
# ---------------------------------------------------------------------------
def pack_signs(signs):
    """{-1, +1} float vector (len % 8 == 0) -> uint8 bit-packed vector,
    most significant bit first, a set bit for +1."""
    bits = (signs > 0).to(torch.uint8).reshape(-1, 8)
    return (bits * _pow2(signs.device)).sum(
        -1, dtype=torch.int32).to(torch.uint8)


def unpack_signs(packed):
    """uint8 bit-packed vector -> {-1, +1} float32 vector."""
    bits = (packed.reshape(-1, 1) & _pow2(packed.device)) > 0
    return (bits.float() * 2.0 - 1.0).reshape(-1)


def sign_compress(x):
    """(scale, signs, residual): x ~= scale * signs, residual = x - that;
    scale = ||x||_2 / sqrt(n) (the norm summed in float64, rounded to
    fp32, then divided in fp32 as the JAX function divides), sign(0) =
    +1."""
    norm = torch.linalg.vector_norm(x, dtype=torch.float64).float()
    # a device tensor, filled there: a CUDA division by a host scalar
    # multiplies by its reciprocal, which rounds otherwise than the CPU's
    # division
    scale = norm / torch.full((), float(x.numel()), dtype=torch.float32,
                              device=x.device).sqrt()
    signs = torch.where(x >= 0, 1.0, -1.0).to(torch.float32)
    return scale, signs, x - scale * signs


def _server_sum(rows, scales):
    """sum_j scales[j] * rows[j], added one rank after the other (each
    product is exact: a row holds signs)."""
    acc = rows[0] * scales[0]
    for j in range(1, rows.shape[0]):
        acc = acc + rows[j] * scales[j]
    return acc


def _onebit_server(recv_signs, scales, server_error):
    """The server phase: the w ranks' signs of this chunk (w, chunk)
    decoded with their scales, averaged, plus the server residual, and
    re-compressed: (scale, packed signs, new residual)."""
    w = recv_signs.shape[0]
    server_m = _server_sum(recv_signs, scales) / w + server_error
    scale, signs, new_se = sign_compress(server_m)
    return scale, pack_signs(signs), new_se


def _decode_chunks(packed_rows, scales, chunk):
    """Every server's chunk decoded: (w, chunk / 8) packed + (w,) scales
    -> the flat (w * chunk,) result."""
    w = packed_rows.shape[0]
    signs = unpack_signs(packed_rows.reshape(-1)).view(w, chunk)
    return (signs * scales.view(w, 1)).reshape(-1)


def _check_onebit(n, w):
    if n % (8 * w):
        raise ValueError(f"compressed_allreduce needs size % {8 * w} == 0, "
                         f"got {n}")


def compressed_allreduce(x, worker_error, server_error, group, name="x",
                         elements=None):
    """Error-compensated 1-bit average of every rank's flat fp32 ``x``
    over ``group`` (JAX ``compressed_allreduce``, custom_collectives.py:
    46-93). ``x.numel()`` is a multiple of 8 * w; ``worker_error`` is
    x-sized; ``server_error`` is chunk-sized (n / w, this rank's server
    residual) or full-sized (this rank's chunk is read and written at
    rank * n / w). The wire: the packed worker signs by all-to-all (chunk
    j to rank j), the worker scales, the servers' packed chunks and
    scales by all-gather; ``name`` and ``elements`` (default n) name the
    leaf for the counter. Returns (mean, new worker_error, new
    server_error)."""
    w, n = group.size, x.numel()
    _check_onebit(n, w)
    chunk = n // w
    e = n if elements is None else elements
    full = server_error.numel() == n
    lo = group.rank * chunk
    se = server_error[lo:lo + chunk] if full else server_error
    wscale, signs, new_we = sign_compress(x + worker_error)
    packed = pack_signs(signs)
    recv = torch.empty_like(packed)
    group.quantized_all_to_all(recv, packed, "onebit_a2a",
                               [(name, e, n // 8)])
    scales = torch.empty(w, dtype=torch.float32, device=x.device)
    group.quantized_all_gather(scales, wscale.reshape(1), "onebit_scales",
                               [(name, e, w)])
    sscale, spacked, new_se = _onebit_server(
        unpack_signs(recv).view(w, chunk), scales, se)
    all_packed = torch.empty(w * spacked.numel(), dtype=torch.uint8,
                             device=x.device)
    group.quantized_all_gather(all_packed, spacked, "onebit_ag",
                               [(name, e, n // 8)])
    all_scales = torch.empty(w, dtype=torch.float32, device=x.device)
    group.quantized_all_gather(all_scales, sscale.reshape(1),
                               "onebit_ag_scales", [(name, e, w)])
    out = _decode_chunks(all_packed.view(w, -1), all_scales, chunk)
    if full:
        whole = server_error.clone()
        whole[lo:lo + chunk] = new_se
        new_se = whole
    return out, new_we, new_se


def compressed_allreduce_virtual(xs, worker_errors, server_errors,
                                 wire=None):
    """What ``compressed_allreduce`` gives each of w = len(xs) virtual
    ranks (rank r holding ``xs[r]``, its residuals at index r; server
    residuals chunk- or full-sized): ([mean], [new worker_error], [new
    server_error]); the exchanges are index permutations. ``wire`` (a
    dict) receives what would cross it: ``worker_packed``,
    ``worker_scales``, ``server_packed``, ``server_scales`` (per rank)
    and ``bytes`` (what one rank sends)."""
    w, n = len(xs), xs[0].numel()
    _check_onebit(n, w)
    chunk = n // w
    coded = [sign_compress(x + e) for x, e in zip(xs, worker_errors)]
    packed = [pack_signs(s).view(w, -1) for _, s, _ in coded]
    scales = torch.stack([sc for sc, _, _ in coded])
    sp, ss, new_se = [], [], []
    for r in range(w):
        se = server_errors[r]
        full = se.numel() == n
        mine = se[r * chunk:(r + 1) * chunk] if full else se
        recv = torch.stack([packed[j][r] for j in range(w)])
        scale, spacked, res = _onebit_server(
            unpack_signs(recv).view(w, chunk), scales, mine)
        if full:
            whole = se.clone()
            whole[r * chunk:(r + 1) * chunk] = res
            res = whole
        sp.append(spacked)
        ss.append(scale)
        new_se.append(res)
    out = _decode_chunks(torch.stack(sp), torch.stack(ss), chunk)
    if wire is not None:
        wire.update(worker_packed=packed, worker_scales=scales,
                    server_packed=sp, server_scales=torch.stack(ss),
                    bytes=onebit_wire_bytes(n, w))
    return [out] * w, [e for _, _, e in coded], new_se


def onebit_wire_bytes(n, w):
    """The bytes one rank sends through ``compressed_allreduce`` of n
    elements over w ranks: the packed signs and one fp32 scale, twice
    (to the servers, then from its server), ring-counted as the
    counter counts them."""
    return (ca.all_to_all_bytes(n // 8, 1, w) + ca.all_gather_bytes(w, 4, w)
            + ca.all_gather_bytes(n // 8, 1, w)
            + ca.all_gather_bytes(w, 4, w))


def quantize_with_error_feedback(x, worker_error, server_error):
    """Single-device twin of ``compressed_allreduce`` (w == 1): two
    sign-compressions in a row with persistent residuals (JAX
    custom_collectives.py:510-522). Returns (out, new worker_error, new
    server_error)."""
    wscale, signs, new_we = sign_compress(x + worker_error)
    sscale, ssigns, new_se = sign_compress(wscale * signs + server_error)
    return sscale * ssigns, new_we, new_se


# ---------------------------------------------------------------------------
# the 0/1 Adam wire (JAX :260-399, :466-508)
# ---------------------------------------------------------------------------
class _Codec:
    """The wire's row codec at ``bits`` 1 (packed signs + per-block mean
    magnitudes) or 8 (int8 + per-block scales)."""

    def __init__(self, bits, block_size):
        if bits not in (1, 8):
            raise ValueError(f"quantized_all_reduce: bits must be 1 or 8, "
                             f"got {bits}")
        self.bits, self.bs = bits, block_size or DEFAULT_BLOCK_SIZE

    def quant(self, rows):
        if self.bits == 1:
            return quantize_signs_rows(rows, self.bs)
        return quantize_rows(rows, self.bs)

    def dequant(self, q, s, n):
        if self.bits == 1:
            return dequantize_signs_rows(q, s, n, block_size=self.bs)
        return dequantize_rows(q, s, n)

    def residual(self, rows, q, s):
        """rows - dequant(q, s): for int8 the product in float64, rounded
        once (the compiled JAX function's fused multiply-add); a sign
        code's product is exact."""
        n = rows.shape[1]
        if self.bits == 1:
            return rows - self.dequant(q, s, n)
        r, npad = q.shape
        nb = s.shape[1]
        prod = (q.view(r, nb, npad // nb).double()
                * s.double()[:, :, None]).view(r, npad)[:, :n]
        return (rows.double() - prod).float()

    def sum(self, q, s, n):
        """The sum over rows of the decoded rows, added one after the
        other (``dequantize_sum`` for int8)."""
        if self.bits == 8:
            return dequantize_sum(q, s, n)
        rows = self.dequant(q, s, n)
        acc = rows[0]
        for j in range(1, rows.shape[0]):
            acc = acc + rows[j]
        return acc

    def row_bytes(self, n):
        """(code bytes, scales) of one row of n elements."""
        if self.bits == 1:
            _, nb, _, nbytes = sign_pack_layout(n, self.bs)
            return nbytes, nb
        _, nb, npad = block_layout(n, self.bs)
        return npad, nb


def quantized_error_feedback(x, worker_error, server_error, *, bits=1,
                             block_size=None):
    """Single-device twin of ``quantized_all_reduce`` (w == 1): both
    quantization stages run locally with persistent residuals (JAX
    custom_collectives.py:466-508). Returns (out, new worker_error, new
    server_error), all flat and x-sized."""
    codec = _Codec(bits, block_size)
    n = x.numel()
    buf = (x.float().reshape(-1) + worker_error.reshape(-1)).reshape(1, -1)
    q, s = codec.quant(buf)
    stage1 = codec.dequant(q, s, n)
    new_we = codec.residual(buf, q, s)[0]
    m = (stage1[0] + server_error.reshape(-1)).reshape(1, -1)
    q2, s2 = codec.quant(m)
    return codec.dequant(q2, s2, n)[0], new_we, codec.residual(m, q2, s2)[0]


def _zeroone_hop(group, q, s, prefix, name, e, link):
    """One all-to-all of the codes and scales of ``q`` / ``s`` (w rows)
    over ``group``: rank j's row for this rank in row j."""
    qr, sr = torch.empty_like(q), torch.empty_like(s)
    group.quantized_all_to_all(qr, q, f"zeroone_a2a{prefix}",
                               [(name, e, q.numel())], link)
    group.quantized_all_to_all(sr, s, f"zeroone_scales{prefix}",
                               [(name, e, s.numel())], link)
    return qr, sr


def _zeroone_gather(group, q, s, prefix, name, e, link):
    """Every rank's codes ``q`` and scales ``s`` (this rank's rows) over
    ``group``: (w, *q.shape), (w, *s.shape), rank-major."""
    w = group.size
    qg = torch.empty(w * q.numel(), dtype=q.dtype, device=q.device)
    sg = torch.empty(w * s.numel(), dtype=s.dtype, device=s.device)
    group.quantized_all_gather(qg, q.reshape(-1), f"zeroone_ag{prefix}",
                               [(name, e, qg.numel())], link)
    group.quantized_all_gather(sg, s.reshape(-1),
                               f"zeroone_ag_scales{prefix}",
                               [(name, e, sg.numel())], link)
    return qg.view((w,) + tuple(q.shape)), sg.view((w,) + tuple(s.shape))


def quantized_all_reduce(x, group, *, bits=1, block_size=None,
                         intra_size=0, worker_error=None, server_error=None,
                         name="x", elements=None):
    """The 0/1 Adam wire (JAX ``quantized_all_reduce``, custom_collectives
    .py:260-399): the mean over ``group`` of every rank's flat ``x``
    (``x.numel()`` a multiple of the group size w) by quantize ->
    all-to-all reduce-scatter -> requantize -> all-gather, in the
    quantized wire format throughout; ``bits`` 1 (packed signs + per-block
    mean magnitudes) or 8 (int8 + per-block scales). ``worker_error``
    (x-sized) is added before the first quantize, ``server_error``
    (chunk-sized, n / w) at the reduced mean before the requantize; both
    come back updated. Hierarchical (``intra_size`` k, 1 < k < w, k | w):
    the reduce-scatter intra-group then inter-group on requantized
    partial sums, the all-gather inter-group then intra-group on the same
    codes. Non-finite inputs give non-finite scales, so the mean comes
    back non-finite. ``name`` / ``elements`` name the leaf for the
    counter. Returns (mean, new worker_error, new server_error)."""
    codec = _Codec(bits, block_size)
    w, n = group.size, x.numel()
    e = n if elements is None else elements
    xf = x.float().reshape(-1)
    we = torch.zeros_like(xf) if worker_error is None \
        else worker_error.float().reshape(-1)
    if w == 1:
        se = torch.zeros_like(xf) if server_error is None \
            else server_error.float().reshape(-1)
        return quantized_error_feedback(xf, we, se, bits=bits,
                                        block_size=codec.bs)
    if n % w:
        raise ValueError(f"quantized_all_reduce needs size % {w} == 0, "
                         f"got {n}")
    nloc = n // w
    rows = (xf + we).view(w, nloc)
    k = hierarchical_size(w, intra_size)
    if not k:
        q, s = codec.quant(rows)
        new_we = codec.residual(rows, q, s).reshape(-1)
        qr, sr = _zeroone_hop(group, q, s, "", name, e, "flat")
        total = codec.sum(qr, sr, nloc)
    else:
        m = w // k
        intra, inter = group.hierarchy(k)
        x1 = rows.view(m, k, nloc).transpose(0, 1).reshape(k, -1)
        q1, s1 = codec.quant(x1)
        new_we = codec.residual(x1, q1, s1).view(k, m, nloc) \
            .transpose(0, 1).reshape(-1)
        qr1, sr1 = _zeroone_hop(intra, q1, s1, "_intra", name, e, "intra")
        partial = codec.sum(qr1, sr1, m * nloc)
        q2, s2 = codec.quant(partial.view(m, nloc))
        qr2, sr2 = _zeroone_hop(inter, q2, s2, "_inter", name, e // k,
                                "inter")
        total = codec.sum(qr2, sr2, nloc)
    se = torch.zeros(nloc, dtype=torch.float32, device=xf.device) \
        if server_error is None else server_error.float().reshape(-1)
    mean = (total / w + se).view(1, -1)
    qm, sm = codec.quant(mean)
    new_se = codec.residual(mean, qm, sm)[0]
    if not k:
        qg, sg = _zeroone_gather(group, qm[0], sm[0], "", name, e, "flat")
        out = codec.dequant(qg, sg, nloc).reshape(-1)
    else:
        qa, sa = _zeroone_gather(inter, qm[0], sm[0], "_inter", name,
                                 e // k, "inter")
        qb, sb = _zeroone_gather(intra, qa, sa, "_intra", name, e, "intra")
        deq = codec.dequant(qb.view(k * m, -1), sb.view(k * m, -1), nloc)
        # qb is [intra][outer]; chunk c = outer * k + intra
        out = deq.view(k, m, nloc).transpose(0, 1).reshape(-1)
    return out, new_we, new_se


def quantized_all_reduce_virtual(xs, *, bits=1, block_size=None,
                                 intra_size=0, worker_errors=None,
                                 server_errors=None, wire=None):
    """What ``quantized_all_reduce`` gives each of w = len(xs) virtual
    ranks: ([mean], [new worker_error], [new server_error]); the hops'
    exchanges are index permutations. ``wire`` (a dict) receives each
    rank's codes and scales of the first quantize (``codes``,
    ``scales``) and of the requantized mean (``mean_codes``,
    ``mean_scales``), ``bytes``, what one rank sends, and (hierarchical)
    ``stateless``: each rank's chunk of the inter hop's uncompensated
    quantization error, as it reaches the mean."""
    codec = _Codec(bits, block_size)
    w, n = len(xs), xs[0].numel()
    if n % w:
        raise ValueError(f"quantized_all_reduce needs size % {w} == 0, "
                         f"got {n}")
    nloc = n // w
    dev = xs[0].device
    wes = worker_errors or [torch.zeros(n, device=dev)] * w
    ses = server_errors or [torch.zeros(nloc, device=dev)] * w
    rows = [(x.float().reshape(-1) + we.reshape(-1)).view(w, nloc)
            for x, we in zip(xs, wes)]
    k = hierarchical_size(w, intra_size)
    if not k:
        coded = [codec.quant(r) for r in rows]
        new_we = [codec.residual(r, q, s).reshape(-1)
                  for r, (q, s) in zip(rows, coded)]
        total = [codec.sum(torch.stack([q[r] for q, _ in coded]),
                           torch.stack([s[r] for _, s in coded]), nloc)
                 for r in range(w)]
    else:
        m = w // k
        x1 = [r.view(m, k, nloc).transpose(0, 1).reshape(k, -1)
              for r in rows]
        coded = [codec.quant(x) for x in x1]
        new_we = [codec.residual(x, q, s).view(k, m, nloc).transpose(0, 1)
                  .reshape(-1) for x, (q, s) in zip(x1, coded)]
        partial = [None] * w
        for o in range(m):                 # intra group o*k .. o*k+k-1
            members = [o * k + i for i in range(k)]
            for i in range(k):
                partial[o * k + i] = codec.sum(
                    torch.stack([coded[j][0][i] for j in members]),
                    torch.stack([coded[j][1][i] for j in members]), m * nloc)
        coded2 = [codec.quant(p.view(m, nloc)) for p in partial]
        if wire is not None:
            # the inter hop's requantize carries no residual: its error
            # reaches rank r's mean uncompensated
            err2 = [codec.residual(p.view(m, nloc), q, s)
                    for p, (q, s) in zip(partial, coded2)]
            wire["stateless"] = [
                sum(err2[o2 * k + r % k][r // k] for o2 in range(m)) / w
                for r in range(w)]
        total = [None] * w
        for i in range(k):                 # inter group i, k + i, ...
            members = [o * k + i for o in range(m)]
            for o in range(m):
                total[o * k + i] = codec.sum(
                    torch.stack([coded2[j][0][o] for j in members]),
                    torch.stack([coded2[j][1][o] for j in members]), nloc)
    means = [(t / w + se.reshape(-1)).view(1, -1)
             for t, se in zip(total, ses)]
    mcoded = [codec.quant(mn) for mn in means]
    new_se = [codec.residual(mn, q, s)[0] for mn, (q, s) in zip(means, mcoded)]
    out = torch.cat([codec.dequant(q, s, nloc)[0] for q, s in mcoded])
    if wire is not None:
        wire.update(codes=[q for q, _ in coded], scales=[s for _, s in coded],
                    mean_codes=[q for q, _ in mcoded],
                    mean_scales=[s for _, s in mcoded],
                    bytes=zeroone_wire_bytes(n, w, codec, k))
    return [out] * w, new_we, new_se


def zeroone_wire_bytes(n, w, codec, k=0):
    """The bytes one rank sends through ``quantized_all_reduce`` of n
    elements over w ranks, as the comm report prices them
    (comm_accounting.zeroone_grad_exchange_collectives)."""
    return sum(c.bytes_per_step
               for c in ca.zeroone_grad_exchange_collectives(
                   [ca.LeafSpec("x", (n,), None)], w, bits=codec.bits,
                   block_size=codec.bs, intra_size=k))
