"""Whether the tensor-core dK/dV sweep's key-tile order pays, at the BERT slice.

    python3 -m deepspeed_tpu_torch.ops.sparse_attention.order_probe  # one GPU

The sweep runs one block per (batch*head, 64-row key tile) and takes each
head's key blocks by descending nnz_t (``Luts.order_t``), so that the tiles
that walk the most query blocks start first. At the slice's Fixed layout 16
of the 64 key blocks per head are walked by all 64 query blocks, the other
48 by 4. This probe prints, for longest-first and for block order, the
makespan of the launch in tile pairs by list scheduling (each block starts
on the first free slot of the 2 per SM that head_dim 64 allows, in launch
order, at one tile pair per unit of time) beside the pairs per slot of an
even spread, and the sweep's measured time with each order (CUDA events,
the two orders in turns).
"""
import heapq

import torch

from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig
from deepspeed_tpu_torch.ops.sparse_attention import \
    block_sparse_kernel as bsk

SHAPE = (4, 12, 4096, 64)   # chip_smoke.py's block-sparse slice shape
LAYOUT = dict(block=64, num_local_blocks=4, num_global_blocks=1)


def makespan(nnz_t, order, bh, slots):
    """Tile pairs until the sweep's last block ends, its blocks started in
    launch order (bh fastest, as blockIdx.x, then the rank in ``order``)
    on ``slots`` resident blocks, each on the first free one, at one tile
    pair per unit of time. nnz_t and order: (H, nb) arrays."""
    heads, nb = order.shape
    free = [0] * slots
    for r in range(nb):
        for b in range(bh):
            n = int(nnz_t[b % heads, order[b % heads, r]])
            heapq.heappush(free, heapq.heappop(free) + n)
    return max(free)


def sweep_ms(fn, iters=50):
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main():
    b, h, s, d = SHAPE
    block = LAYOUT["block"]
    nb = s // block
    layout = FixedSparsityConfig(num_heads=h, **LAYOUT).make_layout(s)
    luts = bsk.luts_for(layout, "cuda")
    by_block = luts._replace(order_t=torch.arange(
        nb, dtype=torch.int32, device="cuda").expand(h, nb).contiguous())
    orders = {"longest first": luts, "block order": by_block}
    nnz_t = luts.nnz_t.cpu().numpy()
    slots = 2 * torch.cuda.get_device_properties(0).multi_processor_count
    even = int(nnz_t.sum()) * b / slots
    gen = torch.Generator(device="cuda").manual_seed(11)
    q, k, v, do = (torch.randn(b * h, s, d, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    bias = torch.zeros(b, s, device="cuda")
    kw = dict(scale=d ** -0.5, block=block, num_heads=h)
    out, lse = bsk.sparse_fwd(q, k, v, luts, bias, **kw)
    delta = (do.float() * out.float()).sum(-1)
    ms = {label: [] for label in orders}
    for label in (*orders, *reversed(orders)):
        ms[label].append(sweep_ms(lambda: bsk.sparse_bwd_dkdv(
            q, k, v, do, lse, delta, orders[label], bias, **kw)))
    for label, tables in orders.items():
        span = makespan(nnz_t, tables.order_t.cpu().numpy(), b * h, slots)
        print(f"{label}: makespan {span} tile pairs on {slots} resident "
              f"blocks ({even:.1f} if even), measured "
              f"{' / '.join(f'{t:.4f}' for t in ms[label])} ms on "
              f"{torch.cuda.get_device_name(0)}")


if __name__ == "__main__":
    main()
