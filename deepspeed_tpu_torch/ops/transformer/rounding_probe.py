"""Where the bf16 and fp16 backward kernels' gate readings come from, at the
GPT-2 slice.

    python3 -m deepspeed_tpu_torch.ops.transformer.rounding_probe [float16]

(one GPU; bfloat16 when no dtype is named). At bf16 (fp16) the flash
backward rounds dS to the storage dtype before dK = dS^T . Q and dQ = dS . K,
as the Pallas kernels do. Two right implementations of that function then
differ wherever their fp32 dS values fall on two sides of a rounding
boundary, and one such flip moves a dK (dQ) element by one ulp of dS
times q (k). This probe runs chip_smoke.py's slice case of
the dK/dV and dQ kernels (same shape, seed and dtype) and reads
chip_smoke.py's element-wise gate, max |a - b| / (|b| + rms(b)), for each
kernel and its plain version against two float64 references computed from
the same inputs: one that rounds dS to the dtype (the function both
compute) and
one that keeps dS exact. It prints each reading with the position of its
maximum.
"""
import sys

import torch

from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

SHAPE = (8, 16, 1024, 64)   # chip_smoke.py's flash slice shape
# chip_smoke.py's seed for that case at each dtype
SEEDS = {"bfloat16": 1, "float16": 11}


def gate(a, ref):
    """(reading, (bh, row, d) of its maximum) of chip_smoke.py's gate."""
    a, ref = a.float(), ref.float()
    rms = ref.square().mean().sqrt()
    err = (a - ref).abs() / (ref.abs() + rms)
    idx = int(err.argmax())
    _, s, d = ref.shape
    return float(err.max()), (idx // (s * d), idx // d % s, idx % d)


def float64_grads(q, k, v, do, lse, delta, scale, round_ds, chunk=16):
    """(dK, dQ) of the causal flash backward in float64, with dS rounded to
    q's dtype before both products when ``round_ds``."""
    bh, s, _ = q.shape
    keep = torch.tril(torch.ones(s, s, dtype=torch.bool, device=q.device))
    dk = torch.empty(k.shape, dtype=torch.float64, device=q.device)
    dq = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    for i in range(0, bh, chunk):
        sl = slice(i, i + chunk)
        qd, kd = q[sl].double(), k[sl].double()
        scores = torch.einsum("bqd,bkd->bqk", qd, kd) * scale
        scores = torch.where(keep, scores, torch.full_like(scores, fa.NEG_INF))
        p = torch.exp(scores - lse[sl, :, None].double())
        dp = torch.einsum("bqd,bkd->bqk", do[sl].double(), v[sl].double())
        ds = p * (dp - delta[sl, :, None].double()) * scale
        if round_ds:
            ds = ds.to(q.dtype).double()
        dk[sl] = torch.einsum("bqk,bqd->bkd", ds, qd)
        dq[sl] = torch.einsum("bqk,bkd->bqd", ds, kd)
    return dk, dq


def main(dtype_name="bfloat16"):
    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = getattr(torch, dtype_name)
    b, h, s, d = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(SEEDS[dtype_name])
    q, k, v, do = (torch.randn(b * h, s, d, generator=gen, device="cuda")
                   .to(dtype) for _ in range(4))
    kw = dict(scale=d ** -0.5, causal=True, bias_kind="none", num_heads=h,
              dropout_rate=0.0)
    out, lse = fa.flash_fwd(q, k, v, None, None, **kw)
    delta = (do.float() * out.float()).sum(-1)
    got = {"dK": fa.flash_bwd_dkdv(q, k, v, do, lse, delta, None, None,
                                   **kw)[0],
           "dQ": fa.flash_bwd_dq(q, k, v, do, lse, delta, None, None, **kw)}
    plain = {"dK": fa.flash_bwd_dkdv_plain(q, k, v, do, lse, delta, None,
                                           None, **kw)[0],
             "dQ": fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, None, None,
                                         **kw)}
    rounded = dict(zip(("dK", "dQ"), float64_grads(
        q, k, v, do, lse, delta, kw["scale"], True)))
    exact = dict(zip(("dK", "dQ"), float64_grads(
        q, k, v, do, lse, delta, kw["scale"], False)))
    torch.cuda.synchronize()
    axis = {"dK": "k", "dQ": "q"}
    for grad in ("dK", "dQ"):
        for label, a, ref in (
                ("kernel vs plain", got[grad], plain[grad]),
                ("kernel vs float64, dS rounded", got[grad], rounded[grad]),
                ("plain vs float64, dS rounded", plain[grad], rounded[grad]),
                ("float64 dS rounded vs float64 dS exact", rounded[grad],
                 exact[grad])):
            reading, at = gate(a, ref)
            print(f"{dtype_name} {grad} {label}: {reading:.4e} at (bh, "
                  f"{axis[grad]}, d) {at} on {torch.cuda.get_device_name(0)}")


if __name__ == "__main__":
    main(*sys.argv[1:2])
