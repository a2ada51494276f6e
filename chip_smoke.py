#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (deepspeed_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, run in this order, each of which raises (exit code != 0) on any
failure:
  1. env      card name and power limit (nvidia-smi), torch and CUDA versions
  2. build    nvcc build of every CUDA source of the port, all sources at
              once, each timed, with the ptxas report (registers, spills)
              of the tensor-core kernels; cuobjdump -sass of both libraries
              counts the tensor-core instructions (HGMMA / HMMA) of every
              kernel instantiation and fails unless each instantiation of
              the tensor-core kernels (flash fwd, dK/dV and dQ, block-sparse
              fwd, dQ and dK/dV; one per head_dim) has HGMMA and no scalar
              kernel has any
  3. kernels  each flash-attention kernel against its plain PyTorch version
              on the card: the GPT-2 training shape (8, 16, 1024, 64) bf16
              causal, plus bf16 and fp32 shapes at head_dim 64, 96 and 128
              with 'key' bias (padded keys), 'full' bias, ragged sequence
              lengths and dropout; per-kernel times beside the plain
              version's, the bound and, as a yardstick only, PyTorch's
              scaled_dot_product_attention (never called by the port), and
              the bf16 dQ sweep's scalar kernel (the route its tensor-core
              kernel replaced) timed beside it; two planted faults
              (diagonal tile skipped, one output tile left at zero) must
              fail the same gate
  4. train    initialize() -> 10 x train_batch of gpt2-350m (24 layers, full
              width) at seq 1024, bf16 over fp32 master, Adam, WarmupLR,
              clipping 1.0, gas 2: losses finite and falling, every flash
              kernel launched exactly 24 x 2 x 10 times
  5. profile  two more train_batch steps under torch.profiler: device time
              by kernel, the flash kernels' and the GEMMs' shares, and the
              device's idle share (after the launch counts are read)
  6. parity   2 layers at full width: loss and every parameter gradient with
              the kernels against the same model with the plain version
              (flash_attention_reference) as its attention, bf16 tolerance;
              a planted fault (diagonal tiles masked) must fail it
  7. sparse kernels
              each block-sparse kernel against its plain version: the
              long-sequence BERT shape (4, 12, 4096, 64) bf16 over the
              FixedSparsityConfig(12, block 64, local 4, global 1) layout
              with a key bias, plus fp32 cases (per-head BigBird at block
              16, an empty layout row, a padded key tail, head_dim 64 to
              128, blocks 32 and 128) and bf16 cases on the tensor-core
              kernels (head_dim 96 and 128, block 128, a padded key tail,
              an empty row, a fully padded row); times beside the plain
              versions, the bound and, as a yardstick only,
              scaled_dot_product_attention with the layout's token mask,
              and each bf16 kernel's scalar kernel (the route its
              tensor-core kernel replaced) beside it; the dQ and dK/dV
              sweeps timed again at head_dim 96 and 128 (off the slice,
              logged only); two planted faults (the last
              active block of every row dropped, one block-row of every
              output left at zero) must fail the gate
  8. train (BERT)
              initialize() -> 10 x train_batch of bert-base (12 layers,
              full width) at seq 4096 over that layout, micro 4, gas 2:
              losses finite and falling, every block-sparse kernel launched
              exactly 12 x 2 x 10 times and no flash kernel
  9. profile (BERT)
              two more steps under torch.profiler
 10. parity (BERT)
              2 layers at full width, seq 4096: loss and every gradient
              against block_sparse_attention_reference as the attention; a
              planted fault (one active block per row dropped) must fail it
The line before the last is the kernels JSON; the last line is
{"ok": true, "device": {...}}. Needs one CUDA card and nvcc.
"""
import concurrent.futures
import json
import os
import random
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FLASH_SOURCE = "deepspeed_tpu_torch/ops/transformer/csrc/flash_attention.cu"
FLASH_KERNELS = (
    ("flash_fwd", "deepspeed_tpu/ops/transformer/flash_attention.py:145"),
    ("flash_bwd_dkdv", "deepspeed_tpu/ops/transformer/flash_attention.py:277"),
    ("flash_bwd_dq", "deepspeed_tpu/ops/transformer/flash_attention.py:343"),
)
SPARSE_SOURCE = ("deepspeed_tpu_torch/ops/sparse_attention/csrc/"
                 "block_sparse_attention.cu")
_BSK = "deepspeed_tpu/ops/sparse_attention/block_sparse_kernel.py"
SPARSE_KERNELS = (
    ("sparse_fwd", f"{_BSK}:68"),
    ("sparse_bwd_dq", f"{_BSK}:179"),
    ("sparse_bwd_dkdv", f"{_BSK}:224"),
)
# the long-sequence BERT slice: bert-base over FixedSparsityConfig(12,
# block 64, local 4, global 1) at seq 4096 (the JAX package's bench.py
# --model bert-base --sparse 1 --seq 4096)
BERT_MODEL = "bert-base"
BERT_SEQ = 4096
BERT_MICRO = 4
BERT_GAS = 2
BERT_STEPS = 10
BERT_SPARSITY = dict(block=64, num_local_blocks=4, num_global_blocks=1)
# error allowed against the plain version, element by element relative to
# the reference's own scale: |a - b| <= TOL * (|b| + rms(b)) (see scaled_err);
# in the parity phase, ||a - b|| <= TOL * ||b|| per gradient tensor
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# tile of the planted faults: the q tile of the bf16 forward and dQ sweep
# and the k tile of the bf16 dK/dV sweep
FAULT_TILE = 128
# the tensor-core kernels, by library: every instantiation (one per
# head_dim) must hold HGMMA, and every other kernel none
TC_FAMILIES = {
    "flash_attention": ("flash_fwd_tc_kernel", "flash_bwd_dkdv_tc_kernel",
                        "flash_bwd_dq_tc_kernel"),
    "block_sparse_attention": ("bsa_fwd_tc_kernel", "bsa_bwd_dq_tc_kernel",
                               "bsa_bwd_dkdv_tc_kernel"),
}
# the tensor-core kernel each kernel takes on its slice's main path (bf16)
FAMILY_OF = {"flash_fwd": "flash_fwd_tc_kernel",
             "flash_bwd_dkdv": "flash_bwd_dkdv_tc_kernel",
             "flash_bwd_dq": "flash_bwd_dq_tc_kernel",
             "sparse_fwd": "bsa_fwd_tc_kernel",
             "sparse_bwd_dq": "bsa_bwd_dq_tc_kernel",
             "sparse_bwd_dkdv": "bsa_bwd_dkdv_tc_kernel"}
# the slice's model and step
SLICE_MODEL = "gpt2-350m"
SLICE_SEQ = 1024
SLICE_MICRO = 8
SLICE_GAS = 2
SLICE_STEPS = 10


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# card peaks (data sheets, dense) for the bound: bytes / memory rate vs
# operations / peak rate of their type, whichever is larger
# ---------------------------------------------------------------------------
_PEAKS = {
    # name fragment: (bf16 tensor FLOP/s, fp32 FLOP/s, bytes/s)
    "H100 PCIe": (756e12, 51e12, 2.0e12),
    "H100 NVL": (835e12, 60e12, 3.9e12),
    "H100": (989e12, 67e12, 3.35e12),          # SXM
    "H200": (989e12, 67e12, 4.8e12),
}


def card_peaks(name):
    for frag, peaks in _PEAKS.items():
        if frag in name:
            return frag, peaks
    raise RuntimeError(f"no peak table for card {name!r}")


def flash_work(kernel, bh, s_q, s_k, d, elem, causal, bias_bytes,
               pairs=None):
    """(operations, bytes) an attention kernel (flash_* or sparse_*) must
    do and move at this shape: matmul FLOPs over the score pairs the mask
    keeps (``pairs`` per batch*head: the active blocks' pairs for a sparse
    layout); each input read once and each output written once."""
    if pairs is None:
        pairs = s_q * (s_q + 1) // 2 if causal else s_q * s_k
    mat = bh * s_q * d * elem          # one (bh, s, d) tensor
    stats = bh * s_q * 4               # one (bh, s_q) fp32 row statistic
    kind = kernel.split("_", 1)[1]
    if kind == "fwd":
        return 4 * d * pairs * bh, 4 * mat + stats + bias_bytes
    if kind == "bwd_dkdv":
        return 8 * d * pairs * bh, 6 * mat + 2 * stats + bias_bytes
    return 6 * d * pairs * bh, 5 * mat + 2 * stats + bias_bytes


def bound(kernel, name, shape, dtype, causal, bias_bytes=0, pairs=None):
    """(ms, "operations" or "bytes"): the least time of the kernel's work at
    this shape."""
    import torch

    _, (bf16_peak, fp32_peak, bw) = card_peaks(name)
    b, h, s, d = shape
    elem = torch.empty((), dtype=dtype).element_size()
    ops, nbytes = flash_work(kernel, b * h, s, s, d, elem, causal,
                             bias_bytes, pairs)
    peak = bf16_peak if dtype == torch.bfloat16 else fp32_peak
    t_ops, t_bytes = ops / peak * 1e3, nbytes / bw * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def cuda_ms(fn, iters=10, warmup=2):
    """Mean device time of fn() over iters launches, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn):
    """cuda_ms over a window of 50 launches for a kernel under 0.5 ms (so
    that launch gaps and event resolution stay small beside the window),
    10 otherwise."""
    probe = cuda_ms(fn, iters=3)
    return cuda_ms(fn, iters=50 if probe < 0.5 else 10)


def device_ms(fn, iters=20, warmup=3):
    """Device time per call of fn(): its kernels' times summed under
    torch.profiler over iters calls. Unlike an event window it leaves out
    the gaps between launches, which set the time of a call that launches
    several kernels from Python (autograd's backward of
    scaled_dot_product_attention read 0.74 ms in a 50-call event window
    where its kernels take about 0.2)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return us / iters / 1e3


def scaled_err(a, b):
    """max over elements of |a - b| / (|b| + rms(b)), in fp32. Rounding
    both sides to bf16 moves an element by at most one ulp, 2**-7 of its
    size, so kernel and plain version read below 0.008 in bf16; an element
    off by its whole size reads about 0.5 or more."""
    a, b = a.float(), b.float()
    rms = float(b.square().mean().sqrt())
    return float(((a - b).abs() / (b.abs() + rms)).max())


def rel_l2(a, b):
    """||a - b|| / ||b|| (||a - b|| where b is all zero), in fp32."""
    a, b = a.float(), b.float()
    diff, ref = float((a - b).norm()), float(b.norm())
    return diff / ref if ref > 0 else diff


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_env():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {name}")
    frag, peaks = card_peaks(name)
    log(f"bound table: {frag} bf16 {peaks[0] / 1e12:g} TFLOP/s, fp32 "
        f"{peaks[1] / 1e12:g} TFLOP/s, {peaks[2] / 1e12:g} TB/s")
    # fp32 references run in full fp32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"smi": smi, "name": name}


def phase_build():
    """One nvcc per source, all started together; each timed."""
    from deepspeed_tpu_torch.ops import op_builder

    def timed(name):
        t0 = time.perf_counter()
        path, report = op_builder.build(name, verbose=True)
        return path, report, time.perf_counter() - t0

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(op_builder.SOURCES)) as ex:
        futures = {name: ex.submit(timed, name)
                   for name in op_builder.SOURCES}
        results = {name: f.result() for name, f in futures.items()}
    by_kernel = {}
    for name, (path, report, secs) in results.items():
        log(f"build {os.path.relpath(op_builder.SOURCES[name], HERE)}: "
            f"{path}")
        with open(os.path.join(op_builder.BUILD_DIR, f"ptxas_{name}.txt"),
                  "w") as f:
            f.write(report)
        _ptxas_summary(report, TC_FAMILIES[name])
        log(f"build seconds ({name}): {secs:.2f}")
        by_kernel.update(_tensor_core_proof(path, TC_FAMILIES[name]))
    log(f"build seconds (all sources, in parallel): "
        f"{time.perf_counter() - t0:.2f}")
    return by_kernel


def _ptxas_summary(report, families):
    """Registers and spills of each tensor-core kernel instantiation from
    the ptxas report (the whole report goes beside the libraries, in
    build/deepspeed_tpu_torch/ptxas_<source>.txt); their shared
    memory is dynamic, set at launch from the source's *_tc_smem()."""
    current = None
    for ln in report.splitlines():
        if "Compiling entry" in ln:
            current = next((f for f in families if f in ln), None)
            dim = re.search(r"ILi(\d+)E", ln)
            if current:
                current += f"<{dim.group(1) if dim else '?'}>"
        elif current and ("registers" in ln or "spill" in ln):
            log(f"  ptxas {current}: {ln.split('info    :')[-1].strip()}")
        if "wgmma" in ln:          # e.g. products serialized by ptxas
            log(f"  ptxas: {ln.strip()[:300]}")


def _tensor_core_proof(library, families):
    """{family: {instantiation: HGMMA + HMMA count}} from cuobjdump -sass of
    one library; raises unless every instantiation of each tensor-core
    family (one per head_dim) holds HGMMA and every other kernel of the
    library (the scalar ones) holds no tensor-core instruction."""
    from deepspeed_tpu_torch.ops import op_builder

    tool = os.path.join(os.path.dirname(op_builder.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", library], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, current = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            current = ln.split("Function :")[1].strip()
            counts[current] = [0, 0]
        elif current is not None:
            counts[current][0] += "HGMMA" in ln
            counts[current][1] += "HMMA" in ln and "HGMMA" not in ln
    for name, (hgmma, hmma) in sorted(counts.items()):
        log(f"  sass {name[:110]}: HGMMA {hgmma} HMMA {hmma}")
    by_kernel = {}
    for family in families:
        found = {n: c for n, c in counts.items() if family in n}
        if len(found) != 3 or not all(c[0] for c in found.values()):
            raise RuntimeError(f"{family}: expected 3 instantiations with "
                               f"HGMMA instructions, got {found}")
        by_kernel[family] = {n: c[0] + c[1] for n, c in found.items()}
    scalar = {n: c for n, c in counts.items()
              if not any(f in n for f in families) and sum(c)}
    if scalar:
        raise RuntimeError(f"scalar kernels with tensor-core instructions: "
                           f"{scalar}")
    return by_kernel


def _flash_case(shape, dtype, causal, bias_kind, dropout, seed, main):
    """Every flash kernel against its plain version on one shape; returns
    {kernel: {"err": .., "max_abs_err": ..}}, plus "ms", "plain_ms" and
    "fault_err" when ``main``, which marks the main path's shape: its
    kernels are timed, and the gate is shown to fail two planted faults
    there."""
    import torch

    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

    b, h, s, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*sz):
        return torch.randn(*sz, generator=gen, device="cuda")

    q, k, v, do = (randn(b * h, s, d).to(dtype) for _ in range(4))
    bias = None
    if bias_kind == "key":
        bias = (randn(b, s) * 2.0).contiguous()
        bias[:, -7:] = fa.NEG_INF          # padded keys
    elif bias_kind == "full":
        bias = randn(b * h, s, s).contiguous()
    kw = dict(scale=d ** -0.5, causal=causal, bias_kind=bias_kind,
              num_heads=h, dropout_rate=dropout)
    dseed = 1234567 if dropout > 0 else None
    out, lse = fa.flash_fwd(q, k, v, bias, dseed, **kw)
    out_p, lse_p = fa.flash_fwd_plain(q, k, v, bias, dseed, **kw)
    delta = (do.float() * out.float()).sum(-1)
    dk, dv = fa.flash_bwd_dkdv(q, k, v, do, lse, delta, bias, dseed, **kw)
    dk_p, dv_p = fa.flash_bwd_dkdv_plain(q, k, v, do, lse, delta, bias,
                                         dseed, **kw)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, bias, dseed, **kw)
    dq_p = fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, bias, dseed, **kw)
    torch.cuda.synchronize()
    for t in (out, lse, dk, dv, dq):
        if not torch.isfinite(t).all():
            raise RuntimeError(f"non-finite kernel output at {shape}")
    plain = {"flash_fwd": (out_p, lse_p), "flash_bwd_dkdv": (dk_p, dv_p),
             "flash_bwd_dq": (dq_p,)}
    got = {"flash_fwd": (out, lse), "flash_bwd_dkdv": (dk, dv),
           "flash_bwd_dq": (dq,)}
    tol = TOL[str(dtype).split(".")[-1]]
    summary = {}
    for name, refs in plain.items():
        err = max(scaled_err(a, p) for a, p in zip(got[name], refs))
        abs_err = max(float((a.float() - p.float()).abs().max())
                      for a, p in zip(got[name], refs))
        summary[name] = {"err": err, "max_abs_err": abs_err}
        log(f"  {name:15s} {tuple(shape)} {str(dtype)[6:]:8s} "
            f"causal={causal} bias={bias_kind} dropout={dropout}: "
            f"scaled err {err:.3e} max abs err {abs_err:.3e} (tol {tol:g})")
    for name, r in summary.items():
        if not r["err"] <= tol:
            raise RuntimeError(f"{name} disagrees with its plain version at "
                               f"{shape} {dtype}: {r['err']:.3e} > {tol:g}")
    if main:
        _planted_faults(q, k, v, do, lse, delta, dseed, kw, plain, tol,
                        summary)
    if main:
        calls = {
            "flash_fwd": (lambda: fa.flash_fwd(q, k, v, bias, dseed, **kw),
                          lambda: fa.flash_fwd_plain(q, k, v, bias, dseed,
                                                     **kw)),
            "flash_bwd_dkdv": (
                lambda: fa.flash_bwd_dkdv(q, k, v, do, lse, delta, bias,
                                          dseed, **kw),
                lambda: fa.flash_bwd_dkdv_plain(q, k, v, do, lse, delta,
                                                bias, dseed, **kw)),
            "flash_bwd_dq": (
                lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, bias, dseed,
                                        **kw),
                lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, bias,
                                              dseed, **kw)),
        }
        # the scalar dQ sweep at bf16: the route the tensor-core one replaced
        scalar = {"flash_bwd_dq": lambda: fa.flash_bwd_dq(
            q, k, v, do, lse, delta, bias, dseed, scalar=True, **kw)}
        _time_in_turns(calls, scalar, summary)
    return summary


def _time_in_turns(calls, scalar, summary):
    """Kernel and plain version in turns (kernel, plain, plain, kernel),
    with the scalar kernel a tensor-core kernel replaced, where there is
    one, timed between them (kernel, scalar, plain, plain, scalar, kernel);
    the means go into summary[kernel]["ms" / "plain_ms" / "scalar_ms"]."""
    for name, (kern, plain) in calls.items():
        k1 = kernel_ms(kern)
        s1 = kernel_ms(scalar[name]) if name in scalar else None
        p1 = cuda_ms(plain, iters=3, warmup=1)
        p2 = cuda_ms(plain, iters=3, warmup=1)
        s2 = kernel_ms(scalar[name]) if name in scalar else None
        k2 = kernel_ms(kern)
        summary[name]["ms"] = (k1 + k2) / 2
        summary[name]["plain_ms"] = (p1 + p2) / 2
        note = ""
        if name in scalar:
            summary[name]["scalar_ms"] = (s1 + s2) / 2
            note = f", scalar kernel {s1:.3f}/{s2:.3f} ms"
        log(f"  {name:15s} kernel {k1:.3f}/{k2:.3f} ms, plain "
            f"{p1:.3f}/{p2:.3f} ms{note}")


def _planted_faults(q, k, v, do, lse, delta, dseed, kw, plain, tol,
                    summary):
    """The gate must fail kernels that are wrong. Two faults are planted in
    outputs of the right shape and read with the same metric: "diagonal"
    skips the tiles on the diagonal (the plain version run with a bias that
    masks every FAULT_TILE x FAULT_TILE diagonal tile but the first, whose
    rows see no other key); "zero tile" leaves
    one FAULT_TILE-row tile of every output at zero. Each reading goes into
    summary[kernel]["fault_err"] as {fault: reading}."""
    import torch

    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

    if kw["bias_kind"] != "none":
        raise ValueError("faults are planted on an unbiased case")
    bh, s, _ = q.shape
    tile = torch.arange(s, device=q.device) // FAULT_TILE
    diag = torch.zeros(s, s, device=q.device).masked_fill(
        (tile[:, None] == tile[None, :]) & (tile[:, None] > 0), fa.NEG_INF)
    fbias = diag.expand(bh, s, s).contiguous()
    fkw = dict(kw, bias_kind="full")
    skipped = {
        "flash_fwd": fa.flash_fwd_plain(q, k, v, fbias, dseed, **fkw),
        "flash_bwd_dkdv": fa.flash_bwd_dkdv_plain(q, k, v, do, lse, delta,
                                                  fbias, dseed, **fkw),
        "flash_bwd_dq": (fa.flash_bwd_dq_plain(q, k, v, do, lse, delta,
                                               fbias, dseed, **fkw),),
    }
    del fbias
    rows = slice(s // 2, s // 2 + FAULT_TILE)
    for name, refs in plain.items():
        zeroed = [p.clone() for p in refs]
        for t in zeroed:
            t[:, rows] = 0
        readings = {
            "diagonal": max(scaled_err(f, p)
                            for f, p in zip(skipped[name], refs)),
            "zero tile": max(scaled_err(z, p) for z, p in zip(zeroed, refs)),
        }
        summary[name]["fault_err"] = readings
        log(f"  {name:15s} planted faults: " + ", ".join(
            f"{f} {e:.3e}" for f, e in readings.items())
            + f" (gate {tol:g}, kernel {summary[name]['err']:.3e})")
        if not min(readings.values()) > tol:
            raise RuntimeError(f"{name}: a planted fault passes the gate "
                               f"{tol:g}: {readings}")


def _dropout_masks_exact(dtype, seed=4242, rate=0.25, bh=3, s=128):
    """Each kernel's dropout keep mask, read out through one-hot inputs,
    equals its plain version's bit for bit. With q = 0 every score is 0 and
    (lse, delta = 0) every p is 1, so: forward with v = I gives out[q, k] =
    keep * inv / s; dK/dV with dO = I gives dv[k, q] = keep * inv; dQ with
    k = v = I and dO = 1 gives dq[q, k] = keep * inv. s = head_dim = 128
    spans two 64-row tiles on both axes of the fp32 kernels and two q tiles
    of the bf16 dK/dV sweep (the tensor-core kernels at bf16)."""
    import torch

    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

    eye = torch.eye(s, device="cuda").expand(bh, s, s).contiguous().to(dtype)
    zeros = torch.zeros(bh, s, s, device="cuda", dtype=dtype)
    ones = torch.ones(bh, s, s, device="cuda", dtype=dtype)
    stat = torch.zeros(bh, s, device="cuda")
    kw = dict(scale=1.0, causal=False, bias_kind="none", num_heads=bh,
              dropout_rate=rate)
    masks = {}
    for route, fwd, dkdv, dq in (
            ("kernel", fa.flash_fwd, fa.flash_bwd_dkdv, fa.flash_bwd_dq),
            ("plain", fa.flash_fwd_plain, fa.flash_bwd_dkdv_plain,
             fa.flash_bwd_dq_plain)):
        out, _ = fwd(zeros, zeros, eye, None, seed, **kw)
        _, dv = dkdv(zeros, zeros, zeros, eye, stat, stat, None, seed, **kw)
        g = dq(zeros, eye, eye, ones, stat, stat, None, seed, **kw)
        masks[route] = {"flash_fwd": out != 0,
                        "flash_bwd_dkdv": dv.transpose(1, 2) != 0,
                        "flash_bwd_dq": g != 0}
    for name, kernel_mask in masks["kernel"].items():
        differ = int((kernel_mask != masks["plain"][name]).sum())
        kept = float(kernel_mask.float().mean())
        log(f"  {name:15s} dropout keep mask ({bh}, {s}, {s}) "
            f"{str(dtype)[6:]} rate {rate}: "
            f"{differ} positions differ from the plain version, kept "
            f"{kept:.4f}")
        if differ or not 0.70 < kept < 0.80:
            raise RuntimeError(f"{name}: in-kernel dropout mask is not the "
                               f"plain version's")


def _library_ms(shape, dtype):
    """scaled_dot_product_attention at the shape, as a yardstick only:
    (forward ms, backward ms for dq, dk and dv together: device time, see
    device_ms)."""
    import torch
    import torch.nn.functional as F

    b, h, s, d = shape
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, do = (torch.randn(b, h, s, d, generator=gen, device="cuda")
                   .to(dtype) for _ in range(4))
    fwd = kernel_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                           is_causal=True))
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    bwd = device_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), do,
                                                retain_graph=True))
    return fwd, bwd


def phase_kernels(env, tensor_cores):
    import torch

    log("kernels against their plain versions on the card:")
    main_shape = (8, 16, SLICE_SEQ, 64)
    main = _flash_case(main_shape, torch.bfloat16, True, "none", 0.0, 1,
                       main=True)
    _flash_case((2, 4, 640, 96), torch.float32, False, "key", 0.0, 2, False)
    _flash_case((1, 2, 200, 128), torch.float32, True, "full", 0.0, 3, False)
    _flash_case((2, 4, 256, 64), torch.float32, True, "none", 0.1, 4, False)
    _flash_case((2, 4, 256, 64), torch.bfloat16, False, "key", 0.1, 5,
                False)
    _flash_case((1, 3, 77, 64), torch.bfloat16, True, "none", 0.0, 6, False)
    # bf16 at head_dim 96 (two panels, the second half zero-padded) and
    # 128: both bias kinds, padded keys, dropout, ragged lengths
    _flash_case((1, 2, 77, 96), torch.bfloat16, True, "full", 0.0, 7, False)
    _flash_case((2, 4, 200, 128), torch.bfloat16, False, "key", 0.1, 8,
                False)
    _flash_case((2, 2, 333, 96), torch.bfloat16, True, "key", 0.1, 9, False)
    _flash_case((1, 2, 256, 128), torch.bfloat16, False, "full", 0.1, 10,
                False)
    _dropout_masks_exact(torch.float32)
    _dropout_masks_exact(torch.bfloat16)
    lib_fwd, lib_bwd = _library_ms(main_shape, torch.bfloat16)
    log(f"  library yardstick (scaled_dot_product_attention) at "
        f"{main_shape} bf16 causal: fwd {lib_fwd:.3f} ms, bwd (dq, dk, dv "
        f"together) {lib_bwd:.3f} ms")
    rows = []
    for name, replaces in FLASH_KERNELS:
        bms, by = bound(name, env["name"], main_shape, torch.bfloat16, True)
        r = main[name]
        rows.append({
            "name": name, "route": "cuda", "source": FLASH_SOURCE,
            "replaces": replaces, "kernel_route": "tc",
            "launches": None,
            "max_abs_err": r["max_abs_err"], "scaled_err": r["err"],
            "planted_fault_err": r["fault_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bms, "bound_by": by,
            # one library call computes the forward; none computes the
            # dK/dV or the dQ sweep alone
            "library_ms": lib_fwd if name == "flash_fwd" else None,
            "library_bwd_all_ms": lib_bwd,
            # the scalar kernel the tensor-core one replaced, at bf16
            "scalar_ms": r.get("scalar_ms"),
            "shape": list(main_shape), "dtype": "bfloat16", "causal": True,
            "card": env["smi"],
            # tensor-core instructions in the SASS of each bf16
            # instantiation
            "tensor_core_sass": tensor_cores.get(FAMILY_OF.get(name), {}),
        })
        log(f"  {name:15s} {r['ms']:.3f} ms vs bound {bms:.4f} ms "
            f"({by}) on {env['smi']}")
    return rows


def _slice_batch(vocab, gas, micro, seq, seed):
    import torch

    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, vocab, (gas, micro, seq), generator=gen)
    return {"input_ids": ids, "labels": ids.clone()}


def _ds_config(micro, gas):
    """bf16 over fp32 master weights, Adam lr 1e-4, WarmupLR, clipping 1.0
    (the JAX package's bench.py settings)."""
    return {
        "train_batch_size": micro * gas,
        "train_micro_batch_size_per_gpu": micro,
        "gradient_accumulation_steps": gas,
        "optimizer": {"type": "Adam", "params": {"lr": 1e-4}},
        "scheduler": {"type": "WarmupLR",
                      "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 1e-4,
                                 "warmup_num_steps": 4}},
        "gradient_clipping": 1.0,
        "bf16": {"enabled": True},
        "steps_per_print": 10 ** 9,
    }


def phase_train(env):
    import torch

    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.gpt2 import GPT2Model, gpt2_config

    cfg = gpt2_config(SLICE_MODEL, n_positions=SLICE_SEQ,
                      dtype=torch.bfloat16, remat=False)
    model = GPT2Model(cfg)
    ds_config = _ds_config(SLICE_MICRO, SLICE_GAS)
    engine, _, _, _ = initialize(model=model, config_params=ds_config)
    batch = _slice_batch(cfg.vocab_size, SLICE_GAS, SLICE_MICRO, SLICE_SEQ,
                         seed=0)
    want = {name: cfg.n_layer * SLICE_GAS * SLICE_STEPS
            for name, _ in FLASH_KERNELS}
    want.update({name: 0 for name, _ in SPARSE_KERNELS})
    return _train_steps(env, engine, batch, SLICE_MODEL, SLICE_SEQ,
                        SLICE_MICRO, SLICE_GAS, SLICE_STEPS, want)


def _train_steps(env, engine, batch, model_name, seq, micro, gas, steps,
                 want):
    """``steps`` train_batch calls with every kernel count set to 0 just
    before and read just after; raises unless the losses are finite and
    falling and each kernel launched exactly ``want[kernel]`` times."""
    import torch

    from deepspeed_tpu_torch.ops.sparse_attention import \
        block_sparse_kernel as bsk
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

    n_params = sum(p.numel() for p in engine.module.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    bsk.reset_launch_counts()
    losses, step_ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = engine.train_batch(batch=batch)
        losses.append(float(loss))          # syncs the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = dict(fa.LAUNCHES, **bsk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"train {model_name} ({n_params / 1e6:.1f}M params) seq "
        f"{seq} micro {micro} gas {gas}: losses "
        f"{[round(x, 4) for x in losses]}")
    log(f"  grad_norm {float(engine._last_metrics['grad_norm']):.4f} "
        f"lr {engine.get_lr()[0]:.3e} launches {launches}")
    steady = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    tokens = micro * gas * seq
    log(f"  step ms (median of steps 2..{steps}) {steady:.1f} on "
        f"{env['smi']}; first step {step_ms[0]:.1f} ms; tokens/s "
        f"{tokens / steady * 1e3:.0f} on {env['smi']}; max_memory_allocated "
        f"{peak / 2 ** 30:.2f} GiB on {env['smi']}")
    if not all(x == x and abs(x) != float("inf") for x in losses):
        raise RuntimeError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"loss did not fall: {losses}")
    if launches != want:
        raise RuntimeError(f"{model_name}: kernels launched {launches}, "
                           f"expected {want}")
    return {"launches": launches, "step_ms": steady, "losses": losses,
            "tokens_per_s": tokens / steady * 1e3, "peak_bytes": peak,
            "engine": engine, "batch": batch}


def _kernel_group(name):
    low = name.lower()
    if "flash_" in low:
        return "flash attention (this port's kernels)"
    if "bsa_" in low:
        return "block-sparse attention (this port's kernels)"
    if any(t in low for t in ("gemm", "xmma", "nvjet", "cutlass", "cublas")):
        return "GEMM (cuBLAS)"
    if "memcpy" in low or "memset" in low:
        return "memcpy/memset"
    return "other (elementwise, norms, reductions, optimizer)"


def phase_profile(env, train, label, steps=2):
    """Device time by kernel over ``steps`` more train_batch steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    engine, batch = train["engine"], train["batch"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.train_batch(batch=batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, n_device = {}, 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name] = by_name.get(evt.name, 0.0) \
                + evt.time_range.elapsed_us()
            n_device += 1
    if not by_name:
        raise RuntimeError("the profiler recorded no device time")
    busy = sum(by_name.values())
    groups = {}
    for name, us in by_name.items():
        g = _kernel_group(name)
        groups[g] = groups.get(g, 0.0) + us
    log(f"profile {label} ({steps} steps under torch.profiler, "
        f"{env['smi']}): "
        f"wall {wall_us / steps / 1e3:.1f} ms/step, device busy "
        f"{busy / steps / 1e3:.1f} ms/step, idle share "
        f"{1 - busy / wall_us:.3f}; {n_device // steps} device operations "
        f"per step")
    # the profiler's own host work slows the host: the share that the
    # step without it leaves idle is busy over the train phase's median
    log(f"  idle share of the unprofiled step ({train['step_ms']:.1f} ms): "
        f"{1 - busy / steps / 1e3 / train['step_ms']:.3f}")
    for g, us in sorted(groups.items(), key=lambda x: -x[1]):
        log(f"  {g:50s} {us / steps / 1e3:9.2f} ms/step "
            f"{us / busy:6.1%} of device time")
    for name, us in sorted(by_name.items(), key=lambda x: -x[1])[:12]:
        log(f"  {us / steps / 1e3:9.2f} ms/step  {name[:100]}")


def _plain_attention(mask_diagonal=False):
    """The model's attention with the plain version, flash_attention_reference
    (autograd through its blockwise online softmax), in place of the
    kernels; ``mask_diagonal`` plants the "diagonal" fault of
    _planted_faults."""
    import torch

    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

    def attend(q, k, v, *, causal, dropout_rate, **_):
        if dropout_rate:
            raise ValueError("the parity phase runs without dropout")
        bias = None
        if mask_diagonal:
            tile = torch.arange(q.shape[2], device=q.device) // FAULT_TILE
            bias = torch.zeros(tile.numel(), tile.numel(),
                               device=q.device).masked_fill(
                (tile[:, None] == tile[None, :]) & (tile[:, None] > 0),
                fa.NEG_INF)[None, None]
        return fa.flash_attention_reference(q, k, v, bias=bias, causal=causal)
    return attend


def phase_parity():
    import torch
    from unittest import mock

    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

    tol = TOL["bfloat16"]
    model = gpt2.GPT2Model(gpt2.gpt2_config(
        SLICE_MODEL, n_layer=2, n_positions=SLICE_SEQ,
        dtype=torch.bfloat16)).cuda()
    model.init_weights(torch.Generator().manual_seed(11))
    batch = {k: v[0].cuda() for k, v in _slice_batch(
        model.config.vocab_size, 1, 4, SLICE_SEQ, seed=1).items()}

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        before = dict(fa.LAUNCHES)
        loss, _ = model.loss(batch, train=True)
        loss.backward()
        launched = {n: fa.LAUNCHES[n] - before[n] for n in before}
        return loss.item(), {n: p.grad.clone() for n, p in
                             model.named_parameters()}, launched

    runs = {"kernels": loss_and_grads()}
    for label, attend in (("plain", _plain_attention()),
                          ("planted fault", _plain_attention(True))):
        with mock.patch.object(gpt2, "scaled_dot_product_attention", attend):
            runs[label] = loss_and_grads()
    for label, (_, _, launched) in runs.items():
        each = model.config.n_layer if label == "kernels" else 0
        if launched != {n: each for n in launched}:
            raise RuntimeError(f"the {label} run launched {launched}, "
                               f"expected {each} of each kernel")
    lp, gp, _ = runs["plain"]
    errs = {}
    for label in ("kernels", "planted fault"):
        loss, grads, _ = runs[label]
        loss_err = abs(loss - lp) / abs(lp)
        worst = max((rel_l2(grads[n], gp[n]), n) for n in gp)
        errs[label] = max(loss_err, worst[0])
        log(f"parity (2 layers, n_embd 1024, bf16) {label} vs plain: loss "
            f"{loss:.6f} vs {lp:.6f}, rel {loss_err:.3e}; worst gradient "
            f"{worst[1]} rel l2 {worst[0]:.3e} (tol {tol:g}, {len(gp)} "
            f"tensors)")
    if not errs["kernels"] <= tol:
        raise RuntimeError("kernel attention disagrees with the plain version")
    if not errs["planted fault"] > tol:
        raise RuntimeError("the parity gate passes a planted fault")


# ---------------------------------------------------------------------------
# block-sparse attention: kernels, BERT train step, profile, parity
# ---------------------------------------------------------------------------
def _fixed_layout(heads, seq):
    from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig

    return FixedSparsityConfig(num_heads=heads,
                               **BERT_SPARSITY).make_layout(seq)


def _drop_last_active(layout):
    """The layout with the last active block of every row removed."""
    import numpy as np

    faulty = np.array(layout, copy=True)
    for h in range(faulty.shape[0]):
        for row in faulty[h]:
            idx = np.flatnonzero(row)
            if len(idx):
                row[idx[-1]] = 0
    return faulty


def _sparse_case(shape, dtype, layout, block, bias_kind, seed, main):
    """Every block-sparse kernel against its plain version on one case;
    returns {kernel: {"err", "max_abs_err"}}, plus "ms", "plain_ms" and
    "fault_err" when ``main`` (the slice's shape: timed there, and the gate
    shown to fail two planted faults). Rows with no active block must give
    out 0 and lse -1e30 exactly; lse is gated on the other rows."""
    import numpy as np
    import torch

    from deepspeed_tpu_torch.ops.sparse_attention import \
        block_sparse_kernel as bsk

    b, h, s, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*sz):
        return torch.randn(*sz, generator=gen, device="cuda")

    q, k, v, do = (randn(b * h, s, d).to(dtype) for _ in range(4))
    bias = None
    if bias_kind == "zeros":           # the slice's all-ones attention mask
        bias = torch.zeros(b, s, device="cuda")
    elif bias_kind == "padded":
        bias = (randn(b, s) * 2.0).contiguous()
        bias[:, -7:] = bsk.NEG_INF         # padded keys
    elif bias_kind == "padded block":      # the last key block all padded
        bias = (randn(b, s) * 2.0).contiguous()
        bias[:, -block:] = bsk.NEG_INF
    luts = bsk.luts_for(layout, "cuda")
    kw = dict(scale=d ** -0.5, block=block, num_heads=h)
    out, lse = bsk.sparse_fwd(q, k, v, luts, bias, **kw)
    out_p, lse_p = bsk.sparse_fwd_plain(q, k, v, luts, bias, **kw)
    delta = (do.float() * out.float()).sum(-1)
    dq = bsk.sparse_bwd_dq(q, k, v, do, lse, delta, luts, bias, **kw)
    dq_p = bsk.sparse_bwd_dq_plain(q, k, v, do, lse, delta, luts, bias, **kw)
    dk, dv = bsk.sparse_bwd_dkdv(q, k, v, do, lse, delta, luts, bias, **kw)
    dk_p, dv_p = bsk.sparse_bwd_dkdv_plain(q, k, v, do, lse, delta, luts,
                                           bias, **kw)
    torch.cuda.synchronize()
    for t in (out, lse, dq, dk, dv):
        if not torch.isfinite(t).all():
            raise RuntimeError(f"non-finite kernel output at {shape}")
    # rows of query blocks with no active block, (bh, s)
    empty = torch.as_tensor((np.asarray(layout) != 0).sum(-1) == 0,
                            device="cuda").repeat_interleave(block, 1)
    empty = empty.repeat(b, 1)
    if not (bool((out[empty] == 0).all())
            and bool((lse[empty] == bsk.NEG_INF).all())):
        raise RuntimeError("rows with no active block must give out 0 and "
                           "lse -1e30")
    full = ~empty
    plain = {"sparse_fwd": (out_p, lse_p[full]), "sparse_bwd_dq": (dq_p,),
             "sparse_bwd_dkdv": (dk_p, dv_p)}
    got = {"sparse_fwd": (out, lse[full]), "sparse_bwd_dq": (dq,),
           "sparse_bwd_dkdv": (dk, dv)}
    tol = TOL[str(dtype).split(".")[-1]]
    summary = {}
    for name, refs in plain.items():
        err = max(scaled_err(a, p) for a, p in zip(got[name], refs))
        abs_err = max(float((a.float() - p.float()).abs().max())
                      for a, p in zip(got[name], refs))
        summary[name] = {"err": err, "max_abs_err": abs_err}
        log(f"  {name:15s} {tuple(shape)} {str(dtype)[6:]:8s} block {block} "
            f"bias={bias_kind} empty rows {int(empty.sum()) // max(1, block)}"
            f" blocks: scaled err {err:.3e} max abs err {abs_err:.3e} "
            f"(tol {tol:g})")
        if not err <= tol:
            raise RuntimeError(f"{name} disagrees with its plain version at "
                               f"{shape} {dtype} block {block}: {err:.3e} > "
                               f"{tol:g}")
    if not main:
        return summary

    # planted faults: the last active block of every row dropped from the
    # LUTs, and one block-row of every output left at zero
    faulty = bsk.luts_for(_drop_last_active(layout), "cuda")
    f_out, f_lse = bsk.sparse_fwd_plain(q, k, v, faulty, bias, **kw)
    dropped = {
        "sparse_fwd": (f_out, f_lse[full]),
        "sparse_bwd_dq": (bsk.sparse_bwd_dq_plain(q, k, v, do, lse, delta,
                                                  faulty, bias, **kw),),
        "sparse_bwd_dkdv": bsk.sparse_bwd_dkdv_plain(q, k, v, do, lse, delta,
                                                     faulty, bias, **kw),
    }
    rows = slice(s // 2, s // 2 + block)
    zero_row = {"sparse_fwd": (out_p.clone(), lse_p.clone()),
                "sparse_bwd_dq": (dq_p.clone(),),
                "sparse_bwd_dkdv": (dk_p.clone(), dv_p.clone())}
    for name, refs in plain.items():
        for t in zero_row[name]:
            t[:, rows] = 0
        zeroed = zero_row[name]
        if name == "sparse_fwd":
            zeroed = (zeroed[0], zeroed[1][full])
        readings = {
            "block dropped": max(scaled_err(f, p)
                                 for f, p in zip(dropped[name], refs)),
            "zero block-row": max(scaled_err(z, p)
                                  for z, p in zip(zeroed, refs)),
        }
        summary[name]["fault_err"] = readings
        log(f"  {name:15s} planted faults: " + ", ".join(
            f"{f} {e:.3e}" for f, e in readings.items())
            + f" (gate {tol:g}, kernel {summary[name]['err']:.3e})")
        if not min(readings.values()) > tol:
            raise RuntimeError(f"{name}: a planted fault passes the gate "
                               f"{tol:g}: {readings}")
    del dropped, zero_row, f_out, f_lse

    calls = {
        "sparse_fwd": (
            lambda: bsk.sparse_fwd(q, k, v, luts, bias, **kw),
            lambda: bsk.sparse_fwd_plain(q, k, v, luts, bias, **kw)),
        "sparse_bwd_dq": (
            lambda: bsk.sparse_bwd_dq(q, k, v, do, lse, delta, luts, bias,
                                      **kw),
            lambda: bsk.sparse_bwd_dq_plain(q, k, v, do, lse, delta, luts,
                                            bias, **kw)),
        "sparse_bwd_dkdv": (
            lambda: bsk.sparse_bwd_dkdv(q, k, v, do, lse, delta, luts, bias,
                                        **kw),
            lambda: bsk.sparse_bwd_dkdv_plain(q, k, v, do, lse, delta, luts,
                                              bias, **kw)),
    }
    # the scalar kernels at bf16: the routes the tensor-core ones replaced
    scalar = {
        "sparse_fwd": lambda: bsk.sparse_fwd(q, k, v, luts, bias, scalar=True,
                                             **kw),
        "sparse_bwd_dq": lambda: bsk.sparse_bwd_dq(
            q, k, v, do, lse, delta, luts, bias, scalar=True, **kw),
        "sparse_bwd_dkdv": lambda: bsk.sparse_bwd_dkdv(
            q, k, v, do, lse, delta, luts, bias, scalar=True, **kw)}
    _time_in_turns(calls, scalar, summary)
    return summary


def _sparse_library_ms(shape, dtype, layout, block):
    """scaled_dot_product_attention with the layout's boolean token mask,
    which computes the same function here (no row of the layout is empty),
    as a yardstick only: (forward ms, forward + whole backward ms)."""
    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.sparse_attention import layout_to_token_mask

    b, h, s, d = shape
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, do = (torch.randn(b, h, s, d, generator=gen, device="cuda")
                   .to(dtype) for _ in range(4))
    mask = layout_to_token_mask(layout, block, "cuda")[None]
    fwd = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                         attn_mask=mask))
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))

    def fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
        torch.autograd.grad(out, (qg, kg, vg), do)

    return fwd, cuda_ms(fwd_bwd)


def phase_sparse_kernels(env, tensor_cores):
    import torch

    from deepspeed_tpu_torch.ops.sparse_attention import (
        BigBirdSparsityConfig, FixedSparsityConfig)

    log("block-sparse kernels against their plain versions on the card:")
    main_shape = (BERT_MICRO, 12, BERT_SEQ, 64)
    block = BERT_SPARSITY["block"]
    layout = _fixed_layout(12, BERT_SEQ)
    main = _sparse_case(main_shape, torch.bfloat16, layout, block, "zeros",
                        11, main=True)
    # per-head BigBird at block 16: ragged nnz, random blocks (seeded)
    random.seed(0)
    bigbird = BigBirdSparsityConfig(num_heads=4, block=16,
                                    different_layout_per_head=True,
                                    num_random_blocks=2).make_layout(512)
    _sparse_case((2, 4, 512, 64), torch.float32, bigbird, 16, "padded", 12,
                 False)
    # an empty layout row, head_dim 128, padded key tail
    holed = FixedSparsityConfig(num_heads=2, block=32,
                                num_local_blocks=2).make_layout(256)
    holed[:, 3] = 0
    _sparse_case((2, 2, 256, 128), torch.float32, holed, 32, "padded", 13,
                 False)
    # a 128 block (two 64-row tiles per block), head_dim 96, no bias
    wide = FixedSparsityConfig(num_heads=2, block=128, num_local_blocks=2,
                               attention="unidirectional").make_layout(512)
    _sparse_case((1, 2, 512, 96), torch.float32, wide, 128, "none", 14,
                 False)
    _sparse_case((2, 2, 512, 64), torch.bfloat16, bigbird[:2], 16, "padded",
                 15, False)
    # bf16 on the tensor-core kernels: head_dim 96 and 128, block 128, a
    # padded key tail, an empty row, and a fully padded row (a query block
    # whose only active key block is padded: every score ties at -1e30 and
    # the row gives the mean of v, as the Pallas kernel does; ROADMAP C-w4)
    fixed = FixedSparsityConfig(num_heads=2, **BERT_SPARSITY).make_layout(512)
    _sparse_case((2, 2, 512, 96), torch.bfloat16, fixed, 64, "padded", 16,
                 False)
    _sparse_case((1, 2, 512, 128), torch.bfloat16, wide, 128, "padded", 17,
                 False)
    holed64 = FixedSparsityConfig(num_heads=2, block=64,
                                  num_local_blocks=2).make_layout(256)
    holed64[:, 2] = 0
    _sparse_case((2, 2, 256, 128), torch.bfloat16, holed64, 64, "none", 18,
                 False)
    tied = FixedSparsityConfig(num_heads=2, block=64,
                               num_local_blocks=2).make_layout(256)
    tied[:, -1] = 0
    tied[:, -1, -1] = 1
    _sparse_case((2, 2, 256, 64), torch.bfloat16, tied, 64, "padded block",
                 19, False)
    lib_fwd, lib_all = _sparse_library_ms(main_shape, torch.bfloat16, layout,
                                          block)
    log(f"  library yardstick (scaled_dot_product_attention with the token "
        f"mask) at {main_shape} bf16: fwd {lib_fwd:.3f} ms, fwd + whole bwd "
        f"{lib_all:.3f} ms")
    b, h = main_shape[:2]
    # score pairs the layout keeps, per batch*head (the heads' mean)
    pairs = int((layout != 0).sum()) * block * block / h
    rows = []
    for name, replaces in SPARSE_KERNELS:
        bms, by = bound(name, env["name"], main_shape, torch.bfloat16, False,
                        bias_bytes=b * BERT_SEQ * 4, pairs=pairs)
        r = main[name]
        rows.append({
            "name": name, "route": "cuda", "source": SPARSE_SOURCE,
            "replaces": replaces, "kernel_route": "tc",
            "launches": None,
            "max_abs_err": r["max_abs_err"], "scaled_err": r["err"],
            "planted_fault_err": r["fault_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bms, "bound_by": by,
            # one library call computes the forward; none computes the dQ
            # or the dK/dV sweep alone
            "library_ms": lib_fwd if name == "sparse_fwd" else None,
            "library_fwd_bwd_ms": lib_all,
            "shape": list(main_shape), "dtype": "bfloat16",
            "layout": "FixedSparsityConfig(12, block=64, num_local_blocks=4,"
                      " num_global_blocks=1)",
            "active_blocks_per_head": int((layout != 0).sum()) // h,
            "scalar_ms": r.get("scalar_ms"),
            "card": env["smi"],
            "tensor_core_sass": tensor_cores.get(FAMILY_OF.get(name), {}),
        })
        log(f"  {name:15s} {r['ms']:.4f} ms vs bound {bms:.4f} ms ({by}), "
            f"library fwd + whole bwd {lib_all:.3f} ms, on {env['smi']}")
    _backward_head_dims(env, main_shape, layout, block, pairs)
    return rows


def _backward_head_dims(env, main_shape, layout, block, pairs):
    """The tensor-core dQ and dK/dV sweeps at the slice's shape with
    head_dim 96 and 128 (off the slice; the dK/dV sweep runs one block per
    SM there, two at 64), against their bounds. Logged only: the kernels
    line holds the slice's shape."""
    import torch

    from deepspeed_tpu_torch.ops.sparse_attention import \
        block_sparse_kernel as bsk

    b, h, s, _ = main_shape
    luts = bsk.luts_for(layout, "cuda")
    bias = torch.zeros(b, s, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(20)
    for d in (96, 128):
        q, k, v, do = (torch.randn(b * h, s, d, generator=gen, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        kw = dict(scale=d ** -0.5, block=block, num_heads=h)
        out, lse = bsk.sparse_fwd(q, k, v, luts, bias, **kw)
        delta = (do.float() * out.float()).sum(-1)
        args = (q, k, v, do, lse, delta, luts, bias)
        for name, fn in (("sparse_bwd_dq", bsk.sparse_bwd_dq),
                         ("sparse_bwd_dkdv", bsk.sparse_bwd_dkdv)):
            ms = kernel_ms(lambda: fn(*args, **kw))
            bms, by = bound(name, env["name"], (b, h, s, d), torch.bfloat16,
                            False, bias_bytes=b * s * 4, pairs=pairs)
            log(f"  {name:15s} at head_dim {d}: {ms:.4f} ms vs bound "
                f"{bms:.4f} ms ({by}), {ms / bms:.2f}x, on {env['smi']}")


def _bert_batch(vocab, gas, micro, seq, seed):
    """input_ids, an all-ones attention mask and 15 % MLM labels (the rest
    -100), from a numpy seed (the JAX package's bench.py batch)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (gas, micro, seq))
    labels = np.where(rng.random((gas, micro, seq)) < 0.15, ids, -100)
    return {"input_ids": torch.as_tensor(ids),
            "attention_mask": torch.ones((gas, micro, seq),
                                         dtype=torch.int32),
            "masked_lm_labels": torch.as_tensor(labels)}


def _bert_config(**overrides):
    import torch

    from deepspeed_tpu_torch.models.bert import bert_config
    from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig

    return bert_config(
        BERT_MODEL, max_position_embeddings=BERT_SEQ, dtype=torch.bfloat16,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        sparsity_config=FixedSparsityConfig(num_heads=12, **BERT_SPARSITY),
        **overrides)


def phase_train_bert(env):
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.bert import BertForPreTraining

    cfg = _bert_config()
    engine, _, _, _ = initialize(model=BertForPreTraining(cfg),
                                 config_params=_ds_config(BERT_MICRO,
                                                          BERT_GAS))
    batch = _bert_batch(cfg.vocab_size, BERT_GAS, BERT_MICRO, BERT_SEQ,
                        seed=0)
    want = {name: 0 for name, _ in FLASH_KERNELS}
    want.update({name: cfg.num_hidden_layers * BERT_GAS * BERT_STEPS
                 for name, _ in SPARSE_KERNELS})
    return _train_steps(env, engine, batch, f"{BERT_MODEL} sparse", BERT_SEQ,
                        BERT_MICRO, BERT_GAS, BERT_STEPS, want)


def phase_parity_bert():
    """2 layers at full width: the kernels against the same model with
    block_sparse_attention_reference (autograd through the plain forward)
    as its attention; a planted fault (the last active block of every row
    dropped from the reference's LUTs) must fail the same gate."""
    import torch
    from unittest import mock

    from deepspeed_tpu_torch.models.bert import BertForPreTraining
    from deepspeed_tpu_torch.ops.sparse_attention import \
        block_sparse_kernel as bsk
    from deepspeed_tpu_torch.ops.sparse_attention import \
        sparse_self_attention as ssa

    tol = TOL["bfloat16"]
    # weights at std 0.05, not 0.02: at 0.02 the scores are so flat that
    # each of a row's 19 active blocks carries about 1/19 of its attention,
    # and dropping one moves the gradients by no more than the gate allows;
    # sharper scores let the planted fault show
    model = BertForPreTraining(_bert_config(num_hidden_layers=2,
                                            initializer_range=0.05)).cuda()
    model.init_weights(torch.Generator().manual_seed(11))
    batch = {k: v[0].cuda() for k, v in _bert_batch(
        model.config.vocab_size, 1, 2, BERT_SEQ, seed=1).items()}
    faulty = _drop_last_active(_fixed_layout(12, BERT_SEQ))

    def reference(fault=False):
        def attend(q, k, v, layout, block, scale=None, key_bias=None):
            return bsk.block_sparse_attention_reference(
                q, k, v, faulty if fault else layout, block, scale=scale,
                key_bias=key_bias)
        return attend

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        before = dict(bsk.LAUNCHES)
        loss, _ = model.loss(batch, train=True)
        loss.backward()
        launched = {n: bsk.LAUNCHES[n] - before[n] for n in before}
        # the pooler and NSP head get no gradient from an MLM-only batch
        return loss.item(), {n: p.grad.clone() for n, p in
                             model.named_parameters()
                             if p.grad is not None}, launched

    runs = {"kernels": loss_and_grads()}
    for label, attend in (("plain", reference()),
                          ("planted fault", reference(fault=True))):
        with mock.patch.object(ssa, "pallas_block_sparse_attention", attend):
            runs[label] = loss_and_grads()
    for label, (_, _, launched) in runs.items():
        each = model.config.num_hidden_layers if label == "kernels" else 0
        if launched != {n: each for n in launched}:
            raise RuntimeError(f"the {label} run launched {launched}, "
                               f"expected {each} of each kernel")
    lp, gp, _ = runs["plain"]
    errs = {}
    for label in ("kernels", "planted fault"):
        loss, grads, _ = runs[label]
        loss_err = abs(loss - lp) / abs(lp)
        worst = max((rel_l2(grads[n], gp[n]), n) for n in gp)
        errs[label] = max(loss_err, worst[0])
        log(f"parity BERT (2 layers, hidden 768, seq {BERT_SEQ}, sparse, "
            f"bf16) {label} vs plain: loss {loss:.6f} vs {lp:.6f}, rel "
            f"{loss_err:.3e}; worst gradient {worst[1]} rel l2 "
            f"{worst[0]:.3e} (tol {tol:g}, {len(gp)} tensors)")
    if not errs["kernels"] <= tol:
        raise RuntimeError("block-sparse kernels disagree with the plain "
                           "version")
    if not errs["planted fault"] > tol:
        raise RuntimeError("the BERT parity gate passes a planted fault")


def main():
    if not os.path.isdir(os.path.join(HERE, "deepspeed_tpu_torch")):
        print("chip_smoke.py: the deepspeed_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    env = phase_env()
    tensor_cores = phase_build()
    rows = phase_kernels(env, tensor_cores)
    train = phase_train(env)
    for row in rows:
        row["launches"] = train["launches"][row["name"]]
    phase_profile(env, train, SLICE_MODEL)
    del train
    phase_parity()
    sparse_rows = phase_sparse_kernels(env, tensor_cores)
    torch.cuda.empty_cache()
    bert = phase_train_bert(env)
    for row in sparse_rows:
        row["launches"] = bert["launches"][row["name"]]
    phase_profile(env, bert, f"{BERT_MODEL} sparse")
    del bert
    torch.cuda.empty_cache()
    phase_parity_bert()
    print(json.dumps({"kernels": rows + sparse_rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
