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
              width) at seq 1024, bf16 (the module's parameters the bf16
              copy of the fp32 master), Adam, WarmupLR, clipping 1.0, gas
              2: losses finite and falling, every flash kernel launched
              exactly 24 x 2 x 10 times
  5. profile  two more train_batch steps under torch.profiler: device time
              by kernel, the flash kernels' and the GEMMs' shares, and the
              device's idle share (after the launch counts are read)
  6. zero     phase 4's run at ZeRO stage 2 in a world of one over NCCL
              (init_distributed() under torchrun's variables, mesh data 1):
              its 10 losses and final master weights equal phase 4's bit
              for bit (else within the spread of two stage-0 runs, which
              is then printed), the collectives counted in each step equal
              comm_volume_report()'s list at dp 1, B1-B3 launch 480 times
              each; step ms, tokens/s and peak memory beside phase 4's, two
              more steps under torch.profiler; the same run with the
              post-step parameter gather skipped (a planted fault) must
              fail the first gate
  7. parity   2 layers at full width: loss and every parameter gradient with
              the kernels against the same model with the plain version
              (flash_attention_reference) as its attention, bf16 tolerance;
              a planted fault (diagonal tiles masked) must fail it
  8. sparse kernels
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
  9. train (BERT)
              initialize() -> 10 x train_batch of bert-base (12 layers,
              full width) at seq 4096 over that layout, micro 4, gas 2:
              losses finite and falling, every block-sparse kernel launched
              exactly 12 x 2 x 10 times and no flash kernel
 10. profile (BERT)
              two more steps under torch.profiler
 11. parity (BERT)
              2 layers at full width, seq 4096: loss and every gradient
              against block_sparse_attention_reference as the attention; a
              planted fault (one active block per row dropped) must fail it
 12. kernels (fp16)
              B1-B3 at fp16 (their fp16 tensor-core instantiations)
              against the plain versions: the slice shape, timed, with
              scaled_dot_product_attention's fp16 time and the two
              planted faults, and small shapes with both bias kinds,
              dropout and head_dim 64, 96, 128; the fp16 gate is 5e-3
              (PERF.md section 2)
 13. train (fp16)
              gpt2-350m at fp16 with dynamic loss scaling (2**16,
              hysteresis 2) and remat 'attn_out': 10 steps with the loss
              scale and skipped steps after each, flash launches per step
              (2 x 24 x 2 forward: the remat re-runs it, as the JAX
              model's does; 24 x 2 of each backward sweep); a checkpoint
              saved after step 5 into a temporary directory (seconds,
              bytes), loaded into a new engine, and steps 6-10 run again:
              their losses must equal the uninterrupted run's bit for bit
 14. profile (fp16)
              two more steps under torch.profiler
 15. optimizers
              LAMB and SGD through initialize() -> train_batch, 3 steps
              each at 2 layers of gpt2-350m, bf16: losses finite and
              falling
 16. serve    generation and the continuous-batching InferenceEngine on
              gpt2-350m (full depth and width, bf16 over fp32 weights,
              seed 42): 32 greedy requests (prompts 16-512 tokens from
              default_rng(0), 64 new tokens, every 8th at priority 1; 8
              submitted, then one per step), 8 slots, KV blocks of 16,
              prefill chunks of 128, after warmup(). Pass A: every
              request finishes in vocab, no new dispatch signature after
              warmup, the pool tensors never move and device_bytes()
              equals their bytes; the replay gate (each generated token
              scores within SERVE_DELTA of the best logit of the training
              forward, the flash kernels, over the same tokens) and its
              planted fault (the decode view's page tables rotated by one
              block) at >= 10x the gate; TTFT, TPOT, tokens/s, peak
              memory, pool.stats(), and 5 decode-only steps under
              torch.profiler. Pass B: kv_blocks 193, evictions > 0, the
              same gate. Pass C: int8 KV. Pass D: fp32 at 2 layers, TF32
              off: engine tokens equal generate()'s (divergence allowed
              only at a near tie, counted) and generate_beam(num_beams=1)
              equals greedy
 17. offload  ZeRO-Offload (stage 2, cpu_offload) of phase 4's run: the
              fp32 master, Adam's m and v and the gradient accumulator on
              the host, stepped by the port's C++ host Adam (built with
              g++ in phase 2), the bf16 gradients copied down to pinned
              memory on a side stream each micro step, the bf16 weights
              pushed back up after each step. The host Adam held against
              the device FusedAdam on the same fp32 gradients for one step
              at full size (each element within 2 ulp of the master plus
              lr * (rho + 2**-20), rho what the fp32 1 - beta moves the
              update by: _adam_gate); 10 steps with losses finite and
              falling, B1-B3 480 launches each, the losses within
              OFFLOAD_LOSS_GATE of phase 4's (PERF.md section 2) and a
              planted fault (the push skipped: the card trains on stale
              weights; 3 steps) at least 10x outside it; a save after step 5 into
              a temporary directory, a load into a new engine and steps
              6-10 again, bit for bit; step ms, tokens/s, idle share and
              peak memory beside phase 4's, the analytic offload bytes,
              host RSS, D2H and H2D GB/s, host Adam ms per step, the
              host's CPU and memory, two steps under torch.profiler
 18. offload (large)
              gpt2-4b (64 layers, n_embd 2304: 4.2B parameters, whose
              stage-0 state, 18 bytes per parameter, does not fit one 80
              GB card) under ZeRO-Offload, seq 1024, micro 1, gas 1, remat
              attn_out: 3 steps with finite losses and every flash launch
              counted; peak device memory beside the analytic stage-0
              bytes; step ms, host Adam ms, host RSS
 19. serve (A10b)
              the prefix cache, speculative decoding and the sparse page
              context on phase 16's gpt2-350m engine (bf16 over fp32
              weights, seed 42, 8 slots, blocks of 16, chunks of 128,
              greedy, warmup() first). Every pass: requests finished in
              vocab, no new dispatch signature after warmup, the pool never
              moved; TTFT p50/p95, TPOT p50, tokens/s, peak memory,
              pool.stats(); 5 decode (or verify) steps under torch.profiler
              beside phase 16's dense decode step. Pass E: 32 requests of a
              shared 392-token prefix + tails of 16-128 (default_rng(0)),
              with and without prefix_cache: >= 2x fewer prefill tokens
              computed, hits and COW splits, the replay gate, a 97-block
              sub-run that evicts while shared blocks are mapped, and the
              planted fault (the COW copy skipped) at >= 10x the gate.
              Pass H: sparse context with the full window on pass E's
              traffic equals the dense engine's tokens bit for bit. Pass F:
              speculative=3 on phase 16's traffic: the replay gate, the
              accept histogram sums to the accepted tokens, fewer verify
              dispatches than output tokens, the planted fault (one draft
              accepted beyond the match) at >= 10x; at 2 layers, fp32, TF32
              off, engine tokens equal generate()'s but at near ties. Pass
              G: sparse context, window 16 blocks + 1 global (K = 17 of 64
              pages), 16 prompts of 600-900 tokens: the active page fraction
              equals the LUT's, window-expired frees > 0, the replay gate
              against a plain forward masked by the policy's token mask and
              the planted fault (view bases shifted one block) at >= 10x
 20. telemetry
              phase 4's run (gpt2-350m bf16, seq 1024, micro 8, gas 2, 10
              steps, steps_per_print 5) disarmed, then armed with
              telemetry {trace, mfu, memory}, flops_profiler (profile_step
              2) and tensorboard, then the same with metrics_jsonl too:
              (a) the armed losses equal phase 4's and the disarmed run's
              bit for bit and B1-B3 launch as in phase 4; (b) the MFU report names the card,
              knows its peak, its hardware FLOPs per step equal the closed
              form (the matmuls written out plus the kernels' own FLOP
              formulas) and HFU >= MFU; (c) the report's device peak equals
              what max_memory_allocated would have read had the engine's
              windows not reset it (every reset observed), the analytic
              persistent bytes sit at or under the measured bytes in use
              and within 15 % of them, and with the optimizer state left
              out of the analytic side (a planted fault) the cross-check
              fires; (d) the Chrome trace parses, each step has 2
              forward_micro, 2 backward_micro and 1 optimizer_step on lane
              train, none dropped; (e) the JSONL replays to 10 records whose
              losses are the returned ones; (f) the TensorBoard file reads
              back with its CRCs and the scalars of steps 5 and 10; (g) step
              ms of the three runs and the telemetry's host step time.
              Then phase 16's pass A traffic (its first 8 requests) served
              with telemetry= armed: the greedy tokens equal an unarmed
              engine's, memory_report()'s pool bytes equal the pool
              tensors' bytes, one serving_step span and one JSONL record
              per engine step after warmup, the decode MFU printed
 21. programs the program lint (deepspeed_tpu_torch/telemetry/
              program_lint.py) over the slice's engines, every dispatch
              observed on the card under set_sync_debug_mode("error"):
              gpt2-350m bf16 (phase 4's config) through train_batch,
              forward/backward/step and eval_loss, linted and unlinted
              (losses bit for bit, B1-B3 launches equal, zero findings);
              ZeRO stage 2 in an NCCL world of one under a hand-declared
              count of its all-reduces (at dp 1 every leaf is replicated:
              no parameter all-gather), whose planted fault (one gradient
              all-reduce skipped) is one program-op-count finding;
              ZeRO-Offload's micro steps; the CPU corpus's three serving
              engines (plain, prefix cache + speculation, sparse context)
              at gpt2-350m, linted and unlinted (tokens bit for bit, zero
              findings), and two planted faults in the decode step (an
              .item(), the pool replaced by a copy), one finding each
              (program-host-transfer, program-donation). Every program
              name equals the CPU corpus's. Wall time of the linted and
              unlinted drive, of the lint, and the unlinted step's
 22. host activations
              gpt2-350m bf16, dropout 0.1, seq 1024, micro 8, gas 1, each
              block under checkpointing.checkpoint, Adam, 3 steps: on-device
              remat, then activation_checkpointing.cpu_checkpointing (the
              matmul outputs in pinned host memory). Losses and one micro
              step's gradients bit for bit; the third step under
              set_sync_debug_mode("error"); 96 saved tensors of 24 x 8192 x
              18,432 B, all pinned, all served to the recompute; B1 twice
              and B2/B3 once per block; peak memory, step ms and, from one
              profiled step, D2H and H2D GB/s
 23. moe      GPT-2 mixture-of-experts (ROADMAP A15, MoE half): gpt2-350m
              with 16 experts, top-2, in its 12 odd blocks (1.87B
              parameters, the expert stacks drawn on the card), bf16, seq
              1024, micro 8, gas 2, Adam, WarmupLR, clipping 1.0, through
              initialize() -> 10 x train_batch: losses finite and falling,
              B1-B3 launched 24 x 2 x 10 times each, an 11th step under
              set_sync_debug_mode("error"), a 12th observed by the
              program lint (zero findings); step ms, tokens/s, peak
              memory, moe_aux_loss and each MoE layer's dropped fraction,
              two steps under torch.profiler. Parity at 2 layers (layer 1
              MoE), full width: loss and every gradient with the kernels
              against the plain attention, the routing of the kernel run
              pinned on the plain run (its flipped choices counted: they
              are the only difference the pin removes), within the bf16
              gate; the planted fault (the second choice dropped) at >=
              10x it; the combine left in fp32 measured. Decode: generate()
              greedy, 4 prompts of 16, 32 new tokens, from the trained fp32
              master at a capacity where nothing drops, under phase 16's
              replay gate against the training forward with generate()'s
              routing pinned on it (its flips counted); fp32 at 2 layers,
              capacity factor 8: greedy tokens equal the training
              forward's argmax but at near ties
 24. seq      sequence parallelism (ROADMAP A15, sequence half), on one
              card: (a) Ulysses's kernels: B1-B3 per rank's heads of
              gpt2-350m's attention (8, 16, 1024, 64) bf16 causal over 4
              ranks of 4 heads (head offset r * 4 of 16), with and without
              dropout 0.1, and B5-B7 per rank's 3 heads of bert-base
              sparse (4, 12, 4096, 64) over the layout's rows of those
              heads: out, lse, dQ, dK and dV equal one launch over all
              heads bit for bit; the head offset left at 0 (a planted
              fault) must change the dropout output. (b) The ring's rounds
              composed for 4 virtual ranks (ring_virtual) at (8, 16, 1024)
              and (1, 16, 8192), d 64: fp32 against plain fp32 attention
              at tests/unit/test_ring_attention.py's tolerances; bf16
              against that exact attention (scaled error) and against the
              flash kernels over the whole sequence (relative L2; the
              kernels' own element error, which rounds p and dS to bf16,
              logged beside), all within the bf16 gate; the
              forward and backward round's ms and one rank's peak bytes at
              8192. (c) 10 steps of phase 4's run with
              attention_sp_mode="ring" at mesh {"data": 1, "seq": 1} in an
              NCCL world of one: losses and the fp32 master equal phase
              4's bit for bit (the seq route never runs at N = 1), B1-B3
              480 each, step ms and tokens/s beside phase 4's
 25. zero3    ZeRO stage 3 and the int8 ZeRO collectives (ROADMAP A13):
              (a) phase 4's run asked for stage 3 in an NCCL world of one,
              with the scheduled default and with the implicit path: at
              dp 1 no leaf is sharded, so stage 3 disarms and both run
              stage 0's code (the stage-3 gathers, their release and qgZ
              run at dp > 1 only: tests/test_torch_cuda.py
              ::test_nccl_zero3_worlds_match_one_card on four cards). 10
              losses and the fp32 master equal phase 4's bit for bit,
              B1-B3 480 each, the counted collectives equal
              comm_volume_report() in every step, stage3_report() disarmed
              and naming why; stage 0's parameter refresh skipped (a
              planted fault) must change the losses.
              (b) The trained bf16 parameters, each sharded leaf split over
              4 virtual ranks along its ZeRO dim: the int8 codes and scales
              on the card equal the CPU's bit for bit, the virtual gather
              too, every dequantized element within half its block's
              scale, the wire bytes the plan's; the codec's ms per gather
              and its bytes against the bf16 dense gather's; scales from
              the block mean (a planted fault) must break the half-scale
              gate. (c) One forward and backward with each sharded leaf
              read through quantized_all_gather_virtual over 4 ranks: the
              gradients equal those of the model run on the dequantized
              weights bit for bit, the loss within 2 % of the bf16
              weights' (the JAX acceptance), and the quantized
              reduce-scatter of 4 ranks' gradients within the int8 bound of
              the dense mean; round's true derivative (a planted fault,
              zero gradients) must fail the gradient gate
 26. onebit   1-bit Adam, 0/1 Adam and CSR gradients (ROADMAP A13b), on
              phase 4's model, batch and precision with gradient clipping
              off, each run in an NCCL world of one (their wires arm at
              dp > 1 only: tests/test_torch_cuda.py
              ::test_nccl_onebit_worlds_match_gloo on four cards). (a)
              1-bit Adam, freeze_step 5, 10 steps: the wire disarmed and
              logged ("data-parallel degree is 1"); steps 1-5 equal Adam
              without bias correction bit for bit (losses and fp32
              master); v unchanged bit for bit over steps 6-10; each
              frozen step's momentum (its input and residuals captured on
              the card) equals quantize_with_error_feedback on the CPU:
              packed codes bit for bit, scales within 1e-6; B1-B3 480
              each; planted faults: sign(0) -> -1 on the CPU side must
              break the codes gate, v updated after the freeze the v gate.
              (b) 0/1 Adam, 10 steps: disarmed (warmup for ever), losses
              and fp32 master equal Adam without bias correction bit for
              bit over all ten, and so (a)'s first five. (c) The trained
              model's gradients of one micro-batch, per JAX leaf of each
              size the model has (layer 0's, the embeddings', ln_f's), as
              4 virtual ranks' contributions (seeded): compressed_allreduce
              _virtual and quantized_all_reduce_virtual at bits 1 and 8,
              flat and over intra groups of 2, 3 rounds with the residuals
              carried: the codes, scales and outputs on the card equal
              the CPU's bit for bit on 4 leaves; the rounds' sum within
              1e-5 (of its largest term) of the dense means' sum less the
              residuals (error feedback; plus the inter hop's own error
              over groups); ms per round, one rank's wire bytes and a
              dense fp32 all-reduce's; the server residual dropped (a
              planted fault) must fail that gate. (d) The JAX tests'
              embedding model at gpt2-350m's table (50304 x 1024) under
              ZeRO-Offload stage 2, 6 steps with and without
              sparse_gradients: losses within rtol 1e-5, the table's
              device-to-host bytes rows x dim (8192 x 1024) against vocab
              x dim
The line before the last is the kernels JSON (the fp16 rows named
<kernel>_fp16, their launches from phase 13); the last line is
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
TOL = {"bfloat16": 2e-2, "float16": 5e-3, "float32": 1e-4}
# tile of the planted faults: the q tile of the bf16 forward and dQ sweep
# and the k tile of the bf16 dK/dV sweep
FAULT_TILE = 128
# the tensor-core kernels, by library: every instantiation (one per
# head_dim and element type) must hold HGMMA, and every other kernel none
TC_FAMILIES = {
    "flash_attention": ("flash_fwd_tc_kernel", "flash_bwd_dkdv_tc_kernel",
                        "flash_bwd_dq_tc_kernel"),
    "block_sparse_attention": ("bsa_fwd_tc_kernel", "bsa_bwd_dq_tc_kernel",
                               "bsa_bwd_dkdv_tc_kernel"),
}
# instantiations of each tensor-core kernel: head_dim 64, 96, 128, at bf16
# and fp16 (flash) or bf16 (block-sparse)
TC_INSTANTIATIONS = {"flash_attention": 6, "block_sparse_attention": 3}
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
# the fp16 slice: the same model and step at fp16 with dynamic loss scaling
# and selective remat
FP16_SCALE_POWER = 16
FP16_REMAT_POLICY = "attn_out"


def log(msg):
    print(msg, flush=True)


# {phase function name: wall seconds}, in the order the phases ran
PHASE_WALLS = {}


def timed(phase, *args):
    """Run ``phase(*args)``, log its wall time and keep it in
    ``PHASE_WALLS``."""
    t0 = time.perf_counter()
    out = phase(*args)
    wall = time.perf_counter() - t0
    key = phase.__name__
    if args and isinstance(args[-1], str):       # phase_profile's label
        key = f"{key} {args[-1]}"
    PHASE_WALLS[key] = wall
    log(f"phase wall: {key} {wall:.3f} s")
    return out


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
    # fp16 and bf16 share the tensor cores' rate
    peak = fp32_peak if dtype == torch.float32 else bf16_peak
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
    """One nvcc per source and one g++ per host source (the offload host
    Adam), all started together; each timed."""
    from deepspeed_tpu_torch.ops import op_builder

    def timed(name):
        t0 = time.perf_counter()
        path, report = op_builder.build(name, verbose=True)
        return path, report, time.perf_counter() - t0

    def timed_host(name):
        t0 = time.perf_counter()
        path = op_builder.build_host(name)
        return path, time.perf_counter() - t0

    t0 = time.perf_counter()
    n = len(op_builder.SOURCES) + len(op_builder.HOST_SOURCES)
    with concurrent.futures.ThreadPoolExecutor(n) as ex:
        futures = {name: ex.submit(timed, name)
                   for name in op_builder.SOURCES}
        host = {name: ex.submit(timed_host, name)
                for name in op_builder.HOST_SOURCES}
        results = {name: f.result() for name, f in futures.items()}
        host = {name: f.result() for name, f in host.items()}
    for name, (path, secs) in host.items():
        log(f"build {os.path.relpath(op_builder.HOST_SOURCES[name], HERE)} "
            f"(g++ {' '.join(op_builder.host_flags())}): {path}; build "
            f"seconds {secs:.2f}")
    by_kernel = {}
    for name, (path, report, secs) in results.items():
        log(f"build {os.path.relpath(op_builder.SOURCES[name], HERE)}: "
            f"{path}")
        with open(os.path.join(op_builder.BUILD_DIR, f"ptxas_{name}.txt"),
                  "w") as f:
            f.write(report)
        _ptxas_summary(report, TC_FAMILIES[name])
        log(f"build seconds ({name}): {secs:.2f}")
        by_kernel.update(_tensor_core_proof(path, TC_FAMILIES[name],
                                            TC_INSTANTIATIONS[name]))
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
            dim = re.search(r"Li(\d+)E", ln)
            elem = "fp16" if "6__half" in ln else "bf16"
            if current:
                current += f"<{elem}, {dim.group(1) if dim else '?'}>"
        elif current and ("registers" in ln or "spill" in ln):
            log(f"  ptxas {current}: {ln.split('info    :')[-1].strip()}")
        if "wgmma" in ln:          # e.g. products serialized by ptxas
            log(f"  ptxas: {ln.strip()[:300]}")


def _tensor_core_proof(library, families, instantiations):
    """{family: {instantiation: HGMMA + HMMA count}} from cuobjdump -sass of
    one library; raises unless each tensor-core family has
    ``instantiations`` instantiations (one per head_dim and element type),
    each holding HGMMA, and every other kernel of the library (the scalar
    ones) holds no tensor-core instruction."""
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
        if len(found) != instantiations \
                or not all(c[0] for c in found.values()):
            raise RuntimeError(f"{family}: expected {instantiations} "
                               f"instantiations with HGMMA instructions, got "
                               f"{found}")
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
    return _kernel_rows(env, tensor_cores, main, main_shape, torch.bfloat16)


def phase_kernels_fp16(env, tensor_cores):
    """B1-B3 at fp16 (the element type of the fp16 training phase) against
    their plain versions: the slice shape, timed and shown to fail the
    planted faults, and small shapes with both bias kinds and dropout at
    head_dim 64, 96 and 128. Rows named <kernel>_fp16."""
    import torch

    log("kernels at fp16 against their plain versions on the card:")
    main_shape = (8, 16, SLICE_SEQ, 64)
    main = _flash_case(main_shape, torch.float16, True, "none", 0.0, 11,
                       main=True)
    _flash_case((2, 4, 256, 64), torch.float16, False, "key", 0.1, 12,
                False)
    _flash_case((1, 2, 200, 128), torch.float16, True, "full", 0.1, 13,
                False)
    _flash_case((2, 2, 333, 96), torch.float16, True, "key", 0.1, 14, False)
    _flash_case((1, 3, 77, 64), torch.float16, True, "none", 0.0, 15, False)
    _dropout_masks_exact(torch.float16)
    return _kernel_rows(env, tensor_cores, main, main_shape, torch.float16,
                        suffix="_fp16")


def _kernel_rows(env, tensor_cores, main, main_shape, dtype, suffix=""):
    """The kernels line's rows of the flash kernels at ``dtype``, with the
    library yardstick timed at the slice shape."""
    lib_fwd, lib_bwd = _library_ms(main_shape, dtype)
    dname = str(dtype).split(".")[-1]
    log(f"  library yardstick (scaled_dot_product_attention) at "
        f"{main_shape} {dname} causal: fwd {lib_fwd:.3f} ms, bwd (dq, dk, "
        f"dv together) {lib_bwd:.3f} ms")
    rows = []
    for name, replaces in FLASH_KERNELS:
        bms, by = bound(name, env["name"], main_shape, dtype, True)
        r = main[name]
        rows.append({
            "name": name + suffix, "route": "cuda", "source": FLASH_SOURCE,
            "replaces": replaces, "kernel_route": "tc",
            "launches": None,
            "max_abs_err": r["max_abs_err"], "scaled_err": r["err"],
            "planted_fault_err": r["fault_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bms, "bound_by": by,
            # one library call computes the forward; none computes the
            # dK/dV or the dQ sweep alone
            "library_ms": lib_fwd if name == "flash_fwd" else None,
            "library_bwd_all_ms": lib_bwd,
            # the scalar kernel the tensor-core one replaced
            "scalar_ms": r.get("scalar_ms"),
            "shape": list(main_shape), "dtype": dname, "causal": True,
            "card": env["smi"],
            # tensor-core instructions in the SASS of each instantiation
            "tensor_core_sass": tensor_cores.get(FAMILY_OF.get(name), {}),
        })
        log(f"  {name + suffix:20s} {r['ms']:.3f} ms vs bound {bms:.4f} ms "
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
    train = _train_steps(env, engine, batch, SLICE_MODEL, SLICE_SEQ,
                         SLICE_MICRO, SLICE_GAS, SLICE_STEPS, want)
    # the fp32 master after the 10 steps, on the host: phase_zero's gate,
    # and its digest: phase_seq's
    train["master"] = _host_master(engine)
    train["digest"] = _master_digest(engine)
    return train


def _host_master(engine):
    return [m.detach().to("cpu", copy=True) for m in engine.master]


def _train_steps(env, engine, batch, model_name, seq, micro, gas, steps,
                 want, after_step=None, falling=True):
    """``steps`` train_batch calls with every kernel count set to 0 just
    before and read just after; raises unless the losses are finite and
    (``falling``) falling and each kernel launched exactly
    ``want[kernel]`` times. ``after_step()`` runs after each step,
    untimed."""
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
        if after_step is not None:
            after_step()
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
    if falling and not losses[-1] < losses[0]:
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
    """Device time by kernel over ``steps`` more train_batch steps; returns
    the device busy ms per step and the unprofiled step's idle share."""
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
    return {"busy_ms": busy / steps / 1e3,
            "idle_share": 1 - busy / steps / 1e3 / train["step_ms"],
            "operations": n_device // steps}


def _slice_engine(zero_stage, mesh=None):
    """phase_train's gpt2-350m engine and batch at ``zero_stage``."""
    import torch

    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.gpt2 import GPT2Model, gpt2_config

    cfg = gpt2_config(SLICE_MODEL, n_positions=SLICE_SEQ,
                      dtype=torch.bfloat16, remat=False)
    ds_config = dict(_ds_config(SLICE_MICRO, SLICE_GAS),
                     zero_optimization={"stage": zero_stage})
    if mesh is not None:
        ds_config["mesh"] = mesh
    engine, _, _, _ = initialize(model=GPT2Model(cfg), config_params=ds_config)
    batch = _slice_batch(cfg.vocab_size, SLICE_GAS, SLICE_MICRO, SLICE_SEQ,
                         seed=0)
    want = {name: cfg.n_layer * SLICE_GAS * SLICE_STEPS
            for name, _ in FLASH_KERNELS}
    want.update({name: 0 for name, _ in SPARSE_KERNELS})
    return engine, batch, want


def _spread(a, b):
    """(max |loss difference|, max |master difference|) of two runs."""
    import torch

    loss = max(abs(x - y) for x, y in zip(a["losses"], b["losses"]))
    master = max(float((x.float() - y.float()).abs().max())
                 for x, y in zip(a["master"], b["master"]))
    return loss, master


def _world_of_one():
    """The torchrun variables of a world of one on a free port; returns the
    values they replaced."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    world = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK="0",
                 WORLD_SIZE="1", LOCAL_RANK="0")
    saved = {k: os.environ.get(k) for k in world}
    os.environ.update(world)
    return saved


def phase_zero(env, ref):
    """ZeRO stage 2 over NCCL in a world of one: phase_train's run (same
    seed, batch, config) with ``zero_optimization.stage`` 2 and ``mesh
    {"data": 1}`` through init_distributed(). Gates: its 10 losses and
    final master equal phase_train's stage-0 run bit for bit (else within
    the spread of two stage-0 runs, which is printed); the collectives
    counted in every step equal comm_volume_report()'s list at dp 1; B1-B3
    launch 480 times each; the same run with the post-step parameter
    gather skipped (a planted fault) fails the first gate."""
    import torch
    import torch.distributed as dist

    from deepspeed_tpu_torch import init_distributed

    saved = _world_of_one()
    try:
        init_distributed()
        if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
            raise RuntimeError(f"phase_zero: {dist.get_backend()} world of "
                               f"{dist.get_world_size()}, expected NCCL x 1")
        engine, batch, want = _slice_engine(2, mesh={"data": 1})
        report = engine.comm_volume_report()
        want_comm = sorted((c["name"], c["op"], c["dtype"], c["elements"],
                            c["count_per_step"], c["bytes_per_step"])
                           for c in report["collectives"])
        records = []
        zero = _train_steps(env, engine, batch, f"{SLICE_MODEL} ZeRO-2 NCCL",
                            SLICE_SEQ, SLICE_MICRO, SLICE_GAS, SLICE_STEPS,
                            want, after_step=lambda: records.append(
                                engine.last_step_comm))
        zero["master"] = _host_master(engine)
        for step, rec in enumerate(records, 1):
            got = sorted((c["name"], c["op"], c["dtype"], c["elements"],
                          c["count_per_step"], c["bytes_per_step"])
                         for c in rec["collectives"])
            if got != want_comm:
                raise RuntimeError(f"phase_zero step {step}: counted "
                                   f"collectives differ from the report")
        log(f"zero: NCCL world 1, stage 2: each of {len(want_comm)} "
            f"leaves all-reduced {SLICE_GAS}x per step, in "
            f"{records[-1]['calls']} NCCL calls and "
            f"{records[-1]['scalars']} scalar reductions; ring bytes "
            f"{report['total_bytes_per_step']}, the report's at dp 1")
        phase_profile(env, zero, f"{SLICE_MODEL} ZeRO-2 NCCL world 1")
        zero.pop("engine")
        del engine
        torch.cuda.empty_cache()
        # the planted fault: the compute parameters never refreshed
        engine, batch, want = _slice_engine(2, mesh={"data": 1})
        engine._gather_params = lambda: None
        fault = {"losses": [float(engine.train_batch(batch=batch))
                            for _ in range(SLICE_STEPS)],
                 "master": _host_master(engine)}
        del engine
        torch.cuda.empty_cache()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    diff = _spread(zero, ref)
    gate = (0.0, 0.0)
    if diff != gate:
        # not bit for bit: the gate is the spread of two stage-0 runs
        engine, batch, want = _slice_engine(0)
        again = {"losses": [float(engine.train_batch(batch=batch))
                            for _ in range(SLICE_STEPS)],
                 "master": _host_master(engine)}
        del engine
        torch.cuda.empty_cache()
        gate = _spread(again, ref)
        log(f"zero: stage 0 is not deterministic here: the spread of two "
            f"stage-0 runs (loss, master) = {gate}")
    planted = _spread(fault, ref)
    log(f"zero: stage 2 vs stage 0 (max |loss diff|, max |master diff|) "
        f"{diff}, gate {gate}; planted fault (gather skipped) {planted}")
    if diff[0] > gate[0] or diff[1] > gate[1]:
        raise RuntimeError(f"phase_zero: stage 2 differs from stage 0 by "
                           f"{diff}, beyond {gate}")
    if not (planted[0] > gate[0] or planted[1] > gate[1]):
        raise RuntimeError(f"phase_zero: the planted fault passed the gate "
                           f"({planted} within {gate})")
    log(f"zero: step ms (median of steps 2..{SLICE_STEPS}) stage 0 "
        f"{ref['step_ms']:.1f} / ZeRO-2 NCCL {zero['step_ms']:.1f}; tokens/s "
        f"{ref['tokens_per_s']:.0f} / {zero['tokens_per_s']:.0f}; "
        f"max_memory_allocated {ref['peak_bytes'] / 2 ** 30:.2f} / "
        f"{zero['peak_bytes'] / 2 ** 30:.2f} GiB on {env['smi']}")
    return zero


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


def _fp16_config(micro, gas):
    """The slice's step at fp16 with dynamic loss scaling (initial scale
    2**16, hysteresis 2, window 1000)."""
    cfg = _ds_config(micro, gas)
    del cfg["bf16"]
    cfg["fp16"] = {"enabled": True, "loss_scale": 0,
                   "initial_scale_power": FP16_SCALE_POWER, "hysteresis": 2}
    return cfg


def _fp16_engine():
    import torch

    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.gpt2 import GPT2Model, gpt2_config

    cfg = gpt2_config(SLICE_MODEL, n_positions=SLICE_SEQ,
                      dtype=torch.float16, remat=True,
                      remat_policy=FP16_REMAT_POLICY)
    engine, _, _, _ = initialize(model=GPT2Model(cfg),
                                 config_params=_fp16_config(SLICE_MICRO,
                                                            SLICE_GAS))
    return engine, cfg


def _fp16_steps(engine, batch, steps, env, label):
    """``steps`` train_batch calls: (losses, step ms, loss scale and skipped
    steps after each, flash launches of each step). The scale and the
    skipped count are read after each step's clock stops."""
    import torch

    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

    out = {"losses": [], "step_ms": [], "scale": [], "skipped": [],
           "launches": []}
    for _ in range(steps):
        before = dict(fa.LAUNCHES)
        t0 = time.perf_counter()
        loss = engine.train_batch(batch=batch)
        out["losses"].append(float(loss))       # syncs the step
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["scale"].append(engine.loss_scale())
        out["skipped"].append(engine.skipped_steps)
        out["launches"].append({n: fa.LAUNCHES[n] - before[n]
                                for n in before})
    torch.cuda.synchronize()
    log(f"  {label}: losses {out['losses']}")
    log(f"  {label}: loss scale {out['scale']}, skipped {out['skipped']}, "
        f"step ms {[round(x, 1) for x in out['step_ms']]} on {env['smi']}")
    return out


def phase_train_fp16(env):
    """gpt2-350m at fp16 (dynamic loss scale, remat 'attn_out'): 10 steps,
    a checkpoint saved after step 5 and loaded into a new engine, steps
    6-10 run again there: their losses must equal the uninterrupted run's
    bit for bit. Every flash kernel count is set to 0 before step 1 and
    read after step 10."""
    import shutil
    import tempfile

    import torch

    from deepspeed_tpu_torch.ops.sparse_attention import \
        block_sparse_kernel as bsk
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

    engine, cfg = _fp16_engine()
    batch = _slice_batch(cfg.vocab_size, SLICE_GAS, SLICE_MICRO, SLICE_SEQ,
                         seed=0)
    n_params = sum(p.numel() for p in engine.params)
    log(f"train fp16 {SLICE_MODEL} ({n_params / 1e6:.1f}M params) seq "
        f"{SLICE_SEQ} micro {SLICE_MICRO} gas {SLICE_GAS}, remat "
        f"{FP16_REMAT_POLICY}, dynamic loss scale 2**{FP16_SCALE_POWER}, "
        f"hysteresis 2:")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    bsk.reset_launch_counts()
    first = _fp16_steps(engine, batch, 5, env, "steps 1-5")
    save_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        t0 = time.perf_counter()
        engine.save_checkpoint(save_dir)
        save_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(root, f))
                     for root, _, files in os.walk(save_dir) for f in files)
        second = _fp16_steps(engine, batch, 5, env, "steps 6-10")
        launches = dict(fa.LAUNCHES, **bsk.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        del engine
        torch.cuda.empty_cache()
        resumed, _ = _fp16_engine()
        t0 = time.perf_counter()
        resumed.load_checkpoint(save_dir)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        rerun = _fp16_steps(resumed, batch, 5, env, "steps 6-10 resumed")
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)
    losses = first["losses"] + second["losses"]
    per_step = first["launches"] + second["launches"]
    steady = sorted((first["step_ms"] + second["step_ms"])[1:])[4]
    tokens = SLICE_MICRO * SLICE_GAS * SLICE_SEQ
    log(f"  checkpoint after step 5: save {save_s:.2f} s, load {load_s:.2f} "
        f"s (manifest verified), {nbytes} bytes ({nbytes / 2 ** 30:.2f} "
        f"GiB); steps 6-10 resumed {rerun['losses']} against "
        f"{second['losses']}")
    log(f"  step ms (median of steps 2..10) {steady:.1f} on {env['smi']}; "
        f"tokens/s {tokens / steady * 1e3:.0f}; steps/s "
        f"{1e3 / steady:.3f}; max_memory_allocated {peak / 2 ** 30:.2f} GiB")
    log(f"  flash launches per step {per_step[0]}; in 10 steps {launches}")
    if not all(x == x and abs(x) != float("inf") for x in losses):
        raise RuntimeError(f"non-finite fp16 loss: {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"fp16 loss did not fall: {losses}")
    # the forward kernel runs twice per layer and micro-batch (the remat
    # recompute, as in the JAX model), the backward sweeps once
    want = {"flash_fwd": 2 * cfg.n_layer * SLICE_GAS,
            "flash_bwd_dkdv": cfg.n_layer * SLICE_GAS,
            "flash_bwd_dq": cfg.n_layer * SLICE_GAS}
    if any(step != want for step in per_step):
        raise RuntimeError(f"fp16 flash launches per step {per_step}, "
                           f"expected {want}")
    if launches != dict({n: 10 * c for n, c in want.items()},
                        **{n: 0 for n, _ in SPARSE_KERNELS}):
        raise RuntimeError(f"fp16 launches in 10 steps: {launches}")
    if rerun["losses"] != second["losses"]:
        raise RuntimeError(f"the resumed run's losses {rerun['losses']} "
                           f"differ from the uninterrupted run's "
                           f"{second['losses']}")
    if rerun["scale"] != second["scale"] \
            or rerun["skipped"] != second["skipped"]:
        raise RuntimeError("the resumed run's loss scale or skipped steps "
                           "differ")
    return {"launches": launches, "step_ms": steady, "losses": losses,
            "engine": resumed, "batch": batch}


def phase_optimizers(env):
    """LAMB and SGD (momentum 0.9) through initialize() -> train_batch at 2
    layers of gpt2-350m, full width, bf16: 3 steps each, losses finite and
    falling."""
    import torch

    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.gpt2 import GPT2Model, gpt2_config

    cfg = gpt2_config(SLICE_MODEL, n_layer=2, n_positions=SLICE_SEQ,
                      dtype=torch.bfloat16)
    batch = _slice_batch(cfg.vocab_size, SLICE_GAS, SLICE_MICRO, SLICE_SEQ,
                         seed=3)
    for optimizer in ({"type": "Lamb", "params": {"lr": 1e-2}},
                      {"type": "SGD", "params": {"lr": 0.1,
                                                 "momentum": 0.9}}):
        ds = _ds_config(SLICE_MICRO, SLICE_GAS)
        ds["optimizer"] = optimizer
        ds.pop("scheduler")
        engine, _, _, _ = initialize(model=GPT2Model(cfg), config_params=ds)
        losses = [float(engine.train_batch(batch=batch)) for _ in range(3)]
        log(f"optimizer {optimizer['type']} ({cfg.n_layer} layers, n_embd "
            f"{cfg.n_embd}, bf16): losses {losses}")
        if not all(x == x and abs(x) != float("inf") for x in losses) \
                or not losses[-1] < losses[0]:
            raise RuntimeError(f"{optimizer['type']}: losses {losses}")
        del engine
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 16: serving (generation and the continuous-batching engine)
# ---------------------------------------------------------------------------
SERVE_REQUESTS = 32
SERVE_PROMPT_LENS = (16, 512)          # uniform, both ends included
SERVE_MAX_NEW = 64
SERVE_SLOTS = 8
SERVE_BLOCK = 16
SERVE_CHUNK = 128
SERVE_FIRST = 8                        # submitted before the first step
SERVE_SEED = 42
# the eviction pass's pool: room for 3 of the 8 lanes' longest sequences
# (1 trash block + 3 x 64 blocks of 16 positions)
SERVE_EVICT_BLOCKS = 1 + 3 * 64
# replay gate (bf16): the engine's token may score at most this far below
# the replay's best logit at any generated position: four bf16 spacings
# at the top logits' magnitude (2**-6 in [2, 4)), twice the worst deficit
# of a right engine (PERF.md section 2)
SERVE_DELTA = 0.0625
SERVE_FAULT_FACTOR = 10
# fp32 near-tie rule: a greedy token may part from generate()'s only at a
# step whose top-2 logit gap in generate()'s logits is below this, relative
TIE_REL = 1e-5
PROFILE_DECODE_STEPS = 5


def _serve_traffic(vocab):
    """32 prompts, lengths uniform in [16, 512], tokens uniform in the
    vocab, from numpy's default_rng(0); every 8th request priority 1."""
    import numpy as np

    rng = np.random.default_rng(0)
    lens = rng.integers(SERVE_PROMPT_LENS[0], SERVE_PROMPT_LENS[1] + 1,
                        SERVE_REQUESTS)
    prompts = [rng.integers(0, vocab, int(n)).astype(np.int32)
               for n in lens]
    prios = [1 if (i + 1) % 8 == 0 else 0 for i in range(SERVE_REQUESTS)]
    return prompts, prios


def _serve_model(**overrides):
    import torch

    from deepspeed_tpu_torch.models.gpt2 import GPT2Model, gpt2_config

    cfg = gpt2_config(SLICE_MODEL, **overrides)
    return GPT2Model(cfg, torch.Generator().manual_seed(SERVE_SEED))


def _serve_engine(model, **kw):
    from deepspeed_tpu_torch.serving import InferenceEngine

    kw.setdefault("max_slots", SERVE_SLOTS)
    return InferenceEngine(model, kv_block_size=SERVE_BLOCK,
                           prefill_chunk=SERVE_CHUNK, **kw)


def _drive_traffic(eng, prompts, prios):
    """8 requests before the first step, then one per step until all are
    in, then serve() to the end; returns (rids, wall seconds)."""
    import time as _time

    t0 = _time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=SERVE_MAX_NEW, priority=q)
            for p, q in zip(prompts[:SERVE_FIRST], prios[:SERVE_FIRST])]
    for p, q in zip(prompts[SERVE_FIRST:], prios[SERVE_FIRST:]):
        eng.step()
        rids.append(eng.submit(p, max_new_tokens=SERVE_MAX_NEW, priority=q))
    eng.serve()
    return rids, _time.perf_counter() - t0


def _check_finished(eng, rids, prompts, vocab, label):
    for rid, p in zip(rids, prompts):
        res = eng.results[rid]
        toks = res["tokens"]
        if res["status"] != "finished" \
                or len(toks) != len(p) + SERVE_MAX_NEW \
                or not (toks >= 0).all() or not (toks < vocab).all():
            raise RuntimeError(f"serve {label}: request {rid} "
                               f"{res['status']}, {len(toks)} tokens")


def _replay_excess(model, eng, rids, prompts):
    """Every generated position's deficit: the replay's best logit minus
    the replay's logit of the engine's token, the replay being the port's
    training forward (GPT2Model.forward: the flash kernels) over
    prompt + generated[:-1]. Returns (deficits, best logits), one array
    each per request."""
    import torch

    out, tops = [], []
    with torch.no_grad():
        for rid, p in zip(rids, prompts):
            toks = eng.results[rid]["tokens"]
            ids = torch.as_tensor(toks[:-1], device="cuda").long()[None]
            logits = model(ids)[0, len(p) - 1:].float()
            gen = torch.as_tensor(toks[len(p):], device="cuda").long()
            mine = logits.gather(1, gen[:, None])[:, 0]
            best = logits.max(dim=-1).values
            out.append((best - mine).cpu().numpy())
            tops.append(best.cpu().numpy())
    return out, tops


def _deficit_summary(replay):
    import numpy as np

    d = np.concatenate(replay[0])
    return {"n": int(d.size), "max": float(d.max()),
            "p99": float(np.percentile(d, 99)),
            "p50": float(np.percentile(d, 50)),
            "nonzero": int((d > 0).sum()),
            "top_max": float(np.abs(np.concatenate(replay[1])).max())}


def _rotated_view():
    """The planted fault: the decode step's page view gathered with every
    lane's page table rotated by one block (prefill chunks, one row,
    unchanged)."""
    import torch

    from deepspeed_tpu_torch.serving import engine as serving_engine

    plain = serving_engine._pool_view

    def rotated(pool, scales, l, tables, quantized, out_dtype):
        if tables.shape[0] > 1:
            tables = torch.roll(tables, 1, dims=1)
        return plain(pool, scales, l, tables, quantized, out_dtype)
    return rotated


def _profile_decode(env, eng, steps, max_new=SERVE_MAX_NEW,
                    label="serve decode step"):
    """Wall ms per decode-only step unprofiled, then ``steps`` steps under
    torch.profiler: device busy ms, idle share, device operations and
    device ms by kernel group per step. ``max_new`` must outlast the 15
    steps (a verify step may deliver several tokens per lane)."""
    import time as _time

    import torch
    from torch.profiler import ProfilerActivity, profile

    # 8 requests of 16 tokens, stepped until every lane decodes and no
    # prefill or queue is left
    prompts, _ = _serve_traffic(eng.cfg.vocab_size)
    for p in prompts[:SERVE_SLOTS]:
        eng.submit(p[:16], max_new_tokens=max_new)
    sch = eng.scheduler
    while len(sch.running) < SERVE_SLOTS or sch.prefilling is not None \
            or sch.queue_depth():
        eng.step()
    torch.cuda.synchronize()
    t0 = _time.perf_counter()
    for _ in range(10):
        eng.step()
    wall = (_time.perf_counter() - t0) / 10 * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = _time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        prof_wall = (_time.perf_counter() - t0) / steps * 1e3
    by_name, n_device = {}, 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name] = by_name.get(evt.name, 0.0) \
                + evt.time_range.elapsed_us()
            n_device += 1
    if not by_name:
        raise RuntimeError("the profiler recorded no device time")
    busy = sum(by_name.values()) / steps / 1e3
    if len(sch.running) != SERVE_SLOTS:
        raise RuntimeError("a lane finished inside the profiled steps")
    log(f"{label} ({SERVE_SLOTS} lanes, view "
        f"{eng.W * eng.bs} positions, {env['smi']}): wall "
        f"{wall:.2f} ms/step unprofiled, {prof_wall:.2f} profiled; "
        f"device busy {busy:.3f} ms/step; idle share of the unprofiled "
        f"step {1 - busy / wall:.3f}; {n_device // steps} device "
        f"operations per step")
    groups = {}
    for name, us in by_name.items():
        g = _kernel_group(name)
        groups[g] = groups.get(g, 0.0) + us
    for g, us in sorted(groups.items(), key=lambda x: -x[1]):
        log(f"  {g:50s} {us / steps / 1e3:9.3f} ms/step")
    for name, us in sorted(by_name.items(), key=lambda x: -x[1])[:8]:
        log(f"  {us / steps / 1e3:9.3f} ms/step  {name[:100]}")
    eng.serve()
    return {"wall_ms": wall, "busy_ms": busy, "ops": n_device // steps,
            "groups": {g: us / steps / 1e3 for g, us in groups.items()}}


def _greedy_matches(model, prompt, got_new, generate):
    """(first bad step or None, near ties): the engine's greedy tokens
    against generate()'s, generate() restarting from the engine's prefix
    after each step whose top-2 gap in generate()'s fp32 logits is below
    TIE_REL relative (the only divergence allowed)."""
    import numpy as np

    ties, done = 0, 0
    n = len(got_new)
    while done < n:
        prefix = np.concatenate([prompt, got_new[:done]])[None]
        ref, logits = generate(model, None, prefix, n - done,
                               return_logits=True)
        diff = np.flatnonzero(ref[0, prefix.shape[1]:] != got_new[done:])
        if diff.size == 0:
            return None, ties
        j = int(diff[0])
        top = np.sort(logits[0, j])[-2:]
        gap = (top[1] - top[0]) / max(abs(float(top[1])), 1e-30)
        if gap >= TIE_REL:
            return (done + j, float(gap)), ties
        ties += 1
        done += j + 1
    return None, ties


def _beam_matches_greedy(model, prompt, beam_new, generate):
    """(first bad step or None, score ties): one beam's tokens against
    greedy decoding. Beam search ranks candidates by the running
    log-probability plus the step's log-softmax, in fp32, so once the
    running score is large two candidates whose log-probabilities differ
    by less than its spacing round to one score and the top-k takes
    either; a divergence is allowed only there (the candidates' scores,
    recomputed in float64 from generate()'s logits along the same
    prefix, at most two fp32 spacings apart), and greedy decoding
    restarts from the beam's prefix."""
    import numpy as np

    ties, done, score = 0, 0, 0.0
    n = len(beam_new)
    while done < n:
        prefix = np.concatenate([prompt, beam_new[:done]])[None]
        ref, logits = generate(model, None, prefix, n - done,
                               return_logits=True)
        lg = logits[0].astype(np.float64)
        lp = lg - lg.max(-1, keepdims=True)
        lp -= np.log(np.exp(lp).sum(-1, keepdims=True))
        new = ref[0, prefix.shape[1]:]
        diff = np.flatnonzero(new != beam_new[done:])
        upto = int(diff[0]) if diff.size else n - done
        score += float(lp[np.arange(upto), new[:upto]].sum())
        if diff.size == 0:
            return None, ties
        j = upto
        a = score + lp[j, new[j]]
        b = score + lp[j, beam_new[done + j]]
        if not 0.0 <= a - b <= 2 * float(np.spacing(np.float32(abs(a)))):
            return (done + j, a - b), ties
        ties += 1
        score = b
        done += j + 1
    return None, ties


def phase_serve(env):
    """Generation and the continuous-batching engine on gpt2-350m: pass A
    (bf16, replay gate and its planted fault, fixed shapes, in-place
    pool, latency, the decode step's profile), pass B (eviction), pass C
    (int8 KV), pass D (fp32 at 2 layers: engine tokens equal generate()'s
    and generate_beam(num_beams=1)'s)."""
    import time as _time
    from unittest import mock

    import numpy as np
    import torch

    from deepspeed_tpu_torch.models.generation import (generate,
                                                       generate_beam)
    from deepspeed_tpu_torch.serving import engine as serving_engine

    model = _serve_model(dtype=torch.bfloat16)
    vocab = model.config.vocab_size
    prompts, prios = _serve_traffic(vocab)
    lens = [len(p) for p in prompts]
    log(f"serve traffic: {SERVE_REQUESTS} requests, prompts {min(lens)}-"
        f"{max(lens)} tokens (mean {np.mean(lens):.1f}), max_new "
        f"{SERVE_MAX_NEW}, greedy, {SERVE_FIRST} then 1 per step; "
        f"{SLICE_MODEL} bf16 over fp32 weights, seed {SERVE_SEED}, "
        f"{SERVE_SLOTS} slots, block {SERVE_BLOCK}, chunk {SERVE_CHUNK}")

    # -- pass A ---------------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    eng = _serve_engine(model)
    if eng.device.type != "cuda":
        raise RuntimeError(f"the engine runs on {eng.device}")
    t0 = _time.perf_counter()
    eng.warmup()
    warm_s = _time.perf_counter() - t0
    sigs = dict(eng.dispatch_shapes.signatures)
    ptrs = [t.data_ptr() for t in eng.pool.tensors.arrays]
    rids, wall = _drive_traffic(eng, prompts, prios)
    _check_finished(eng, rids, prompts, vocab, "A")
    if set(eng.dispatch_shapes.signatures) != set(sigs):
        new = set(eng.dispatch_shapes.signatures) - set(sigs)
        raise RuntimeError(f"serve A: new dispatch signatures after warmup:"
                           f" {new}")
    if [t.data_ptr() for t in eng.pool.tensors.arrays] != ptrs:
        raise RuntimeError("serve A: the pool tensors moved")
    nbytes = sum(t.numel() * t.element_size()
                 for t in eng.pool.tensors.arrays)
    if eng.pool.device_bytes() != nbytes:
        raise RuntimeError(f"serve A: device_bytes {eng.pool.device_bytes()}"
                           f" != tensors {nbytes}")
    rep = eng.serving_report()
    peak = torch.cuda.max_memory_allocated()
    gen_tokens = rep["tokens"]["generated"]
    log(f"serve A ({env['smi']}): warmup {warm_s:.1f} s, "
        f"{len(sigs)} dispatch signatures "
        f"({', '.join(eng.dispatch_shapes.names())}); traffic "
        f"{wall:.2f} s, {rep['steps']['total']} engine steps "
        f"({rep['steps']['decode']} decode), evictions "
        f"{rep['requests']['evictions']}")
    log(f"  TTFT p50 {rep['ttft_s']['p50'] * 1e3:.1f} ms, p95 "
        f"{rep['ttft_s']['p95'] * 1e3:.1f} ms; TPOT p50 "
        f"{rep['tpot_p50_s'] * 1e3:.2f} ms (mean "
        f"{rep['tpot_s'] * 1e3:.2f}); output {gen_tokens / wall:.1f} "
        f"tokens/s ({gen_tokens} tokens); peak max_memory_allocated "
        f"{peak / 2 ** 30:.2f} GiB; pool {nbytes / 1e9:.3f} GB")
    log(f"  pool.stats() {json.dumps(eng.pool.stats())}")
    model.cuda()
    deficit = _deficit_summary(_replay_excess(model, eng, rids, prompts))
    log(f"  replay gate: engine token's deficit to the replay's best "
        f"logit over {deficit['n']} positions: max {deficit['max']:.4f}, "
        f"p99 {deficit['p99']:.4f}, p50 {deficit['p50']:.4f}, "
        f"{deficit['nonzero']} positions > 0, best logits up to "
        f"{deficit['top_max']:.3f}; gate {SERVE_DELTA}")
    if not deficit["max"] <= SERVE_DELTA:
        raise RuntimeError(f"serve A: replay deficit {deficit['max']} > "
                           f"{SERVE_DELTA}")
    decode = _profile_decode(env, eng, PROFILE_DECODE_STEPS)
    del eng
    torch.cuda.empty_cache()

    # -- the planted fault ----------------------------------------------
    eng = _serve_engine(model)
    with mock.patch.object(serving_engine, "_pool_view", _rotated_view()):
        frids, _ = _drive_traffic(eng, prompts, prios)
    fault = _deficit_summary(_replay_excess(model, eng, frids, prompts))
    log(f"  planted fault (decode view's page tables rotated by one "
        f"block, the same traffic): max deficit {fault['max']:.4f} = "
        f"{fault['max'] / SERVE_DELTA:.1f} x the gate (needs "
        f">= {SERVE_FAULT_FACTOR}); p50 {fault['p50']:.4f}")
    if not fault["max"] >= SERVE_FAULT_FACTOR * SERVE_DELTA:
        raise RuntimeError("serve: the planted fault passes the replay gate")
    del eng
    torch.cuda.empty_cache()

    # -- pass B: eviction ------------------------------------------------
    eng = _serve_engine(model, kv_blocks=SERVE_EVICT_BLOCKS)
    rids, wall = _drive_traffic(eng, prompts, prios)
    _check_finished(eng, rids, prompts, vocab, "B")
    rep = eng.serving_report()
    evictions = rep["requests"]["evictions"]
    deficit_b = _deficit_summary(_replay_excess(model, eng, rids, prompts))
    log(f"serve B (kv_blocks {SERVE_EVICT_BLOCKS}): {evictions} evictions, "
        f"{rep['steps']['total']} engine steps, {wall:.2f} s, prefill "
        f"tokens computed {rep['prefix_cache']['prefill_tokens_computed']};"
        f" replay max deficit {deficit_b['max']:.4f} (p99 "
        f"{deficit_b['p99']:.4f})")
    if evictions <= 0:
        raise RuntimeError("serve B: no eviction")
    if not deficit_b["max"] <= SERVE_DELTA:
        raise RuntimeError(f"serve B: replay deficit {deficit_b['max']}")
    del eng
    torch.cuda.empty_cache()

    # -- pass C: int8 KV -------------------------------------------------
    eng = _serve_engine(model, quantize_kv=True)
    if not eng.pool.quantized:
        raise RuntimeError("serve C: int8 KV disarmed")
    rids, wall = _drive_traffic(eng, prompts, prios)
    _check_finished(eng, rids, prompts, vocab, "C")
    nbytes = sum(t.numel() * t.element_size()
                 for t in eng.pool.tensors.arrays)
    if eng.pool.device_bytes() != nbytes:
        raise RuntimeError(f"serve C: device_bytes {eng.pool.device_bytes()}"
                           f" != tensors {nbytes}")
    deficit_c = _deficit_summary(_replay_excess(model, eng, rids, prompts))
    log(f"serve C (int8 KV): {wall:.2f} s, pool {nbytes / 1e9:.3f} GB "
        f"(device_bytes equal); replay deficit against the bf16 replay, "
        f"logged only: max {deficit_c['max']:.4f}, p99 "
        f"{deficit_c['p99']:.4f}, p50 {deficit_c['p50']:.4f}")
    del eng, model
    torch.cuda.empty_cache()

    # -- pass D: fp32, 2 layers at full width ------------------------------
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("serve D needs TF32 off")
    model = _serve_model(dtype=torch.float32, n_layer=2)
    eng = _serve_engine(model)
    model.cuda()
    rids, wall = _drive_traffic(eng, prompts, prios)
    _check_finished(eng, rids, prompts, vocab, "D")
    ties = 0
    for rid, p in zip(rids, prompts):
        got = eng.results[rid]["tokens"][len(p):]
        bad, t = _greedy_matches(model, p, got, generate)
        ties += t
        if bad is not None:
            raise RuntimeError(f"serve D: request {rid} parts from "
                               f"generate() at step {bad[0]}, top-2 gap "
                               f"{bad[1]:.3g} relative")
    beam_ties = 0
    for p in prompts[:SERVE_FIRST]:
        got = generate_beam(model, None, p[None], SERVE_MAX_NEW,
                            num_beams=1)[0]
        bad, t = _beam_matches_greedy(model, p, got[len(p):], generate)
        beam_ties += t
        if bad is not None:
            raise RuntimeError("serve D: generate_beam(num_beams=1) parts "
                               f"from greedy at step {bad[0]}, candidate "
                               f"scores {bad[1]:.3g} apart")
    log(f"serve D (fp32, 2 layers, TF32 off): engine greedy tokens equal "
        f"generate()'s for all {SERVE_REQUESTS} requests with {ties} "
        f"near-tie steps (top-2 gap < {TIE_REL} relative); "
        f"generate_beam(num_beams=1) equals greedy on {SERVE_FIRST} "
        f"prompts with {beam_ties} steps where the beam's two best "
        f"candidate scores round together")
    del eng, model
    torch.cuda.empty_cache()
    return {"decode": decode, "deficit": deficit, "fault": fault}


# ---------------------------------------------------------------------------
# phases 17-18: ZeRO-Offload
# ---------------------------------------------------------------------------
# phase 18's size, fixed: stage 0 holds 18 bytes per parameter (bf16
# params 2, fp32 master 4, fp32 accumulator 4, Adam m and v 8), 75.6 GB of
# state for gpt2-4b's 4.2B parameters, beyond one 80 GB card with its
# activations; offloaded, the host holds 16 bytes per parameter (67.2 GB)
# plus two bf16 pinned staging buffers (16.8 GB). The H100 machine's host
# has 101 GiB (free -g), short of gpt2-8b's ~183 GB.
OFFLOAD_LARGE_MODEL = "gpt2-4b"
OFFLOAD_LARGE_STEPS = 3
OFFLOAD_LARGE_REMAT = "attn_out"
# the loss gate against phase 4 (PERF.md section 2): both runs start from
# the same weights and see the same gradients at step 1; the host Adam
# rounds differently from FusedAdam (1 - beta formed in fp32, fused
# multiply-adds, a float64 norm), a few fp32 ulps of the master, which
# flip a few bf16 roundings of the parameters and grow slowly: 7.1e-4
# over 10 steps on an H100 (PERF.md). A loss 1e-2 off is 5-8 % of one
# step's decrease here (0.13-0.19), what a wrong update, gradient or push
# moves within a step or two; the planted fault (no push) must read 10x
OFFLOAD_LOSS_GATE = 1e-2
OFFLOAD_FAULT_FACTOR = 10
# the planted fault's run: the first update lands at step 2 (WarmupLR
# starts at lr 0), so 3 steps show it
OFFLOAD_FAULT_STEPS = 3


def _host_info():
    """The host's CPU model, cores and memory (lscpu, free -g)."""
    lscpu = subprocess.run(["lscpu"], capture_output=True, text=True,
                           timeout=60).stdout
    keep = ("Model name", "CPU(s)", "Thread(s) per core", "Socket(s)")
    cpu = "; ".join(line.strip() for line in lscpu.splitlines()
                    if line.split(":")[0].strip() in keep)
    free = subprocess.run(["free", "-g"], capture_output=True, text=True,
                          timeout=60).stdout.splitlines()
    mem = next((line for line in free if line.startswith("Mem:")), "")
    return f"{cpu}; free -g {' '.join(mem.split())}"


def _rss():
    """(resident, peak resident) GiB of this process: VmRSS of
    /proc/self/status and getrusage's ru_maxrss (both in KiB)."""
    import resource

    rss = 0.0
    with open("/proc/self/status") as f:
        for line in f:
            key, _, value = line.partition(":")
            if key == "VmRSS":
                rss = int(value.split()[0]) / 2 ** 20
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    return rss, peak


def _release_earlier_phases():
    """Collect what earlier phases left in reference cycles and return the
    card's cached blocks, so that the offload phases' memory figures and
    the host's 96 GiB hold their own state only; returns the card's bytes
    still allocated."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def _offload_engine(model_name, micro, gas, remat_policy=None):
    """An offload engine (ZeRO stage 2, cpu_offload) over phase 4's
    config; returns (engine, model config, construction seconds)."""
    import torch

    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.gpt2 import GPT2Model, gpt2_config

    cfg = gpt2_config(model_name, n_positions=SLICE_SEQ,
                      dtype=torch.bfloat16, remat=remat_policy is not None,
                      **({"remat_policy": remat_policy} if remat_policy
                         else {}))
    ds = dict(_ds_config(micro, gas),
              zero_optimization={"stage": 2, "cpu_offload": True})
    t0 = time.perf_counter()
    # built on the card from a card generator: the constructor's own
    # initialization, which the engine's init_weights from the config's
    # seed overwrites, takes minutes on the host at gpt2-4b's size
    with torch.device("cuda"):
        model = GPT2Model(cfg, torch.Generator("cuda").manual_seed(0))
    engine, _, _, _ = initialize(model=model, config_params=ds)
    torch.cuda.synchronize()
    return engine, cfg, time.perf_counter() - t0


def _time_host_calls(engine):
    """Wrap the engine's host-side calls to time them (seconds per call):
    the host Adam, the adds of staged gradients, the push and the whole
    host step."""
    times = {"adam": [], "drain": [], "push": [], "step": []}

    def wrap(obj, attr, key):
        fn = getattr(obj, attr)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            times[key].append(time.perf_counter() - t0)
            return out
        setattr(obj, attr, timed)

    wrap(engine.optimizer, "step", "adam")
    wrap(engine, "_drain_pending_fetches", "drain")
    wrap(engine, "_push_params", "push")
    wrap(engine, "_take_model_step_offload", "step")
    return times


def _host_times_line(times, steps):
    """ms per step of each timed host call over the last ``steps``."""
    parts = []
    for key, label in (("step", "host step"), ("adam", "host Adam"),
                       ("drain", "gradient adds (all micro steps)"),
                       ("push", "push (cast + copy up)")):
        vals = times[key]
        per_step = len(vals) // max(1, len(times["step"]))
        last = vals[-steps * per_step:] if per_step else []
        parts.append(f"{label} {sum(last) / steps * 1e3:.1f}")
    return "ms per step: " + ", ".join(parts)


def _pcie_rates(engine, iters=5):
    """(D2H, H2D) GB/s of the engine's own buffers: its flat device buffer
    into pinned staging on its side stream, and pinned staging up into
    the flat buffer on the current stream, by CUDA events."""
    import torch

    src, dst, up = engine._dev_flat, engine._staging[0], engine._push_host
    nbytes = src.numel() * src.element_size()
    rates = []
    for stream, copy in ((engine._d2h_stream,
                          lambda: dst.copy_(src, non_blocking=True)),
                         (torch.cuda.current_stream(),
                          lambda: src.copy_(up, non_blocking=True))):
        with torch.cuda.stream(stream):
            copy()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                copy()
            end.record()
        end.synchronize()
        rates.append(nbytes * iters / (start.elapsed_time(end) / 1e3) / 1e9)
    return rates


def _adam_gate(env, engine):
    """One Adam step at full size on the same fp32 master and gradients:
    the port's host Adam against the device FusedAdam. The two differ in
    arithmetic, not in the update: the C++ kernel forms 1 - beta in fp32
    (1.f - beta) where FusedAdam rounds the double 1 - beta to fp32, which
    moves the step-1 update (m / sqrt(v) with bias correction, at most 1
    in size) by rho = d1 + d2 / 2 relative (d_i: the two 1 - beta_i's
    relative difference; 6.9e-6 at beta2 0.999), and each side rounds
    the update a few times more (2**-20) and the new master once. Each
    element must lie within 2 ulp(master) + lr * (rho + 2**-20). Returns
    the worst element's share of its bound and the host Adam's ms."""
    import torch

    from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam

    opt, lr = engine.optimizer, 1e-4
    n = engine._host_master.numel()
    gen = torch.Generator().manual_seed(17)
    master = engine._host_master.clone()
    grads = torch.randn(n, generator=gen) * 1e-2
    host = master.clone()
    state = opt.init_state([host])
    t0 = time.perf_counter()
    opt.step([host], [grads], state, lr=lr, grad_scale=1.0)
    host_ms = (time.perf_counter() - t0) * 1e3
    dev_opt = FusedAdam(lr=lr, betas=(opt.beta1, opt.beta2), eps=opt.eps,
                        weight_decay=opt.weight_decay,
                        adam_w_mode=opt.adamw_mode,
                        bias_correction=opt.bias_correction)
    dev = master.cuda()
    dev_opt.init_state([dev])
    dev_opt.update([dev], [grads.cuda()], lr=lr)
    dev = dev.cpu()
    f32 = torch.float32

    def rel(beta):
        one_minus = float(torch.tensor(1.0, dtype=f32)
                          - torch.tensor(beta, dtype=f32))
        rounded = float(torch.tensor(1.0 - beta, dtype=f32))
        return abs(one_minus - rounded) / rounded

    rho = rel(opt.beta1) + rel(opt.beta2) / 2
    ulp = torch.nextafter(dev.abs(), torch.tensor(float("inf"))) - dev.abs()
    bound = 2 * ulp + lr * (rho + 2.0 ** -20)
    share = float(((host - dev).abs() / bound).max())
    log(f"offload: one Adam step over {n} elements, host Adam against the "
        f"device FusedAdam on the same fp32 gradients: max |diff| "
        f"{float((host - dev).abs().max()):.3e}, worst element at "
        f"{share:.3f} of its bound (2 ulp + lr * (rho {rho:.3e} + "
        f"2**-20)); host Adam {host_ms:.1f} ms")
    del dev_opt, dev
    torch.cuda.empty_cache()
    if share > 1.0:
        raise RuntimeError(f"offload: the host Adam differs from FusedAdam "
                           f"beyond the bound ({share:.3f})")
    return share, host_ms


def phase_offload(env, stage0):
    """ZeRO-Offload of phase 4's run (gpt2-350m bf16, seq 1024, micro 8,
    gas 2, Adam, WarmupLR, clipping 1.0, seed 42): the gates of the
    module docstring's phase 17."""
    import shutil
    import tempfile

    import torch

    from deepspeed_tpu_torch.ops.sparse_attention import \
        block_sparse_kernel as bsk
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

    left = _release_earlier_phases()
    host_before = _rss()
    engine, cfg, init_s = _offload_engine(SLICE_MODEL, SLICE_MICRO,
                                          SLICE_GAS)
    mem = engine._analytic_memory_components()
    log(f"offload: {SLICE_MODEL} engine built in {init_s:.1f} s; host "
        f"{_host_info()}; OpenMP threads "
        f"{engine._host_lib.ds_get_num_threads()}, torch threads "
        f"{torch.get_num_threads()}, SIMD width "
        f"{engine._host_lib.ds_simd_width()}")
    log(f"offload: analytic bytes: device {mem['components']} + transient "
        f"{mem['transient']} = {mem['device_bytes'] / 2 ** 30:.2f} GiB; "
        f"host {mem['host']} = {mem['host_bytes'] / 2 ** 30:.2f} GiB; "
        f"host RSS before/after construction {host_before[0]:.2f} / "
        f"{_rss()[0]:.2f} GiB; card bytes left by earlier phases {left}")
    _adam_gate(env, engine)
    times = _time_host_calls(engine)
    batch = _slice_batch(cfg.vocab_size, SLICE_GAS, SLICE_MICRO, SLICE_SEQ,
                         seed=0)
    want = {name: cfg.n_layer * SLICE_GAS * SLICE_STEPS
            for name, _ in FLASH_KERNELS}
    want.update({name: 0 for name, _ in SPARSE_KERNELS})
    half = SLICE_STEPS // 2
    save_dir = tempfile.mkdtemp(prefix="chip_smoke_offload_")
    state = {"step": 0}

    def after_step():
        state["step"] += 1
        if state["step"] == half:
            t0 = time.perf_counter()
            engine.save_checkpoint(save_dir)
            state["save_s"] = time.perf_counter() - t0

    try:
        train = _train_steps(env, engine, batch, f"{SLICE_MODEL} offload",
                             SLICE_SEQ, SLICE_MICRO, SLICE_GAS, SLICE_STEPS,
                             want, after_step=after_step)
        log(f"offload: {_host_times_line(times, SLICE_STEPS - 1)} (steps "
            f"2..{SLICE_STEPS}); host RSS / peak {_rss()[0]:.2f} / "
            f"{_rss()[1]:.2f} GiB")
        d2h, h2d = _pcie_rates(engine)
        nbytes = engine._dev_flat.numel() * engine._dev_flat.element_size()
        log(f"offload: PCIe, {nbytes / 1e9:.3f} GB per copy: D2H (device "
            f"-> pinned, side stream) {d2h:.1f} GB/s, H2D (pinned -> "
            f"device) {h2d:.1f} GB/s on {env['smi']}")
        profile = phase_profile(env, train, f"{SLICE_MODEL} offload")
        train.pop("engine")
        del engine
        torch.cuda.empty_cache()
        nbytes = sum(os.path.getsize(os.path.join(root, f))
                     for root, _, files in os.walk(save_dir) for f in files)
        resumed, _, _ = _offload_engine(SLICE_MODEL, SLICE_MICRO, SLICE_GAS)
        t0 = time.perf_counter()
        resumed.load_checkpoint(save_dir)
        load_s = time.perf_counter() - t0
        rerun = [float(resumed.train_batch(batch=batch))
                 for _ in range(SLICE_STEPS - half)]
        del resumed
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)
    log(f"offload: checkpoint after step {half}: save {state['save_s']:.2f} "
        f"s, load {load_s:.2f} s, {nbytes} bytes ({nbytes / 2 ** 30:.2f} "
        f"GiB); steps {half + 1}-{SLICE_STEPS} resumed {rerun} against "
        f"{train['losses'][half:]}")
    if rerun != train["losses"][half:]:
        raise RuntimeError("offload: the resumed run's losses differ from "
                           "the uninterrupted run's")
    # the planted fault: the push skipped, the card trains on stale weights
    engine, _, _ = _offload_engine(SLICE_MODEL, SLICE_MICRO, SLICE_GAS)
    engine._push_params = lambda: None
    fault = [float(engine.train_batch(batch=batch))
             for _ in range(OFFLOAD_FAULT_STEPS)]
    del engine
    torch.cuda.empty_cache()
    diff = max(abs(a - b) for a, b in zip(train["losses"], stage0["losses"]))
    planted = max(abs(a - b) for a, b in zip(fault, stage0["losses"]))
    log(f"offload: losses against phase 4's: max |diff| {diff:.3e} (per "
        f"step {[round(a - b, 6) for a, b in zip(train['losses'], stage0['losses'])]}), "
        f"gate {OFFLOAD_LOSS_GATE}; planted fault (push skipped) {planted:.3e} "
        f"= {planted / OFFLOAD_LOSS_GATE:.1f}x the gate; its losses {fault}")
    log(f"offload: step ms (median of steps 2..{SLICE_STEPS}) stage 0 "
        f"{stage0['step_ms']:.1f} / offload {train['step_ms']:.1f}; tokens/s "
        f"{stage0['tokens_per_s']:.0f} / {train['tokens_per_s']:.0f}; idle "
        f"share {stage0['idle_share']:.3f} / {profile['idle_share']:.3f}; "
        f"device busy {profile['busy_ms']:.1f} ms/step; max_memory_allocated "
        f"{stage0['peak_bytes'] / 2 ** 30:.2f} / "
        f"{train['peak_bytes'] / 2 ** 30:.2f} GiB on {env['smi']}")
    if diff > OFFLOAD_LOSS_GATE:
        raise RuntimeError(f"offload: losses differ from phase 4's by "
                           f"{diff:.3e}, beyond {OFFLOAD_LOSS_GATE}")
    if planted < OFFLOAD_FAULT_FACTOR * OFFLOAD_LOSS_GATE:
        raise RuntimeError(f"offload: the planted fault reads {planted:.3e},"
                           f" under {OFFLOAD_FAULT_FACTOR}x the gate")
    return train


def phase_offload_large(env):
    """gpt2-4b under ZeRO-Offload: module docstring, phase 18."""
    import torch

    from deepspeed_tpu_torch.runtime import memory_accounting

    left = _release_earlier_phases()
    engine, cfg, init_s = _offload_engine(OFFLOAD_LARGE_MODEL, 1, 1,
                                          OFFLOAD_LARGE_REMAT)
    n = sum(p.numel() for p in engine.params)
    stage0 = memory_accounting.train_state_bytes(n, torch.bfloat16)
    mem = engine._analytic_memory_components()
    log(f"offload large: {OFFLOAD_LARGE_MODEL} ({n / 1e9:.3f}B params, "
        f"{cfg.n_layer} layers, n_embd {cfg.n_embd}) built in {init_s:.1f} "
        f"s; stage-0 analytic state {stage0['persistent_bytes'] / 1e9:.2f} "
        f"GB ({stage0['persistent_bytes'] / 2 ** 30:.2f} GiB); offload "
        f"analytic device {mem['device_bytes'] / 2 ** 30:.2f} GiB, host "
        f"{mem['host_bytes'] / 2 ** 30:.2f} GiB; host RSS "
        f"{_rss()[0]:.2f} GiB; card bytes left by earlier phases {left}")
    times = _time_host_calls(engine)
    batch = _slice_batch(cfg.vocab_size, 1, 1, SLICE_SEQ, seed=0)
    steps = OFFLOAD_LARGE_STEPS
    # remat attn_out runs the flash forward twice per layer
    want = {"flash_fwd": 2 * cfg.n_layer * steps,
            "flash_bwd_dkdv": cfg.n_layer * steps,
            "flash_bwd_dq": cfg.n_layer * steps}
    want.update({name: 0 for name, _ in SPARSE_KERNELS})
    train = _train_steps(env, engine, batch, f"{OFFLOAD_LARGE_MODEL} offload",
                         SLICE_SEQ, 1, 1, steps, want, falling=False)
    log(f"offload large: {_host_times_line(times, steps - 1)} (steps "
        f"2..{steps}); peak device memory {train['peak_bytes'] / 2 ** 30:.2f}"
        f" GiB against stage 0's analytic "
        f"{stage0['persistent_bytes'] / 2 ** 30:.2f} GiB of state alone; "
        f"host RSS / peak {_rss()[0]:.2f} / {_rss()[1]:.2f} GiB on "
        f"{env['smi']}")
    d2h, h2d = _pcie_rates(engine, iters=2)
    nbytes = engine._dev_flat.numel() * engine._dev_flat.element_size()
    log(f"offload large: PCIe, {nbytes / 1e9:.3f} GB per copy: D2H "
        f"{d2h:.1f} GB/s, H2D {h2d:.1f} GB/s on {env['smi']}")
    phase_profile(env, train, f"{OFFLOAD_LARGE_MODEL} offload", steps=1)
    train.pop("engine")
    del engine
    torch.cuda.empty_cache()
    return train


# ---------------------------------------------------------------------------
# phase 19: serving A10b (prefix cache, speculative decoding, sparse context)
# ---------------------------------------------------------------------------
# pass E: a shared system prompt of 24.5 blocks (every hit also COW-splits
# the 25th block at 8 trusted positions), then each request's own tail
PREFIX_LEN = 392
PREFIX_TAILS = (16, 128)               # uniform, both ends included
PREFIX_RATIO = 2                       # the JAX package's prefill guard
# the eviction sub-run's pool: 1 trash block + 96. Phase 16's 193 blocks
# never evict under this traffic once the prefix is shared (the tree
# reclaims instead); 97 evicts while shared blocks are mapped
PREFIX_EVICT_BLOCKS = 1 + 96
# the planted fault's prefix: 15 positions, all in the block a hit
# COW-splits. On pass E's traffic a skipped copy leaves 8 of 400-518
# context positions at zero, which random weights barely feel (2.2x the
# gate on an H100); here the wrong rows are the whole shared part
PREFIX_FAULT_LEN = SERVE_BLOCK - 1
SPEC_K = 3
# pass G: K = 1 + 16 = 17 of W = 64 pages; prefill_K(128) = 26
SPARSE_NARROW = {"num_sliding_window_blocks": 16, "num_global_blocks": 1}
SPARSE_FULL = {"num_sliding_window_blocks": 64, "num_global_blocks": 0}
SPARSE_REQUESTS = 16
SPARSE_PROMPT_LENS = (600, 900)        # uniform, both ends included


def _prefix_traffic(vocab, prefix_len=PREFIX_LEN):
    """32 prompts: one shared 392-token prefix, then tails of 16-128
    tokens, all from numpy's default_rng(0); priority 0."""
    import numpy as np

    rng = np.random.default_rng(0)
    prefix = rng.integers(0, vocab, prefix_len)
    tails = rng.integers(PREFIX_TAILS[0], PREFIX_TAILS[1] + 1,
                         SERVE_REQUESTS)
    prompts = [np.concatenate([prefix, rng.integers(0, vocab, int(n))])
               .astype(np.int32) for n in tails]
    return prompts, [0] * SERVE_REQUESTS


def _long_traffic(vocab):
    """16 prompts of 600-900 tokens from numpy's default_rng(0)."""
    import numpy as np

    rng = np.random.default_rng(0)
    lens = rng.integers(SPARSE_PROMPT_LENS[0], SPARSE_PROMPT_LENS[1] + 1,
                        SPARSE_REQUESTS)
    return ([rng.integers(0, vocab, int(n)).astype(np.int32) for n in lens],
            [0] * SPARSE_REQUESTS)


def _dispatch_counts(eng):
    out = {}
    for sig, n in eng.dispatch_shapes.signatures.items():
        out[sig[0]] = out.get(sig[0], 0) + n
    return out


def _a10b_pass(env, model, label, prompts, prios, warm=True, **kw):
    """One pass of phase 19: warmup(), the traffic, and the gates every
    pass holds (requests finished in vocab, no new dispatch signature
    after warmup, the pool tensors never moved); logs the latency line
    and pool.stats(). Returns (engine, rids, report, dispatches by name
    during the traffic)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    eng = _serve_engine(model, **kw)
    if warm:
        eng.warmup()
    sigs = set(eng.dispatch_shapes.signatures)
    before = _dispatch_counts(eng)
    ptrs = [t.data_ptr() for t in eng.pool.tensors.arrays]
    rids, wall = _drive_traffic(eng, prompts, prios)
    _check_finished(eng, rids, prompts, model.config.vocab_size, label)
    if warm and set(eng.dispatch_shapes.signatures) != sigs:
        raise RuntimeError(f"serve {label}: new dispatch signatures after "
                           f"warmup: {set(eng.dispatch_shapes.signatures) - sigs}")
    if [t.data_ptr() for t in eng.pool.tensors.arrays] != ptrs:
        raise RuntimeError(f"serve {label}: the pool tensors moved")
    counts = {k: v - before.get(k, 0)
              for k, v in _dispatch_counts(eng).items()}
    rep = eng.serving_report()
    gen = rep["tokens"]["generated"]
    log(f"serve {label} ({env['smi']}): {len(rids)} requests, "
        f"{rep['steps']['total']} engine steps ({rep['steps']['decode']} "
        f"decode), {wall:.2f} s; TTFT p50 "
        f"{rep['ttft_s']['p50'] * 1e3:.1f} ms, p95 "
        f"{rep['ttft_s']['p95'] * 1e3:.1f} ms; TPOT p50 "
        f"{rep['tpot_p50_s'] * 1e3:.2f} ms; output {gen / wall:.1f} "
        f"tokens/s; peak max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
        f"dispatches {json.dumps(counts, sort_keys=True)}")
    log(f"  pool.stats() {json.dumps(eng.pool.stats())}")
    return eng, rids, rep, counts


def _gate(label, replay, fault=None):
    """The replay gate on every generated token, and the planted fault's
    reading at >= SERVE_FAULT_FACTOR x the gate."""
    log(f"  {label} replay gate: max deficit {replay['max']:.4f} over "
        f"{replay['n']} positions (p99 {replay['p99']:.4f}, "
        f"{replay['nonzero']} > 0); gate {SERVE_DELTA}")
    if not replay["max"] <= SERVE_DELTA:
        raise RuntimeError(f"serve {label}: replay deficit "
                           f"{replay['max']} > {SERVE_DELTA}")
    if fault is None:
        return
    log(f"  {label} planted fault: max deficit {fault['max']:.4f} = "
        f"{fault['max'] / SERVE_DELTA:.1f} x the gate (needs >= "
        f"{SERVE_FAULT_FACTOR})")
    if not fault["max"] >= SERVE_FAULT_FACTOR * SERVE_DELTA:
        raise RuntimeError(f"serve {label}: the planted fault passes the "
                           f"replay gate")


def _policy_replay_excess(eng, rids, prompts, sparse):
    """_replay_excess against a plain masked forward: the engine's own
    decode math (models/generation.py) over prompt + generated[:-1]
    with each query restricted to the policy's token mask
    (layout_to_token_mask of SparseContext.layout()) and the causal
    mask."""
    import torch

    from deepspeed_tpu_torch.models.generation import (_attn_core, _dense,
                                                       _ffn, _lm_logits,
                                                       _ln, _split_heads)
    from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention \
        import layout_to_token_mask

    params, cfg, dev = eng.params, eng.cfg, eng.device
    H, D, eps = cfg.n_head, cfg.head_dim, cfg.layer_norm_epsilon
    policy = layout_to_token_mask(sparse.layout()[None], sparse.bs,
                                  device=dev)[0]
    out, tops = [], []
    with torch.no_grad():
        for rid, p in zip(rids, prompts):
            toks = eng.results[rid]["tokens"]
            ids = torch.as_tensor(toks[:-1], device=dev).long()
            T = ids.numel()
            allowed = (policy[:T, :T] & torch.ones(
                T, T, dtype=torch.bool, device=dev).tril())[None, None]
            x = (params["wte"][ids] + params["wpe"][:T])[None]
            for bp in params["blocks"]:
                h = _ln(x, bp["ln_1"], eps)
                q, k, v = (_split_heads(t, 1, T, H, D) for t in
                           _dense(h, bp["attn"]["c_attn"])
                           .split(cfg.n_embd, dim=-1))
                x = x + _attn_core(q, k, v, allowed, bp["attn"], x.dtype)
                x = x + _ffn(_ln(x, bp["ln_2"], eps), bp)
            x = _ln(x, params["ln_f"], eps)
            logits = _lm_logits(params, cfg, x[0, len(p) - 1:])
            gen = torch.as_tensor(toks[len(p):], device=dev).long()
            best = logits.max(dim=-1).values
            out.append((best - logits.gather(1, gen[:, None])[:, 0])
                       .cpu().numpy())
            tops.append(best.cpu().numpy())
    return out, tops


def _shifted_sbase():
    """The planted fault of pass G: every live view base of the sparse
    gather rows, decode and prefill, shifted one block up."""
    import numpy as np

    from deepspeed_tpu_torch.serving.sparse_context import SparseContext

    def shift(fn):
        def wrapped(self, *args):
            stables, sbase = fn(self, *args)
            return stables, np.where(sbase != self.sentinel,
                                     sbase + self.bs, sbase)
        return wrapped
    return {"active_row": shift(SparseContext.active_row),
            "prefill_active_row": shift(SparseContext.prefill_active_row)}


def _accept_one_more(plain):
    """The planted fault of pass F: where a lane's drafts stop matching
    below its budget, the first draft past the matched prefix is accepted
    as if it had matched: it is delivered in place of the bonus token,
    and the dispatch's token after it becomes the new bonus. The fault's
    run drafts a constant token (the JAX package's rigged constant
    drafter): the n-gram drafter proposes tokens the model produced
    before, which random weights score within 0.59 of their best logit
    (9.5x the gate on an H100), so an accepted miss of it hides."""
    def accepted(drafts, row, nvalid):
        m = plain(drafts, row, nvalid)
        if m < min(len(drafts) + 1, int(nvalid)):
            row[m - 1] = drafts[m - 1]
            return m + 1
        return m
    return accepted


def _profile_line(label, prof, dense):
    """The pass's decode (or verify) step beside phase 16's dense decode
    step: wall and device ms, the copy/element-wise and GEMM groups."""
    other = "other (elementwise, norms, reductions, optimizer)"
    gemm = "GEMM (cuBLAS)"
    log(f"  {label} step vs phase 16's dense decode step: wall "
        f"{prof['wall_ms']:.2f} vs {dense['wall_ms']:.2f} ms, device "
        f"{prof['busy_ms']:.3f} vs {dense['busy_ms']:.3f} ms (copies and "
        f"element-wise {prof['groups'].get(other, 0.0):.3f} vs "
        f"{dense['groups'].get(other, 0.0):.3f}, GEMM "
        f"{prof['groups'].get(gemm, 0.0):.3f} vs "
        f"{dense['groups'].get(gemm, 0.0):.3f}), operations {prof['ops']} "
        f"vs {dense['ops']}")


def phase_serve_a10b(env, dense):
    """The serving prefix cache, speculative decoding and the sparse page
    context on gpt2-350m: module docstring, phase 19. ``dense`` is phase
    16's decode profile, printed beside each pass's."""
    from unittest import mock

    import numpy as np
    import torch

    from deepspeed_tpu_torch.models.generation import generate
    from deepspeed_tpu_torch.serving import engine as serving_engine
    from deepspeed_tpu_torch.serving.kv_cache import PagedKVPool
    from deepspeed_tpu_torch.serving.sparse_context import SparseContext

    model = _serve_model(dtype=torch.bfloat16)
    vocab = model.config.vocab_size
    steps = PROFILE_DECODE_STEPS
    out = {}

    # -- pass E: prefix cache ---------------------------------------------
    prompts, prios = _prefix_traffic(vocab)
    log(f"serve E traffic: {len(prompts)} requests, a shared "
        f"{PREFIX_LEN}-token prefix + tails {PREFIX_TAILS[0]}-"
        f"{PREFIX_TAILS[1]} (prompts {min(map(len, prompts))}-"
        f"{max(map(len, prompts))} tokens), {SERVE_MAX_NEW} new tokens")
    off, off_rids, off_rep, _ = _a10b_pass(env, model, "E (cache off)",
                                           prompts, prios)
    dense_tokens = [off.results[r]["tokens"] for r in off_rids]
    del off
    eng, rids, rep, _ = _a10b_pass(env, model, "E (prefix cache)", prompts,
                                   prios, prefix_cache=True)
    model.cuda()
    pc, st = rep["prefix_cache"], eng.pool.stats()
    c_off = off_rep["prefix_cache"]["prefill_tokens_computed"]
    c_on = pc["prefill_tokens_computed"]
    log(f"  prefill tokens computed {c_on} with the cache against {c_off} "
        f"without ({c_off / max(c_on, 1):.2f}x fewer; gate "
        f">= {PREFIX_RATIO}x); lookups {pc['lookups']}, hits {pc['hits']},"
        f" avoided {pc['avoided_prefill_tokens']}; COW splits "
        f"{st['prefix_cow_splits']}; TTFT p50 "
        f"{rep['ttft_s']['p50'] * 1e3:.1f} ms against "
        f"{off_rep['ttft_s']['p50'] * 1e3:.1f} without")
    if not c_off >= PREFIX_RATIO * c_on:
        raise RuntimeError(f"serve E: the cache computed {c_on} prefill "
                           f"tokens against {c_off} without")
    if pc["hits"] < 1 or st["prefix_cow_splits"] < 1:
        raise RuntimeError(f"serve E: hits {pc['hits']}, COW splits "
                           f"{st['prefix_cow_splits']}")
    replay = _deficit_summary(_replay_excess(model, eng, rids, prompts))
    out["E"] = {"profile": _profile_decode(env, eng, steps,
                                           label="serve E decode step")}
    _profile_line("E decode", out["E"]["profile"], dense)
    del eng
    faults = {}
    for plen in (PREFIX_LEN, PREFIX_FAULT_LEN):
        fprompts, _ = _prefix_traffic(vocab, plen)
        with mock.patch.object(PagedKVPool, "_cow_copy",
                               lambda self, src, dst: None):
            bad, brids, _, _ = _a10b_pass(
                env, model, f"E (fault: COW copy skipped, prefix {plen})",
                fprompts, prios, warm=False, prefix_cache=True)
        faults[plen] = _deficit_summary(_replay_excess(model, bad, brids,
                                                       fprompts))
        del bad
    log(f"  E planted fault on pass E's own traffic (logged only): max "
        f"deficit {faults[PREFIX_LEN]['max']:.4f} = "
        f"{faults[PREFIX_LEN]['max'] / SERVE_DELTA:.1f} x the gate")
    _gate("E", replay, faults[PREFIX_FAULT_LEN])
    # the eviction sub-run: each eviction notes the refs the tree's
    # blocks held at that moment
    eng = _serve_engine(model, prefix_cache=True,
                        kv_blocks=PREFIX_EVICT_BLOCKS)
    live, evict = [], eng._evict

    def counted(req, events):
        live.append(eng.pool.stats()["prefix_shared_refs"])
        evict(req, events)
    eng._evict = counted
    rids, _ = _drive_traffic(eng, prompts, prios)
    _check_finished(eng, rids, prompts, vocab, "E (eviction)")
    shared_live = sum(1 for n in live if n > 0)
    log(f"  eviction sub-run (kv_blocks {PREFIX_EVICT_BLOCKS}): {len(live)} "
        f"evictions, {shared_live} of them "
        f"while shared blocks were mapped; reclaims "
        f"{eng.pool.stats()['prefix_cache_reclaims']}")
    if shared_live < 1:
        raise RuntimeError("serve E: no eviction while shared blocks were "
                           "live")
    _gate("E (eviction)", _deficit_summary(
        _replay_excess(model, eng, rids, prompts)))
    del eng
    torch.cuda.empty_cache()

    # -- pass H: sparse context, full window (E's traffic) ----------------
    eng, rids, rep, _ = _a10b_pass(env, model, "H (sparse, full window)",
                                   prompts, prios,
                                   sparse_context=SPARSE_FULL)
    if eng.sparse is None or eng.sparse.K != eng.W:
        raise RuntimeError("serve H: the full window did not arm at K = W")
    same = sum(bool(np.array_equal(eng.results[r]["tokens"], t))
               for r, t in zip(rids, dense_tokens))
    log(f"  H: {same} of {len(rids)} requests equal the dense engine's "
        f"tokens (E, cache off) bit for bit; active page fraction "
        f"{rep['sparse_context']['active_page_fraction']}")
    if same != len(rids):
        raise RuntimeError(f"serve H: {len(rids) - same} requests differ "
                           f"from the dense engine's")
    out["H"] = {"profile": _profile_decode(env, eng, steps,
                                           label="serve H sparse decode")}
    _profile_line("H sparse decode", out["H"]["profile"], dense)
    del eng
    torch.cuda.empty_cache()

    # -- pass F: speculative decoding ---------------------------------------
    prompts, prios = _serve_traffic(vocab)
    eng, rids, rep, counts = _a10b_pass(env, model, f"F (speculative="
                                        f"{SPEC_K})", prompts, prios,
                                        speculative=SPEC_K)
    sp = rep["speculative"]
    hist = sp["accept_len_hist"]
    gen = rep["tokens"]["generated"]
    verifies = counts.get("spec_verify", 0)
    log(f"  accept histogram {json.dumps(hist)}; accepted "
        f"{sp['accepted_tokens']} tokens in {sp['verify_steps']} lane "
        f"verifies ({sp['tokens_per_verify']:.3f} per verify); "
        f"{verifies} verify dispatches for {gen} output tokens "
        f"({verifies / gen:.4f} decode dispatches per output token)")
    if sum(int(k) * v for k, v in hist.items()) != sp["accepted_tokens"]:
        raise RuntimeError(f"serve F: histogram {hist} does not sum to "
                           f"{sp['accepted_tokens']}")
    if not 0 < verifies < gen:
        raise RuntimeError(f"serve F: {verifies} verify dispatches for "
                           f"{gen} tokens")
    replay = _deficit_summary(_replay_excess(model, eng, rids, prompts))
    out["F"] = {"profile": _profile_decode(env, eng, steps, max_new=512,
                                           label="serve F verify step")}
    _profile_line("F verify", out["F"]["profile"], dense)
    del eng
    with mock.patch.object(serving_engine, "_accepted",
                           _accept_one_more(serving_engine._accepted)), \
            mock.patch.object(serving_engine.InferenceEngine,
                              "_draft_tokens",
                              lambda self, req, k: [vocab - 1] * k):
        bad, brids, _, _ = _a10b_pass(env, model, "F (fault: one draft "
                                      "beyond the match)", prompts, prios,
                                      warm=False, speculative=SPEC_K)
    fault = _deficit_summary(_replay_excess(model, bad, brids, prompts))
    _gate("F", replay, fault)
    del bad, model
    torch.cuda.empty_cache()
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("serve F (fp32) needs TF32 off")
    model32 = _serve_model(dtype=torch.float32, n_layer=2)
    eng = _serve_engine(model32, speculative=SPEC_K)
    model32.cuda()
    rids, _ = _drive_traffic(eng, prompts, prios)
    _check_finished(eng, rids, prompts, vocab, "F (fp32)")
    ties = 0
    for rid, p in zip(rids, prompts):
        bad_step, t = _greedy_matches(model32, p,
                                      eng.results[rid]["tokens"][len(p):],
                                      generate)
        ties += t
        if bad_step is not None:
            raise RuntimeError(f"serve F (fp32): request {rid} parts from "
                               f"generate() at step {bad_step[0]}, top-2 "
                               f"gap {bad_step[1]:.3g} relative")
    log(f"serve F (fp32, 2 layers, TF32 off, speculative={SPEC_K}): engine "
        f"greedy tokens equal generate()'s for all {len(rids)} requests "
        f"with {ties} near-tie steps (top-2 gap < {TIE_REL} relative); "
        f"{eng.metrics.tokens_per_verify():.3f} tokens per verify")
    del eng, model32
    torch.cuda.empty_cache()

    # -- pass G: sparse context, narrow window --------------------------------
    model = _serve_model(dtype=torch.bfloat16)
    prompts, prios = _long_traffic(vocab)
    eng, rids, rep, _ = _a10b_pass(env, model, "G (sparse, window 16 + 1 "
                                   "global)", prompts, prios,
                                   sparse_context=SPARSE_NARROW)
    sparse = eng.sparse
    sc = rep["sparse_context"]
    want = sparse.lut.shape[1] / eng.W
    log(f"  G: K {sparse.K} of W {eng.W} pages, prefill_K("
        f"{SERVE_CHUNK}) {sparse.prefill_K(SERVE_CHUNK)}; active page "
        f"fraction {sc['active_page_fraction']} (the LUT's {want}); "
        f"active pages per lane step {sc['active_pages_per_lane_step']}; "
        f"window-expired frees {sc['window_expired_frees']}")
    if sc["active_page_fraction"] != want:
        raise RuntimeError(f"serve G: active page fraction "
                           f"{sc['active_page_fraction']} != {want}")
    if not sc["window_expired_frees"] > 0:
        raise RuntimeError("serve G: no window-expired frees")
    model.cuda()
    replay = _deficit_summary(_policy_replay_excess(eng, rids, prompts,
                                                    sparse))
    dense_replay = _deficit_summary(_replay_excess(model, eng, rids,
                                                   prompts))
    log(f"  G against the dense replay (flash, no policy; logged only): "
        f"max deficit {dense_replay['max']:.4f}, p50 "
        f"{dense_replay['p50']:.4f}")
    out["G"] = {"profile": _profile_decode(env, eng, steps,
                                           label="serve G sparse decode")}
    _profile_line("G sparse decode", out["G"]["profile"], dense)
    del eng
    with mock.patch.multiple(SparseContext, **_shifted_sbase()):
        bad, brids, _, _ = _a10b_pass(env, model, "G (fault: sbase "
                                      "shifted one block)", prompts, prios,
                                      warm=False,
                                      sparse_context=SPARSE_NARROW)
    fault = _deficit_summary(_policy_replay_excess(bad, brids, prompts,
                                                   sparse))
    _gate("G (plain masked forward)", replay, fault)
    del bad, model
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 20: telemetry and accounting (ROADMAP A17)
# ---------------------------------------------------------------------------
TEL_PRINT_EVERY = 5
TEL_SERVE_REQUESTS = 8
TEL_TOLERANCE = 0.15


def _closed_form_step_flops(cfg, micro, seq, gas):
    """One optimizer step's hardware FLOPs of a GPT-2 (no dropout, no
    remat): per layer the four matmuls forward, 2 T E (3E + E + 4E + 4E) =
    24 T E^2, and twice that backward; the tied LM head over the T' =
    micro (seq - 1) shifted tokens and the padded vocabulary forward, its
    chunk recomputed in the backward and its two backward products; per
    layer one flash forward, dK/dV and dQ sweep at their own FLOP formulas
    (ops/transformer/flash_attention.py)."""
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

    e, n_layer, vocab = cfg.n_embd, cfg.n_layer, cfg.padded_vocab_size
    t, t1 = micro * seq, micro * (seq - 1)
    bh, d = micro * cfg.n_head, cfg.head_dim
    kernels = sum(fn(bh, seq, seq, d, True, cfg.dtype)
                  for fn in fa.FLOPS.values())
    return gas * (n_layer * (72 * t * e * e + kernels)
                  + 4 * 2 * t1 * e * vocab)


def _telemetry_run(engine, batch, steps):
    """``steps`` train_batch calls, each synced by its loss; returns
    (losses, step ms, launches)."""
    import torch

    from deepspeed_tpu_torch.ops.sparse_attention import \
        block_sparse_kernel as bsk
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

    fa.reset_launch_counts()
    bsk.reset_launch_counts()
    losses, step_ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch=batch)))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return losses, step_ms, dict(fa.LAUNCHES, **bsk.LAUNCHES)


def phase_telemetry(env, ref):
    """Telemetry on the slice's train step and serving engine: module
    docstring, phase 20. ``ref`` is phase 4's run."""
    import shutil
    import tempfile
    from unittest import mock

    import torch

    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.gpt2 import GPT2Model, gpt2_config
    from deepspeed_tpu_torch.runtime import memory_accounting as mem_acc
    from deepspeed_tpu_torch.telemetry.metrics import MetricsStream
    from deepspeed_tpu_torch.utils.tb_writer import read_events

    out = tempfile.mkdtemp(prefix="telemetry_")
    # what earlier phases left in reference cycles would sit in the
    # disarmed run's peak only
    _release_earlier_phases()
    try:
        cfg = gpt2_config(SLICE_MODEL, n_positions=SLICE_SEQ,
                          dtype=torch.bfloat16, remat=False)
        batch = _slice_batch(cfg.vocab_size, SLICE_GAS, SLICE_MICRO,
                             SLICE_SEQ, seed=0)
        ds = dict(_ds_config(SLICE_MICRO, SLICE_GAS),
                  steps_per_print=TEL_PRINT_EVERY)
        engine = initialize(model=GPT2Model(cfg), config_params=ds)[0]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        off_losses, off_ms, _ = _telemetry_run(engine, batch, SLICE_STEPS)
        off_peak = torch.cuda.max_memory_allocated()
        del engine
        _release_earlier_phases()

        def armed_config(jsonl, job):
            tel = {"enabled": True, "trace": True, "mfu": True,
                   "memory": True}
            if jsonl:
                tel["metrics_jsonl"] = jsonl
            return dict(ds, telemetry=tel,
                        flops_profiler={"enabled": True, "profile_step": 2},
                        tensorboard={"enabled": True, "output_path": out,
                                     "job_name": job})

        # armed without the stream: what the stream's fetch adds is the
        # difference to the armed run below
        engine = initialize(model=GPT2Model(cfg),
                            config_params=armed_config(None, "nostream"))[0]
        nostream_losses, nostream_ms, _ = _telemetry_run(engine, batch,
                                                         SLICE_STEPS)
        del engine
        _release_earlier_phases()

        jsonl = os.path.join(out, "metrics.jsonl")
        engine = initialize(model=GPT2Model(cfg),
                            config_params=armed_config(jsonl, "armed"))[0]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # every reset the engine makes, observed: the peak before it
        real_reset, seen = torch.cuda.reset_peak_memory_stats, [0]

        def observed_reset(device=None):
            seen[0] = max(seen[0], torch.cuda.max_memory_allocated(device))
            real_reset(device)

        with mock.patch.object(torch.cuda, "reset_peak_memory_stats",
                               observed_reset):
            losses, on_ms, launches = _telemetry_run(engine, batch,
                                                     SLICE_STEPS)
        unreset_peak = max(seen[0], torch.cuda.max_memory_allocated())
        tel = engine.telemetry
        med = [sorted(x[1:])[len(x[1:]) // 2]
               for x in (off_ms, nostream_ms, on_ms)]

        # (a) what the armed run computes
        log(f"telemetry (a): armed losses {[round(x, 4) for x in losses]}")
        if losses != ref["losses"] or losses != off_losses \
                or nostream_losses != off_losses:
            raise RuntimeError(f"telemetry: armed losses {losses} (without "
                               f"the stream {nostream_losses}) differ from "
                               f"phase 4's {ref['losses']} or the disarmed "
                               f"run's {off_losses}")
        if launches != ref["launches"]:
            raise RuntimeError(f"telemetry: launches {launches}, phase 4 "
                               f"{ref['launches']}")
        log(f"  bit for bit phase 4's and the disarmed run's; launches "
            f"{launches}")

        # (b) MFU
        report = engine.telemetry_report()
        mfu = report["mfu"]
        want = _closed_form_step_flops(cfg, SLICE_MICRO, SLICE_SEQ,
                                       SLICE_GAS)
        log(f"telemetry (b) on {env['smi']}: MFU {mfu['mfu']:.4f}, HFU "
            f"{mfu['hfu']:.4f}, achieved {mfu['achieved_tflops_per_device']:.1f}"
            f" model TFLOP/s and {mfu['achieved_hw_tflops_per_device']:.1f}"
            f" hardware TFLOP/s (peak {mfu['peak_flops_per_device'] / 1e12:g}"
            f" TFLOP/s for {mfu['device_kind']}); model FLOPs/step "
            f"{mfu['model_flops_per_step']:.6g}, hardware "
            f"{mfu['hw_flops_per_step']:.6g} (closed form {want:.6g}; "
            f"kernels {mfu['per_jit']['micro_step']['kernel_flops']} per "
            f"micro step); telemetry step time "
            f"{mfu['step_time_s'] * 1e3:.1f} ms (mean between step "
            f"boundaries, the profile step's included); at the synced "
            f"median step {med[2]:.2f} ms MFU "
            f"{mfu['model_flops_per_step'] / (med[2] / 1e3) / mfu['peak_flops_per_device']:.4f}"
            f", HFU "
            f"{mfu['hw_flops_per_step'] / (med[2] / 1e3) / mfu['peak_flops_per_device']:.4f}")
        if mfu["device_kind"] != env["name"] or not mfu["peak_known"]:
            raise RuntimeError(f"telemetry: MFU report names "
                               f"{mfu['device_kind']!r}, peak known "
                               f"{mfu['peak_known']}")
        if mfu["hw_flops_per_step"] != want:
            raise RuntimeError(f"telemetry: hardware FLOPs "
                               f"{mfu['hw_flops_per_step']} != closed form "
                               f"{want}")
        if not mfu["hfu"] >= mfu["mfu"] > 0:
            raise RuntimeError(f"telemetry: HFU {mfu['hfu']} < MFU "
                               f"{mfu['mfu']}")

        # (c) memory
        mem = report["memory"]
        dev = mem["devices"][0]
        state = mem["measured"]["train_state"]
        check = mem["cross_check"]["train_state"]
        analytic = mem["analytic"]["persistent_bytes"]
        micro = mem["measured"]["micro_step"]
        log(f"telemetry (c) on {env['smi']}: device peak "
            f"{dev['peak_bytes_in_use']} B (unreset max_memory_allocated "
            f"{unreset_peak}; the disarmed run's {off_peak}), in use at the "
            f"step boundary {state['in_use_bytes']} B, analytic persistent "
            f"{analytic} B (ratio {check['ratio']:.4f}), micro step "
            f"transient {micro['transient_bytes']} B, apply step "
            f"{mem['measured']['apply_step']['transient_bytes']} B, limit "
            f"{dev['bytes_limit']} B")
        if dev["peak_bytes_in_use"] != unreset_peak:
            raise RuntimeError(f"telemetry: report peak "
                               f"{dev['peak_bytes_in_use']} != unreset "
                               f"{unreset_peak}")
        if not analytic <= state["in_use_bytes"] or check["underestimated"]:
            raise RuntimeError(f"telemetry: analytic {analytic} vs in use "
                               f"{state['in_use_bytes']}: {check}")
        opt = mem["analytic"]["components"]["optimizer_state_bytes"]
        acct = engine._memacct
        acct.expect("train_state", "planted fault: no optimizer state",
                    analytic - opt, field="in_use_bytes")
        planted = acct.cross_check(warn=False)["train_state"]
        log(f"  planted fault (optimizer state left out): ratio "
            f"{planted['ratio']:.4f}, underestimated "
            f"{planted['underestimated']}")
        if not planted["underestimated"]:
            raise RuntimeError("telemetry: the planted fault passed the "
                               "cross-check")

        # (d) the trace
        path = engine.export_trace(os.path.join(out, "trace.json"))
        trace = json.load(open(path))
        lanes = {e["tid"]: e["args"]["name"] for e in trace["traceEvents"]
                 if e["name"] == "thread_name"}
        steps, cur = [], {}
        for e in trace["traceEvents"]:
            if e["ph"] != "X" or lanes.get(e["tid"]) != "train":
                continue
            cur[e["name"]] = cur.get(e["name"], 0) + 1
            if e["name"] == "optimizer_step":
                steps.append(cur)
                cur = {}
        dropped = trace["otherData"]["dropped_events"]
        log(f"telemetry (d): {len(trace['traceEvents'])} trace events, "
            f"lanes {sorted(lanes.values())}, {dropped} dropped; spans per "
            f"step {steps[0]}; trace summary {report['trace']}")
        per_step = {"forward_micro": SLICE_GAS, "backward_micro": SLICE_GAS,
                    "optimizer_step": 1}
        if len(steps) != SLICE_STEPS or any(st != per_step for st in steps) \
                or dropped:
            raise RuntimeError(f"telemetry: train spans per step {steps}, "
                               f"{dropped} dropped")

        # (e) the metrics stream
        engine.close_telemetry()
        records = MetricsStream.replay(jsonl)
        log(f"telemetry (e): {len(records)} records; keys "
            f"{sorted(records[0])}")
        if [r["loss"] for r in records] != losses:
            raise RuntimeError("telemetry: the stream's losses differ from "
                               "the returned ones")

        # (f) TensorBoard
        events = read_events(engine.summary_writer.path)
        scalars = {(e["step"], tag): v for e in events
                   for tag, v in e.get("scalars", {}).items()}
        by_step = {r["step"]: r for r in records}
        for step in range(TEL_PRINT_EVERY, SLICE_STEPS + 1, TEL_PRINT_EVERY):
            got = scalars.get((step, "Train/Samples/grad_norm"))
            want_norm = float(torch.tensor(by_step[step]["grad_norm"],
                                           dtype=torch.float32))
            if got != want_norm or (step, "Train/Samples/lr") not in scalars:
                raise RuntimeError(f"telemetry: TensorBoard step {step}: "
                                   f"grad_norm {got} != {want_norm}")
        log(f"telemetry (f): {len(events)} TensorBoard records, CRCs good, "
            f"scalars {sorted(scalars.items())}")

        # (g) what arming costs the step
        log(f"telemetry (g) on {env['smi']}: step ms (median of steps "
            f"2..{SLICE_STEPS}, each step synced by its loss) disarmed "
            f"{med[0]:.2f}, armed without the stream {med[1]:.2f} "
            f"({med[1] - med[0]:+.2f}), armed {med[2]:.2f} "
            f"({med[2] - med[0]:+.2f} ms, {(med[2] / med[0] - 1) * 100:+.2f}"
            f" %); the telemetry's host step time {tel.step_time_s() * 1e3:.2f}"
            f" ms (mean of {tel.step_time_hist.count} intervals); steps "
            f"disarmed {[round(x, 1) for x in off_ms]}, without the stream "
            f"{[round(x, 1) for x in nostream_ms]}, armed "
            f"{[round(x, 1) for x in on_ms]}")
        del engine, tel, report
        _release_earlier_phases()
        _telemetry_serve(env, out)
    finally:
        shutil.rmtree(out, ignore_errors=True)


def _telemetry_serve(env, out):
    """Phase 16's pass A traffic, its first TEL_SERVE_REQUESTS requests,
    unarmed and armed."""
    import torch

    from deepspeed_tpu_torch.telemetry.metrics import MetricsStream

    model = _serve_model(dtype=torch.bfloat16)
    vocab = model.config.vocab_size
    prompts, prios = _serve_traffic(vocab)
    prompts = prompts[:TEL_SERVE_REQUESTS]
    prios = prios[:TEL_SERVE_REQUESTS]
    tokens = []
    for telemetry in (None, {"metrics_jsonl":
                             os.path.join(out, "serve.jsonl")}):
        eng = _serve_engine(model, telemetry=telemetry)
        eng.warmup()
        if telemetry is not None:
            eng.telemetry.tracer.reset()        # the traffic's spans only
        rids, wall = _drive_traffic(eng, prompts, prios)
        _check_finished(eng, rids, prompts, vocab, "telemetry")
        tokens.append([eng.results[r]["tokens"].tolist() for r in rids])
    if tokens[0] != tokens[1]:
        raise RuntimeError("telemetry serve: arming changed the tokens")
    rep = eng.telemetry_report()
    pool = sum(t.numel() * t.element_size()
               for t in eng.pool.tensors.arrays)
    got_pool = rep["memory"]["analytic"]["components"]["kv_pool_bytes"]
    names = [e["name"] for e in eng.telemetry.tracer.events()]
    n_steps = eng._step_idx
    eng.close_telemetry()
    records = MetricsStream.replay(os.path.join(out, "serve.jsonl"))
    mfu = rep["mfu"]
    log(f"telemetry serve on {env['smi']}: {TEL_SERVE_REQUESTS} requests, "
        f"tokens equal the unarmed engine's; {n_steps} engine steps, "
        f"{names.count('serving_step')} serving_step spans, {len(records)} "
        f"records; pool {got_pool} B (tensors {pool} B); decode MFU "
        f"{mfu['mfu']:.5f}, HFU {mfu['hfu']:.5f} at "
        f"{mfu['step_time_s'] * 1e3:.2f} ms/step, hardware FLOPs/step "
        f"{mfu['hw_flops_per_step']:.6g} over {sorted(mfu['per_jit'])}; "
        f"dispatch windows {rep['memory']['measured']}")
    if got_pool != pool:
        raise RuntimeError(f"telemetry serve: pool bytes {got_pool} != "
                           f"tensors {pool}")
    if names.count("serving_step") != n_steps or len(records) != n_steps:
        raise RuntimeError(f"telemetry serve: {names.count('serving_step')} "
                           f"serving_step spans, {len(records)} records, "
                           f"{n_steps} steps")

# phase 21: the program lint on the slice's engines
SERVE_FAULTS = ("host-transfer", "donation")


def _drive_train(engine, batch):
    """program_lint.drive_base on ``engine`` with every launch count set
    to 0 just before and read just after; returns (the losses it
    produced, B1-B3 launches, wall seconds)."""
    import torch

    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

    gas = engine.gradient_accumulation_steps()
    losses = []
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    losses.append(engine.train_batch(batch=batch))
    for i in range(gas):
        micro = {k: v[i] for k, v in batch.items()}
        loss = engine(micro)
        engine.backward(loss)
        engine.step()
        losses.append(loss.detach())
    losses.append(engine.eval_loss({k: v[0] for k, v in batch.items()}))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return [float(x) for x in losses], dict(fa.LAUNCHES), wall


def _lint(registries, label, want_rules=()):
    """Lint ``registries``; raises unless the new findings are exactly
    ``want_rules`` (one each); returns (findings, seconds)."""
    from deepspeed_tpu_torch.telemetry.program_lint import lint_programs

    t0 = time.perf_counter()
    res = lint_programs(registries, use_baseline=False)
    sec = time.perf_counter() - t0
    got = [f.rule for f in res.new]
    if sorted(got) != sorted(want_rules):
        raise RuntimeError(f"programs {label}: findings "
                           f"{[f.format() for f in res.new]}, expected "
                           f"{list(want_rules) or 'none'}")
    return res.new, sec


def _names(registries):
    return {reg.engine: set(reg.names()) for reg in registries}


def _serve_fault(model, fault):
    """One plain engine of the serving corpus (its first request) with a
    planted fault in the decode step: a host read of the output
    (``host-transfer``), or the pool replaced by a fresh copy after the
    dispatch (``donation``)."""
    import numpy as np

    from deepspeed_tpu_torch.serving import InferenceEngine
    from deepspeed_tpu_torch.serving import engine as serving_engine

    eng = InferenceEngine(model, None, max_slots=3, kv_block_size=4,
                          prefill_chunk=8, max_blocks_per_seq=8)
    eng.program_registry.observing = True
    original = serving_engine._decode_step

    def decode(*args, **kw):
        out = original(*args, **kw)
        if fault == "host-transfer":
            out.sum().item()
        else:
            pool = eng.pool.tensors
            eng.pool.tensors = pool._replace(k=pool.k.clone(),
                                             v=pool.v.clone())
        return out

    serving_engine._decode_step = decode
    try:
        eng.submit(np.random.default_rng(1).integers(0, 97, 5)
                   .astype(np.int32), max_new_tokens=4)
        eng.serve(max_steps=100)
    finally:
        serving_engine._decode_step = original
    return eng.program_registry


def phase_programs(env, stage0):
    """The program lint (telemetry/program_lint.py) over the slice's
    engines on the card: module docstring, phase 21. ``stage0`` is phase
    4's run."""
    import torch
    import torch.distributed as dist

    from deepspeed_tpu_torch import init_distributed, initialize
    from deepspeed_tpu_torch.models.gpt2 import GPT2Model, gpt2_config
    from deepspeed_tpu_torch.serving import InferenceEngine
    from deepspeed_tpu_torch.telemetry import program_lint as pl

    t_phase = time.perf_counter()
    cpu = _names(pl.build_corpus(device="cpu"))
    batch = _slice_batch(gpt2_config(SLICE_MODEL).vocab_size, SLICE_GAS,
                         SLICE_MICRO, SLICE_SEQ, seed=0)
    runs = {}
    for linted in (False, True):
        engine, _, _ = _slice_engine(0)
        engine.program_registry.observing = linted
        runs[linted] = _drive_train(engine, batch)
        if linted:
            base = engine.program_registry
        else:
            # the unlinted drive's time once warm (the first pays the
            # process's first launches), then the step's: two more steps,
            # the second timed
            wall_u = _drive_train(engine, batch)[2]
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                float(engine.train_batch(batch=batch))
                step_ms = (time.perf_counter() - t0) * 1e3
        del engine
        torch.cuda.empty_cache()
    (want, want_launch, first_u), (got, got_launch, wall_l) = \
        runs[False], runs[True]
    if got != want:
        raise RuntimeError(f"programs: linted losses {got} != unlinted "
                           f"{want}")
    if got_launch != want_launch or not all(want_launch.values()):
        raise RuntimeError(f"programs: B1-B3 launched {got_launch} linted, "
                           f"{want_launch} unlinted")
    _, lint_s = _lint([base], "base")
    log(f"programs: base {sorted(base.names())}: 0 findings; losses "
        f"{got} bit for bit the unlinted run's; B1-B3 {got_launch} both; "
        f"drive_base wall {wall_l:.3f} s linted / {wall_u:.3f} s unlinted "
        f"(its first: {first_u:.3f} s), "
        f"lint_programs {lint_s * 1e3:.2f} ms on {env['smi']}; unlinted "
        f"train_batch {step_ms:.1f} ms (phase 4: {stage0['step_ms']:.1f} "
        f"ms)")

    # ZeRO stage 2 in an NCCL world of one, then its planted fault: one
    # gradient all-reduce skipped under a hand-declared count (at dp 1
    # every leaf is replicated: the step posts no parameter all-gather)
    count = [("all-reduce", "f32", SLICE_GAS + 2)]   # the gas gradient
    # buckets, the loss mean and the overflow flag
    saved = _world_of_one()
    try:
        init_distributed()
        engine, _, _ = _slice_engine(2, mesh={"data": 1})
        reg = engine.program_registry
        reg.engine = "zero2"
        reg.observing = True
        zloss = float(engine.train_batch(batch=batch))
        reg.declare("fused_train_step", expect_op_counts=count)
        _lint([reg], "ZeRO-2")
        order = [(c.op, c.dtype, c.elements) for c in
                 reg.get("fused_train_step").observation.collectives]
        # the sequence the dispatcher's c10d ops show: one fp32 bucket of
        # every gradient per micro step, then the two scalars
        n_params = sum(p.numel() for p in engine.params)
        want_order = [("all-reduce", "f32", n_params)] * SLICE_GAS + \
            [("all-reduce", "f32", 1)] * 2
        group = engine.dp_group
        real, skipped = group.all_reduce, []

        def skip_one(tensor, leaves=(), **kw):
            if leaves and not skipped:
                skipped.append(len(leaves))
                return tensor
            return real(tensor, leaves=leaves, **kw)

        group.all_reduce = skip_one
        reg.get("fused_train_step").observation = None
        engine.train_batch(batch=batch)
        group.all_reduce = real
        fault, _ = _lint([reg], "ZeRO-2 fault", ["program-op-count"])
        zero_names = set(reg.names())
        del engine
        torch.cuda.empty_cache()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    if zloss != want[0]:
        raise RuntimeError(f"programs: ZeRO-2 loss {zloss} != stage 0's "
                           f"{want[0]}")
    if order != want_order:
        raise RuntimeError(f"programs: ZeRO-2 posted {order}, not "
                           f"{want_order}")
    log(f"programs: ZeRO-2 NCCL world 1 {sorted(zero_names)}: 0 findings "
        f"under expect_op_counts {count}, posted {order} (read off the "
        f"c10d ops); loss bit for bit "
        f"stage 0's; planted fault (one gradient all-reduce skipped): "
        f"{fault[0].format()}")

    engine, _, _ = _offload_engine(SLICE_MODEL, SLICE_MICRO, SLICE_GAS)
    engine.program_registry.observing = True
    oloss = float(engine.train_batch(batch=batch))
    offload = engine.program_registry
    offload.engine = "offload"
    _lint([offload], "offload")
    del engine
    _release_earlier_phases()
    if oloss != want[0]:
        raise RuntimeError(f"programs: offload loss {oloss} != stage 0's "
                           f"{want[0]}")
    log(f"programs: offload {sorted(offload.names())}: 0 findings; first "
        f"loss bit for bit stage 0's")

    model = _serve_model(dtype=torch.bfloat16)

    def make(**kw):
        return InferenceEngine(model, None, **kw)

    tokens = {}
    for observe in (False, True):
        engines = pl.serving_engines(make, observe=observe)
        tokens[observe] = [{r: res["tokens"].tolist()
                            for r, res in e.results.items()}
                           for e in engines]
        if observe:
            serving = [e.program_registry for e in engines]
        del engines
        torch.cuda.empty_cache()
    if tokens[True] != tokens[False]:
        raise RuntimeError("programs: linted serving tokens differ from the "
                           "unlinted run's")
    _lint(serving, "serving")
    faults = {}
    for fault in SERVE_FAULTS:
        found, _ = _lint([_serve_fault(model, fault)], f"fault {fault}",
                         [f"program-{fault}"])
        faults[fault] = found[0].format()
    got_names = _names([base, offload] + serving)
    if got_names != {k: cpu[k] for k in got_names} or zero_names != \
            cpu["base"] - {"micro_step", "apply_step", "eval_loss"}:
        raise RuntimeError(f"programs: names {got_names} (ZeRO-2 "
                           f"{zero_names}) differ from the CPU corpus's "
                           f"{cpu}")
    log(f"programs: serving {got_names['serving']} / "
        f"{got_names['serving-spec']} / {got_names['serving-sparse']}: 0 "
        f"findings, tokens bit for bit the unlinted engines'; every name "
        f"the CPU corpus's; planted faults: {faults}")
    log(f"programs: phase wall {time.perf_counter() - t_phase:.1f} s on "
        f"{env['smi']}")


# phase 22: activation checkpoints in host memory
ACT_GAS = 1
ACT_STEPS = 3
ACT_DROPOUT = 0.1
# the bytes checkpoint_in_cpu saves per token and layer at bf16: the
# outputs of c_attn (3 n_embd), attn.c_proj (n_embd), mlp.c_fc (4 n_embd)
# and mlp.c_proj (n_embd)
ACT_BYTES_PER_TOKEN_LAYER = (3 + 1 + 4 + 1) * 1024 * 2


def _checkpoint_blocks(model):
    """Each GPT-2 block's forward under the user-level
    ``checkpointing.checkpoint`` (its dropout replayed)."""
    import torch

    from deepspeed_tpu_torch.ops.transformer.transformer import replayable
    from deepspeed_tpu_torch.runtime.activation_checkpointing import \
        checkpointing

    for block in model.h:
        def forward(x, train, generator, _inner=block.forward):
            if not torch.is_grad_enabled():
                return _inner(x, train, generator)
            return checkpointing.checkpoint(replayable(_inner, generator),
                                            x, train)
        block.forward = forward
    return model


def _memcpy_rates(engine, batch):
    """One more step under torch.profiler: (D2H GB/s, H2D GB/s, D2H GB,
    H2D GB) of its pinned-memory copies, bytes over their device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deepspeed_tpu_torch.runtime.activation_checkpointing import \
        checkpointing

    acts = checkpointing.HOST_ACTIVATIONS
    acts.reset()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.train_batch(batch=batch)
        torch.cuda.synchronize()
    us = {"DtoH": 0.0, "HtoD": 0.0}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA \
                and "Memcpy" in evt.name:
            for kind in us:
                if kind in evt.name:
                    us[kind] += evt.time_range.elapsed_us()
    d2h = acts.saved_bytes
    h2d = d2h * acts.served // max(1, acts.saved)
    return (d2h / us["DtoH"] / 1e3 if us["DtoH"] else 0.0,
            h2d / us["HtoD"] / 1e3 if us["HtoD"] else 0.0,
            d2h / 1e9, h2d / 1e9)


def phase_host_activations(env):
    """Activation checkpoints in host memory: module docstring, phase
    22."""
    import torch

    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.gpt2 import GPT2Model, gpt2_config
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    from deepspeed_tpu_torch.runtime.activation_checkpointing import \
        checkpointing

    _release_earlier_phases()
    acts = checkpointing.HOST_ACTIVATIONS
    cfg = gpt2_config(SLICE_MODEL, n_positions=SLICE_SEQ,
                      dtype=torch.bfloat16, dropout=ACT_DROPOUT)
    batch = _slice_batch(cfg.vocab_size, ACT_GAS, SLICE_MICRO, SLICE_SEQ,
                         seed=0)
    micro = {k: v[0] for k, v in batch.items()}
    runs = {}
    for in_cpu in (False, True):
        ds = dict(_ds_config(SLICE_MICRO, ACT_GAS),
                  activation_checkpointing={"cpu_checkpointing": in_cpu})
        checkpointing.reset()
        engine, _, _, _ = initialize(
            model=_checkpoint_blocks(GPT2Model(cfg)), config_params=ds)
        checkpointing.configure(deepspeed_config=ds)
        if checkpointing._CONFIG["checkpoint_in_cpu"] != in_cpu:
            raise RuntimeError("host activations: configure() did not take "
                               "cpu_checkpointing from the config")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        losses, step_ms = [], []
        for step in range(ACT_STEPS):
            acts.reset()
            torch.cuda.synchronize()
            if step == ACT_STEPS - 1:
                # a steady-state step: its pinned buffers come from the
                # caching host allocator, not a new cudaHostAlloc
                torch.cuda.set_sync_debug_mode("error")
            t0 = time.perf_counter()
            try:
                loss = engine.train_batch(batch=batch)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            losses.append(float(loss))
            step_ms.append((time.perf_counter() - t0) * 1e3)
        saved = (acts.saved, acts.saved_bytes, acts.pinned_bytes,
                 acts.served)
        launches = dict(fa.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        # one micro step's gradients, before the step zeroes them
        engine.backward(engine(micro))
        grads = engine._flat_accum.detach().clone()
        rates = _memcpy_rates(engine, batch)
        runs[in_cpu] = dict(losses=losses, step_ms=step_ms, peak=peak,
                            saved=saved, grads=grads, rates=rates,
                            launches=launches)
        del engine
        _release_earlier_phases()
    remat, host = runs[False], runs[True]
    closed = cfg.n_layer * SLICE_MICRO * SLICE_SEQ * ACT_GAS \
        * ACT_BYTES_PER_TOKEN_LAYER
    n_saved = 4 * cfg.n_layer * ACT_GAS
    for label, run in (("on-device remat", remat),
                       ("checkpoint_in_cpu", host)):
        d2h, h2d, gb_out, gb_in = run["rates"]
        log(f"host activations, {label}: losses {run['losses']}; step ms "
            f"{[round(x, 1) for x in run['step_ms']]} on {env['smi']}; "
            f"max_memory_allocated {run['peak'] / 2 ** 30:.2f} GiB; "
            f"saved {run['saved']}; D2H {gb_out:.3f} GB at {d2h:.1f} GB/s, "
            f"H2D {gb_in:.3f} GB at {h2d:.1f} GB/s; flash launches "
            f"{run['launches']}")
    if host["losses"] != remat["losses"]:
        raise RuntimeError("host activations: losses differ from the "
                           "on-device remat's")
    if not torch.equal(host["grads"], remat["grads"]):
        raise RuntimeError("host activations: gradients differ from the "
                           "on-device remat's")
    if remat["saved"] != (0, 0, 0, 0):
        raise RuntimeError(f"host activations: the remat run saved "
                           f"{remat['saved']}")
    if host["saved"] != (n_saved, closed, closed, n_saved):
        raise RuntimeError(f"host activations: saved {host['saved']}, the "
                           f"closed form is {n_saved} tensors, {closed} "
                           f"bytes, all pinned, all served")
    # B1 twice per block and micro step (forward, recompute), B2/B3 once
    want = {"flash_fwd": 2 * cfg.n_layer * ACT_GAS * ACT_STEPS,
            "flash_bwd_dkdv": cfg.n_layer * ACT_GAS * ACT_STEPS,
            "flash_bwd_dq": cfg.n_layer * ACT_GAS * ACT_STEPS}
    if host["launches"] != want or remat["launches"] != want:
        raise RuntimeError(f"host activations: flash launches "
                           f"{host['launches']} / {remat['launches']}, "
                           f"expected {want}")
    log(f"host activations: losses and gradients bit for bit the "
        f"on-device remat's; step {ACT_STEPS} under "
        f"set_sync_debug_mode('error'); {n_saved} matmul outputs, "
        f"{closed} B pinned = {cfg.n_layer} layers x "
        f"{SLICE_MICRO * SLICE_SEQ} tokens x {ACT_BYTES_PER_TOKEN_LAYER} "
        f"B; step ms (median) {sorted(remat['step_ms'])[1]:.1f} remat / "
        f"{sorted(host['step_ms'])[1]:.1f} host on {env['smi']}")


# ---------------------------------------------------------------------------
# phase 23: GPT-2 mixture-of-experts (ROADMAP A15, MoE half)
# ---------------------------------------------------------------------------
MOE_EXPERTS = 16
MOE_TOP_K = 2
MOE_MICRO = 8
MOE_GAS = 2
MOE_STEPS = 10
MOE_PROMPTS = 4
MOE_PROMPT_LEN = 16
MOE_NEW = 32
# a capacity factor at which no token drops: a decode step's token never
# drops (capacity k), so the replay forward must not either
MOE_NO_DROP = 8.0
MOE_FAULT_FACTOR = 10


def _moe_config(**overrides):
    """gpt2-350m with 16 experts, top-2, in its odd blocks, bf16."""
    import torch

    from deepspeed_tpu_torch.models.gpt2 import gpt2_config

    kw = dict(n_positions=SLICE_SEQ, dtype=torch.bfloat16, remat=False,
              moe_num_experts=MOE_EXPERTS, moe_top_k=MOE_TOP_K)
    kw.update(overrides)
    return gpt2_config(SLICE_MODEL, **kw)


def _moe_gating(model, micro):
    """(moe_aux_loss, [dropped fraction of each MoE layer]) of one
    micro-batch, train, no gradient."""
    import torch

    from deepspeed_tpu_torch.moe.sharded_moe import MoE

    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, args, out: seen.append((mod, args[0])))
        for m in model.modules() if isinstance(m, MoE)]
    try:
        with torch.no_grad():
            _, metrics = model.loss(micro, train=True)
            dropped = [float(mod.gate(x, train=True)[-1]["moe_dropped_frac"])
                       for mod, x in seen]
    finally:
        for h in hooks:
            h.remove()
    return float(metrics["moe_aux_loss"]), dropped


class _PinnedRouting:
    """A stand-in for moe/sharded_moe.py's ``_argmax``: recording, it
    keeps each choice it makes; replaying, it returns the recorded
    choices in order and counts where its own argmax would differ (the
    flipped choices)."""

    def __init__(self):
        self.choices, self.replay, self.flips, self.total = [], None, [], 0

    def __call__(self, rem):
        import torch

        own = torch.argmax(rem, dim=-1)
        if self.replay is None:
            self.choices.append(own)
            return own
        want = self.replay.pop(0)
        self.flips.append((own != want).sum())
        self.total += own.numel()
        return want


def _moe_parity(env):
    """2 layers at full width (layer 1 MoE): the kernels against the plain
    attention with the kernel run's routing pinned; the planted fault
    (the second choice dropped) and the fp32 combine measured beside."""
    import torch
    from unittest import mock

    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.moe import sharded_moe
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

    tol = TOL["bfloat16"]
    model = gpt2.GPT2Model(_moe_config(n_layer=2), device="cuda",
                           generator=torch.Generator().manual_seed(11))
    moe = model.h[1].moe
    batch = {k: v[0].cuda() for k, v in _slice_batch(
        model.config.vocab_size, 1, 4, SLICE_SEQ, seed=1).items()}

    def run(pin, attend=None, k=MOE_TOP_K, combine_fp32=False):
        model.zero_grad(set_to_none=True)
        moe.k = k
        patches = [mock.patch.object(sharded_moe, "_argmax", pin)]
        if attend is not None:
            patches.append(mock.patch.object(
                gpt2, "scaled_dot_product_attention", attend))
        if combine_fp32:
            cast = sharded_moe._cast
            patches.append(mock.patch.object(
                sharded_moe, "_cast", lambda t, dt, ct: t.float()
                if t.dtype == torch.float32 and t.dim() == 4
                else cast(t, dt, ct)))
            einsum = torch.einsum
            patches.append(mock.patch.object(
                torch, "einsum", lambda eq, a, b: einsum(
                    eq, a.float(), b.float()).to(a.dtype)
                if eq == "egcm,gsec->gsm" else einsum(eq, a, b)))
        before = dict(fa.LAUNCHES)
        try:
            for p in patches:
                p.start()
            loss, _ = model.loss(batch, train=True)
            loss.backward()
        finally:
            for p in reversed(patches):
                p.stop()
            moe.k = MOE_TOP_K
        launched = {n: fa.LAUNCHES[n] - before[n] for n in before}
        return loss.item(), {n: p.grad.clone() for n, p in
                             model.named_parameters()}, launched

    record = _PinnedRouting()
    runs = {"kernels": run(record)}
    choices = record.choices

    def pinned():
        pin = _PinnedRouting()
        pin.replay = list(choices)
        return pin

    plain_pin = pinned()
    runs["plain, pinned"] = run(plain_pin, _plain_attention())
    runs["plain, own routing"] = run(_PinnedRouting(), _plain_attention())
    runs["planted fault: second choice dropped"] = run(
        pinned(), _plain_attention(), k=1)
    runs["kernels, combine in fp32"] = run(pinned(), combine_fp32=True)
    flips = int(sum(int(f) for f in plain_pin.flips))
    for label, (_, _, launched) in runs.items():
        each = 0 if "plain" in label or "fault" in label else 2
        if launched != {n: each for n in launched}:
            raise RuntimeError(f"moe parity: the {label} run launched "
                               f"{launched}, expected {each} of each")
    lp, gp, _ = runs["plain, pinned"]
    errs = {}
    for label in runs:
        if label == "plain, pinned":
            continue
        loss, grads, _ = runs[label]
        loss_err = abs(loss - lp) / abs(lp)
        worst = max((rel_l2(grads[n], gp[n]), n) for n in gp)
        errs[label] = max(loss_err, worst[0])
        log(f"moe parity (2 layers, n_embd 1024, {MOE_EXPERTS} experts, "
            f"bf16) {label} vs plain pinned: loss {loss:.6f} vs {lp:.6f}, "
            f"rel {loss_err:.3e}; worst gradient {worst[1]} rel l2 "
            f"{worst[0]:.3e} (gate {tol:g}, {len(gp)} tensors)")
    log(f"moe parity: {flips} of {plain_pin.total} routing choices flip "
        f"between the kernel and the plain attention's own routing (H3); "
        f"the pin removes exactly them, so the gate is phase 7's {tol:g}")
    if flips == 0 and errs["plain, own routing"] != 0.0:
        raise RuntimeError("moe parity: no flip, yet the own routing run "
                           "differs from the pinned one")
    if not errs["kernels"] <= tol:
        raise RuntimeError("moe parity: the kernels disagree with the plain "
                           "attention beyond the gate")
    fault = errs["planted fault: second choice dropped"]
    if not fault >= MOE_FAULT_FACTOR * tol:
        raise RuntimeError(f"moe parity: the planted fault reads {fault:.3e}"
                           f", under {MOE_FAULT_FACTOR}x the gate")
    return {"flips": flips, "choices": plain_pin.total,
            "err": errs["kernels"], "fault": fault,
            "combine_fp32": errs["kernels, combine in fp32"]}


def _moe_decode(env, cfg, master):
    """generate() greedy from the trained fp32 master (at a capacity where
    nothing drops), 4 prompts of 16 and 32 new tokens, under phase 16's
    replay gate against the training forward (the flash kernels) over the
    same tokens, with generate()'s routing choices pinned on the replay:
    a choice the two computations decide apart by their rounding (H3)
    moves a whole token's FFN output, which the gate is not for; those
    flips are counted, and the unpinned deficits logged."""
    import dataclasses
    from unittest import mock

    import numpy as np
    import torch

    from deepspeed_tpu_torch.models.generation import generate
    from deepspeed_tpu_torch.models.gpt2 import GPT2Model
    from deepspeed_tpu_torch.moe import sharded_moe

    nodrop = dataclasses.replace(cfg, moe_capacity_factor=MOE_NO_DROP)
    model = GPT2Model(nodrop, device="cuda")
    model.load_state_dict(master)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (MOE_PROMPTS, MOE_PROMPT_LEN)).astype(np.int32)
    # what the prompts' prefill drops at the trained capacity factor
    layers = [m for m in model.modules() if isinstance(m, sharded_moe.MoE)]
    for m in layers:
        m.capacity_factor = cfg.moe_capacity_factor
    ids = torch.as_tensor(prompts, device="cuda").long()
    _, prefill = _moe_gating(model, {"input_ids": ids, "labels": ids})
    for m in layers:
        m.capacity_factor = MOE_NO_DROP
    record = _PinnedRouting()
    t0 = time.perf_counter()
    with mock.patch.object(sharded_moe, "_argmax", record):
        seq = generate(model, None, prompts, MOE_NEW)
    gen_s = time.perf_counter() - t0
    # the choices per layer and rank along the sequence: the prefill's
    # (rows, 16), then one (rows, 1) per decode step
    per = len(layers) * MOE_TOP_K
    steps = len(record.choices) // per - 1
    pin = _PinnedRouting()
    pin.replay = [torch.cat([record.choices[j]] + [
        record.choices[(t + 1) * per + j] for t in range(steps)], dim=1)
        for j in range(per)]
    ids = torch.as_tensor(seq[:, :-1], device="cuda").long()
    new = torch.as_tensor(seq[:, MOE_PROMPT_LEN:], device="cuda").long()

    def deficits():
        with torch.no_grad():
            logits = model(ids)[:, MOE_PROMPT_LEN - 1:].float()
        best = logits.max(dim=-1).values
        return best - logits.gather(2, new[..., None])[..., 0], best

    with mock.patch.object(sharded_moe, "_argmax", pin):
        deficit, best = deficits()
    flips = int(sum(int(f) for f in pin.flips))
    own, _ = deficits()
    worst = float(deficit.max())
    log(f"moe decode: generate() greedy, {MOE_PROMPTS} prompts of "
        f"{MOE_PROMPT_LEN}, {MOE_NEW} new tokens in {gen_s:.2f} s on "
        f"{env['smi']}; replay deficit max {worst:.4f} with generate()'s "
        f"routing pinned (gate {SERVE_DELTA}), {int((deficit > 0).sum())} "
        f"of {deficit.numel()} positions above 0, top logit max "
        f"{float(best.abs().max()):.3f}; {flips} of {pin.total} routing "
        f"choices flip between generate() and the replay (H3), whose own "
        f"routing reads a deficit max {float(own.max()):.4f}; at capacity "
        f"factor {cfg.moe_capacity_factor} the prompts' prefill would drop "
        f"{[round(d, 5) for d in prefill]} by MoE layer")
    if not worst <= SERVE_DELTA:
        raise RuntimeError(f"moe decode: a generated token scores "
                           f"{worst:.4f} under the replay's best")
    return {"deficit": worst, "decode_flips": flips,
            "decode_choices": pin.total}


def _moe_decode_fp32(env):
    """fp32, 2 layers, capacity factor 8 (nothing drops): greedy tokens
    equal the training forward's argmax at every generated position but
    where its top-2 gap is under TIE_REL (tests/unit/test_generation.py
    holds the JAX package so)."""
    import numpy as np
    import torch

    from deepspeed_tpu_torch.models.generation import generate
    from deepspeed_tpu_torch.models.gpt2 import GPT2Model

    model = GPT2Model(_moe_config(n_layer=2, dtype=torch.float32,
                                  moe_capacity_factor=MOE_NO_DROP),
                      device="cuda", generator=torch.Generator()
                      .manual_seed(5))
    prompts = np.random.default_rng(1).integers(
        0, model.config.vocab_size,
        (MOE_PROMPTS, MOE_PROMPT_LEN)).astype(np.int32)
    seq = generate(model, None, prompts, MOE_NEW)
    with torch.no_grad():
        logits = model(torch.as_tensor(seq[:, :-1], device="cuda").long())
        logits = logits[:, MOE_PROMPT_LEN - 1:].float().cpu().numpy()
    want = logits.argmax(-1)
    got = seq[:, MOE_PROMPT_LEN:]
    top2 = -np.sort(-logits, axis=-1)[..., :2]
    gap = (top2[..., 0] - top2[..., 1]) / np.maximum(np.abs(top2[..., 0]),
                                                     1e-30)
    bad = (got != want) & (gap >= TIE_REL)
    ties = int(((got != want) & (gap < TIE_REL)).sum())
    log(f"moe decode fp32 (2 layers, capacity factor {MOE_NO_DROP}): "
        f"{int((got == want).sum())} of {got.size} greedy tokens equal the "
        f"training forward's argmax, {ties} near ties, smallest top-2 gap "
        f"{float(gap.min()):.3e} relative")
    if bad.any():
        raise RuntimeError(f"moe decode fp32: {int(bad.sum())} greedy tokens "
                           f"differ from the training forward's argmax away "
                           f"from a near tie")


def phase_moe(env):
    """GPT-2 mixture-of-experts: module docstring, phase 23."""
    import torch

    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.gpt2 import GPT2Model

    _release_earlier_phases()
    cfg = _moe_config()
    t0 = time.perf_counter()
    model = GPT2Model(cfg, device="cuda")
    engine, _, _, _ = initialize(model=model,
                                 config_params=_ds_config(MOE_MICRO, MOE_GAS))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in engine.module.parameters())
    n_experts = sum(p.numel() for n, p in engine.module.named_parameters()
                    if ".moe.experts." in n)
    log(f"moe: {SLICE_MODEL} with {MOE_EXPERTS} experts top-{MOE_TOP_K} in "
        f"{cfg.n_layer // cfg.moe_layer_freq} blocks: {n_params} parameters "
        f"({n_experts} in the expert stacks), model and engine built in "
        f"{init_s:.2f} s (the stacks drawn on the card)")
    batch = _slice_batch(cfg.vocab_size, MOE_GAS, MOE_MICRO, SLICE_SEQ,
                         seed=0)
    want = {name: cfg.n_layer * MOE_GAS * MOE_STEPS
            for name, _ in FLASH_KERNELS}
    want.update({name: 0 for name, _ in SPARSE_KERNELS})
    train = _train_steps(env, engine, batch, f"{SLICE_MODEL}-moe"
                         f"{MOE_EXPERTS}", SLICE_SEQ, MOE_MICRO, MOE_GAS,
                         MOE_STEPS, want)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        engine.train_batch(batch=batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    # the program lint over the MoE engine's step: one observed dispatch
    from deepspeed_tpu_torch.telemetry.program_lint import lint_programs

    engine.program_registry.observing = True
    engine.train_batch(batch=batch)
    engine.program_registry.observing = False
    findings = lint_programs([engine.program_registry],
                             use_baseline=False).new
    log(f"moe: program lint over {sorted(engine.program_registry.names())}"
        f": {len(findings)} findings {[(f.rule, f.path) for f in findings]}")
    if findings:
        raise RuntimeError("moe: the program lint has findings")
    micro = {k: v[0].cuda() for k, v in batch.items()}
    aux, dropped = _moe_gating(engine.module, micro)
    log(f"moe: step {MOE_STEPS + 1} under set_sync_debug_mode('error'): no "
        f"host sync; moe_aux_loss {aux:.6f}; dropped fraction by MoE layer "
        f"{[round(d, 5) for d in dropped]} (mean "
        f"{sum(dropped) / len(dropped):.5f}) at capacity factor "
        f"{cfg.moe_capacity_factor}")
    profile = phase_profile(env, train, f"{SLICE_MODEL}-moe{MOE_EXPERTS}")
    master = {n: m.detach().clone() for n, m in zip(engine.param_names,
                                                    engine.master)}
    train.pop("engine")
    del engine, model
    _release_earlier_phases()
    decode = _moe_decode(env, cfg, master)
    del master
    _release_earlier_phases()
    _moe_decode_fp32(env)
    parity = _moe_parity(env)
    _release_earlier_phases()
    summary = dict(step_ms=train["step_ms"],
                   tokens_per_s=train["tokens_per_s"],
                   peak_bytes=train["peak_bytes"], aux=aux, dropped=dropped,
                   idle_share=profile["idle_share"],
                   launches=train["launches"], **decode, **parity)
    log(f"moe summary on {env['smi']}: {json.dumps(summary)}")
    return summary


# ---------------------------------------------------------------------------
# phase 24: sequence parallelism (ROADMAP A15, sequence half)
# ---------------------------------------------------------------------------
# virtual sequence ranks of the kernel and ring cases, the long ring case
# (B, H, S), the dropout rate of the Ulysses kernel case
SEQ_RANKS = 4
SEQ_LONG = (1, 16, 8192)
SEQ_DROPOUT = 0.1
# the ring against plain fp32 attention: tests/unit/test_ring_attention.py's
# tolerances (output; gradients)
RING_TOL = (2e-5, 2e-5)
RING_GRAD_TOL = (5e-4, 5e-5)


def _heads_of(t, r, n):
    """Rank r's heads of a (B, H, ...) tensor, as the contiguous (B*H/n,
    ...) operand its launch takes."""
    h = t.shape[1] // n
    return t[:, r * h:(r + 1) * h].reshape((-1,) + tuple(t.shape[2:])) \
        .contiguous()


def _joined(parts, like, n):
    """Rank-major (B*H/n, ...) parts back into ``like``'s (B, H, ...)."""
    import torch

    b, h = like.shape[:2]
    return torch.cat([p.view((b, h // n) + tuple(p.shape[1:]))
                      for p in parts], 1)


def _ulysses_flash(env):
    """B1-B3 per rank's heads (head offset r * H/N of H) against one launch
    over all heads, bit for bit, with and without dropout; the offset left
    at 0 (the fault it repairs) must change the dropout output."""
    import torch

    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

    b, h, s, d = SLICE_MICRO, 16, SLICE_SEQ, 64
    n = SEQ_RANKS
    gen = torch.Generator(device="cuda").manual_seed(24)
    q, k, v, do = (torch.randn(b, h, s, d, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    seed = torch.tensor(424242, dtype=torch.int32, device="cuda")
    for rate in (0.0, SEQ_DROPOUT):
        kw = dict(scale=d ** -0.5, causal=True, bias_kind="none",
                  num_heads=h, dropout_rate=rate)
        flat = [t.reshape(b * h, s, d) for t in (q, k, v, do)]
        out, lse = fa.flash_fwd(*flat[:3], None, seed, **kw)
        delta = (flat[3].float() * out.float()).sum(-1)
        dk, dv = fa.flash_bwd_dkdv(*flat[:3], flat[3], lse, delta, None,
                                   seed, **kw)
        dq = fa.flash_bwd_dq(*flat[:3], flat[3], lse, delta, None, seed,
                             **kw)
        whole = {"out": out, "lse": lse, "dq": dq, "dk": dk, "dv": dv}
        parts = {key: [] for key in whole}
        for r in range(n):
            rkw = dict(kw, num_heads=h // n, head_offset=r * h // n,
                       total_heads=h)
            qr, kr, vr, dor = (_heads_of(t, r, n) for t in (q, k, v, do))
            o, l = fa.flash_fwd(qr, kr, vr, None, seed, **rkw)
            dl = (dor.float() * o.float()).sum(-1)
            a, c = fa.flash_bwd_dkdv(qr, kr, vr, dor, l, dl, None, seed,
                                     **rkw)
            g = fa.flash_bwd_dq(qr, kr, vr, dor, l, dl, None, seed, **rkw)
            for key, t in zip(("out", "lse", "dq", "dk", "dv"),
                              (o, l, g, a, c)):
                parts[key].append(t)
        for key, t in whole.items():
            got = _joined(parts[key], t.view((b, h) + tuple(t.shape[1:])),
                          n)
            if not torch.equal(got.reshape(t.shape), t):
                raise RuntimeError(f"seq: Ulysses {key} (dropout {rate}) "
                                   f"differs from one launch over all "
                                   f"heads")
        if rate:
            # the planted fault: rank 1's heads hashed as heads 0..3
            o, _ = fa.flash_fwd(*(_heads_of(t, 1, n) for t in (q, k, v)),
                                None, seed, **dict(kw, num_heads=h // n))
            want = out.view(b, h, s, d)[:, h // n:2 * h // n]
            if torch.equal(o.view(b, h // n, s, d), want):
                raise RuntimeError("seq: the dropout masks ignore the head "
                                   "offset")
    log(f"seq (a): B1-B3 over {n} ranks of {h // n} heads of ({b}, {h}, "
        f"{s}, {d}) bf16 causal, dropout 0 and {SEQ_DROPOUT} (head offset "
        f"r*{h // n} of {h}): out, lse, dQ, dK, dV equal one {h}-head "
        f"launch bit for bit; offset 0 on rank 1 (the planted fault) "
        f"changes its dropout output")


def _ulysses_sparse(env):
    """B5-B7 per rank's heads over the layout's rows of those heads against
    one launch over all heads, bit for bit."""
    import torch

    from deepspeed_tpu_torch.ops.sparse_attention import \
        block_sparse_kernel as bsk

    b, h, s, d = BERT_MICRO, 12, BERT_SEQ, 64
    n, block = SEQ_RANKS, BERT_SPARSITY["block"]
    layout = _fixed_layout(h, s)
    gen = torch.Generator(device="cuda").manual_seed(25)
    q, k, v, do = (torch.randn(b, h, s, d, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    bias = torch.zeros(b, s, device="cuda")
    bias[1, -100:] = bsk.NEG_INF              # padded keys of one row
    kw = dict(scale=d ** -0.5, block=block, num_heads=h)
    flat = [t.reshape(b * h, s, d) for t in (q, k, v, do)]
    luts = bsk.luts_for(layout, "cuda")
    out, lse = bsk.sparse_fwd(*flat[:3], luts, bias, **kw)
    delta = (flat[3].float() * out.float()).sum(-1)
    dq = bsk.sparse_bwd_dq(*flat[:3], flat[3], lse, delta, luts, bias, **kw)
    dk, dv = bsk.sparse_bwd_dkdv(*flat[:3], flat[3], lse, delta, luts, bias,
                                 **kw)
    whole = {"out": out, "lse": lse, "dq": dq, "dk": dk, "dv": dv}
    parts = {key: [] for key in whole}
    hl = h // n
    for r in range(n):
        rl = bsk.luts_for(layout[r * hl:(r + 1) * hl], "cuda")
        rkw = dict(kw, num_heads=hl)
        qr, kr, vr, dor = (_heads_of(t, r, n) for t in (q, k, v, do))
        o, l = bsk.sparse_fwd(qr, kr, vr, rl, bias, **rkw)
        dl = (dor.float() * o.float()).sum(-1)
        g = bsk.sparse_bwd_dq(qr, kr, vr, dor, l, dl, rl, bias, **rkw)
        a, c = bsk.sparse_bwd_dkdv(qr, kr, vr, dor, l, dl, rl, bias, **rkw)
        for key, t in zip(("out", "lse", "dq", "dk", "dv"), (o, l, g, a, c)):
            parts[key].append(t)
    for key, t in whole.items():
        got = _joined(parts[key], t.view((b, h) + tuple(t.shape[1:])), n)
        if not torch.equal(got.reshape(t.shape), t):
            raise RuntimeError(f"seq: Ulysses sparse {key} differs from one "
                               f"launch over all heads")
    log(f"seq (a): B5-B7 over {n} ranks of {hl} heads of ({b}, {h}, {s}, "
        f"{d}) bf16, FixedSparsityConfig({h}, block {block}, local "
        f"{BERT_SPARSITY['num_local_blocks']}, global "
        f"{BERT_SPARSITY['num_global_blocks']}) rows of each rank's heads, "
        f"a padded key tail: out, lse, dQ, dK, dV equal one {h}-head launch "
        f"bit for bit")


def _close(a, b, tol):
    """assert_allclose's rule: |a - b| <= atol + rtol |b|, every element;
    returns the largest |a - b|."""
    import torch

    rtol, atol = tol
    diff = (a.float() - b.float()).abs()
    if not bool((diff <= atol + rtol * b.float().abs()).all()):
        raise RuntimeError(f"seq: {float(diff.max()):.3e} beyond rtol "
                           f"{rtol}, atol {atol}")
    return float(diff.max())


def _ring_case(env, shape, n):
    """The ring's rounds for n virtual ranks (``ring_virtual``): fp32
    against plain fp32 attention (RING_TOL, RING_GRAD_TOL); bf16 against
    that exact attention of the same values (scaled error) and against the
    flash kernels over the whole sequence (relative L2), each within the
    bf16 gate; returns the errors."""
    import torch

    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    from deepspeed_tpu_torch.parallel.ring_attention import ring_virtual

    b, h, s = shape
    d = 64
    gen = torch.Generator(device="cuda").manual_seed(26)
    x = [torch.randn(b, h, s, d, generator=gen, device="cuda")
         .to(torch.bfloat16) for _ in range(4)]
    # fp32: the same bf16 values, upcast
    q, k, v, do = (t.float() for t in x)
    (out, _), grads = ring_virtual(q, k, v, n, causal=True, do=do)
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    scores = torch.matmul(qq, kk.transpose(-1, -2)) * d ** -0.5
    keep = torch.ones(s, s, dtype=torch.bool, device="cuda").tril()
    ref = torch.matmul(torch.softmax(scores.masked_fill(~keep, -1e30), -1),
                       vv)
    ref.backward(do)
    del scores
    err = {"out_fp32": _close(out, ref.detach(), RING_TOL)}
    for name, g, t in zip(("dq", "dk", "dv"), grads, (qq, kk, vv)):
        err[f"{name}_fp32"] = _close(g, t.grad, RING_GRAD_TOL)
    exact = {"out": ref.detach(), "dq": qq.grad, "dk": kk.grad,
             "dv": vv.grad}
    del qq, kk, vv, ref, out, grads
    # bf16: the ring against the exact attention of the same bf16 values
    # (the fp32 run above), element by element, and against the flash
    # kernels over the whole sequence in relative L2 (the parity phases'
    # gate): the kernels round p and dS to bf16 before their second
    # products, as the Pallas kernels do, where the ring (as the JAX ring)
    # keeps them in fp32, so the kernels' own element error against exact
    # attention, reported beside, exceeds the element gate at S 8192
    (out, _), grads = ring_virtual(*x[:3], n, causal=True, do=x[3])
    qk = [t.clone().requires_grad_() for t in x[:3]]
    flash = fa.flash_attention(*qk, causal=True)
    flash.backward(x[3])
    tol = TOL["bfloat16"]
    ring = dict(zip(("out", "dq", "dk", "dv"), (out,) + tuple(grads)))
    kern = dict(zip(("out", "dq", "dk", "dv"),
                    (flash.detach(),) + tuple(t.grad for t in qk)))
    for name in ring:
        err[f"{name}_bf16"] = scaled_err(ring[name], exact[name])
        err[f"{name}_kernel_bf16"] = scaled_err(kern[name], exact[name])
        err[f"{name}_vs_kernel"] = rel_l2(ring[name], kern[name])
        if not (err[f"{name}_bf16"] <= tol
                and err[f"{name}_vs_kernel"] <= tol):
            raise RuntimeError(f"seq: ring {name} at {shape} bf16 reads "
                               f"{err[f'{name}_bf16']:.3e} against exact "
                               f"attention and {err[f'{name}_vs_kernel']:.3e}"
                               f" against the flash kernels, beyond {tol}")
    return err


def _ring_rounds(env, shape, n):
    """Per-round ms of the forward and the backward round at ``shape``
    split over n (a diagonal block, the causal mask applied), and the peak
    bytes one rank's rounds hold over its inputs."""
    import torch

    from deepspeed_tpu_torch.parallel import ring_attention as ra

    b, h, s = shape
    d, sl = 64, shape[2] // n
    gen = torch.Generator(device="cuda").manual_seed(27)
    q, k, v, do = (torch.randn(b, h, sl, d, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    q32 = q.float() * d ** -0.5
    m = torch.full((b, h, sl, 1), ra.NEG_INF, device="cuda")
    l = torch.zeros_like(m)
    acc = torch.zeros(b, h, sl, d, device="cuda")
    fwd_ms = cuda_ms(lambda: ra.ring_forward_round(
        q32, k, v, m, l, acc, q_start=0, k_start=0, causal=True))
    m, l, acc = ra.ring_forward_round(q32, k, v, m, l, acc, q_start=0,
                                      k_start=0, causal=True)
    out32, lse = ra.ring_finish(m, l, acc)
    do32 = do.float()
    delta = (do32 * out32).sum(-1, keepdim=True)
    bwd_ms = cuda_ms(lambda: ra.ring_backward_round(
        q32, k, v, do32, lse, delta, q_start=0, k_start=0, causal=True,
        scale=d ** -0.5))
    # one rank's whole rounds: n forward rounds, n backward ones
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mm, ll, aa = m, l, acc
    for _ in range(n):
        mm, ll, aa = ra.ring_forward_round(q32, k, v, mm, ll, aa, q_start=0,
                                           k_start=0, causal=True)
    for _ in range(n):
        ra.ring_backward_round(q32, k, v, do32, lse, delta, q_start=0,
                               k_start=0, causal=True, scale=d ** -0.5)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    return fwd_ms, bwd_ms, peak


def phase_seq(env, stage0):
    """Sequence parallelism (ROADMAP A15, sequence half): module docstring,
    phase 24."""
    import torch
    import torch.distributed as dist

    from deepspeed_tpu_torch import init_distributed

    _release_earlier_phases()
    t0 = time.perf_counter()
    _ulysses_flash(env)
    torch.cuda.empty_cache()
    _ulysses_sparse(env)
    torch.cuda.empty_cache()
    t_a = time.perf_counter() - t0
    slice_shape = (SLICE_MICRO, 16, SLICE_SEQ)
    errs = {}
    for shape in (slice_shape, SEQ_LONG):
        errs[shape] = _ring_case(env, shape, SEQ_RANKS)
        torch.cuda.empty_cache()
        log(f"seq (b): ring over {SEQ_RANKS} virtual ranks at (B, H, S) "
            f"{shape}, d 64, causal: fp32 against plain fp32 attention, max "
            f"|diff| out {errs[shape]['out_fp32']:.3e} (gate rtol/atol "
            f"{RING_TOL}), dQ/dK/dV {errs[shape]['dq_fp32']:.3e} / "
            f"{errs[shape]['dk_fp32']:.3e} / {errs[shape]['dv_fp32']:.3e} "
            f"(gate {RING_GRAD_TOL}); bf16 (gate {TOL['bfloat16']}): "
            f"scaled error against exact attention out/dQ/dK/dV "
            + " / ".join(f"{errs[shape][f'{x}_bf16']:.3e}"
                         for x in ("out", "dq", "dk", "dv"))
            + " (the flash kernels' own: "
            + " / ".join(f"{errs[shape][f'{x}_kernel_bf16']:.3e}"
                         for x in ("out", "dq", "dk", "dv"))
            + "); against the flash kernels, relative L2 out/dQ/dK/dV "
            + " / ".join(f"{errs[shape][f'{x}_vs_kernel']:.3e}"
                         for x in ("out", "dq", "dk", "dv")))
    fwd_ms, bwd_ms, peak = _ring_rounds(env, SEQ_LONG, SEQ_RANKS)
    log(f"seq (b): ring round at {SEQ_LONG} over {SEQ_RANKS} (a rank's "
        f"{SEQ_LONG[2] // SEQ_RANKS} queries against one block, bf16 "
        f"operands, fp32 rounds): forward {fwd_ms:.3f} ms, backward "
        f"{bwd_ms:.3f} ms per round; one rank's {SEQ_RANKS} forward and "
        f"{SEQ_RANKS} backward rounds peak at {peak / 2 ** 20:.1f} MiB over "
        f"its inputs, on {env['smi']}")
    torch.cuda.empty_cache()
    t_b = time.perf_counter() - t0 - t_a
    # (c) one real step: the grid in an NCCL world of one, ring mode
    saved = _world_of_one()
    try:
        init_distributed()
        from deepspeed_tpu_torch import initialize
        from deepspeed_tpu_torch.models.gpt2 import GPT2Model, gpt2_config

        cfg = gpt2_config(SLICE_MODEL, n_positions=SLICE_SEQ,
                          dtype=torch.bfloat16, remat=False,
                          attention_sp_mode="ring")
        config = dict(_ds_config(SLICE_MICRO, SLICE_GAS),
                      mesh={"data": 1, "seq": 1})
        engine, _, _, _ = initialize(model=GPT2Model(cfg),
                                     config_params=config)
        if engine.sp_group is not None or engine.sp_world_size != 1:
            raise RuntimeError("seq: the grid made a seq group at seq 1")
        batch = _slice_batch(cfg.vocab_size, SLICE_GAS, SLICE_MICRO,
                             SLICE_SEQ, seed=0)
        want = {name: cfg.n_layer * SLICE_GAS * SLICE_STEPS
                for name, _ in FLASH_KERNELS}
        want.update({name: 0 for name, _ in SPARSE_KERNELS})
        run = _train_steps(env, engine, batch, f"{SLICE_MODEL} ring mode, "
                           f"mesh data 1 seq 1, NCCL world 1", SLICE_SEQ,
                           SLICE_MICRO, SLICE_GAS, SLICE_STEPS, want)
        digest = _master_digest(engine)
        run.pop("engine")
        del engine
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    torch.cuda.empty_cache()
    if run["losses"] != stage0["losses"] or digest != stage0["digest"]:
        raise RuntimeError(f"seq: the ring-mode step at seq 1 differs from "
                           f"phase 4's: losses {run['losses']} against "
                           f"{stage0['losses']}")
    log(f"seq (c): {SLICE_STEPS} steps equal phase 4's bit for bit (losses "
        f"and the fp32 master's digest); step ms {run['step_ms']:.1f} "
        f"against phase 4's {stage0['step_ms']:.1f}, tokens/s "
        f"{run['tokens_per_s']:.0f} against {stage0['tokens_per_s']:.0f} on "
        f"{env['smi']}; B1-B3 launched {run['launches']['flash_fwd']} times "
        f"each")
    log(f"seq: (a) {t_a:.1f} s, (b) {t_b:.1f} s, (c) "
        f"{time.perf_counter() - t0 - t_a - t_b:.1f} s")
    return {"ring": {str(k): v for k, v in errs.items()},
            "round_ms": (fwd_ms, bwd_ms), "peak_bytes": peak,
            "step_ms": run["step_ms"], "tokens_per_s": run["tokens_per_s"]}


# ---------------------------------------------------------------------------
# phase 25: ZeRO stage 3 and the int8 ZeRO collectives (ROADMAP A13)
# ---------------------------------------------------------------------------
# the virtual ranks of the codec and gradient cases, the rows of the micro
# batch each virtual rank's gradient reads, the JAX acceptance of the int8
# weight wire's loss (tests/unit/test_zero_stage3.py:141-149)
ZERO3_RANKS = 4
ZERO3_LOSS_GATE = 0.02


def _zero3_run(env, stage0, zero, label, steps=SLICE_STEPS, fault=None):
    """phase 4's run at ZeRO stage 3 (``zero``: more zero_optimization
    keys) in an NCCL world of one: its losses, the fp32 master's digest,
    the collectives counted in each step against the report, the plan's
    report. ``fault`` patches the engine first."""
    import torch
    import torch.distributed as dist

    from deepspeed_tpu_torch import init_distributed, initialize
    from deepspeed_tpu_torch.models.gpt2 import GPT2Model, gpt2_config

    saved = _world_of_one()
    try:
        init_distributed()
        cfg = gpt2_config(SLICE_MODEL, n_positions=SLICE_SEQ,
                          dtype=torch.bfloat16, remat=False)
        config = dict(_ds_config(SLICE_MICRO, SLICE_GAS),
                      zero_optimization=dict({"stage": 3}, **zero),
                      mesh={"data": 1})
        engine, _, _, _ = initialize(model=GPT2Model(cfg),
                                     config_params=config)
        batch = _slice_batch(cfg.vocab_size, SLICE_GAS, SLICE_MICRO,
                             SLICE_SEQ, seed=0)
        if fault is not None:
            fault(engine)
            losses = [float(engine.train_batch(batch=batch))
                      for _ in range(steps)]
            return {"losses": losses}
        want = {name: cfg.n_layer * SLICE_GAS * steps
                for name, _ in FLASH_KERNELS}
        want.update({name: 0 for name, _ in SPARSE_KERNELS})
        report = engine.comm_volume_report()
        key = lambda c: (c["name"], c["op"], c["dtype"],  # noqa: E731
                         c["elements"], c["count_per_step"],
                         c["bytes_per_step"])
        want_comm = sorted(key(c) for c in report["collectives"])
        records = []
        run = _train_steps(env, engine, batch, f"{SLICE_MODEL} {label}",
                           SLICE_SEQ, SLICE_MICRO, SLICE_GAS, steps, want,
                           after_step=lambda: records.append(
                               engine.last_step_comm))
        for step, rec in enumerate(records, 1):
            if sorted(key(c) for c in rec["collectives"]) != want_comm:
                raise RuntimeError(f"zero3 {label} step {step}: counted "
                                   f"collectives differ from the report")
        run.update(digest=_master_digest(engine), plan=engine.stage3_report(),
                   n_comm=len(want_comm), params=engine.module,
                   names=engine.param_names)
        run.pop("engine")
        return run
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, value in saved.items():
            if value is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = value


def _zero3_leaves(module, names):
    """The JAX leaves of ``module`` with their ZeRO dim at dp ZERO3_RANKS
    (runtime/zero/partition.py), and each leaf's whole tensor in the JAX
    layout (the module's bf16 parameters)."""
    from deepspeed_tpu_torch.runtime.zero.partition import ZeroPartition

    params = [p for _, p in module.named_parameters()]
    part = ZeroPartition(module, names, params, ZERO3_RANKS, 0, 3)
    leaves = [leaf for leaf in part.leaves if leaf.shard_dim is not None]
    return part, leaves, [part.leaf_tensor(leaf, params).detach()
                          for leaf in leaves]


def _codec_case(env, module, names, timer=None):
    """(b): every sharded leaf of the trained bf16 parameters split over
    ZERO3_RANKS virtual ranks along its ZeRO dim; ``timer`` (default
    ``cuda_ms``) times the codec's gather of them all."""
    import torch

    from deepspeed_tpu_torch.runtime import comm_accounting as ca
    from deepspeed_tpu_torch.runtime import custom_collectives as cc
    from deepspeed_tpu_torch.runtime import quantization as qz
    from deepspeed_tpu_torch.runtime.zero import stage3 as s3

    n = ZERO3_RANKS
    timer = timer or cuda_ms
    part, leaves, fulls = _zero3_leaves(module, names)
    wire, dense, worst, fault_worst = 0, 0, 0.0, 0.0
    for leaf, full in zip(leaves, fulls):
        rows = cc.leaf_rows(full, leaf.shard_dim, n)
        q, s = qz.quantize_rows(rows)
        q_cpu, s_cpu = qz.quantize_rows(rows.cpu())
        if not (torch.equal(q.cpu(), q_cpu) and torch.equal(s.cpu(), s_cpu)):
            raise RuntimeError(f"zero3 (b): {leaf.name}: the codec on the "
                               f"card differs from the CPU's")
        shards = list(full.chunk(n, leaf.shard_dim))
        got = cc.quantized_all_gather_virtual(shards, dim=leaf.shard_dim)
        want = cc.quantized_all_gather_virtual([t.cpu() for t in shards],
                                               dim=leaf.shard_dim)
        if not torch.equal(got.cpu(), want):
            raise RuntimeError(f"zero3 (b): {leaf.name}: the virtual gather "
                               f"on the card differs from the CPU's")
        # the half-scale bound, in fp32 (before the compute-dtype cast)
        deq = qz.dequantize_rows(q, s, rows.shape[1])
        bs, nb, npad = qz.block_layout(rows.shape[1])
        scale = s.repeat_interleave(bs, dim=1)[:, :rows.shape[1]]
        worst = max(worst, float(((deq - rows.float()).abs()
                                  / scale.clamp(min=1e-30)).max()))
        # the planted fault: each block's scale from its mean magnitude
        xf = torch.nn.functional.pad(rows.float(), (0, npad - rows.shape[1]))
        blocks = xf.reshape(n, nb, bs)
        s_bad = blocks.abs().mean(-1) / 127
        q_bad = torch.clamp(torch.round(blocks / s_bad[:, :, None]), -127,
                            127)
        d_bad = (q_bad * s_bad[:, :, None]).reshape(n, npad)[
            :, :rows.shape[1]]
        fault_worst = max(fault_worst, float(
            ((d_bad - rows.float()).abs() / scale.clamp(min=1e-30)).max()))
        wire += ca.all_gather_bytes(n * npad, 1, n) \
            + ca.all_gather_bytes(n * nb, 4, n)
        dense += ca.all_gather_bytes(full.numel(), full.element_size(), n)
    plan = s3.build_gather_plan(
        [leaf.name for leaf in part.leaves],
        [leaf.shape for leaf in part.leaves],
        [leaf.shard_dim for leaf in part.leaves], n,
        param_dtype="bfloat16")
    # half a code step, plus the fp32 roundings of x / scale and of code
    # x scale: each at most 2^-24 of a value up to 127 scales
    gate = 0.5 + 2 * 127 * 2.0 ** -24
    if worst > gate:
        raise RuntimeError(f"zero3 (b): a dequantized element lies "
                           f"{worst:.6f} of its block's scale from its input, "
                           f"beyond {gate}")
    if not fault_worst > gate:
        raise RuntimeError(f"zero3 (b): the planted fault (mean scales) "
                           f"passed the half-scale gate ({fault_worst})")
    if wire != plan.wire_bytes_per_gather:
        raise RuntimeError(f"zero3 (b): wire bytes {wire} != the plan's "
                           f"{plan.wire_bytes_per_gather}")
    shards = [list(full.chunk(n, leaf.shard_dim))
              for leaf, full in zip(leaves, fulls)]
    ms = timer(lambda: [cc.quantized_all_gather_virtual(
        sh, dim=leaf.shard_dim) for leaf, sh in zip(leaves, shards)])
    log(f"zero3 (b): {len(leaves)} sharded leaves of {SLICE_MODEL}'s trained "
        f"bf16 parameters over {n} virtual ranks: codes and scales on the "
        f"card equal the CPU's bit for bit, the virtual gather too; worst "
        f"|dequantized - input| {worst:.6f} of its block's scale (gate "
        f"{gate:.7f}; the planted fault, mean scales: {fault_worst:.3f}); "
        f"wire "
        f"{wire} B per gather per rank = the plan's, against {dense} B "
        f"for the bf16 dense gather ({dense / wire:.3f}x); the codec's "
        f"{n} quantizations and one dequantization of every leaf "
        f"{ms:.3f} ms per gather on {env['smi']}")
    return {"wire_bytes": wire, "dense_bytes": dense, "ms": ms,
            "worst": worst, "fault_worst": fault_worst}


class _TrueRoundGrad:
    """The planted fault of (c): the gather's backward as the true
    derivative of round (zero), built on the virtual gather's
    Function."""

    @staticmethod
    def apply(*args):
        from deepspeed_tpu_torch.runtime import custom_collectives as cc

        class Zeroed(cc._QuantizedAllGatherVirtual):
            @staticmethod
            def backward(ctx, grad):
                out = cc._QuantizedAllGatherVirtual.backward(ctx, grad)
                return out[:3] + tuple(t.mul(0) for t in out[3:])

        return Zeroed.apply(*args)


def _gradient_case(env, module, names, fault=False):
    """(c): one forward and backward of the model with each sharded leaf
    read through quantized_all_gather_virtual(., ZERO3_RANKS) on virtual
    rank 0's rows, against the same model run directly on the dequantized
    weights; then each virtual rank's gradient on its rows, reduce-
    scattered with quantized_reduce_scatter_virtual against the dense
    mean. Returns the gates' numbers."""
    import torch
    from torch.func import functional_call

    from deepspeed_tpu_torch.runtime import custom_collectives as cc
    from deepspeed_tpu_torch.runtime import quantization as qz

    n = ZERO3_RANKS
    part, leaves, fulls = _zero3_leaves(module, names)
    batch = _slice_batch(module.config.vocab_size, 1, SLICE_MICRO, SLICE_SEQ,
                         seed=25)
    rows = SLICE_MICRO // n
    dev = next(module.parameters()).device
    micro = [{k: v[0, r * rows:(r + 1) * rows].to(dev) for k, v in
              batch.items()} for r in range(n)]

    class Loss(torch.nn.Module):
        def __init__(self, m):
            super().__init__()
            self.m = m

        def forward(self, b):
            return self.m.loss(b, train=True)[0]

    wrap = Loss(module)
    base = {n_: p.detach() for n_, p in module.named_parameters()}
    sharded = {i for leaf in leaves for i in leaf.params}
    shards = [[t.clone().requires_grad_(True)
               for t in full.chunk(n, leaf.shard_dim)]
              for leaf, full in zip(leaves, fulls)]
    gather = _TrueRoundGrad.apply if fault else \
        cc._QuantizedAllGatherVirtual.apply
    params = {}
    for leaf, sh in zip(leaves, shards):
        whole = gather(leaf.shard_dim, qz.DEFAULT_BLOCK_SIZE,
                       torch.bfloat16, *sh)
        for i, v in part.leaf_views(leaf, whole):
            params[f"m.{names[i]}"] = v
    for i, name in enumerate(names):
        if i not in sharded:
            params[f"m.{name}"] = base[name]
    loss_q = functional_call(wrap, params, (micro[0],))
    loss_q.backward()
    # the same model on the dequantized weights, directly
    direct = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    loss_d = functional_call(wrap, direct, (micro[0],))
    loss_d.backward()
    worst = 0.0
    for leaf, sh in zip(leaves, shards):
        got = torch.cat([t.grad for t in sh], leaf.shard_dim)
        want = part.leaf_tensor(leaf, [direct[f"m.{x}"].grad
                                       for x in names])
        worst = max(worst, float((got.float() - want.float()).abs().max()))
    spread = 0.0
    if worst and not fault:
        # not bit for bit: the gate is the spread of two direct runs
        again = {k: v.detach().clone().requires_grad_(True)
                 for k, v in params.items()}
        functional_call(wrap, again, (micro[0],)).backward()
        spread = max(float((again[k].grad.float()
                            - direct[k].grad.float()).abs().max())
                     for k in direct)
    with torch.no_grad():
        loss_full = float(functional_call(wrap, {f"m.{k}": v for k, v in
                                                 base.items()},
                                          (micro[0],)))
    if fault:
        return {"worst": worst}
    # each virtual rank's gradients on its rows, on the dequantized weights
    grads = []
    for r in range(n):
        w = {k: v.detach().clone().requires_grad_(True)
             for k, v in params.items()}
        functional_call(wrap, w, (micro[r],)).backward()
        grads.append([part.leaf_tensor(
            leaf, [w[f"m.{x}"].grad for x in names]) for leaf in leaves])
    rs_worst = 0.0
    for j, leaf in enumerate(leaves):
        xs = [g[j].float() for g in grads]
        got = cc.quantized_reduce_scatter_virtual(xs, dim=leaf.shard_dim)
        dense = torch.stack(xs).mean(0).chunk(n, leaf.shard_dim)
        # int8 bound: half a code step of each rank's block, over n
        bound = sum(float(x.abs().max()) for x in xs) / 127 / 2 / n
        for g_r, d_r in zip(got, dense):
            rs_worst = max(rs_worst, float((g_r - d_r).abs().max()) / bound)
    return {"worst": worst, "spread": spread, "loss_q": float(loss_q.detach()),
            "loss_d": float(loss_d.detach()), "loss_full": loss_full,
            "rs_worst": rs_worst}


def phase_zero3(env, stage0):
    """ZeRO stage 3 and the int8 collectives (ROADMAP A13): module
    docstring, phase 25."""
    import torch

    _release_earlier_phases()
    t0 = time.perf_counter()
    runs = {}
    # at dp 1 stage 3 disarms: both configurations run stage 0's code
    for label, zero in (("ZeRO-3 asked, scheduled (dp 1: stage 0's path)",
                         {}),
                        ("ZeRO-3 asked, implicit (dp 1: stage 0's path)", {
                            "stage3_scheduled_gathers": False})):
        run = _zero3_run(env, stage0, zero, f"{label} NCCL world 1")
        if run["losses"] != stage0["losses"] \
                or run["digest"] != stage0["digest"]:
            raise RuntimeError(f"zero3 (a): {label} differs from phase 4's "
                               f"stage 0: losses {run['losses']} against "
                               f"{stage0['losses']}")
        plan = run["plan"]
        if plan["armed"] or not any("data-parallel degree is 1" in b
                                    for b in plan["disarmed_by"]):
            raise RuntimeError(f"zero3 (a): {label}: the plan at dp 1 "
                               f"reads armed={plan['armed']} "
                               f"({plan['disarmed_by']})")
        if runs:
            run.pop("params")          # (b) and (c) read the first run's
        runs[label] = run
        torch.cuda.empty_cache()
    # WarmupLR's first step has lr 0: the fault shows from step 3
    fault = _zero3_run(env, stage0, {}, "fault", steps=3,
                       fault=lambda e: setattr(e, "_gather_params",
                                               lambda: None))
    if fault["losses"] == stage0["losses"][:3]:
        raise RuntimeError("zero3 (a): the planted fault (the parameter "
                           "refresh skipped) passed the gate")
    sched = runs["ZeRO-3 asked, scheduled (dp 1: stage 0's path)"]
    log(f"zero3 (a): stage 3 asked, scheduled and implicit, at dp 1 in an "
        f"NCCL world of one, where nothing is sharded and both run stage "
        f"0's code: 10 losses and the fp32 master's digest equal phase "
        f"4's bit for bit, B1-B3 launched {sched['launches']['flash_fwd']} "
        f"times each, the counted collectives ({sched['n_comm']} leaves) "
        f"equal comm_volume_report() in every step; the plan disarmed "
        f"({sched['plan']['disarmed_by'][0]}); the planted fault (stage "
        f"0's refresh skipped) loses {fault['losses']} against "
        f"{stage0['losses'][:3]}; step ms {sched['step_ms']:.1f} against "
        f"phase 4's {stage0['step_ms']:.1f} on {env['smi']}")
    t_a = time.perf_counter() - t0
    module, names = sched["params"], sched["names"]
    codec = _codec_case(env, module, names)
    t_b = time.perf_counter() - t0 - t_a
    grads = _gradient_case(env, module, names)
    planted = _gradient_case(env, module, names, fault=True)
    rel = abs(grads["loss_q"] - grads["loss_full"]) / grads["loss_full"]
    if grads["worst"] > grads["spread"]:
        raise RuntimeError(f"zero3 (c): the straight-through gradients "
                           f"differ from the dequantized weights' by "
                           f"{grads['worst']}, beyond {grads['spread']}")
    if not planted["worst"] > 0.0:
        raise RuntimeError("zero3 (c): the planted fault (round's true "
                           "derivative) passed the gradient gate")
    if grads["loss_q"] != grads["loss_d"]:
        raise RuntimeError(f"zero3 (c): the gathered forward's loss "
                           f"{grads['loss_q']} != the dequantized weights' "
                           f"{grads['loss_d']}")
    if rel > ZERO3_LOSS_GATE:
        raise RuntimeError(f"zero3 (c): loss with int8 weights "
                           f"{grads['loss_q']} against {grads['loss_full']} "
                           f"({rel:.4f} > {ZERO3_LOSS_GATE})")
    if grads["rs_worst"] > 1.0 + 1e-6:
        raise RuntimeError(f"zero3 (c): the quantized reduce-scatter lies "
                           f"{grads['rs_worst']:.4f} of the int8 bound from "
                           f"the dense mean")
    log(f"zero3 (c): {SLICE_MODEL} forward and backward through the virtual "
        f"int8 gather over {ZERO3_RANKS} ranks: every shard's gradient "
        f"equals the dequantized weights' bit for bit (the planted fault, "
        f"round's true derivative, off by {planted['worst']:.3e}); loss "
        f"{grads['loss_q']:.6f} against {grads['loss_full']:.6f} on the "
        f"bf16 weights ({rel:.2e}, gate {ZERO3_LOSS_GATE}); the quantized "
        f"reduce-scatter of {ZERO3_RANKS} ranks' gradients within "
        f"{grads['rs_worst']:.4f} of the int8 bound of the dense mean, on "
        f"{env['smi']}")
    log(f"zero3: (a) {t_a:.1f} s, (b) {t_b:.1f} s, (c) "
        f"{time.perf_counter() - t0 - t_a - t_b:.1f} s")
    return {"codec": codec, "loss_rel": rel, "step_ms": sched["step_ms"]}


# ---------------------------------------------------------------------------
# phase 26: 1-bit Adam, 0/1 Adam and CSR gradients (ROADMAP A13b)
# ---------------------------------------------------------------------------
# 1-bit Adam's freeze in (a); the virtual ranks and rounds of (c); the JAX
# leaves whose wires (c) also runs on the CPU; the codes' scale tolerance
# of (a) (float64 norms on both sides, rounded to fp32); the gate of the
# error-feedback identity of (c), relative to the leaf's largest term; the
# embedding model of (d) (gpt2-350m's table) and its steps
ONEBIT_FREEZE = 5
ONEBIT_RANKS = 4
ONEBIT_ROUNDS = 3
ONEBIT_CPU_LEAVES = ("wpe", "h_0/attn/c_proj/kernel", "h_0/ln_1/scale",
                     "h_0/mlp/c_fc/bias")
ONEBIT_SCALE_RTOL = 1e-6
ONEBIT_EF_GATE = 1e-5
CSR_VOCAB = 50304
CSR_DIM = 1024
CSR_CLASSES = 4
CSR_STEPS = 6
CSR_RTOL = 1e-5       # tests/unit/test_csr.py:119


def _embed_model(vocab, dim, n_classes):
    """The JAX tests' SimpleEmbedModel (tests/unit/simple_model.py:153-198,
    its torch counterpart tests/torch_zero_worker.py ``EmbedModel``): ids
    -> an untied embedding -> mean over the sequence -> a linear
    classifier; the table's gradient is row-sparse."""
    import torch

    class EmbedModel(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.emb = torch.nn.Parameter(torch.zeros(vocab, dim))
            self.w = torch.nn.Parameter(torch.zeros(dim, n_classes))
            self.b = torch.nn.Parameter(torch.zeros(n_classes))

        def init_weights(self, generator):
            with torch.no_grad():
                for p in (self.emb, self.w):
                    p.copy_(torch.randn(p.shape, generator=generator) * 0.1)
                self.b.zero_()

        def loss(self, batch, generator=None, train=True):
            x = self.emb[batch["ids"]].mean(dim=1)
            logp = torch.log_softmax((x @ self.w + self.b).float(), dim=-1)
            loss = -logp.gather(1, batch["y"][:, None].long()).mean()
            return loss, {"loss": loss}

        def sparse_grad_spec(self):
            return {"emb": True, "w": False, "b": False}

        def sparse_grad_tokens(self, batch):
            return batch["ids"].numel()

    return EmbedModel()


def _onebit_run(env, optimizer, params, label, keep=(), capture=None,
                keep_engine=False):
    """phase 4's run (bf16, micro 8, gas 2, WarmupLR) with ``optimizer``
    and gradient clipping off, in an NCCL world of one: 10 steps under
    _train_steps (B1-B3 480 each); ``keep``: the steps after which the
    fp32 master is cloned on the card; ``capture(engine, step)`` runs
    after each step, untimed. Returns the run with ``masters`` {step:
    [tensors]} and, with ``keep_engine``, the engine."""
    import torch
    import torch.distributed as dist

    from deepspeed_tpu_torch import init_distributed, initialize
    from deepspeed_tpu_torch.models.gpt2 import GPT2Model, gpt2_config

    saved = _world_of_one()
    try:
        init_distributed()
        cfg = gpt2_config(SLICE_MODEL, n_positions=SLICE_SEQ,
                          dtype=torch.bfloat16, remat=False)
        config = dict(_ds_config(SLICE_MICRO, SLICE_GAS),
                      optimizer={"type": optimizer,
                                 "params": dict({"lr": 1e-4}, **params)},
                      gradient_clipping=0.0, mesh={"data": 1})
        engine, _, _, _ = initialize(model=GPT2Model(cfg),
                                     config_params=config)
        batch = _slice_batch(cfg.vocab_size, SLICE_GAS, SLICE_MICRO,
                             SLICE_SEQ, seed=0)
        want = {name: cfg.n_layer * SLICE_GAS * SLICE_STEPS
                for name, _ in FLASH_KERNELS}
        want.update({name: 0 for name, _ in SPARSE_KERNELS})
        masters = {}

        def after_step():
            step = engine.global_steps
            if step in keep:
                masters[step] = [m.detach().clone() for m in engine.master]
            if capture is not None:
                capture(engine, step)

        run = _train_steps(env, engine, batch, f"{SLICE_MODEL} {label}",
                           SLICE_SEQ, SLICE_MICRO, SLICE_GAS, SLICE_STEPS,
                           want, after_step=after_step, falling=False)
        run["masters"] = masters
        run["wire"] = engine._wire
        if not keep_engine:
            run.pop("engine")
        return run
    finally:
        if dist.is_initialized() and not keep_engine:
            dist.destroy_process_group()
        for k, value in saved.items():
            if value is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = value


def _same(a, b):
    """Two lists of tensors equal bit for bit."""
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def _frozen_codes(capture, faulty=False):
    """(a)'s gate on one frozen step: each leaf's momentum in (captured
    on the card: b1 * m + (1 - b1) * g, and the residuals) through
    quantize_with_error_feedback plain on the CPU; the card's code (the
    sign bit of each element, what pack_signs packs) must equal the CPU's
    bit for bit, and the scale within ONEBIT_SCALE_RTOL. ``faulty``: the
    CPU's sign(0) is -1 (a planted fault). The leaves are checked in
    parallel threads. Returns (leaves whose codes differ, worst scale
    rtol, elements checked)."""
    import torch

    from deepspeed_tpu_torch.runtime import custom_collectives as cc

    def sign_compress(x):
        norm = torch.linalg.vector_norm(x, dtype=torch.float64).float()
        scale = norm / torch.sqrt(torch.tensor(float(x.numel())))
        signs = torch.where(x > 0, 1.0, -1.0)
        return scale, signs, x - scale * signs

    def twin(x, we, se):
        if not faulty:
            return cc.quantize_with_error_feedback(x, we, se)
        ws, s, _ = sign_compress(x + we)
        ss, s2, _ = sign_compress(ws * s + se)
        return ss * s2, None, None

    def one(item):
        x, we, se, out = item
        codes = (out >= 0).cpu()
        scale = float(out.abs().max())
        ref, _, _ = twin(x.cpu(), we.cpu(), se.cpu())
        rs = float(ref.abs().max())
        return (not torch.equal(ref >= 0, codes),
                abs(scale - rs) / rs if rs else abs(scale), x.numel())

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        got = list(pool.map(one, capture))
    return ([j for j, (b, _, _) in enumerate(got) if b],
            max(w for _, w, _ in got), sum(n for _, _, n in got))


def _onebit_case(env, ref):
    """(a): 1-bit Adam with freeze_step 5 against ``ref`` (the Adam run
    without bias correction); returns the run and its engine."""
    import logging

    import torch

    from deepspeed_tpu_torch.utils.logging import logger

    frozen_checks = []
    v_at = {}

    def capture(engine, step):
        opt = engine.optimizer
        if step == ONEBIT_FREEZE:
            v_at["freeze"] = [v.clone() for v in opt.v]
            # each later step's momentum through the wire, captured on the
            # card (inputs and output), checked on the CPU after the step
            original = opt.compress_momentum

            def compress(skip=None):
                lm = opt.leaf_map
                ins = [(lm.gather(j, opt.m).clone(),
                        opt.worker_error[j].clone(),
                        opt.server_error[j].clone())
                       for j in range(len(lm.sizes))]
                original(skip)
                v_at["capture"] = [
                    ins[j] + (lm.gather(j, opt.m).clone(),)
                    for j in range(len(lm.sizes))]
            opt.compress_momentum = compress
        if step > ONEBIT_FREEZE:
            got = v_at.pop("capture")
            frozen_checks.append(_frozen_codes(got))
            if step == ONEBIT_FREEZE + 1:
                v_at["fault"] = _frozen_codes(got, faulty=True)
            del got

    records = []

    class Catch(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    handler = Catch(level=logging.WARNING)
    logger.addHandler(handler)
    try:
        run = _onebit_run(env, "OneBitAdam", {"freeze_step": ONEBIT_FREEZE},
                          "1-bit Adam", keep=(ONEBIT_FREEZE,),
                          capture=capture, keep_engine=True)
    finally:
        logger.removeHandler(handler)
    engine = run["engine"]
    if not any("OneBitAdam: wire compression DISARMED" in r
               and "data-parallel degree is 1" in r for r in records):
        raise RuntimeError(f"onebit (a): no disarmed warning at dp 1: "
                           f"{records}")
    if run["losses"][:ONEBIT_FREEZE] != ref["losses"][:ONEBIT_FREEZE] \
            or not _same(run["masters"][ONEBIT_FREEZE],
                         ref["masters"][ONEBIT_FREEZE]):
        raise RuntimeError(f"onebit (a): the warmup steps differ from Adam "
                           f"without bias correction: {run['losses']} "
                           f"against {ref['losses']}")
    if not _same(engine.optimizer.v, v_at["freeze"]):
        raise RuntimeError("onebit (a): v moved after the freeze")
    bad = [(s, b) for s, (b, _, _) in enumerate(frozen_checks, 1) if b]
    worst = max(w for _, w, _ in frozen_checks)
    if len(frozen_checks) != SLICE_STEPS - ONEBIT_FREEZE or bad \
            or worst > ONEBIT_SCALE_RTOL:
        raise RuntimeError(f"onebit (a): the frozen momentum's codes differ "
                           f"from the CPU twin's at {bad} (scale rtol "
                           f"{worst:.2e})")
    fault_bad = v_at["fault"][0]
    if not fault_bad:
        raise RuntimeError("onebit (a): the planted fault (sign(0) -> -1) "
                           "passed the codes gate")
    # the second planted fault: v updated after the freeze
    held = [v.clone() for v in engine.optimizer.v]
    engine._onebit_frozen = lambda: False
    engine.train_batch(batch=run["batch"])
    del engine._onebit_frozen
    if _same(engine.optimizer.v, held):
        raise RuntimeError("onebit (a): the planted fault (v updated after "
                           "the freeze) passed the v gate")
    del held, v_at["freeze"]
    n = frozen_checks[0][2]
    log(f"onebit (a): {SLICE_MODEL} 1-bit Adam, freeze_step "
        f"{ONEBIT_FREEZE}, NCCL world of one (wire disarmed: 'data-parallel "
        f"degree is 1'): steps 1-{ONEBIT_FREEZE} equal Adam without bias "
        f"correction bit for bit (losses and fp32 master); v unchanged bit "
        f"for bit over steps {ONEBIT_FREEZE + 1}-{SLICE_STEPS}; each frozen "
        f"step's momentum ({n} elements, {len(engine.optimizer.leaf_map.sizes)}"
        f" leaves) equals quantize_with_error_feedback on the CPU: packed "
        f"codes bit for bit, scales within {worst:.1e} (gate "
        f"{ONEBIT_SCALE_RTOL:g}); planted faults: sign(0) -> -1 breaks "
        f"{len(fault_bad)} leaves' codes, v updated after the freeze moves "
        f"v; B1-B3 {run['launches']['flash_fwd']} launches each; step ms "
        f"{run['step_ms']:.1f} (codes captured on frozen steps) against "
        f"Adam's {ref['step_ms']:.1f} on {env['smi']}")
    return run, engine


def _ef_ratio(sums, means, wes, ses, stateless):
    """How far the sum of a wire's rounds lies from the sum of the dense
    means beyond what its residuals hold: |sum(out) - sum(mean) +
    mean_r(we_r) + se (+ the stateless hop's error)|, over the largest of
    those terms (0 in exact arithmetic: error feedback)."""
    import torch

    we = torch.stack([w.double() for w in wes]).mean(0)
    se = torch.cat([s.double() for s in ses])
    ident = sums - means + we + se + stateless
    scale = means.abs().max() + we.abs().max() + se.abs().max()
    return float(ident.abs().max() / scale)


def _wire_case(env, engine, batch):
    """(c): the trained model's gradients of one micro-batch, per JAX leaf
    of each size gpt2-350m has (layer 0's leaves, the embeddings', the
    final LayerNorm's: the other 23 layers repeat layer 0's sizes), split
    into ONEBIT_RANKS virtual ranks' contributions (each element times 1
    + N(0, 1) / 2 from a seeded card generator), through every wire for
    ONEBIT_ROUNDS rounds with the residuals carried."""
    import torch

    from deepspeed_tpu_torch.runtime import comm_accounting as ca
    from deepspeed_tpu_torch.runtime import custom_collectives as cc

    w = ONEBIT_RANKS
    lm = engine.optimizer.leaf_map
    micro = {k: v[0] for k, v in batch.items()}
    engine.forward(micro)
    engine.backward()
    names = [n for n in lm.names
             if not n.startswith("h_") or n.startswith("h_0/")]
    grads = [lm.gather(lm.names.index(n), engine.accum).float().clone()
             for n in names]
    engine._flat_accum.zero_()
    engine.micro_steps = 0
    cpu_idx = [names.index(n) for n in ONEBIT_CPU_LEAVES]
    gen = torch.Generator(device="cuda")

    def inputs(j, t):
        g = grads[j]
        n = g.numel()
        pad = (-n) % (8 * w)
        xs = []
        for r in range(w):
            gen.manual_seed(((t * w + r) << 20) + j)
            noise = torch.randn(g.shape, generator=gen, device="cuda")
            xs.append(torch.nn.functional.pad(g * (1 + 0.5 * noise),
                                              (0, pad)))
        return xs

    wires = {"onebit": None, "b1_flat": (1, 0), "b1_k2": (1, 2),
             "b8_flat": (8, 0), "b8_k2": (8, 2)}
    out = {}

    def run_wire(xs, state, spec, wire):
        if spec is None:
            return cc.compressed_allreduce_virtual(xs, state[0], state[1],
                                                   wire=wire)
        bits, k = spec
        return cc.quantized_all_reduce_virtual(
            xs, bits=bits, intra_size=k, worker_errors=state[0],
            server_errors=state[1], wire=wire)

    for label, spec in wires.items():
        round_ms = [0.0] * ONEBIT_ROUNDS
        wire_bytes = dense_bytes = 0
        worst_ef = 0.0
        cpu_diff = []
        for j in range(len(grads)):
            xs0 = inputs(j, 0)
            npad = xs0[0].numel()
            zeros = lambda n: [torch.zeros(n, device="cuda")  # noqa: E731
                               for _ in range(w)]
            state = [zeros(npad), zeros(npad // w)]
            cpu_state = [[x.cpu() for x in s] for s in state] \
                if j in cpu_idx else None
            sums = torch.zeros(npad, dtype=torch.float64, device="cuda")
            means = torch.zeros_like(sums)
            stateless = torch.zeros_like(sums)
            for t in range(ONEBIT_ROUNDS):
                xs = xs0 if t == 0 else inputs(j, t)
                wire = {}
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                res, nwe, nse = run_wire(xs, state, spec, wire)
                end.record()
                end.synchronize()
                round_ms[t] += start.elapsed_time(end)
                if cpu_state is not None:
                    cwire = {}
                    cres, cwe, cse = run_wire([x.cpu() for x in xs],
                                              cpu_state, spec, cwire)
                    cpu_diff.append(_wire_diff(
                        (res, nwe, nse, wire), (cres, cwe, cse, cwire)))
                    cpu_state = [cwe, cse]
                state = [nwe, nse]
                sums += res[0].double()
                means += torch.stack([x.double() for x in xs]).mean(0)
                if "stateless" in wire:
                    stateless += torch.cat(wire["stateless"]).double()
                if t == 0:
                    wire_bytes += wire["bytes"]
                    dense_bytes += ca.allreduce_bytes(npad, 4, w)
            worst_ef = max(worst_ef, _ef_ratio(sums, means, state[0],
                                               state[1], stateless))
        differ = [d for d in cpu_diff if d]
        if differ:
            raise RuntimeError(f"onebit (c) {label}: the card's wire differs "
                               f"from the CPU's: {differ[:3]}")
        if worst_ef > ONEBIT_EF_GATE:
            raise RuntimeError(f"onebit (c) {label}: the rounds' sum lies "
                               f"{worst_ef:.2e} (of its largest term) beyond "
                               f"what the residuals hold (gate "
                               f"{ONEBIT_EF_GATE:g})")
        out[label] = {"round_ms": round_ms, "bytes": wire_bytes,
                      "dense_bytes": dense_bytes, "ef": worst_ef,
                      "cpu_checks": len(cpu_diff)}
        log(f"onebit (c) {label}: {len(grads)} leaves (each leaf size of "
            f"{SLICE_MODEL} once) over {w} virtual "
            f"ranks, {ONEBIT_ROUNDS} rounds: ms per round "
            f"{[round(x, 1) for x in round_ms]}; one rank sends "
            f"{wire_bytes} B a round against {dense_bytes} B of a dense "
            f"fp32 all-reduce ({dense_bytes / wire_bytes:.1f}x); the card's "
            f"codes, scales and outputs equal the CPU's bit for bit on "
            f"{len(ONEBIT_CPU_LEAVES)} leaves x {ONEBIT_ROUNDS} rounds; "
            f"error feedback holds to {worst_ef:.1e} of the largest term "
            f"(gate {ONEBIT_EF_GATE:g}) on {env['smi']}")
    # the planted fault: the server residual dropped after each round
    j = names.index("wpe")
    state = [[torch.zeros(grads[j].numel(), device="cuda")
              for _ in range(w)],
             [torch.zeros(grads[j].numel() // w, device="cuda")
              for _ in range(w)]]
    sums = torch.zeros(grads[j].numel(), dtype=torch.float64, device="cuda")
    means = torch.zeros_like(sums)
    for t in range(ONEBIT_ROUNDS):
        xs = inputs(j, t)
        res, nwe, nse = cc.compressed_allreduce_virtual(xs, *state)
        state = [nwe, [torch.zeros_like(s) for s in nse]]
        sums += res[0].double()
        means += torch.stack([x.double() for x in xs]).mean(0)
    fault = _ef_ratio(sums, means, state[0], state[1], torch.zeros_like(sums))
    if not fault > ONEBIT_EF_GATE:
        raise RuntimeError(f"onebit (c): the planted fault (the server "
                           f"residual dropped) passed the gate ({fault:.2e})")
    log(f"onebit (c): the planted fault (server residual dropped) reads "
        f"{fault:.2e} against the gate {ONEBIT_EF_GATE:g}")
    return out


def _wire_diff(card, cpu):
    """The names of what differs between the card's and the CPU's run of
    one wire round: outputs, residuals and every code and scale."""
    import torch

    (res, we, se, wire), (cres, cwe, cse, cwire) = card, cpu
    bad = []
    for name, a, b in (("out", res, cres), ("we", we, cwe), ("se", se, cse)):
        if not all(torch.equal(x.cpu(), y) for x, y in zip(a, b)):
            bad.append(name)
    for key, val in wire.items():
        if key == "bytes":
            continue
        got = val if isinstance(val, list) else [val]
        want = cwire[key] if isinstance(cwire[key], list) else [cwire[key]]
        if not all(torch.equal(x.cpu(), y) for x, y in zip(got, want)):
            bad.append(key)
    return bad


def _csr_case(env):
    """(d): the embedding model at gpt2-350m's table under ZeRO-Offload
    stage 2 (dp 1), sparse_gradients on and off, CSR_STEPS steps each."""
    import torch

    from deepspeed_tpu_torch import initialize

    gen = torch.Generator().manual_seed(7)
    ids = torch.randint(0, CSR_VOCAB, (SLICE_GAS, SLICE_MICRO, SLICE_SEQ),
                        generator=gen)
    y = torch.randint(0, CSR_CLASSES, (SLICE_GAS, SLICE_MICRO),
                      generator=gen)
    runs = {}
    for sparse in (True, False):
        config = {"train_batch_size": SLICE_MICRO * SLICE_GAS,
                  "train_micro_batch_size_per_gpu": SLICE_MICRO,
                  "gradient_accumulation_steps": SLICE_GAS,
                  "optimizer": {"type": "Adam", "params": {"lr": 1e-4}},
                  "zero_optimization": {"stage": 2, "cpu_offload": True},
                  "sparse_gradients": sparse, "steps_per_print": 10 ** 9}
        engine, _, _, _ = initialize(
            model=_embed_model(CSR_VOCAB, CSR_DIM, CSR_CLASSES),
            config_params=config)
        losses, ms = [], []
        for _ in range(CSR_STEPS):
            t0 = time.perf_counter()
            losses.append(float(engine.train_batch(batch={"ids": ids,
                                                          "y": y})))
            ms.append((time.perf_counter() - t0) * 1e3)
        runs[sparse] = {"losses": losses, "fetch": engine.last_fetch_bytes,
                        "csr": [engine.param_names[i]
                                for i in engine._csr_idx],
                        "ms": sorted(ms[1:])[len(ms[1:]) // 2]}
        del engine
        _release_earlier_phases()
    sparse, dense = runs[True], runs[False]
    rel = max(abs(a - b) / abs(b) for a, b in zip(sparse["losses"],
                                                   dense["losses"]))
    if sparse["csr"] != ["emb"] or rel > CSR_RTOL:
        raise RuntimeError(f"onebit (d): CSR offload {sparse['csr']} losses "
                           f"{sparse['losses']} against dense "
                           f"{dense['losses']} ({rel:.2e} > {CSR_RTOL:g})")
    cap = SLICE_MICRO * SLICE_SEQ
    rows = sparse["fetch"]["csr"]["emb"]
    table = sparse["fetch"]["csr_dense"]["emb"]
    if rows != cap * CSR_DIM * 4 + cap * 8 + 8 \
            or table != CSR_VOCAB * CSR_DIM * 4:
        raise RuntimeError(f"onebit (d): the table's copy down is {rows} B "
                           f"(dense {table} B)")
    log(f"onebit (d): embedding {CSR_VOCAB} x {CSR_DIM} under ZeRO-Offload "
        f"stage 2, {CSR_STEPS} steps: losses with and without "
        f"sparse_gradients within {rel:.1e} (gate {CSR_RTOL:g}); the "
        f"table's device-to-host bytes per micro step {rows} (rows x dim "
        f"+ indices: {cap} x {CSR_DIM} fp32) against {table} (vocab x dim), "
        f"{table / rows:.1f}x fewer; step ms {sparse['ms']:.1f} against "
        f"{dense['ms']:.1f} on {env['smi']}")
    return runs


def phase_onebit(env, stage0):
    """1-bit Adam, 0/1 Adam and CSR gradients (ROADMAP A13b): module
    docstring, phase 26."""
    import torch
    import torch.distributed as dist

    _release_earlier_phases()
    t0 = time.perf_counter()
    ref = _onebit_run(env, "Adam", {"bias_correction": False},
                      "Adam, no bias correction",
                      keep=(ONEBIT_FREEZE, SLICE_STEPS))
    onebit, engine = _onebit_case(env, ref)
    t_a = time.perf_counter() - t0
    wires = _wire_case(env, engine, onebit["batch"])
    del engine, onebit
    if dist.is_initialized():
        dist.destroy_process_group()
    _release_earlier_phases()
    t_c = time.perf_counter() - t0 - t_a
    zeroone = _onebit_run(env, "ZeroOneAdam",
                          {"var_freeze_step": ONEBIT_FREEZE,
                           "local_steps": 2}, "0/1 Adam",
                          keep=(ONEBIT_FREEZE, SLICE_STEPS))
    if zeroone["wire"] is not None \
            or zeroone["losses"] != ref["losses"] \
            or not _same(zeroone["masters"][SLICE_STEPS],
                         ref["masters"][SLICE_STEPS]) \
            or not _same(zeroone["masters"][ONEBIT_FREEZE],
                         ref["masters"][ONEBIT_FREEZE]):
        raise RuntimeError(f"onebit (b): 0/1 Adam at dp 1 differs from Adam "
                           f"without bias correction: {zeroone['losses']} "
                           f"against {ref['losses']}")
    log(f"onebit (b): {SLICE_MODEL} 0/1 Adam at dp 1 (wire disarmed, warmup "
        f"for ever): 10 losses and the fp32 master equal Adam without bias "
        f"correction bit for bit, so (a)'s first {ONEBIT_FREEZE} steps too; "
        f"B1-B3 {zeroone['launches']['flash_fwd']} each; step ms "
        f"{zeroone['step_ms']:.1f} against {ref['step_ms']:.1f} (phase 4: "
        f"{stage0['step_ms']:.1f}) on {env['smi']}")
    del zeroone, ref
    _release_earlier_phases()
    t_b = time.perf_counter() - t0 - t_a - t_c
    csr = _csr_case(env)
    t_d = time.perf_counter() - t0 - t_a - t_b - t_c
    log(f"onebit: (a) {t_a:.1f} s, (b) {t_b:.1f} s, (c) {t_c:.1f} s, (d) "
        f"{t_d:.1f} s")
    torch.cuda.empty_cache()
    return {"wires": wires, "csr": csr}


def _master_digest(engine):
    """sha256 of the fp32 master's bytes, in parameter order."""
    import hashlib

    h = hashlib.sha256()
    for m in engine.master:
        h.update(m.detach().float().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


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
    t_main = time.perf_counter()
    env = timed(phase_env)
    tensor_cores = timed(phase_build)
    rows = timed(phase_kernels, env, tensor_cores)
    train = timed(phase_train, env)
    for row in rows:
        row["launches"] = train["launches"][row["name"]]
    profile = timed(phase_profile, env, train, SLICE_MODEL)
    train.pop("engine")
    torch.cuda.empty_cache()
    timed(phase_zero, env, train)
    # what phase 17 is held against
    stage0 = {k: train[k] for k in ("losses", "step_ms", "tokens_per_s",
                                    "peak_bytes", "launches")}
    stage0["idle_share"] = profile["idle_share"]
    # what phase 24's step at seq 1 is held against, bit for bit
    stage0["digest"] = train["digest"]
    del train
    torch.cuda.empty_cache()
    timed(phase_parity)
    sparse_rows = timed(phase_sparse_kernels, env, tensor_cores)
    torch.cuda.empty_cache()
    bert = timed(phase_train_bert, env)
    for row in sparse_rows:
        row["launches"] = bert["launches"][row["name"]]
    timed(phase_profile, env, bert, f"{BERT_MODEL} sparse")
    del bert
    torch.cuda.empty_cache()
    timed(phase_parity_bert)
    fp16_rows = timed(phase_kernels_fp16, env, tensor_cores)
    torch.cuda.empty_cache()
    fp16 = timed(phase_train_fp16, env)
    for row in fp16_rows:
        row["launches"] = fp16["launches"][row["name"][:-len("_fp16")]]
    timed(phase_profile, env, fp16, f"{SLICE_MODEL} fp16")
    del fp16
    torch.cuda.empty_cache()
    timed(phase_optimizers, env)
    torch.cuda.empty_cache()
    serve = timed(phase_serve, env)
    torch.cuda.empty_cache()
    timed(phase_offload, env, stage0)
    torch.cuda.empty_cache()
    timed(phase_offload_large, env)
    torch.cuda.empty_cache()
    timed(phase_serve_a10b, env, serve["decode"])
    torch.cuda.empty_cache()
    timed(phase_telemetry, env, stage0)
    torch.cuda.empty_cache()
    timed(phase_programs, env, stage0)
    torch.cuda.empty_cache()
    timed(phase_host_activations, env)
    torch.cuda.empty_cache()
    timed(phase_moe, env)
    torch.cuda.empty_cache()
    timed(phase_seq, env, stage0)
    torch.cuda.empty_cache()
    timed(phase_zero3, env, stage0)
    torch.cuda.empty_cache()
    timed(phase_onebit, env, stage0)
    log(f"phase walls (s) on {env['smi']}: "
        f"{json.dumps(PHASE_WALLS)}; all phases "
        f"{time.perf_counter() - t_main:.3f} s")
    print(json.dumps({"kernels": rows + sparse_rows + fp16_rows}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
