"""FLOP counting of the PyTorch port: the attention kernels' formulas, the
hardware FLOPs of a training step, and the flops profiler.

- Each kernel (B1-B3 flash, B5-B7 block-sparse) states the FLOPs one
  launch computes: its products over the tiles it visits (causal: only
  those up to the diagonal, at the kernel's own tile sizes), or over the
  layout's active blocks. The figures below are worked by hand from the
  kernels' loops (csrc/flash_attention.cu, csrc/block_sparse_attention.cu).
- The hardware FLOPs of a 2-layer GPT-2 step at gas 2 equal a closed form
  exactly, with and without remat ``attn_out``: the matmuls (forward, the
  backward's two per matmul, the recomputed ones) plus those formulas;
  dropping the attention formula (a planted fault) breaks the equality.
- The profiler's printed layout and string helpers are the JAX package's.
"""
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.profiling import flops_profiler as jprof
from deepspeed_tpu_torch.models.bert import BertForPreTraining, bert_config
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from deepspeed_tpu_torch.ops.sparse_attention import \
    block_sparse_kernel as bsk
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as tsa
from deepspeed_tpu_torch.ops.transformer import flash_attention as tfa
from deepspeed_tpu_torch.profiling import flops_profiler as tprof
from deepspeed_tpu_torch.telemetry import mfu as tmfu

BF16, FP32 = torch.bfloat16, torch.float32


# ---------------------------------------------------------------------------
# the kernels' formulas
# ---------------------------------------------------------------------------
def test_flash_formulas_at_the_gpt2_shape():
    """(8, 16, 1024, 64) causal, bf16 (tensor-core tiles): the forward
    visits 1 + 2 + ... + 8 = 36 of its (128 q x 128 k) tile pairs; the
    dK/dV sweep 16 + 14 + ... + 2 = 72 (64 q x 128 k); the dQ sweep's
    64-row warpgroups 1 + 2 + ... + 16 = 136 (64 x 64)."""
    bh, s, d = 128, 1024, 64
    assert tfa.flash_fwd_flops(bh, s, s, d, True, BF16) \
        == 2 * 2 * 128 * 128 * d * 36 * bh
    assert tfa.flash_bwd_dkdv_flops(bh, s, s, d, True, BF16) \
        == 4 * 2 * 64 * 128 * d * 72 * bh
    assert tfa.flash_bwd_dq_flops(bh, s, s, d, True, BF16) \
        == 3 * 2 * 64 * 64 * d * 136 * bh
    # non-causal: every tile pair, i.e. exactly the products' FLOPs
    for fn, products in ((tfa.flash_fwd_flops, 2),
                         (tfa.flash_bwd_dkdv_flops, 4),
                         (tfa.flash_bwd_dq_flops, 3)):
        for dtype in (BF16, FP32, torch.float16):
            assert fn(bh, s, s, d, False, dtype) \
                == products * 2 * s * s * d * bh
    # causal work is more than half the square: the diagonal tiles are
    # computed whole
    half = 2 * 2 * s * (s + 1) // 2 * d * bh
    assert half < tfa.flash_fwd_flops(bh, s, s, d, True, BF16) < 2 * half


def test_flash_formulas_scalar_tiles_and_ragged_lengths():
    """fp32 takes the scalar kernels' 64 x 64 tiles; a ragged length pads
    its last tile (the kernels compute it whole)."""
    bh, d = 3, 96
    # s = 200: 4 tiles of 64; causal fwd 1+2+3+4 = 10 pairs, dK/dV 4+3+2+1
    assert tfa.flash_fwd_flops(bh, 200, 200, d, True, FP32) \
        == 2 * 2 * 64 * 64 * d * 10 * bh
    assert tfa.flash_bwd_dkdv_flops(bh, 200, 200, d, True, FP32) \
        == 4 * 2 * 64 * 64 * d * 10 * bh
    assert tfa.flash_bwd_dq_flops(bh, 200, 200, d, True, FP32) \
        == 3 * 2 * 64 * 64 * d * 10 * bh
    # bf16 at s = 200: 2 q blocks of 128, 2 k tiles of 128 -> 1 + 2
    assert tfa.flash_fwd_flops(bh, 200, 200, d, True, BF16) \
        == 2 * 2 * 128 * 128 * d * 3 * bh
    # non-causal, q 100 and k 300: ceil(100/128) x ceil(300/128)
    assert tfa.flash_fwd_flops(bh, 100, 300, d, False, BF16) \
        == 2 * 2 * 128 * 128 * d * 3 * bh


def _layout(heads=2, nb=8):
    rng = np.random.default_rng(0)
    layout = (rng.random((heads, nb, nb)) < 0.3).astype(np.int64)
    layout[:, np.arange(nb), np.arange(nb)] = 1
    return layout


@pytest.mark.parametrize("dtype,block,products", [
    (BF16, 64, (3, 4, 6)), (BF16, 128, (3, 4, 6)),
    (FP32, 64, (2, 3, 4)), (BF16, 32, (2, 3, 4))])
def test_block_sparse_formulas(dtype, block, products):
    """The active blocks' products; the tensor-core kernels (bf16 at block
    64/128) split each second product in two bf16 parts and so compute it
    twice."""
    layout = _layout()
    active = int(layout.sum())
    d, batch = 64, 3
    for fn, n in zip((bsk.sparse_fwd_flops, bsk.sparse_bwd_dq_flops,
                      bsk.sparse_bwd_dkdv_flops), products):
        assert fn(batch, layout, block, d, dtype) \
            == n * 2 * block * block * d * active * batch


# ---------------------------------------------------------------------------
# the hardware FLOPs of a step
# ---------------------------------------------------------------------------
TINY = dict(vocab_size=97, n_positions=32, n_embd=64, n_layer=2, n_head=1)
B, S, GAS = 2, 32, 2


def _closed_form(cfg, remat):
    """One optimizer step's matmul and attention-kernel FLOPs of a GPT-2
    (no dropout) at micro-batch B, seq S, gas GAS, written out:

    - per layer, forward 2 T E (3E + E + 4E + 4E) = 24 T E^2 (c_attn,
      attn.c_proj, mlp.c_fc, mlp.c_proj), backward twice that (the input
      and the weight gradient of each);
    - remat 'attn_out' recomputes c_attn, attn.c_proj and mlp.c_fc in the
      backward (mlp.c_proj's output feeds no backward: the recompute stops
      before it) and the attention forward;
    - the tied LM head over the T' = B (S - 1) shifted tokens and the
      padded vocabulary: forward, its chunk's recompute in the backward,
      and two backward products;
    - per layer one flash forward (two under remat) and one dK/dV and one
      dQ sweep, at (B H, S, S, D) causal."""
    E, L, V = cfg.n_embd, cfg.n_layer, cfg.padded_vocab_size
    T, T1 = B * S, B * (S - 1)
    mm = L * (72 * T * E * E + (16 * T * E * E if remat else 0)) \
        + 4 * 2 * T1 * E * V
    bh, d, dt = B * cfg.n_head, cfg.head_dim, cfg.dtype
    attn = L * ((2 if remat else 1) * tfa.flash_fwd_flops(bh, S, S, d, True,
                                                          dt)
                + tfa.flash_bwd_dkdv_flops(bh, S, S, d, True, dt)
                + tfa.flash_bwd_dq_flops(bh, S, S, d, True, dt))
    return GAS * (mm + attn)


def _engine(dtype, remat):
    cfg = GPT2Config(dtype=dtype, remat=remat, remat_policy="attn_out",
                     **TINY)
    ds = {"train_batch_size": B * GAS, "train_micro_batch_size_per_gpu": B,
          "gradient_accumulation_steps": GAS,
          "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
          "steps_per_print": 10 ** 9,
          "telemetry": {"enabled": True, "peak_tflops_per_device": 1e-3}}
    if dtype == BF16:
        ds["bf16"] = {"enabled": True}
    return cfg, deepspeed_tpu_torch.initialize(
        model=GPT2Model(cfg), config_params=ds, device="cpu")[0]


@pytest.mark.parametrize("dtype", [FP32, BF16])
@pytest.mark.parametrize("remat", [False, True])
def test_step_hardware_flops_equal_the_closed_form(dtype, remat):
    cfg, eng = _engine(dtype, remat)
    ids = np.random.default_rng(0).integers(0, 97, (GAS, B, S))
    for _ in range(2):
        eng.train_batch(batch={"input_ids": ids, "labels": ids})
    rep = eng.telemetry_report()["mfu"]
    assert rep["hw_flops_per_step"] == _closed_form(cfg, remat)
    assert rep["hw_flops_complete"]
    micro = rep["per_jit"]["micro_step"]
    assert micro["kernel_launches"] == {
        "flash_fwd": 2 * TINY["n_layer"] if remat else TINY["n_layer"],
        "flash_bwd_dkdv": TINY["n_layer"], "flash_bwd_dq": TINY["n_layer"]}
    assert rep["model_flops_per_step"] \
        == 6.0 * sum(p.numel() for p in eng.params) * B * S * GAS
    assert rep["peak_known"] and rep["hfu"] >= rep["mfu"] > 0


def test_dropping_the_attention_formula_fails_the_closed_form(monkeypatch):
    """The planted fault: with the forward kernel's formula read as 0 the
    count misses the attention's forward."""
    cfg, eng = _engine(FP32, False)
    ids = torch.zeros((B, S), dtype=torch.long)
    batch = {"input_ids": ids, "labels": ids}
    want = _closed_form(cfg, False)
    assert GAS * tmfu.loss_step_flops(eng.module, batch)["flops"] == want
    monkeypatch.setattr(tfa, "flash_fwd_flops", lambda *a: 0)
    bad = tmfu.loss_step_flops(eng.module, batch)
    assert bad["kernel_flops"]["flash_fwd"] == 0
    assert GAS * bad["flops"] != want


def test_count_is_the_same_on_either_route():
    """The CPU's plain einsum path (use_pallas None) and the kernels'
    plain versions (True) count the kernels' formulas alike, and counting
    launches nothing."""
    ids = torch.zeros((B, S), dtype=torch.long)
    batch = {"input_ids": ids, "labels": ids}
    counts = []
    for route in (None, True):
        m = GPT2Model(GPT2Config(dtype=FP32, use_pallas_attention=route,
                                 **TINY))
        tfa.reset_launch_counts()
        counts.append(tmfu.loss_step_flops(m, batch))
        assert sum(tfa.LAUNCHES.values()) == 0
    assert counts[0] == counts[1]


def test_bert_sparse_step_counts_the_block_sparse_kernels():
    layout_cfg = tsa.FixedSparsityConfig(12, block=64, num_local_blocks=4,
                                         num_global_blocks=1)
    cfg = bert_config("bert-base", num_hidden_layers=2,
                      max_position_embeddings=512, dtype=BF16,
                      hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0,
                      sparsity_config=layout_cfg)
    model = BertForPreTraining(cfg).to(BF16)
    ids = torch.zeros((2, 512), dtype=torch.long)
    batch = {"input_ids": ids, "masked_lm_labels": ids,
             "attention_mask": torch.ones_like(ids)}
    got = tmfu.loss_step_flops(model, batch)
    layout = layout_cfg.make_layout(512)
    for name in ("sparse_fwd", "sparse_bwd_dq", "sparse_bwd_dkdv"):
        assert got["kernel_launches"][name] == 2
        assert got["kernel_flops"][name] == 2 * bsk.FLOPS[name](
            2, layout, 64, 64, BF16)
    assert got["flops"] == got["matmul_flops"] \
        + sum(got["kernel_flops"].values())


# ---------------------------------------------------------------------------
# the profiler
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("value", [None, 0.0, 12.5, 3.2e4, 7.5e9, 4.1e13])
def test_string_helpers_equal_jax(value):
    for name in ("number_to_string", "flops_to_string", "params_to_string",
                 "macs_to_string", "duration_to_string"):
        if value is None and name not in ("duration_to_string",
                                          "flops_to_string"):
            continue
        assert getattr(tprof, name)(value) == getattr(jprof, name)(value)
    assert tprof.duration_to_string(3e-5) == jprof.duration_to_string(3e-5)


def test_printed_profile_layout_equals_jax():
    comm = {"total_bytes_per_step": 3.2e9,
            "grad_exchange_bytes_per_step": 2.1e9,
            "grad_reduction_vs_fp32": 2.0, "inter_bytes_per_step": 5e8}
    out = []
    for mod in (jprof, tprof):
        p = mod.FlopsProfiler(peak_flops=989.4e12)
        p._params, p._flops, p._duration = 354_823_168, 2.3e13, 0.091
        p._cost = {"bytes_accessed": 1.5e11}
        p.profile_comm(comm)
        out.append((p.print_model_profile(profile_step=2),
                    p.get_total_flops(True), p.get_total_params(True),
                    p.get_total_duration(True)))
    assert out[0] == out[1]


def test_analyze_fn_and_profile_fn_count_on_meta():
    a, b = torch.randn(4, 8), torch.randn(8, 16)
    assert tprof.analyze_fn(torch.matmul, a, b)["flops"] == 2 * 4 * 8 * 16
    prof = tprof.FlopsProfiler()
    cost = prof.profile_fn(torch.matmul, a, b, n_timing_runs=2)
    assert cost["flops"] == prof.get_total_flops() == 1024
    assert prof.get_total_duration() > 0
    flops, params, duration = tprof.get_model_profile(
        torch.matmul, (a, b), print_profile=False)
    assert flops == tprof.flops_to_string(1024) and params is None
    assert prof.profile_params(GPT2Model(GPT2Config(**TINY))) \
        == sum(p.numel() for p in GPT2Model(GPT2Config(**TINY)).parameters())
