"""The port on a GPU (its CUDA kernels, training and serving); every test
here skips without one.

This file imports neither jax nor the JAX package, so it also runs on a
machine that has only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: kernel against its plain version element by element,
|a - b| <= 2e-2 (bf16) / 5e-3 (fp16) / 1e-4 (fp32) times (|b| + rms(b)),
as chip_smoke.py holds them: both compute in fp32 from the same stored
inputs, so they differ by summation order, the final rounding to the
storage dtype (at most one ulp: 2**-7 of the value at bf16, 2**-10 at
fp16) and dS values rounded on two sides of a boundary (PERF.md section 2).
"""
import gc
import os

import pytest
import torch

from deepspeed_tpu_torch.ops.transformer import flash_attention as tfa

TOL = {torch.bfloat16: 2e-2, torch.float16: 5e-3, torch.float32: 1e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA-only")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(a, b, dtype):
    a, b = a.float(), b.float()
    rms = b.square().mean().sqrt()
    return bool(((a - b).abs() <= TOL[dtype] * (b.abs() + rms)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,s,d,kind,causal,rate", [
    (torch.bfloat16, 200, 64, "none", True, 0.0),
    (torch.float32, 128, 96, "full", True, 0.0),
    (torch.float32, 130, 128, "key", False, 0.1),
    # bf16 runs the tensor-core forward and dK/dV: head_dim 96 (padded to
    # two 64-column panels) and 128, both bias kinds, dropout, ragged S
    (torch.bfloat16, 77, 96, "full", True, 0.0),
    (torch.bfloat16, 200, 96, "key", False, 0.1),
    (torch.bfloat16, 256, 128, "full", False, 0.1),
    (torch.bfloat16, 333, 128, "key", True, 0.0),
    (torch.bfloat16, 1000, 64, "key", True, 0.1),
    # the tensor-core dQ sweep: 64-row k tiles, ragged at both ends
    (torch.bfloat16, 130, 64, "full", False, 0.1),
    (torch.bfloat16, 520, 128, "none", True, 0.1),
    (torch.bfloat16, 384, 96, "none", False, 0.0),
    # fp16 on the same tensor-core kernels (their fp16 instantiations)
    (torch.float16, 200, 64, "none", True, 0.0),
    (torch.float16, 77, 96, "full", True, 0.1),
    (torch.float16, 333, 128, "key", False, 0.1),
    (torch.float16, 1000, 64, "key", True, 0.1),
])
def test_kernels_match_plain_versions(cuda, dtype, s, d, kind, causal, rate):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v, do = (torch.randn(4, s, d, generator=gen, device=cuda)
                   .to(dtype) for _ in range(4))
    bias = None
    if kind == "full":
        bias = torch.randn(4, s, s, generator=gen, device=cuda)
    elif kind == "key":
        bias = torch.randn(2, s, generator=gen, device=cuda)
        bias[:, -9:] = tfa.NEG_INF         # padded keys
    seed = 99 if rate else None
    kw = dict(scale=d ** -0.5, causal=causal, bias_kind=kind, num_heads=2,
              dropout_rate=rate)
    before = dict(tfa.LAUNCHES)
    out, lse = tfa.flash_fwd(q, k, v, bias, seed, **kw)
    delta = (do.float() * out.float()).sum(-1)
    dk, dv = tfa.flash_bwd_dkdv(q, k, v, do, lse, delta, bias, seed, **kw)
    dq = tfa.flash_bwd_dq(q, k, v, do, lse, delta, bias, seed, **kw)
    assert {n: tfa.LAUNCHES[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_bwd_dkdv": 1, "flash_bwd_dq": 1}
    ref_out, ref_lse = tfa.flash_fwd_plain(q, k, v, bias, seed, **kw)
    ref_dk, ref_dv = tfa.flash_bwd_dkdv_plain(q, k, v, do, lse, delta, bias,
                                              seed, **kw)
    ref_dq = tfa.flash_bwd_dq_plain(q, k, v, do, lse, delta, bias, seed,
                                    **kw)
    for a, b in ((out, ref_out), (lse, ref_lse), (dq, ref_dq), (dk, ref_dk),
                 (dv, ref_dv)):
        assert _close(a, b, dtype)
    if dtype != torch.float32:
        # the scalar dQ sweep that the tensor-core one replaced computes the
        # same function
        dq_scalar = tfa.flash_bwd_dq(q, k, v, do, lse, delta, bias, seed,
                                     scalar=True, **kw)
        assert _close(dq_scalar, ref_dq, dtype)


@pytest.mark.cuda
def test_gpt2_on_cuda_runs_the_kernels_and_matches_the_cpu(cuda):
    """A tiny fp32 GPT-2 on the card launches each kernel once per layer
    and gives the loss and gradients of the same model on the CPU."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model

    cfg = GPT2Config(vocab_size=256, n_positions=128, n_embd=128, n_layer=2,
                     n_head=2, dtype=torch.float32)
    cpu = GPT2Model(cfg)
    gpu = GPT2Model(cfg).to(cuda)
    gpu.load_state_dict(cpu.state_dict())
    ids = torch.randint(0, 256, (2, 100), generator=torch.Generator()
                        .manual_seed(1))
    before = dict(tfa.LAUNCHES)
    losses = []
    for m, dev in ((cpu, "cpu"), (gpu, cuda)):
        b = {"input_ids": ids.to(dev), "labels": ids.to(dev)}
        loss, _ = m.loss(b)
        loss.backward()
        losses.append(loss.item())
    assert {n: tfa.LAUNCHES[n] - before[n] for n in before} == {
        "flash_fwd": 2, "flash_bwd_dkdv": 2, "flash_bwd_dq": 2}
    assert abs(losses[0] - losses[1]) <= 1e-4 * abs(losses[0])
    for (n, p), q in zip(cpu.named_parameters(), gpu.parameters()):
        assert _close(q.grad.cpu(), p.grad, torch.float32), n


@pytest.mark.cuda
def test_cuda_attention_raises_instead_of_rerouting(cuda):
    from deepspeed_tpu_torch.ops.transformer.functional import \
        scaled_dot_product_attention

    q = torch.zeros(1, 2, 16, 80, device=cuda)
    with pytest.raises(ValueError, match="head_dim 80"):
        scaled_dot_product_attention(q, q, q, causal=True)
    q = torch.zeros(1, 2, 16, 64, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError, match="bfloat16 or float16"):
        scaled_dot_product_attention(q, q, q, causal=True)
    q = torch.zeros(1, 2, 16, 64, device=cuda)
    with pytest.raises(ValueError, match="CPU tensors only"):
        scaled_dot_product_attention(q, q, q, causal=True, use_pallas=False)
    # bf16 at a head_dim the tensor-core kernels do not take still raises
    q = torch.zeros(1, 2, 16, 80, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 80"):
        scaled_dot_product_attention(q, q, q, causal=True)
    with pytest.raises(ValueError, match="head_dim in"):
        tfa.flash_fwd(q[0], q[0], q[0], None, None, scale=1.0, causal=True,
                      bias_kind="none", num_heads=2, dropout_rate=0.0)


def _sparse_layout(heads, s, block):
    """Per-head BigBird (ragged nnz, seeded) with one empty row in head 1."""
    import random

    from deepspeed_tpu_torch.ops.sparse_attention import \
        BigBirdSparsityConfig

    random.seed(0)
    layout = BigBirdSparsityConfig(heads, block=block,
                                   different_layout_per_head=True,
                                   num_random_blocks=1).make_layout(s)
    layout[1, s // block // 2] = 0
    return layout


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,s,d,block,padded", [
    (torch.bfloat16, 512, 64, 64, True),
    (torch.float32, 256, 128, 16, True),
    (torch.float32, 512, 96, 128, False),
    (torch.bfloat16, 256, 64, 32, False),
    # the tensor-core kernels: bf16 at block 64 and 128, head_dim 64 to 128
    (torch.bfloat16, 512, 96, 64, True),
    (torch.bfloat16, 256, 128, 64, False),
    (torch.bfloat16, 512, 128, 128, True),
    (torch.bfloat16, 512, 64, 128, False),
])
def test_sparse_kernels_match_plain_versions(cuda, dtype, s, d, block,
                                             padded):
    from deepspeed_tpu_torch.ops.sparse_attention import \
        block_sparse_kernel as bsk

    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v, do = (torch.randn(4, s, d, generator=gen, device=cuda)
                   .to(dtype) for _ in range(4))
    bias = torch.randn(2, s, generator=gen, device=cuda)
    if padded:
        bias[:, -9:] = bsk.NEG_INF
    luts = bsk.luts_for(_sparse_layout(2, s, block), cuda)
    kw = dict(scale=d ** -0.5, block=block, num_heads=2)
    before = dict(bsk.LAUNCHES)
    out, lse = bsk.sparse_fwd(q, k, v, luts, bias, **kw)
    delta = (do.float() * out.float()).sum(-1)
    dq = bsk.sparse_bwd_dq(q, k, v, do, lse, delta, luts, bias, **kw)
    dk, dv = bsk.sparse_bwd_dkdv(q, k, v, do, lse, delta, luts, bias, **kw)
    assert {n: bsk.LAUNCHES[n] - before[n] for n in before} == {
        "sparse_fwd": 1, "sparse_bwd_dq": 1, "sparse_bwd_dkdv": 1}
    ref_out, ref_lse = bsk.sparse_fwd_plain(q, k, v, luts, bias, **kw)
    ref_dq = bsk.sparse_bwd_dq_plain(q, k, v, do, lse, delta, luts, bias,
                                     **kw)
    ref_dk, ref_dv = bsk.sparse_bwd_dkdv_plain(q, k, v, do, lse, delta, luts,
                                               bias, **kw)
    # head 1's empty row: zeros and lse -1e30, exactly
    rows = slice(s // 2, s // 2 + block)
    assert bool((out[1::2, rows] == 0).all())
    assert bool((lse[1::2, rows] == bsk.NEG_INF).all())
    full = ref_lse > bsk.NEG_INF / 2
    assert torch.equal(lse > bsk.NEG_INF / 2, full)
    for a, b in ((out, ref_out), (lse[full], ref_lse[full]), (dq, ref_dq),
                 (dk, ref_dk), (dv, ref_dv)):
        assert _close(a, b, dtype)
    if dtype == torch.bfloat16 and block in (64, 128):
        # the scalar kernels that the tensor-core ones replaced compute the
        # same functions
        out_s, lse_s = bsk.sparse_fwd(q, k, v, luts, bias, scalar=True, **kw)
        assert _close(out_s, ref_out, dtype)
        assert _close(lse_s[full], ref_lse[full], dtype)
        dq_s = bsk.sparse_bwd_dq(q, k, v, do, lse, delta, luts, bias,
                                 scalar=True, **kw)
        dk_s, dv_s = bsk.sparse_bwd_dkdv(q, k, v, do, lse, delta, luts, bias,
                                         scalar=True, **kw)
        for a, b in ((dq_s, ref_dq), (dk_s, ref_dk), (dv_s, ref_dv)):
            assert _close(a, b, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("d", [64, 96, 128])
def test_sparse_tc_backward_sweeps_match_plain_versions(cuda, d, block):
    """The bf16 tensor-core dQ and dK/dV sweeps against their plain versions
    over a Fixed layout, whose global key blocks are walked by every query
    block and the others by a few (the dK/dV sweep takes its key tiles
    longest first), with one key block that no query block walks (its dK
    and dV are zero) and a padded key tail; each launch counted once."""
    from deepspeed_tpu_torch.ops.sparse_attention import (
        FixedSparsityConfig, block_sparse_kernel as bsk)

    s = 1024
    gen = torch.Generator(device=cuda).manual_seed(d + block)
    q, k, v, do = (torch.randn(6, s, d, generator=gen, device=cuda)
                   .to(torch.bfloat16) for _ in range(4))
    bias = torch.randn(2, s, generator=gen, device=cuda)
    bias[:, -9:] = bsk.NEG_INF
    layout = FixedSparsityConfig(3, block=block, num_local_blocks=4 if
                                 block == 64 else 2).make_layout(s)
    layout[0, :, 0] = 0
    luts = bsk.luts_for(layout, cuda)
    kw = dict(scale=d ** -0.5, block=block, num_heads=3)
    out, lse = bsk.sparse_fwd(q, k, v, luts, bias, **kw)
    delta = (do.float() * out.float()).sum(-1)
    before = dict(bsk.LAUNCHES)
    dq = bsk.sparse_bwd_dq(q, k, v, do, lse, delta, luts, bias, **kw)
    dk, dv = bsk.sparse_bwd_dkdv(q, k, v, do, lse, delta, luts, bias, **kw)
    assert {n: bsk.LAUNCHES[n] - before[n] for n in before} == {
        "sparse_fwd": 0, "sparse_bwd_dq": 1, "sparse_bwd_dkdv": 1}
    ref_dq = bsk.sparse_bwd_dq_plain(q, k, v, do, lse, delta, luts, bias,
                                     **kw)
    ref_dk, ref_dv = bsk.sparse_bwd_dkdv_plain(q, k, v, do, lse, delta, luts,
                                               bias, **kw)
    assert int(luts.nnz_t[0, 0]) == 0 and int(luts.order_t[0, -1]) == 0
    assert not dk[0, :block].any() and not dv[0, :block].any()
    for a, b in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        assert torch.isfinite(a).all()
        assert _close(a, b, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_sparse_bf16_backward_fully_padded_row(cuda, d):
    """ROADMAP C-w4 on the tensor-core backward sweeps: a query block whose
    only active key block is all padded ties every score at -1e30 and
    reproduces the forward's lse (p = 1 on each of its keys), as the
    plain versions compute it."""
    import numpy as np

    from deepspeed_tpu_torch.ops.sparse_attention import \
        block_sparse_kernel as bsk

    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v, do = (torch.randn(1, 128, d, generator=gen, device=cuda)
                   .to(torch.bfloat16) for _ in range(4))
    bias = torch.zeros(1, 128, device=cuda)
    bias[:, 64:] = bsk.NEG_INF
    luts = bsk.luts_for(np.array([[[1, 1], [0, 1]]]), cuda)
    kw = dict(scale=d ** -0.5, block=64, num_heads=1)
    out, lse = bsk.sparse_fwd(q, k, v, luts, bias, **kw)
    delta = (do.float() * out.float()).sum(-1)
    dq = bsk.sparse_bwd_dq(q, k, v, do, lse, delta, luts, bias, **kw)
    dk, dv = bsk.sparse_bwd_dkdv(q, k, v, do, lse, delta, luts, bias, **kw)
    ref_dq = bsk.sparse_bwd_dq_plain(q, k, v, do, lse, delta, luts, bias,
                                     **kw)
    ref_dk, ref_dv = bsk.sparse_bwd_dkdv_plain(q, k, v, do, lse, delta, luts,
                                               bias, **kw)
    # the tied rows: p = 1 on each padded key, so dv of those keys holds
    # the sum of dO over the tied rows (plus the first block's share)
    assert float(ref_dv[0, 64:].float().abs().max()) > 1.0
    for a, b in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        assert _close(a, b, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_sparse_bf16_forward_fully_padded_row(cuda, d):
    """ROADMAP C-w4 on the tensor-core forward: a query block whose active
    keys are all padded (key bias -1e30) ties every score at exactly -1e30
    and gives the mean of v over those keys, as the Pallas kernel does."""
    import numpy as np

    from deepspeed_tpu_torch.ops.sparse_attention import \
        block_sparse_kernel as bsk

    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(1, 128, d, generator=gen, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    bias = torch.zeros(1, 128, device=cuda)
    bias[:, 64:] = bsk.NEG_INF
    luts = bsk.luts_for(np.array([[[1, 1], [0, 1]]]), cuda)
    kw = dict(scale=d ** -0.5, block=64, num_heads=1)
    out, lse = bsk.sparse_fwd(q, k, v, luts, bias, **kw)
    ref_out, ref_lse = bsk.sparse_fwd_plain(q, k, v, luts, bias, **kw)
    mean = v[0, 64:].float().mean(0).expand(64, d)
    assert _close(out[0, 64:], mean, torch.bfloat16)
    assert _close(out, ref_out, torch.bfloat16)
    assert _close(lse, ref_lse, torch.bfloat16)


@pytest.mark.cuda
def test_sparse_bert_on_cuda_runs_the_kernels_and_matches_the_cpu(cuda):
    """A tiny fp32 sparse BERT on the card launches each block-sparse
    kernel once per layer and no flash kernel, and gives the loss and
    gradients of the same model on the CPU (masked path)."""
    from deepspeed_tpu_torch.models.bert import BertConfig, BertForPreTraining
    from deepspeed_tpu_torch.ops.sparse_attention import (
        FixedSparsityConfig, block_sparse_kernel as bsk)

    cfg = BertConfig(vocab_size=256, hidden_size=128, num_hidden_layers=2,
                     num_attention_heads=2, intermediate_size=256,
                     max_position_embeddings=256, hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0, dtype=torch.float32,
                     sparsity_config=FixedSparsityConfig(
                         2, block=64, num_local_blocks=2))
    cpu = BertForPreTraining(cfg)
    gpu = BertForPreTraining(cfg).to(cuda)
    gpu.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(2)
    ids = torch.randint(0, 256, (2, 256), generator=gen)
    mask = torch.ones(2, 256, dtype=torch.int32)
    mask[1, -20:] = 0
    labels = torch.where(torch.rand(2, 256, generator=gen) < 0.15, ids,
                         torch.full_like(ids, -100))
    before = dict(bsk.LAUNCHES, **tfa.LAUNCHES)
    losses = []
    for m, dev in ((cpu, "cpu"), (gpu, cuda)):
        b = {"input_ids": ids.to(dev), "attention_mask": mask.to(dev),
             "masked_lm_labels": labels.to(dev)}
        loss, _ = m.loss(b)
        loss.backward()
        losses.append(loss.item())
    after = dict(bsk.LAUNCHES, **tfa.LAUNCHES)
    assert {n: after[n] - before[n] for n in before} == {
        "sparse_fwd": 2, "sparse_bwd_dq": 2, "sparse_bwd_dkdv": 2,
        "flash_fwd": 0, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}
    assert abs(losses[0] - losses[1]) <= 1e-4 * abs(losses[0])
    for (n, p), q in zip(cpu.named_parameters(), gpu.parameters()):
        if p.grad is None:        # the pooler and NSP head: an MLM batch
            assert q.grad is None, n
            continue
        assert _close(q.grad.cpu(), p.grad, torch.float32), n


@pytest.mark.cuda
def test_cuda_sparse_attention_raises_instead_of_rerouting(cuda):
    import numpy as np

    from deepspeed_tpu_torch.ops.sparse_attention import \
        block_sparse_attention

    layout = np.ones((2, 2, 2))
    q = torch.zeros(1, 2, 128, 80, device=cuda)
    with pytest.raises(ValueError, match="head_dim 80"):
        block_sparse_attention(q, q, q, layout, 64)
    q = torch.zeros(1, 2, 128, 64, device=cuda)
    with pytest.raises(ValueError, match="rpe"):
        block_sparse_attention(q, q, q, layout, 64,
                               rpe=torch.zeros(128, 128, device=cuda))
    with pytest.raises(ValueError, match="CPU tensors only"):
        block_sparse_attention(q, q, q, layout, 64, use_pallas=False)
    with pytest.raises(ValueError, match="block 8"):
        block_sparse_attention(q, q, q, np.ones((2, 16, 16)), 8)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp16", "bf16"])
def test_dropout_and_the_step_make_no_host_sync(cuda, precision):
    """A train_batch of a GPT-2 with dropout 0.1 (attention dropout in the
    flash kernels, remat replaying it) runs under
    torch.cuda.set_sync_debug_mode("error"): the dropout seed is drawn and
    read on the device, and the optimizer step decides an overflow there."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model

    dtype = {"fp16": torch.float16, "bf16": torch.bfloat16}[precision]
    cfg = GPT2Config(vocab_size=256, n_positions=128, n_embd=128, n_layer=2,
                     n_head=2, dtype=dtype, dropout=0.1, remat=True,
                     remat_policy="attn_out")
    ds = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
          "gradient_accumulation_steps": 2, "gradient_clipping": 1.0,
          "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
          "steps_per_print": 10 ** 9,
          precision: {"enabled": True}}
    eng, _, _, _ = deepspeed_tpu_torch.initialize(model=GPT2Model(cfg),
                                                  config_params=ds)
    ids = torch.randint(0, 256, (2, 2, 128), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(0))
    batch = {"input_ids": ids, "labels": ids}
    eng.train_batch(batch=batch)          # builds and loads the library
    torch.cuda.synchronize()
    before = dict(tfa.LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = eng.train_batch(batch=batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert {n: tfa.LAUNCHES[n] - before[n] for n in before} == {
        "flash_fwd": 8, "flash_bwd_dkdv": 4, "flash_bwd_dq": 4}
    assert torch.isfinite(loss).item()


def _telemetry_engine(cuda, tmp_path, jsonl, precision="bf16"):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model

    dtype = {"fp16": torch.float16, "bf16": torch.bfloat16}[precision]
    cfg = GPT2Config(vocab_size=256, n_positions=128, n_embd=128, n_layer=2,
                     n_head=2, dtype=dtype)
    tel = {"enabled": True, "trace": True, "mfu": True, "memory": True}
    if jsonl:
        tel["metrics_jsonl"] = str(tmp_path / "m.jsonl")
    ds = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
          "gradient_accumulation_steps": 2, "gradient_clipping": 1.0,
          "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
          "steps_per_print": 10 ** 9, precision: {"enabled": True},
          "telemetry": tel}
    eng = deepspeed_tpu_torch.initialize(model=GPT2Model(cfg),
                                         config_params=ds)[0]
    ids = torch.randint(0, 256, (2, 2, 128), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(0))
    batch = {"input_ids": ids, "labels": ids}
    eng.train_batch(batch=batch)          # builds and loads the library
    torch.cuda.synchronize()
    return eng, batch


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp16", "bf16"])
def test_armed_step_without_a_stream_makes_no_host_sync(cuda, tmp_path,
                                                        precision):
    """Trace, MFU and memory armed (spans on the host clock, the
    allocator's host-side counters, the micro step's shapes captured): a
    train_batch runs under torch.cuda.set_sync_debug_mode("error")."""
    eng, batch = _telemetry_engine(cuda, tmp_path, jsonl=False,
                                   precision=precision)
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.train_batch(batch=batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    rep = eng.telemetry_report()
    assert rep["memory"]["measured"]["micro_step"]["transient_bytes"] > 0
    assert "hbm_in_use" in [e["name"] for e in eng.telemetry.tracer.events()]


@pytest.mark.cuda
def test_the_metrics_stream_costs_one_fetch_per_step(cuda, tmp_path):
    """With metrics_jsonl the step's scalars are stacked and fetched in ONE
    device-to-host copy: exactly one synchronizing call per step."""
    import warnings

    from deepspeed_tpu_torch.telemetry.metrics import MetricsStream

    eng, batch = _telemetry_engine(cuda, tmp_path, jsonl=True)
    for _ in range(2):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                eng.train_batch(batch=batch)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs = [w for w in caught
                 if "called a synchronizing" in str(w.message)]
        assert len(syncs) == 1, [str(w.message) for w in syncs]
    eng.close_telemetry()
    recs = MetricsStream.replay(str(tmp_path / "m.jsonl"))
    assert [r["step"] for r in recs] == [1, 2, 3]
    assert all(isinstance(r["loss"], float) and r["overflow"] is False
               for r in recs)


@pytest.mark.cuda
def test_peak_counter_disarmed_untouched_armed_kept(cuda, tmp_path):
    """A disarmed engine leaves the allocator's peak counter as it found
    it; an armed one resets it for its windows, and its report's device
    peak is what the counter would have read with no reset."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model

    cfg = GPT2Config(vocab_size=256, n_positions=128, n_embd=128, n_layer=2,
                     n_head=2, dtype=torch.bfloat16)
    ds = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
          "gradient_accumulation_steps": 2,
          "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
          "steps_per_print": 10 ** 9, "bf16": {"enabled": True}}
    ids = torch.randint(0, 256, (2, 2, 128), device=cuda)
    batch = {"input_ids": ids, "labels": ids}
    eng = deepspeed_tpu_torch.initialize(model=GPT2Model(cfg),
                                         config_params=ds)[0]
    eng.train_batch(batch=batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    big = torch.empty(2 ** 30, dtype=torch.uint8, device=cuda)
    del big
    marked = torch.cuda.max_memory_allocated()
    eng.train_batch(batch=batch)
    assert torch.cuda.max_memory_allocated() == marked
    del eng         # the step boundary's bytes in use are the armed one's
    torch.cuda.reset_peak_memory_stats()
    big = torch.empty(2 ** 30, dtype=torch.uint8, device=cuda)
    del big
    marked = torch.cuda.max_memory_allocated()
    # the armed engine's windows all open after this reset
    armed, _ = _telemetry_engine(cuda, tmp_path, jsonl=False)
    armed.train_batch(batch=batch)
    assert torch.cuda.max_memory_allocated() < marked       # it was reset
    rep = armed.memory_report()
    assert rep["devices"][0]["peak_bytes_in_use"] == marked
    # the state is priced from the tensors held: at most what is in use
    # (at this tiny width the process's other allocations, cuBLAS
    # workspaces among them, outweigh it: the 15 % gate is phase 20's,
    # at full width)
    check = rep["cross_check"]["train_state"]
    assert check["analytic_bytes"] <= check["measured_bytes"]


@pytest.mark.cuda
def test_moe_train_step_makes_no_host_sync(cuda):
    """A train_batch of a GPT-2 with MoE blocks (bf16, top-2 over 4
    experts, remat 'dots' in its MoE block policy) runs under
    torch.cuda.set_sync_debug_mode("error"): the gating, its capacity drop
    and the dispatch and combine stay on the device, and B1-B3 launch in
    every block, dense and MoE."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model

    cfg = GPT2Config(vocab_size=256, n_positions=128, n_embd=128, n_layer=2,
                     n_head=2, dtype=torch.bfloat16, moe_num_experts=4,
                     remat=True, remat_policy="dots")
    ds = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
          "gradient_accumulation_steps": 2, "gradient_clipping": 1.0,
          "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
          "steps_per_print": 10 ** 9, "bf16": {"enabled": True}}
    eng, _, _, _ = deepspeed_tpu_torch.initialize(model=GPT2Model(cfg),
                                                  config_params=ds)
    ids = torch.randint(0, 256, (2, 2, 128), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(0))
    batch = {"input_ids": ids, "labels": ids}
    eng.train_batch(batch=batch)          # builds and loads the library
    torch.cuda.synchronize()
    before = dict(tfa.LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = eng.train_batch(batch=batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert {n: tfa.LAUNCHES[n] - before[n] for n in before} == {
        "flash_fwd": 8, "flash_bwd_dkdv": 4, "flash_bwd_dq": 4}
    assert torch.isfinite(loss).item()


@pytest.mark.cuda
def test_expert_exchange_in_a_nccl_world_of_one_is_the_identity(
        cuda, monkeypatch):
    """The MoE token exchange (parallel/mesh.py expert_exchange) over a
    1-rank NCCL group: both directions return their input, and so do
    their backwards; each call is counted as one all-to-all."""
    import socket

    import torch.distributed as dist

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.parallel.mesh import (DataParallelGroup,
                                                   expert_exchange)

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    for key, value in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                           RANK="0", WORLD_SIZE="1", LOCAL_RANK="0").items():
        monkeypatch.setenv(key, value)
    deepspeed_tpu_torch.init_distributed()
    try:
        group = DataParallelGroup()
        assert group.backend == "nccl" and group.size == 1
        gen = torch.Generator(device=cuda).manual_seed(0)
        x = torch.randn(4, 3, 5, 8, device=cuda, generator=gen,
                        requires_grad=True)
        g = torch.randn(4, 3, 5, 8, device=cuda, generator=gen)
        y = expert_exchange(x, group, "t/dispatch", True)
        z = expert_exchange(y, group, "t/combine", False)
        assert torch.equal(y, x) and torch.equal(z, x)
        z.backward(g)
        assert torch.equal(x.grad, g)
        rec = group.counter.take()
        assert rec["calls"] == {"all-to-all": 4}
        assert sorted(c["name"] for c in rec["collectives"]) == [
            "moe_a2a:t/combine", "moe_a2a:t/combine_bwd",
            "moe_a2a:t/dispatch", "moe_a2a:t/dispatch_bwd"]
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_nccl_world_of_one_stage2_step_makes_no_host_sync(cuda, monkeypatch):
    """A 1-rank NCCL world at ZeRO stage 2 (bf16): the micro steps'
    all-reduces, the overflow MAX, the norm and the loss reduction enqueue
    on the stream without a host sync under
    torch.cuda.set_sync_debug_mode("error"); the collectives counted in
    the step are the comm volume report's."""
    import socket

    import torch.distributed as dist

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    for key, value in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                           RANK="0", WORLD_SIZE="1", LOCAL_RANK="0").items():
        monkeypatch.setenv(key, value)
    cfg = GPT2Config(vocab_size=256, n_positions=128, n_embd=128, n_layer=2,
                     n_head=2, dtype=torch.bfloat16)
    ds = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
          "gradient_accumulation_steps": 2, "gradient_clipping": 1.0,
          "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
          "zero_optimization": {"stage": 2}, "mesh": {"data": 1},
          "steps_per_print": 10 ** 9, "bf16": {"enabled": True}}
    deepspeed_tpu_torch.init_distributed()
    try:
        assert dist.get_backend() == "nccl"
        eng, _, _, _ = deepspeed_tpu_torch.initialize(model=GPT2Model(cfg),
                                                      config_params=ds)
        ids = torch.randint(0, 256, (2, 2, 128), device=cuda,
                            generator=torch.Generator(device=cuda)
                            .manual_seed(0))
        batch = {"input_ids": ids, "labels": ids}
        eng.train_batch(batch=batch)      # builds the library, warms NCCL
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            loss = eng.train_batch(batch=batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert torch.isfinite(loss).item()
        got = sorted((c["name"], c["op"], c["count_per_step"])
                     for c in eng.last_step_comm["collectives"])
        want = sorted((c["name"], c["op"], c["count_per_step"])
                      for c in eng.comm_volume_report()["collectives"])
        assert got == want and len(got) == len(eng.param_names)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_nccl_worlds_of_2_and_4_match_one_card(cuda, tmp_path):
    """On a host with 4 cards: NCCL worlds of 2 and 4 ranks (rank r on card
    r) at ZeRO stages 1 and 2 train the gloo tests' tiny GPT-2 at the
    kernels' head_dim 64 (n_embd 128; fp32, 5 Adam steps, gas 2) to one
    card's losses (rtol 1e-4) and master weights (rtol 1e-4, atol 5e-5,
    the key biases as in tests/test_torch_zero.py) on the same global
    batch, every rank alike; each step's counted
    collectives are the report's (at stage 1 plus the post-step gather of
    each sharded leaf, ROADMAP C-w7). Skips with fewer than 4 cards.
    The weights' atol is tests/test_torch_checkpoint.py's: the one card
    multiplies micro-batches dp times as large, cuBLAS sums them in
    another order, and Adam moves an element whose gradient is near zero
    by lr times the ratio of two tiny moments (one element of 49152 read
    1.53e-5 apart at dp 4 on an H100, 1.5 % of lr)."""
    import numpy as np

    import torch_zero_worker as W

    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    steps, gas, lr = 5, 2, 1e-3
    model = dict(W.TINY, n_embd=128)
    for dp in (2, 4):
        micro = W.MICRO * dp
        ref = W._engine(W.ds_config(1, 0, gas, micro=micro), None,
                        device="cuda", model=model)
        batches = W.global_batches(0, steps, gas, micro)
        want = [ref.train_batch(batch=W._local(b, 0, micro)).item()
                for b in batches]
        want_master = W._full_master(ref)
        del ref
        jobs = [(f"s{stage}", "train",
                 dict(dp=dp, stage=stage, gas=gas, steps=steps, seed=0,
                      init=None, device="cuda", model=model))
                for stage in (1, 2)]
        ranks = W.run_world(dp, jobs, str(tmp_path / f"dp{dp}"),
                            device="cuda")
        for stage in (1, 2):
            for rank in ranks:
                got = rank[f"s{stage}"]
                np.testing.assert_allclose(got["losses"], want, rtol=1e-4)
                W.assert_master_close(got["master"], want_master, 1e-4,
                                      5e-5, steps, lr,
                                      f"dp {dp} stage {stage}")
                sharded = _sharded_leaves(got, model)
                assert sharded
                extra = set() if stage == 2 else {
                    (f"param_ag:{leaf}", "all-gather", 1) for leaf in sharded}
                report = {(c["name"], c["op"], c["count_per_step"])
                          for c in got["report"]["collectives"]}
                for step in got["comm"]:
                    assert {(c["name"], c["op"], c["count_per_step"])
                            for c in step["collectives"]} == report | extra


@pytest.mark.cuda
def test_nccl_moe_worlds_of_2_and_4_match_one_card(cuda, tmp_path):
    """On a host with 4 cards: expert parallelism over NCCL worlds of 2
    and 4 ranks (8 experts, E/dp per card; stages 0 and 2; fp32, 4 Adam
    steps, gas 2, n_embd 128 for the kernels' head_dim 64) trains to one
    card's losses and master weights at the tolerances of the test above,
    every rank alike, with the model's moe_aux_loss before each step that
    of the whole global batch (rtol 1e-5); each step posts 4 all-to-alls
    per MoE layer and micro step and no collective of an expert leaf.
    Skips with fewer than 4 cards."""
    import numpy as np

    import torch_zero_worker as W

    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    steps, gas, lr = 4, 2, 1e-3
    model = dict(W.MOE, n_embd=128)
    layers = model["n_layer"] // 2
    for dp in (2, 4):
        micro = W.MICRO * dp
        ref = W._engine(W.ds_config(1, 0, gas, micro=micro), None,
                        device="cuda", model=model)
        batches = W.global_batches(0, steps, gas, micro)
        want, want_aux = [], []
        for b in batches:
            local = W._local(b, 0, micro)
            want_aux.append(W._moe_metrics(ref, {k: v[0] for k, v in
                                                 local.items()})[0])
            want.append(ref.train_batch(batch=local).item())
        want_master = W._full_master(ref)
        del ref
        jobs = [(f"s{stage}", "moe",
                 dict(dp=dp, stage=stage, gas=gas, steps=steps, seed=0,
                      init=None, device="cuda", model=model))
                for stage in (0, 2)]
        ranks = W.run_world(dp, jobs, str(tmp_path / f"moe_dp{dp}"),
                            device="cuda")
        for stage in (0, 2):
            for rank in ranks:
                got = rank[f"s{stage}"]
                np.testing.assert_allclose(got["losses"], want, rtol=1e-4)
                np.testing.assert_allclose(got["aux"], want_aux, rtol=1e-5)
                W.assert_master_close(got["master"], want_master, 1e-4,
                                      5e-5, steps, lr,
                                      f"moe dp {dp} stage {stage}")
                assert got["layout"]["h.1.moe.experts.w_in"]["master"][0] \
                    == model["moe_num_experts"] // dp
                for rec in got["comm"]:
                    assert rec["calls"]["all-to-all"] == gas * 4 * layers
                    assert not any("/moe/experts/" in c["name"]
                                   for c in rec["collectives"])


# the four-card sequence-parallel cases: name -> (kind, mesh, stage, model,
# micro, seq); gpt2-350m and bert-base over FixedSparsityConfig(12, block
# 64, local 4, global 1) at full width
_GPT2_350M = dict(vocab_size=50257, n_positions=1024, n_embd=1024,
                  n_layer=24, n_head=16)
_BERT_BASE = dict(vocab_size=30522, hidden_size=768, num_hidden_layers=12,
                  num_attention_heads=12, intermediate_size=3072,
                  max_position_embeddings=4096)
_SEQ_CASES = {
    "s4_ulysses": ("gpt2", {"seq": 4}, 0, _GPT2_350M, 8, 1024),
    "s4_ring": ("gpt2", {"seq": 4}, 0,
                dict(_GPT2_350M, attention_sp_mode="ring"), 8, 1024),
    "d2s2_z2": ("gpt2", {"data": 2, "seq": 2}, 2, _GPT2_350M, 8, 1024),
    "bert_s4_sparse": ("bert", {"seq": 4}, 0, dict(
        _BERT_BASE, sparse=dict(num_heads=12, block=64, num_local_blocks=4,
                                num_global_blocks=1)), 4, 4096),
}


def _seq_collectives(kind, mesh, model, micro, seq):
    """{name: (calls per step, elements)} of the attention's exchanges in
    one step at gas 1: Ulysses's four all-to-alls per layer, or the ring's
    N - 1 hops of K/V forward and backward and N of their gradients."""
    n = mesh["seq"]
    if kind == "gpt2":
        layers, width = model["n_layer"], model["n_embd"]
    else:
        layers, width = model["num_hidden_layers"], model["hidden_size"]
    chunk = micro * width * (seq // n)
    if model.get("attention_sp_mode") == "ring":
        return {"sp_ring:kv": ((n - 1) * layers, 2 * chunk),
                "sp_ring:kv_bwd": ((n - 1) * layers, 2 * chunk),
                "sp_ring:dkv_bwd": (n * layers, 2 * chunk)}
    return {f"sp_a2a:{x}": (layers, m * chunk) for x, m in
            (("qkv", 3), ("out", 1), ("out_bwd", 1), ("qkv_bwd", 3))}


@pytest.mark.cuda
def test_nccl_seq_worlds_match_one_card(cuda, tmp_path):
    """On a host with 4 cards: sequence parallelism over NCCL worlds of 4
    (rank r on card r) trains gpt2-350m bf16 at full width (seq 1024,
    micro 8, gas 1, the flash kernels) at {"seq": 4} with Ulysses and with
    the ring and at {"data": 2, "seq": 2} with ZeRO-2, and bert-base
    block-sparse at seq 4096 (micro 4) at {"seq": 4} with Ulysses, against
    one card on the same global batch (``check_seq_worlds``). Correctness
    only: no timing. Skips with fewer than 4 cards."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    check_seq_worlds(_SEQ_CASES, "cuda", str(tmp_path))


def check_seq_worlds(cases, device, out):
    """Each of ``cases`` in a world of 4 against one process, every rank
    alike: over 3 Adam steps, the losses and gradient norms within rtol
    2e-2 (the bf16 gate of PERF.md section 2), the flash (or block-sparse)
    kernels launched on every rank under Ulysses and none under the ring
    (its rounds are plain torch, as the JAX ring's are jnp), each step's
    counted all-to-alls or hops in closed form, and on the card a peak of
    allocated bytes below one card's (each rank holds S/N positions). The
    weights after one SGD step (lr 1, no weight decay) from the same
    initial ones: each leaf's change from init, which is the clipped
    gradient, within 2e-2 of one card's in relative L2. (Adam moves an
    element by about lr a step whatever its gradient's size, so its
    weights could not tell a wrong gradient from a right one.)"""
    import numpy as np

    import torch_zero_worker as W

    steps, lr = 3, 1e-3
    runs = {"adam": dict(steps=steps, lr=lr, master=None),
            "sgd": dict(steps=1, lr=1.0, optimizer="SGD", weight_decay=0.0,
                        master="delta")}
    jobs = [(f"{name}.{run}", "seq", dict(
        kind=kind, mesh=mesh, stage=stage, gas=1, seed=0, model=model,
        micro=micro, dtype=torch.bfloat16, device=device, seq=seq, **kw))
        for name, (kind, mesh, stage, model, micro, seq) in cases.items()
        for run, kw in runs.items()]
    ranks = W.run_world(4, jobs, os.path.join(out, "seq"), timeout=1500,
                        device=device)
    for name, (kind, mesh, _, model, micro, seq) in cases.items():
        dp = mesh.get("data", 1)
        one = dict(model)
        one.pop("attention_sp_mode", None)
        ref = {run: W.job_seq(kind, {"data": 1}, 0, 1, seed=0, model=one,
                              micro=micro * dp, dtype=torch.bfloat16,
                              device=device, seq=seq, **kw)
               for run, kw in runs.items()}
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        want = _seq_collectives(kind, mesh, model, micro, seq)
        for r, rank in enumerate(ranks):
            got, what = rank[f"{name}.adam"], f"{name} rank {r}"
            np.testing.assert_allclose(got["losses"], ref["adam"]["losses"],
                                       rtol=2e-2, err_msg=what)
            np.testing.assert_allclose(got["norms"], ref["adam"]["norms"],
                                       rtol=2e-2, err_msg=what)
            kernels = ("sparse_fwd", "sparse_bwd_dq", "sparse_bwd_dkdv") \
                if kind == "bert" else ("flash_fwd", "flash_bwd_dkdv",
                                        "flash_bwd_dq")
            ring = model.get("attention_sp_mode") == "ring"
            if device == "cuda":
                assert all((got["launches"][k] == 0) if ring
                           else (got["launches"][k] > 0) for k in kernels), \
                    (what, got["launches"])
                assert got["peak_bytes"] < ref["adam"]["peak_bytes"], what
            for step in got["comm"]:
                seq_ops = {c["name"]: (c["count_per_step"], c["elements"])
                           for c in step["collectives"]
                           if c["name"].startswith(("sp_a2a", "sp_ring"))}
                assert seq_ops == want, what
            worst = 0.0
            delta = rank[f"{name}.sgd"]["master"]
            for leaf, b in ref["sgd"]["master"].items():
                a = delta[leaf]
                err = float(np.linalg.norm(a - b))
                assert err <= 2e-2 * float(np.linalg.norm(b)), (what, leaf,
                                                                 err)
                worst = max(worst, err / max(float(np.linalg.norm(b)),
                                             1e-30))
            print(f"{what}: losses {got['losses']} against "
                  f"{ref['adam']['losses']}, grad norms {got['norms']} "
                  f"against {ref['adam']['norms']}, SGD step's worst leaf "
                  f"rel L2 {worst:.3e}, peak bytes "
                  f"{got.get('peak_bytes')} against one card's "
                  f"{ref['adam'].get('peak_bytes')}")


# the four-card ZeRO-3 cases: name -> (stage, more zero_optimization keys,
# the dp worlds that run it)
_ZERO3_CASES = {
    "s2": (2, {}, (2, 4)),
    "s3_implicit": (3, {"stage3_scheduled_gathers": False}, (2, 4)),
    "s3_scheduled": (3, {}, (2, 4)),
    "qgz": (2, {"quantized_gradients": True}, (2, 4)),
    "qgz_hier": (2, {"quantized_gradients": True,
                     "hierarchical_allreduce": True,
                     "hierarchical_intra_size": 2}, (4,)),
}
# the losses' gate against one card: about 7x the worst measured (1.478e-5,
# scheduled stage 3 at dp 2, 4 x H100 80GB HBM3); every world sums the
# same rows' gradients in another order, and the int8 weights move the
# loss by 1.7e-5 relative at full width (chip_smoke.py phase 25 (c))
ZERO3_LOSS_RTOL = 1e-4


@pytest.mark.cuda
def test_nccl_zero3_worlds_match_one_card(cuda, tmp_path):
    """On a host with 4 cards: gpt2-350m bf16 at full width (seq 1024, the
    flash kernels, gas 2, 10 Adam steps) over NCCL worlds of 2 and 4
    (rank r on card r, 8 / dp rows each: phase 4's global batch of 8),
    against one card on the same global batch: implicit stage 3 equals
    stage 2 at the same dp bit for bit (losses, grad norms and the fp32
    master's digest); stage 2, scheduled stage 3 and qgZ (flat, and
    hierarchical over pairs at dp 4) within ZERO3_LOSS_RTOL of one card's
    losses, every rank alike, each step's counted collectives the
    report's, the scheduled plan armed.
    Prints each rank's parameter bytes at rest, the bytes the card holds
    between steps, its peak and the step ms.
    Skips with fewer than 4 cards."""
    import numpy as np

    import torch_zero_worker as W

    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    steps, gas, rows, seq = 10, 2, 8, 1024
    ref = W._engine(W.ds_config(1, 0, gas, micro=rows, bf16=True), None,
                    dtype=torch.bfloat16, device="cuda", model=_GPT2_350M)
    batches = W.global_batches(0, steps, gas, rows,
                               _GPT2_350M["vocab_size"], seq)
    want = [ref.train_batch(batch=W._local(b, 0, rows)).item()
            for b in batches]
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    for dp in (2, 4):
        jobs = [(name, "train", dict(
            dp=dp, stage=stage, gas=gas, steps=steps, seed=0, init=None,
            device="cuda", model=_GPT2_350M, dtype=torch.bfloat16,
            zero=zero, micro=rows // dp, seq=seq, master_out=False))
            for name, (stage, zero, dps) in _ZERO3_CASES.items()
            if dp in dps]
        ranks = W.run_world(dp, jobs, str(tmp_path / f"z3_dp{dp}"),
                            timeout=1500, device="cuda")
        for name, *_ in jobs:
            for r, rank in enumerate(ranks):
                got, what = rank[name], f"{name} dp {dp} rank {r}"
                assert got["losses"] == ranks[0][name]["losses"], what
                np.testing.assert_allclose(got["losses"], want,
                                           rtol=ZERO3_LOSS_RTOL,
                                           err_msg=what)
                report = sorted((c["name"], c["count_per_step"])
                                for c in got["report"]["collectives"])
                for step in got["comm"]:
                    assert sorted((c["name"], c["count_per_step"])
                                  for c in step["collectives"]) == report, \
                        what
                rel = max(abs(a - b) / b for a, b in zip(got["losses"],
                                                          want))
                ms = sorted(got["step_ms"][1:])
                print(f"{what}: losses {got['losses']} against one card's "
                      f"{want} (max rel {rel:.3e}); params at rest "
                      f"{got['memory']['components']['params_bytes']} B, "
                      f"device allocated at rest {got['rest_bytes']} B, "
                      f"peak {got['peak_bytes']} B, step ms (median of "
                      f"2..) {ms[len(ms) // 2]:.1f}")
        base, implicit = ranks[0]["s2"], ranks[0]["s3_implicit"]
        assert implicit["losses"] == base["losses"]
        assert implicit["norms"] == base["norms"]
        assert implicit["digest"] == base["digest"]
        assert ranks[0]["s3_scheduled"]["stage3"]["armed"]


@pytest.mark.cuda
def test_nccl_onebit_worlds_match_gloo(cuda, tmp_path):
    """On a host with 4 cards: 1-bit Adam (freeze_step 2) and 0/1 Adam
    (var_freeze_step 2, local_steps 2) on the tiny GPT-2 (n_embd 128: the
    flash kernels' head_dim 64), 6 steps each, fp32, the wire armed, over
    an NCCL world of 4 (rank r on card r) against the same world over
    gloo on the CPU: losses at rtol 1e-4 (the card's fp32 flash kernels
    against the plain attention), the master within one sign flip per
    compressed step (tests/torch_a13b_cases.py ``assert_within_one_flip``),
    every rank alike but a 0/1 local round's own loss, and each step's
    counted collectives those of the report's wire: the dense mean in
    warmup, nothing in a local round, the 1-bit Adam's four packed
    collectives per leaf when frozen, the report's ``optimizer_wire``
    collectives at a sync. Skips with fewer than 4 cards."""
    import numpy as np

    import torch_a13b_cases as A
    import torch_zero_worker as W

    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    model = dict(W.TINY, n_embd=128)
    cases = {"ob": ("OneBitAdam", {"freeze_step": 2}, 4),
             "zo": ("ZeroOneAdam", {"var_freeze_step": 2,
                                    "local_steps": 2}, 4)}
    worlds = {}
    for device in ("cpu", "cuda"):
        jobs = [(name, "wire", dict(dp=4, gas=2, steps=6, seed=0, init=None,
                                    optimizer=opt, opt_params=params,
                                    model=model, device=device))
                for name, (opt, params, _) in cases.items()]
        worlds[device] = W.run_world(4, jobs, str(tmp_path / device),
                                     timeout=600, device=device)
    for name, (_, _, compressed) in cases.items():
        want = worlds["cpu"][0][name]
        for r, rank in enumerate(worlds["cuda"]):
            got, what = rank[name], f"{name} rank {r}"
            assert got["wire"] == want["wire"] and got["phases"] == \
                want["phases"], what
            keep = [ph != "local" for ph, _ in got["phases"]]
            if r == 0 or all(keep):
                np.testing.assert_allclose(got["losses"], want["losses"],
                                           rtol=1e-4, err_msg=what)
            assert got["digest"] == worlds["cuda"][0][name]["digest"], what
            A.assert_within_one_flip(got["master"], want["master"],
                                     want["m"], want["v"],
                                     compressed=compressed, what=what)
            leaves = [c["name"].split(":", 1)[1] for c in
                      got["reports"][0]["collectives"]
                      if c["op"] == "all-reduce"]
            for step, (comm, report) in enumerate(zip(got["comm"],
                                                      got["reports"])):
                phase = got["phases"][step][0]
                names = sorted(c["name"] for c in comm["collectives"])
                if phase == "warmup":
                    assert names == sorted(f"grad_ar:{n}" for n in leaves)
                elif phase == "local":
                    assert names == [], what
                elif phase == "frozen":
                    assert names == sorted(
                        f"{p}:{n}" for p in ("onebit_a2a", "onebit_scales",
                                             "onebit_ag", "onebit_ag_scales")
                        for n in leaves), what
                else:
                    assert A.wire_collectives(comm["collectives"]) == \
                        A.wire_collectives(
                            report["optimizer_wire"]["collectives"]), what
            print(f"{what}: losses {got['losses']} against gloo's "
                  f"{want['losses']}")

def _sharded_leaves(result, sizes):
    """The JAX leaf names whose master this rank holds a shard of."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model

    model = GPT2Model(GPT2Config(dtype=torch.float32, **sizes))
    return {path for path, (name, _) in zip(model.reference_leaf_paths(),
                                            model.reference_leaf_specs())
            if result["layout"][name]["master"]
            != result["layout"][name]["full"]}


# ---------------------------------------------------------------------------
# ZeRO-Offload on the card
# ---------------------------------------------------------------------------
def _offload_engine(cuda, offload=True, precision="bf16"):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model

    dtype = {"fp16": torch.float16, "bf16": torch.bfloat16}[precision]
    cfg = GPT2Config(vocab_size=256, n_positions=128, n_embd=128, n_layer=2,
                     n_head=2, dtype=dtype)
    ds = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
          "gradient_accumulation_steps": 2, "gradient_clipping": 1.0,
          "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
          "zero_optimization": {"stage": 2, "cpu_offload": offload},
          "steps_per_print": 10 ** 9, precision: {"enabled": True}}
    eng, _, _, _ = deepspeed_tpu_torch.initialize(model=GPT2Model(cfg),
                                                  config_params=ds)
    ids = torch.randint(0, 256, (2, 2, 128), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(0))
    return eng, {"input_ids": ids, "labels": ids}


@pytest.mark.cuda
def test_offload_state_is_on_the_host_and_the_staging_pinned(cuda):
    """Under cpu_offload the device holds the bf16 parameters and the
    engine's flat bf16 buffer, and no fp32 master, accumulator or Adam
    moment: the engine's fp32 state is host tensors, the two staging
    buffers are pinned, and the bytes the engine allocated on the card
    are its analytic device bytes (params + staging + scaler)."""
    # earlier tests' engines sit in reference cycles: collected here, not
    # while this engine is built, or their frees would count against it
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    eng, _ = _offload_engine(cuda)
    allocated = torch.cuda.memory_allocated() - before
    assert eng._offload and not hasattr(eng, "_flat_accum")
    assert not hasattr(eng.optimizer, "m")
    assert all(p.is_cuda and p.dtype == torch.bfloat16 for p in eng.params)
    for t in (eng.master + eng.accum + eng._host_m + eng._host_v
              + [eng._host_master, eng._host_accum]
              + eng._host_opt["m"] + eng._host_opt["v"]):
        assert t.device.type == "cpu" and t.dtype == torch.float32
        assert not t.is_pinned()
    assert all(s.is_pinned() for s in eng._staging)
    mem = eng._analytic_memory_components()
    assert mem["components"]["master_bytes"] == 0
    assert mem["components"]["grad_accum_bytes"] == 0
    assert mem["components"]["optimizer_state_bytes"] == 0
    n = sum(p.numel() for p in eng.params)
    assert mem["host"]["master_bytes"] == 4 * n
    assert mem["host"]["optimizer_state_bytes"] == 8 * n
    # the allocator rounds each block to 512 bytes
    assert mem["persistent_bytes"] <= allocated \
        <= mem["persistent_bytes"] + 512 * (len(eng.params) + 8)


@pytest.mark.cuda
def test_offload_gradients_go_down_on_a_side_stream(cuda, tmp_path):
    """The device-to-pinned copies of the micro steps' gradients run on a
    stream other than the one the model's kernels run on (read from the
    profiler's trace), and the push up runs on the compute stream."""
    import json

    from torch.profiler import ProfilerActivity, profile

    eng, batch = _offload_engine(cuda)
    eng.train_batch(batch=batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.train_batch(batch=batch)
        torch.cuda.synchronize()
    trace = tmp_path / "trace.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]

    def streams(pred):
        return {e["args"]["stream"] for e in events
                if e.get("ph") == "X" and "stream" in e.get("args", {})
                and pred(e["name"])}

    compute = streams(lambda n: "flash_fwd" in n)
    down = streams(lambda n: "DtoH" in n and "Pinned" in n)
    up = streams(lambda n: "HtoD" in n and "Pinned" in n)
    assert len(compute) == 1 and len(down) == 1 and up
    assert down != compute and up == compute
    assert len([e for e in events if e.get("ph") == "X"
                and "DtoH" in e["name"] and "Pinned" in e["name"]]) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp16", "bf16"])
def test_offload_step_makes_no_host_sync_but_its_decision(cuda, precision):
    """A train_batch under offload runs under
    torch.cuda.set_sync_debug_mode("warn") with no synchronizing call
    counted: the host waits only on the events of the gradient copies
    (one per micro step), which the host step's decision needs, as the
    JAX engine's; the push up and the loss-scale update do not block."""
    import warnings

    eng, batch = _offload_engine(cuda, precision=precision)
    eng.train_batch(batch=batch)          # builds and loads the libraries
    torch.cuda.synchronize()
    waits = eng._host_waits
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            loss = eng.train_batch(batch=batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    assert syncs == [], [str(w.message) for w in syncs]
    assert eng._host_waits - waits == eng.gradient_accumulation_steps()
    assert torch.isfinite(loss).item()


@pytest.mark.cuda
def test_offload_trains_as_the_device_engine(cuda):
    """bf16: 5 steps with the host Adam track the device FusedAdam's
    losses (rtol 2e-3, as the JAX package's test_engine_offload_e2e holds
    its two engines); both fall."""
    got, want = [], []
    for offload, out in ((True, got), (False, want)):
        eng, batch = _offload_engine(cuda, offload)
        out += [eng.train_batch(batch=batch).item() for _ in range(5)]
        del eng
    assert got[-1] < got[0] and want[-1] < want[0]
    import numpy as np

    np.testing.assert_allclose(got, want, rtol=2e-3)


# ---------------------------------------------------------------------------
# serving on the card
# ---------------------------------------------------------------------------
# a small GPT-2 with the kernels' head_dim, bf16 over fp32 weights
_SERVE_CFG = dict(vocab_size=256, n_positions=128, n_embd=128, n_layer=2,
                  n_head=2)
# the replay gate at this size: four bf16 spacings at the top logits'
# magnitude (2**-8 in [1, 2)), as chip_smoke.py derives its gate; the
# planted fault must read 10x above it
_SERVE_DELTA = 2.0 ** -6


def _serve_setup(cuda, **kw):
    import numpy as np

    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    from deepspeed_tpu_torch.serving import InferenceEngine

    model = GPT2Model(GPT2Config(dtype=torch.bfloat16, **_SERVE_CFG),
                      torch.Generator().manual_seed(42))
    eng = InferenceEngine(model, max_slots=4, kv_block_size=16,
                          prefill_chunk=32, **kw)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, int(n)).astype(np.int32)
               for n in rng.integers(4, 80, 8)]
    return model, eng, prompts


def _serve(eng, prompts, max_new=24):
    rids = [eng.submit(p, max_new_tokens=max_new) for p in prompts[:4]]
    for p in prompts[4:]:
        eng.step()
        rids.append(eng.submit(p, max_new_tokens=max_new))
    eng.serve()
    return rids


def _worst_deficit(model, eng, rids, prompts):
    """Max over generated positions of the replay's best logit minus its
    logit of the engine's token; the replay is the training forward (the
    flash kernels) over prompt + generated[:-1]."""
    worst = 0.0
    with torch.no_grad():
        for rid, p in zip(rids, prompts):
            toks = eng.results[rid]["tokens"]
            ids = torch.as_tensor(toks[:-1], device="cuda").long()[None]
            logits = model(ids)[0, len(p) - 1:].float()
            gen = torch.as_tensor(toks[len(p):], device="cuda").long()
            d = logits.max(-1).values - logits.gather(1, gen[:, None])[:, 0]
            worst = max(worst, float(d.max()))
    return worst


@pytest.mark.cuda
def test_serving_replay_gate_and_planted_fault(cuda):
    """Greedy engine tokens on the card score within the gate of the
    replay's best logit; gathering the decode view with each lane's page
    table rotated by one block fails the gate tenfold."""
    from unittest import mock

    from deepspeed_tpu_torch.serving import engine as serving_engine

    model, eng, prompts = _serve_setup(cuda)
    assert eng.device.type == "cuda"
    rids = _serve(eng, prompts)
    model.to(cuda)
    before = dict(tfa.LAUNCHES)
    worst = _worst_deficit(model, eng, rids, prompts)
    assert tfa.LAUNCHES["flash_fwd"] - before["flash_fwd"] \
        == len(rids) * _SERVE_CFG["n_layer"]
    plain = serving_engine._pool_view

    def rotated(pool, scales, l, tables, quantized, out_dtype):
        if tables.shape[0] > 1:
            tables = torch.roll(tables, 1, dims=1)
        return plain(pool, scales, l, tables, quantized, out_dtype)

    _, bad, _ = _serve_setup(cuda)
    with mock.patch.object(serving_engine, "_pool_view", rotated):
        bad_rids = _serve(bad, prompts)
    fault = _worst_deficit(model, bad, bad_rids, prompts)
    print(f"replay deficit {worst:.5f}, planted fault {fault:.5f}")
    assert worst <= _SERVE_DELTA, worst
    assert fault >= 10 * _SERVE_DELTA, fault


@pytest.mark.cuda
def test_serving_step_fetches_once_per_dispatch(cuda):
    """Under torch.cuda.set_sync_debug_mode("warn") a step syncs exactly
    once per dispatch that samples (the decode step and a final prefill
    chunk: tokens and finiteness flags in one fetch) and nowhere else;
    the per-step inputs go up through pinned memory without a sync."""
    import warnings

    model, eng, prompts = _serve_setup(cuda)
    eng.warmup()
    torch.cuda.synchronize()
    rids = [eng.submit(p, max_new_tokens=12) for p in prompts[:6]]
    steps = 0
    while eng.scheduler.has_work():
        before = dict(eng.dispatch_shapes.signatures)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                eng.step()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        fetches = sum(n - before.get(sig, 0) for sig, n in
                      eng.dispatch_shapes.signatures.items()
                      if sig[0] == "decode_step"
                      or sig[0].endswith("_final"))
        syncs = [w for w in caught
                 if "called a synchronizing" in str(w.message)]
        assert len(syncs) == fetches, (steps, fetches,
                                       [str(w.message) for w in syncs])
        steps += 1
    assert steps > 12
    assert all(eng.results[r]["status"] == "finished" for r in rids)


@pytest.mark.cuda
def test_serving_pool_storage_stable_on_card(cuda):
    """The pool tensors keep their storage across steps, int8 included,
    and device_bytes() prices them byte for byte."""
    for quantize in (False, True):
        model, eng, prompts = _serve_setup(cuda, quantize_kv=quantize)
        assert eng.pool.quantized == quantize
        ptrs = [t.data_ptr() for t in eng.pool.tensors.arrays]
        k0 = eng.pool.tensors.k.clone()
        rids = _serve(eng, prompts)
        assert [t.data_ptr() for t in eng.pool.tensors.arrays] == ptrs
        assert not torch.equal(eng.pool.tensors.k, k0)
        assert eng.pool.device_bytes() == sum(
            t.numel() * t.element_size() for t in eng.pool.tensors.arrays)
        assert all(eng.results[r]["status"] == "finished" for r in rids)


def _shared_prefix_prompts(n, prefix_len=40):
    import numpy as np

    rng = np.random.default_rng(1)
    prefix = rng.integers(0, 256, prefix_len).astype(np.int32)
    return [np.concatenate([prefix, rng.integers(0, 256, int(t))
                            .astype(np.int32)])
            for t in rng.integers(3, 30, n)]


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(prefix_cache=True, speculative=3),
    dict(sparse_context={"num_sliding_window_blocks": 2,
                         "num_global_blocks": 1}),
])
def test_a10b_dispatches_fetch_once_and_cow_never_syncs(cuda, kw):
    """Under torch.cuda.set_sync_debug_mode("warn") a step syncs exactly
    once per dispatch that samples (the draft-verify or the sparse
    decode step, and final prefill chunks) and nowhere else: COW splits
    and window-expired frees add no sync."""
    import warnings

    model, eng, _ = _serve_setup(cuda, **kw)
    eng.warmup()
    torch.cuda.synchronize()
    prompts = _shared_prefix_prompts(6)
    rids = [eng.submit(p, max_new_tokens=40) for p in prompts]
    fetching = ("decode_step", "sparse_decode_step", "spec_verify")
    steps = 0
    while eng.scheduler.has_work():
        before = dict(eng.dispatch_shapes.signatures)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                eng.step()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        fetches = sum(n - before.get(sig, 0) for sig, n in
                      eng.dispatch_shapes.signatures.items()
                      if sig[0] in fetching or sig[0].endswith("_final"))
        syncs = [w for w in caught
                 if "called a synchronizing" in str(w.message)]
        assert len(syncs) == fetches, (steps, fetches,
                                       [str(w.message) for w in syncs])
        steps += 1
    assert all(eng.results[r]["status"] == "finished" for r in rids)
    st = eng.pool.stats()
    if eng.prefix_cache:
        assert st["prefix_cow_splits"] >= 1
        assert eng.metrics.spec_verify_steps > 0
    else:
        assert st["window_expired_frees"] > 0


@pytest.mark.cuda
def test_a10b_pool_storage_stable_across_cow_and_window_frees(cuda):
    """COW splits and window-expired frees write the pool in place: the
    tensors keep their storage, int8 scales included."""
    for quantize in (False, True):
        for kw in (dict(prefix_cache=True),
                   dict(sparse_context={"num_sliding_window_blocks": 2})):
            model, eng, _ = _serve_setup(cuda, quantize_kv=quantize, **kw)
            ptrs = [t.data_ptr() for t in eng.pool.tensors.arrays]
            rids = [eng.submit(p, max_new_tokens=24)
                    for p in _shared_prefix_prompts(6)]
            eng.serve()
            assert [t.data_ptr() for t in eng.pool.tensors.arrays] == ptrs
            assert all(eng.results[r]["status"] == "finished" for r in rids)
            st = eng.pool.stats()
            assert st["prefix_cow_splits"] + st["window_expired_frees"] > 0


@pytest.mark.cuda
def test_full_window_sparse_equals_dense_bit_for_bit_on_card(cuda):
    """With the window covering the whole table the sparse dispatches
    gather the dense view in the dense order: the same kernels, the same
    tokens."""
    _, dense, prompts = _serve_setup(cuda)
    _, sparse, _ = _serve_setup(
        cuda, sparse_context={"num_sliding_window_blocks": dense.W,
                              "num_global_blocks": 0})
    assert sparse.sparse.K == dense.W
    got = [_serve(e, prompts) for e in (dense, sparse)]
    for a, b in zip(*got):
        assert (dense.results[a]["tokens"]
                == sparse.results[b]["tokens"]).all()
    assert "sparse_decode_step" in sparse.dispatch_shapes.names()
