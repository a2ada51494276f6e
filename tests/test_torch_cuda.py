"""The port's CUDA kernels on a GPU; every test here skips without one.

This file imports neither jax nor the JAX package, so it also runs on a
machine that has only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: kernel against its plain version element by element,
|a - b| <= 2e-2 (bf16) / 1e-4 (fp32) times (|b| + rms(b)), as chip_smoke.py
holds them: both compute in fp32 from the same stored inputs, so they
differ by summation order and the final rounding to the storage dtype
(at most one bf16 ulp, 2**-7 of the value).
"""
import pytest
import torch

from deepspeed_tpu_torch.ops.transformer import flash_attention as tfa

TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


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
    if dtype == torch.bfloat16:
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
    q = torch.zeros(1, 2, 16, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
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
