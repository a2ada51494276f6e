"""Block-sparse attention of the PyTorch port against the JAX package.

- Layouts and lookup tables: every SparsityConfig's ``make_layout`` and
  ``build_luts`` give exactly the JAX package's arrays (``random`` seeded
  before each BigBird / Variable call).
- Kernels: the plain PyTorch version of each CUDA kernel (what a CPU
  tensor runs) against the Pallas kernels in interpreter mode, as
  tests/unit/test_block_sparse_kernel.py runs them, on the same numpy
  inputs. The CUDA kernels themselves run only on a GPU
  (tests/test_torch_cuda.py, skipped elsewhere).
- The masked dense path (``use_pallas=None/False`` on CPU tensors) against
  the JAX package's XLA masked path, with rpe, attn_mask and key padding.

Tolerances (fp32, (2, 2, 256, 64) unit-normal inputs): outputs and lse at
atol 1e-5, gradients at atol 1e-4. Both sides compute in fp32 over the
same blocks in the same order, but sum inside a block in different orders;
fp32 rounding of sums over up to 256 keys is ~1e-6 on the outputs and grows
to ~1e-5 on the gradients, which sum products over both sequence axes.
"""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu.ops.sparse_attention import block_sparse_kernel as jbsk
from deepspeed_tpu_torch.ops import sparse_attention as tsa
from deepspeed_tpu_torch.ops.sparse_attention import \
    block_sparse_kernel as tbsk
from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import \
    sparse_refusal

B, H, S, D = 2, 2, 256, 64
OUT_ATOL = 1e-5
GRAD_ATOL = 1e-4

LAYOUT_CASES = [
    ("DenseSparsityConfig", dict(num_heads=2, block=16), 64),
    ("FixedSparsityConfig", dict(num_heads=4, block=16), 256),
    ("FixedSparsityConfig", dict(num_heads=2, block=16, num_local_blocks=4,
                                 attention="unidirectional"), 160),
    ("FixedSparsityConfig", dict(num_heads=4, block=16,
                                 different_layout_per_head=True,
                                 num_local_blocks=4, num_global_blocks=2,
                                 horizontal_global_attention=True,
                                 num_different_global_patterns=2), 224),
    ("FixedSparsityConfig", dict(num_heads=12, block=64, num_local_blocks=4,
                                 num_global_blocks=1), 4096),
    ("VariableSparsityConfig", dict(num_heads=3, block=16,
                                    different_layout_per_head=True,
                                    num_random_blocks=2,
                                    local_window_blocks=[2, 3],
                                    global_block_indices=[0, 5],
                                    global_block_end_indices=[2, 7]), 256),
    ("VariableSparsityConfig", dict(num_heads=2, block=32,
                                    num_random_blocks=1,
                                    attention="unidirectional"), 512),
    ("BigBirdSparsityConfig", dict(num_heads=4, block=16,
                                   different_layout_per_head=True,
                                   num_random_blocks=2), 256),
    ("BigBirdSparsityConfig", dict(num_heads=2, block=64,
                                   num_sliding_window_blocks=5,
                                   num_global_blocks=2), 1024),
    ("BSLongformerSparsityConfig", dict(num_heads=2, block=16,
                                        num_sliding_window_blocks=5,
                                        global_block_indices=[0, 6],
                                        global_block_end_indices=[2, 8]),
     256),
]


@pytest.mark.parametrize("name,kwargs,seq", LAYOUT_CASES)
def test_layouts_and_luts_equal_jax(name, kwargs, seq):
    random.seed(1234)
    want = getattr(jsa, name)(**kwargs).make_layout(seq)
    random.seed(1234)
    got = getattr(tsa, name)(**kwargs).make_layout(seq)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    for a, b in zip(tbsk.build_luts(got), jbsk.build_luts(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_config_errors_match_jax():
    for mod in (jsa, tsa):
        with pytest.raises(ValueError, match="divisible"):
            mod.FixedSparsityConfig(4, num_local_blocks=3,
                                    num_global_blocks=2)
        with pytest.raises(ValueError, match="divisible by block"):
            mod.DenseSparsityConfig(2, block=16).make_layout(40)


def test_luts_are_cached_per_layout_and_device():
    lay = tsa.FixedSparsityConfig(2, block=16).make_layout(128)
    a = tbsk.luts_for(lay, "cpu")
    assert tbsk.luts_for(lay.copy(), "cpu") is a      # keyed by content
    assert all(t.dtype == torch.int32 for t in a)
    other = lay.copy()
    other[0, 0, 1] = 1 - other[0, 0, 1]
    assert tbsk.luts_for(other, "cpu") is not a


# ---------------------------------------------------------------------------
# plain kernel versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------
def _layout(kind, block):
    nb = S // block
    if kind == "fixed":
        return tsa.FixedSparsityConfig(
            H, block=block, num_local_blocks=2 if nb <= 4 else 4,
            num_global_blocks=1).make_layout(S)
    if kind == "fixed_uni":
        return tsa.FixedSparsityConfig(
            H, block=block, num_local_blocks=2,
            attention="unidirectional").make_layout(S)
    # per-head BigBird, ragged nnz, with one empty row in head 1
    random.seed(5)
    lay = tsa.BigBirdSparsityConfig(
        H, block=block, different_layout_per_head=True,
        num_random_blocks=1, num_sliding_window_blocks=1,
        num_global_blocks=1).make_layout(S)
    lay[1, nb // 2] = 0
    return lay


KERNEL_CASES = [(kind, block, bias) for kind in ("fixed", "fixed_uni",
                                                 "bigbird")
                for block in (64, 16) for bias in (False, True)]


def _inputs(kind, block, bias):
    rng = np.random.default_rng(KERNEL_CASES.index((kind, block, bias)))
    q, k, v, g = (rng.standard_normal((B, H, S, D)).astype(np.float32)
                  for _ in range(4))
    kb = None
    if bias:
        kb = (2.0 * rng.standard_normal((B, S))).astype(np.float32)
        kb[:, -9:] = -1e30                   # padded keys
    return q, k, v, g, kb


def _jax_attention(q, k, v, g, layout, block, kb):
    """(out, (dq, dk, dv)) of the Pallas kernels for sum(out * g)."""
    jkb = None if kb is None else jnp.asarray(kb)

    def f(q, k, v):
        out = jbsk.pallas_block_sparse_attention(q, k, v, layout, block,
                                                 key_bias=jkb,
                                                 interpret=True)
        return jnp.sum(out * g), out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                         has_aux=True)(q, k, v)
    return np.asarray(out), tuple(np.asarray(x) for x in grads)


def _torch_attention(fn, q, k, v, g, layout, block, kb):
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = fn(tq, tk, tv, layout, block,
             key_bias=None if kb is None else torch.tensor(kb))
    (out * torch.tensor(g)).sum().backward()
    return out.detach().numpy(), (tq.grad.numpy(), tk.grad.numpy(),
                                  tv.grad.numpy())


@pytest.mark.parametrize("path", ["plain_kernels", "autograd_reference"])
@pytest.mark.parametrize("kind,block,bias", KERNEL_CASES)
def test_port_matches_pallas_kernels(kind, block, bias, path):
    """pallas_block_sparse_attention on CPU tensors (the autograd Function
    running the plain versions of the three kernels) and
    block_sparse_attention_reference (autograd through the plain forward)
    both match the Pallas kernels: Fixed bi- and unidirectional, per-head
    BigBird with ragged nnz and an empty row, with and without a key bias."""
    fn = tbsk.pallas_block_sparse_attention if path == "plain_kernels" \
        else tbsk.block_sparse_attention_reference
    q, k, v, g, kb = _inputs(kind, block, bias)
    layout = _layout(kind, block)
    before = dict(tbsk.LAUNCHES)
    out, grads = _torch_attention(fn, q, k, v, g, layout, block, kb)
    assert tbsk.LAUNCHES == before, "a CPU tensor must not count a launch"
    j_out, j_grads = _jax_attention(q, k, v, g, layout, block, kb)
    np.testing.assert_allclose(out, j_out, atol=OUT_ATOL, rtol=0)
    for name, a, b in zip("qkv", grads, j_grads):
        np.testing.assert_allclose(a, b, atol=GRAD_ATOL, rtol=0,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("kind,block,bias", [("bigbird", 16, True),
                                             ("fixed", 64, True),
                                             ("fixed_uni", 16, False)])
def test_each_plain_kernel_matches_its_pallas_kernel(kind, block, bias):
    """Kernel by kernel: sparse_fwd_plain against _sparse_fwd (out and
    lse, empty rows included), then sparse_bwd_dq_plain and
    sparse_bwd_dkdv_plain against _sparse_bwd fed the same residuals."""
    q, k, v, g, kb = _inputs(kind, block, bias)
    layout = _layout(kind, block)
    q3, k3, v3, g3 = (x.reshape(B * H, S, D) for x in (q, k, v, g))
    jluts = jbsk.build_luts(layout)
    jkb = None if kb is None else jnp.asarray(kb)
    j_out, j_lse = jbsk._sparse_fwd(q3, k3, v3, jluts[0], jluts[1],
                                    scale=D ** -0.5, block=block, heads=H,
                                    interpret=True, key_bias=jkb)
    luts = tbsk.luts_for(layout, "cpu")
    kw = dict(scale=D ** -0.5, block=block, num_heads=H)
    tq, tk, tv, tg = (torch.tensor(x) for x in (q3, k3, v3, g3))
    tkb = None if kb is None else torch.tensor(kb)
    out, lse = tbsk.sparse_fwd(tq, tk, tv, luts, tkb, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out),
                               atol=OUT_ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse),
                               atol=OUT_ATOL, rtol=0)
    res = (q3, k3, v3, jkb, j_out, j_lse) + tuple(jluts)
    j_dq, j_dk, j_dv = jbsk._sparse_bwd(res, g3, scale=D ** -0.5,
                                        block=block, heads=H, interpret=True)
    delta = (tg * out).sum(-1)
    dq = tbsk.sparse_bwd_dq(tq, tk, tv, tg, lse, delta, luts, tkb, **kw)
    dk, dv = tbsk.sparse_bwd_dkdv(tq, tk, tv, tg, lse, delta, luts, tkb,
                                  **kw)
    for a, b in ((dq, j_dq), (dk, j_dk), (dv, j_dv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL,
                                   rtol=0)


def test_empty_rows_give_zero_and_lse_neg_inf():
    layout = _layout("bigbird", 16)
    q, k, v, _, _ = _inputs("bigbird", 16, False)
    q3, k3, v3 = (torch.tensor(x.reshape(B * H, S, D)) for x in (q, k, v))
    out, lse = tbsk.sparse_fwd(q3, k3, v3, tbsk.luts_for(layout, "cpu"),
                               None, scale=D ** -0.5, block=16, num_heads=H)
    rows = slice(S // 2, S // 2 + 16)            # head 1's empty row
    for b in range(B):
        assert torch.all(out[b * H + 1, rows] == 0)
        assert torch.all(lse[b * H + 1, rows] == tbsk.NEG_INF)
        assert torch.all(out[b * H, rows] != 0)


def test_fully_padded_row_follows_the_pallas_kernel():
    """A query row whose active keys are all padded (key bias -1e30): every
    score rounds to exactly -1e30 and ties, so the Pallas kernel returns the
    mean of v over the active keys. The port's kernels and plain versions
    follow it; its masked CPU path follows the JAX XLA path, which takes
    the mean over all S keys (ROADMAP C-w4)."""
    rng = np.random.default_rng(21)
    q, k, v, g = (rng.standard_normal((1, 1, 128, 64)).astype(np.float32)
                  for _ in range(4))
    layout = np.array([[[1, 1], [0, 1]]])
    kb = np.zeros((1, 128), np.float32)
    kb[:, 64:] = -1e30
    j_out, j_grads = _jax_attention(q, k, v, g, layout, 64, kb)
    np.testing.assert_allclose(j_out[0, 0, 64:],
                               np.broadcast_to(v[0, 0, 64:].mean(0),
                                               (64, 64)), atol=1e-6)
    for fn in (tbsk.pallas_block_sparse_attention,
               tbsk.block_sparse_attention_reference):
        out, grads = _torch_attention(fn, q, k, v, g, layout, 64, kb)
        np.testing.assert_allclose(out, j_out, atol=OUT_ATOL, rtol=0)
        if fn is tbsk.pallas_block_sparse_attention:
            for a, b in zip(grads, j_grads):
                np.testing.assert_allclose(a, b, atol=GRAD_ATOL, rtol=0)
    masked = tsa.block_sparse_attention(
        *(torch.tensor(x) for x in (q, k, v)), layout, 64,
        key_padding_mask=torch.tensor(kb))
    xla = jsa.block_sparse_attention(q, k, v, layout, 64,
                                     key_padding_mask=kb, use_pallas=False)
    np.testing.assert_allclose(masked.numpy(), np.asarray(xla),
                               atol=OUT_ATOL, rtol=0)
    np.testing.assert_allclose(masked.numpy()[0, 0, 64:],
                               np.broadcast_to(v[0, 0].mean(0), (64, 64)),
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the masked dense path and the dispatch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("variant", ["plain", "rpe", "attn_mask_mul",
                                     "attn_mask_add", "kpm_add", "kpm_mul",
                                     "all"])
def test_masked_path_matches_jax_xla_path(variant):
    rng = np.random.default_rng(31)
    s, block = 128, 16
    q, k, v = (rng.standard_normal((B, H, s, 32)).astype(np.float32)
               for _ in range(3))
    random.seed(3)
    layout = tsa.BigBirdSparsityConfig(H, block=block,
                                       different_layout_per_head=True
                                       ).make_layout(s)
    kw = {}
    if variant in ("rpe", "all"):
        kw["rpe"] = rng.standard_normal((s, s)).astype(np.float32)
    if variant in ("attn_mask_mul", "all"):
        kw["attn_mask"] = (rng.random((s, s)) > 0.2).astype(np.float32)
        kw["attn_mask_mode"] = "mul"
    if variant == "attn_mask_add":
        kw["attn_mask"] = rng.standard_normal((s, s)).astype(np.float32)
        kw["attn_mask_mode"] = "add"
    if variant in ("kpm_mul", "all"):
        kpm = np.ones((B, s), np.float32)
        kpm[1, -20:] = 0
        kw["key_padding_mask"], kw["key_padding_mask_mode"] = kpm, "mul"
    if variant == "kpm_add":
        kpm = rng.standard_normal((B, s)).astype(np.float32)
        kpm[0, -5:] = -1e30
        kw["key_padding_mask"], kw["key_padding_mask_mode"] = kpm, "add"
    want = jsa.block_sparse_attention(q, k, v, layout, block,
                                      use_pallas=False, **kw)
    tkw = {n: torch.tensor(x) if isinstance(x, np.ndarray) else x
           for n, x in kw.items()}
    for use_pallas in (None, False):
        got = tsa.block_sparse_attention(
            *(torch.tensor(x) for x in (q, k, v)), layout, block,
            use_pallas=use_pallas, **tkw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=OUT_ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["add", "mul"])
def test_module_matches_jax_module_on_both_routes(mode):
    """SparseSelfAttention (masked path) against the JAX module, and the
    kernels' plain versions (use_pallas=True) against the Pallas kernel
    given the key padding in the same mode."""
    rng = np.random.default_rng(41)
    q, k, v = (rng.standard_normal((B, H, S, D)).astype(np.float32)
               for _ in range(3))
    if mode == "add":
        kpm = rng.standard_normal((B, S)).astype(np.float32)
    else:
        kpm = np.ones((B, S), np.float32)
        kpm[:, -13:] = 0
    cfg = dict(num_heads=H, block=32, num_local_blocks=2)
    jmod = jsa.SparseSelfAttention(jsa.FixedSparsityConfig(**cfg),
                                   key_padding_mask_mode=mode)
    tmod = tsa.SparseSelfAttention(tsa.FixedSparsityConfig(**cfg),
                                   key_padding_mask_mode=mode)
    assert not list(tmod.parameters())
    tq, tk, tv, tkpm = (torch.tensor(x) for x in (q, k, v, kpm))
    want = jmod(q, k, v, key_padding_mask=kpm)
    got = tmod(tq, tk, tv, key_padding_mask=tkpm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OUT_ATOL,
                               rtol=0)
    assert tmod.get_layout(S) is tmod.get_layout(S)
    layout = tmod.get_layout(S)
    want_k = jsa.block_sparse_attention(q, k, v, layout, 32,
                                        key_padding_mask=kpm,
                                        key_padding_mask_mode=mode,
                                        use_pallas=True)
    got_k = tsa.block_sparse_attention(tq, tk, tv, layout, 32,
                                       key_padding_mask=tkpm,
                                       key_padding_mask_mode=mode,
                                       use_pallas=True)
    np.testing.assert_allclose(got_k.numpy(), np.asarray(want_k),
                               atol=OUT_ATOL, rtol=0)
    with pytest.raises(ValueError, match="heads"):
        tmod(tq[:, :1], tk[:, :1], tv[:, :1])


def test_layout_to_token_mask_matches_jax():
    lay = tsa.FixedSparsityConfig(2, block=8).make_layout(64)
    np.testing.assert_array_equal(
        tsa.layout_to_token_mask(lay, 8).numpy(),
        np.asarray(jsa.layout_to_token_mask(lay, 8)))


def test_cuda_dispatch_refuses_what_the_kernels_cannot_take():
    """The reasons a CUDA call would be refused (raised, never rerouted to
    the masked path)."""
    q = torch.zeros(1, 2, 128, 64)
    assert sparse_refusal(q, 64) is None
    assert "rpe" in sparse_refusal(q, 64, rpe=torch.zeros(128, 128))
    assert "attn_mask" in sparse_refusal(q, 64,
                                         attn_mask=torch.ones(128, 128))
    assert "block 8" in sparse_refusal(q, 8)
    assert "multiple of block" in sparse_refusal(torch.zeros(1, 2, 96, 64),
                                                 64)
    assert "head_dim 80" in sparse_refusal(torch.zeros(1, 2, 128, 80), 64)
    assert "dtype" in sparse_refusal(q.half(), 64)


def test_masked_path_runs_on_cpu_tensors_only():
    """A tensor off the CPU never takes the masked path: use_pallas=False
    raises, a refused call raises, and None routes to the kernels (which
    raise here, on a device that has none)."""
    q = torch.zeros(1, 2, 128, 64, device="meta")
    lay = np.ones((2, 2, 2))
    with pytest.raises(ValueError, match="CPU tensors only"):
        tsa.block_sparse_attention(q, q, q, lay, 64, use_pallas=False)
    with pytest.raises(ValueError, match="rpe"):
        tsa.block_sparse_attention(q, q, q, lay, 64,
                                   rpe=torch.zeros(128, 128, device="meta"))
    with pytest.raises(ValueError, match="no kernel or plain version"):
        tsa.block_sparse_attention(q, q, q, lay, 64)
    x = torch.zeros(1, 2, 128, 64)
    with pytest.raises(ValueError, match="no rpe or attn_mask"):
        tsa.block_sparse_attention(x, x, x, lay, 64, use_pallas=True,
                                   rpe=torch.zeros(128, 128))


def test_wrappers_refuse_bad_arguments():
    x = torch.zeros(1, 2, 128, 64)
    with pytest.raises(ValueError, match="layout"):
        tbsk.pallas_block_sparse_attention(x, x, x, np.ones((2, 4, 4)), 64)
    with pytest.raises(ValueError, match="key_bias"):
        tbsk.pallas_block_sparse_attention(x, x, x, np.ones((2, 2, 2)), 64,
                                           key_bias=torch.zeros(2, 128))
    luts = tbsk.luts_for(np.ones((2, 2, 2)), "cpu")
    q = torch.zeros(2, 128, 64)
    with pytest.raises(ValueError, match="operand"):
        tbsk._check_cuda((q, q[:, :64]), luts, None, 64, 2)
    with pytest.raises(ValueError, match="lse and delta"):
        tbsk._check_cuda((q, q, q, q), luts, None, 64, 2,
                         stats=(torch.zeros(2, 128).double(),
                                torch.zeros(2, 128)))
    with pytest.raises(ValueError, match="LUTs"):
        tbsk._check_cuda((q, q, q), tbsk.luts_for(np.ones((1, 2, 2)), "cpu"),
                         None, 64, 2)
    with pytest.raises(ValueError, match="key_bias"):
        tbsk._check_cuda((q, q, q), luts, torch.zeros(2, 128), 64, 2)


# ---------------------------------------------------------------------------
# utilities
# ---------------------------------------------------------------------------
def test_pad_unpad_and_position_extension_match_jax():
    from deepspeed_tpu.ops.sparse_attention import \
        SparseAttentionUtils as JUtils

    U = tsa.SparseAttentionUtils
    rng = np.random.default_rng(51)
    ids = rng.integers(1, 100, (2, 45))
    mask = np.ones((2, 45), np.int64)
    types = rng.integers(0, 2, (2, 45))
    pos = np.broadcast_to(np.arange(45), (2, 45)).copy()
    emb = rng.standard_normal((2, 45, 8)).astype(np.float32)
    table = rng.standard_normal((100, 8)).astype(np.float32)
    want = JUtils.pad_to_block_size(16, ids, mask, types, pos, emb,
                                    pad_token_id=3, model_embeddings=table)
    got = U.pad_to_block_size(16, *(torch.tensor(x) for x in
                                    (ids, mask, types, pos, emb)),
                              pad_token_id=3,
                              model_embeddings=torch.tensor(table))
    assert got[0] == want[0] == 3
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        U.unpad_sequence_output(3, got[5]).numpy(),
        np.asarray(JUtils.unpad_sequence_output(3, want[5])))
    assert U.pad_to_block_size(15, torch.tensor(ids))[0] == 0
    np.testing.assert_array_equal(
        U.extend_position_embedding(torch.tensor(table), 250).numpy(),
        np.asarray(JUtils.extend_position_embedding(table, 250)))
    with pytest.raises(ValueError, match="must exceed"):
        U.extend_position_embedding(torch.tensor(table), 100)

    class Tok:
        model_max_length = 512
        init_kwargs = {}

    tok = U.update_tokenizer_model_max_length(Tok(), 4096)
    assert tok.model_max_length == tok.init_kwargs["model_max_length"] == 4096


# ---------------------------------------------------------------------------
# precision policy of the bf16 tensor-core forward
# ---------------------------------------------------------------------------
def _tc_forward_emulation(q, k, v, luts, key_bias, *, scale, block,
                          num_heads, p_operand):
    """The bf16 tensor-core forward's arithmetic in torch: S from bf16
    operands (exact products) summed in fp32, s = S * scale + bias, the
    online softmax in fp32 over the LUT's blocks in order, and P.V taken
    from ``p_operand(p)``, a list of bf16 parts of p whose products with V
    sum in fp32. Returns the output rounded to bf16."""
    bh, s, d = q.shape
    qf, kf, vf = (tbsk._blocks(t, num_heads, block) for t in (q, k, v))
    bias = tbsk._key_bias_blocks(key_bias, num_heads, block)
    m = torch.full((*qf.shape[:4], 1), tbsk.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros(qf.shape)
    for a in range(luts.cols.shape[-1]):
        kb = luts.cols[:, :, a]
        active = (a < luts.nnz)[None, :, :, None, None]
        sc = torch.einsum("bhiqd,bhikd->bhiqk", qf, tbsk._gather(kf, kb))
        sc = sc * scale
        if bias is not None:
            sc = sc + tbsk._gather(bias, kb)[:, :, :, None, :]
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l_new = l * alpha + p.sum(-1, keepdim=True)
        vg = tbsk._gather(vf, kb)
        pv = sum(torch.einsum("bhiqk,bhikd->bhiqd", part.float(), vg)
                 for part in p_operand(p))
        m = torch.where(active, m_new, m)
        l = torch.where(active, l_new, l)
        acc = torch.where(active, acc * alpha + pv, acc)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.where(l > 0.0, acc / l_safe, torch.zeros_like(acc))
    return out.to(torch.bfloat16).reshape(bh, s, d)


def _split_p(p):
    """The kernel's policy: p_hi = bf16(p), p_lo = bf16(p - p_hi)."""
    hi = p.to(torch.bfloat16)
    return [hi, (p - hi.float()).to(torch.bfloat16)]


def _round_p_once(p):
    """What the policy forbids: p rounded to bf16 once."""
    return [p.to(torch.bfloat16)]


def _bf16_ulps(a, b):
    """|a - b| in bf16 ulps of max(|b|, rms(b)), element by element. The
    floor at the rms keeps out the elements that cancel to near zero, whose
    own ulp is far below the rounding error of any fp32 sum that makes
    them."""
    a, b = a.float(), b.float()
    mag = torch.maximum(b.abs(), b.square().mean().sqrt())
    return (a - b).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)


# at most this share of the output elements may differ from the Pallas
# kernel's, each by at most one bf16 ulp (of max(|b|, rms(b))). Measured on
# the four cases below: 0.12-0.23 % differ with p split (the two sum the
# same exact products in other orders, with p to about 16 bits, and a sum
# close to a bf16 rounding boundary rounds either way), 26-38 % with p
# rounded to bf16 once, some of them by 1.5-2 ulps
SPLIT_P_SHARE = 1e-2


@pytest.mark.parametrize("d,bias", [(64, False), (64, True), (96, True),
                                    (128, True)])
def test_bf16_forward_needs_p_at_fp32_accuracy(d, bias):
    """The Pallas block-sparse forward (interpret mode, bf16 inputs, fp32
    upcast, p kept fp32) against the tensor-core forward's arithmetic on
    the CPU at (2, 2, 512, d) over a Fixed layout at block 64: with p split
    into two bf16 parts, at most SPLIT_P_SHARE of the output elements
    differ, by one bf16 ulp at most; with p rounded to bf16 once, the same
    check fails."""
    s, block = 512, 64
    rng = np.random.default_rng(100 + d + bias)
    q, k, v = (rng.standard_normal((B * H, s, d)).astype(np.float32)
               for _ in range(3))
    kb = None
    if bias:
        kb = (2.0 * rng.standard_normal((B, s))).astype(np.float32)
        kb[:, -9:] = -1e30                   # padded keys
    layout = tsa.FixedSparsityConfig(H, block=block, num_local_blocks=4,
                                     num_global_blocks=1).make_layout(s)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    cols, nnz, _, _ = jbsk.build_luts(layout)
    j_out, _ = jbsk._sparse_fwd(jq, jk, jv, cols, nnz, scale=d ** -0.5,
                                block=block, heads=H, interpret=True,
                                key_bias=None if kb is None
                                else jnp.asarray(kb))
    want = torch.tensor(np.asarray(j_out.astype(jnp.float32))).bfloat16()
    tq, tk, tv = (torch.tensor(x).bfloat16() for x in (q, k, v))
    kw = dict(scale=d ** -0.5, block=block, num_heads=H)
    luts = tbsk.luts_for(layout, "cpu")
    tkb = None if kb is None else torch.tensor(kb)
    plain, _ = tbsk.sparse_fwd_plain(tq, tk, tv, luts, tkb, **kw)
    assert int(_bf16_ulps(plain, want).max()) <= 1
    for policy, holds in ((_split_p, True), (_round_p_once, False)):
        got = _tc_forward_emulation(tq, tk, tv, luts, tkb, p_operand=policy,
                                    **kw)
        ulps = _bf16_ulps(got, want)
        share = float((ulps > 0).float().mean())
        ok = int(ulps.max()) <= 1 and share <= SPLIT_P_SHARE
        assert ok == holds, (policy.__name__, share, int(ulps.max()))


# ---------------------------------------------------------------------------
# precision policy of the bf16 tensor-core backward sweeps
# ---------------------------------------------------------------------------
def _tc_backward_emulation(q, k, v, do, lse, delta, luts, key_bias, *, scale,
                           block, num_heads, operand):
    """The bf16 tensor-core dQ and dK/dV sweeps' arithmetic in torch: S and
    dP from bf16 operands (exact products) summed in fp32, s = S * scale +
    bias, p = exp(s - lse) and dS = p (dP - delta) scale in fp32
    (``_bwd_probs``), and the second products dQ = dS.K, dV = p^T.dO and
    dK = dS^T.Q taken from ``operand(x)``, a list of bf16 parts of p or dS
    whose products sum in fp32, over the LUTs' blocks in order. Returns
    (dq, dk, dv) rounded to bf16."""
    bh, s, d = q.shape
    qf, kf, vf, dof = (tbsk._blocks(t, num_heads, block)
                       for t in (q, k, v, do))
    lse_b, delta_b = (tbsk._blocks(t, num_heads, block)[..., None]
                      for t in (lse, delta))
    bias = tbsk._key_bias_blocks(key_bias, num_heads, block)

    def product(eq, x, y):
        return sum(torch.einsum(eq, part.float(), y) for part in operand(x))

    dq = torch.zeros(qf.shape)
    for a in range(luts.cols.shape[-1]):
        kb = luts.cols[:, :, a]
        active = (a < luts.nnz)[None, :, :, None, None]
        kg = tbsk._gather(kf, kb)
        _, ds = tbsk._bwd_probs(qf, kg, tbsk._gather(vf, kb), dof, lse_b,
                                delta_b, None if bias is None
                                else tbsk._gather(bias, kb), scale)
        dq = torch.where(active, dq + product("bhiqk,bhikd->bhiqd", ds, kg),
                         dq)
    dk, dv = torch.zeros(kf.shape), torch.zeros(vf.shape)
    for a in range(luts.rows_t.shape[-1]):
        qb = luts.rows_t[:, :, a]
        active = (a < luts.nnz_t)[None, :, :, None, None]
        qg, dog = tbsk._gather(qf, qb), tbsk._gather(dof, qb)
        p, ds = tbsk._bwd_probs(qg, kf, vf, dog, tbsk._gather(lse_b, qb),
                                tbsk._gather(delta_b, qb), bias, scale)
        dv = torch.where(active, dv + product("bhiqk,bhiqd->bhikd", p, dog),
                         dv)
        dk = torch.where(active, dk + product("bhiqk,bhiqd->bhikd", ds, qg),
                         dk)
    return tuple(x.to(torch.bfloat16).reshape(bh, s, d) for x in (dq, dk, dv))


@pytest.mark.parametrize("d", [64, 96, 128])
@pytest.mark.parametrize("bias", [False, True])
def test_bf16_backward_needs_p_and_ds_at_fp32_accuracy(d, bias):
    """The Pallas block-sparse backward (``_sparse_bwd`` in interpret mode,
    bf16 inputs, fp32 upcast, p and dS kept fp32) against the tensor-core
    sweeps' arithmetic on the CPU at (2, 2, 512, d) over a Fixed layout at
    block 64, fed the Pallas forward's out and lse: with p and dS split into
    two bf16 parts, at most SPLIT_P_SHARE of the elements of dq, dk and dv
    differ, by one bf16 ulp at most. Measured on the six cases: 0.17-0.26 %
    of the elements of each gradient differ with p and dS split, by one ulp;
    38.9-42.5 % with p and dS rounded to bf16 once, by up to 2-4 ulps, and
    up to 8-14 in dk and dv with the key bias: rounding once fails the
    same check."""
    s, block = 512, 64
    rng = np.random.default_rng(200 + d + bias)
    q, k, v, do = (rng.standard_normal((B * H, s, d)).astype(np.float32)
                   for _ in range(4))
    kb = None
    if bias:
        kb = (2.0 * rng.standard_normal((B, s))).astype(np.float32)
        kb[:, -9:] = -1e30                   # padded keys
    layout = tsa.FixedSparsityConfig(H, block=block, num_local_blocks=4,
                                     num_global_blocks=1).make_layout(s)
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    jluts = jbsk.build_luts(layout)
    jkb = None if kb is None else jnp.asarray(kb)
    j_out, j_lse = jbsk._sparse_fwd(jq, jk, jv, jluts[0], jluts[1],
                                    scale=d ** -0.5, block=block, heads=H,
                                    interpret=True, key_bias=jkb)
    want = [torch.tensor(np.asarray(g.astype(jnp.float32))).bfloat16()
            for g in jbsk._sparse_bwd((jq, jk, jv, jkb, j_out, j_lse)
                                      + tuple(jluts), jdo, scale=d ** -0.5,
                                      block=block, heads=H, interpret=True)]
    tq, tk, tv, tdo = (torch.tensor(x).bfloat16() for x in (q, k, v, do))
    out = torch.tensor(np.asarray(j_out.astype(jnp.float32)))
    lse = torch.tensor(np.asarray(j_lse))
    delta = (tdo.float() * out).sum(-1)
    kw = dict(scale=d ** -0.5, block=block, num_heads=H)
    luts = tbsk.luts_for(layout, "cpu")
    tkb = None if kb is None else torch.tensor(kb)
    readings = {}
    for policy in (_split_p, _round_p_once):
        got = _tc_backward_emulation(tq, tk, tv, tdo, lse, delta, luts, tkb,
                                     operand=policy, **kw)
        ulps = [_bf16_ulps(a, b) for a, b in zip(got, want)]
        readings[policy.__name__] = (
            max(float((u > 0).float().mean()) for u in ulps),
            max(float(u.max()) for u in ulps))
    share, worst = readings["_split_p"]
    assert int(worst) <= 1 and share <= SPLIT_P_SHARE, readings
    share, worst = readings["_round_p_once"]
    assert not (int(worst) <= 1 and share <= SPLIT_P_SHARE), readings


def test_key_order_takes_the_longest_key_blocks_first():
    """Luts.order_t is, for each head, a permutation of its key blocks by
    descending nnz_t (ties in block order), and the four tables beside it
    are still the JAX package's build_luts."""
    random.seed(7)
    layout = tsa.BigBirdSparsityConfig(3, block=16,
                                       different_layout_per_head=True,
                                       num_random_blocks=2).make_layout(256)
    luts = tbsk.luts_for(layout, "cpu")
    for a, b in zip(luts[:4], jbsk.build_luts(layout)):
        np.testing.assert_array_equal(a.numpy(), b)
    order, nnz_t = luts.order_t.numpy(), luts.nnz_t.numpy()
    assert order.dtype == np.int32 and order.shape == nnz_t.shape
    for h in range(3):
        assert sorted(order[h]) == list(range(nnz_t.shape[1]))
        lengths = nnz_t[h, order[h]]
        assert all(lengths[:-1] >= lengths[1:])
        ties = lengths[:-1] == lengths[1:]
        assert all(order[h, :-1][ties] < order[h, 1:][ties])
    fixed = tsa.FixedSparsityConfig(12, block=64, num_local_blocks=4,
                                    num_global_blocks=1).make_layout(4096)
    order = tbsk.luts_for(fixed, "cpu").order_t.numpy()
    # the slice's layout: the 16 global key blocks of each head, walked by
    # all 64 query blocks, come first
    np.testing.assert_array_equal(order[:, :16],
                                  np.tile(np.arange(3, 64, 4), (12, 1)))


def test_longest_first_leaves_a_short_tail_at_the_slice_layout():
    """The dK/dV sweep's launch at the BERT slice (batch 4 x 12 heads, the
    Fixed layout at seq 4096) by list scheduling on 264 resident blocks
    (132 SMs, 2 blocks each at head_dim 64): longest first ends within
    1.5 % of an even spread of the tile pairs, block order 12 % after."""
    from deepspeed_tpu_torch.ops.sparse_attention.order_probe import makespan

    fixed = tsa.FixedSparsityConfig(12, block=64, num_local_blocks=4,
                                    num_global_blocks=1).make_layout(4096)
    luts = tbsk.luts_for(fixed, "cpu")
    nnz_t = luts.nnz_t.numpy()
    even = nnz_t.sum() * 4 / 264
    by_block = np.tile(np.arange(64), (12, 1))
    assert makespan(nnz_t, luts.order_t.numpy(), 48, 264) == 224
    assert makespan(nnz_t, by_block, 48, 264) == 248
    assert 224 <= 1.015 * even and 248 >= 1.12 * even
