"""The int8 codec, its host twins and the 1-bit sign codes of the PyTorch
port (deepspeed_tpu_torch/runtime/quantization.py), and the int8 ZeRO
collectives composed over virtual ranks
(runtime/custom_collectives.py), against the JAX package's.

The JAX side runs once per session in a process of its own
(tests/jax_zero_reference.py), compiled as the JAX engine compiles it:
XLA folds the codec's division by 127 into a multiplication by its
reciprocal, and the sum of a reduce-scatter's dequantized rows into a
chain of fused multiply-adds; the port computes both so.

- Codes, scales and dequantized values equal the jitted JAX functions bit
  for bit on finite blocks, and the host twins the numpy twins (which
  divide by 127) bit for bit.
- The sign codes' packed bits are bit for bit; their scales (a block's
  mean magnitude) sum in another order than XLA's and numpy's (which
  differ from each other too): within 4 ulps (rtol 5e-7), measured 1.
- A block holding a non-finite element dequantizes non-finite, and the
  element codes 0 on both twins.
- ``quantized_reduce_scatter_virtual`` (flat, and hierarchical over
  consecutive intra groups) and ``quantized_all_gather_virtual`` equal
  the JAX collectives under ``shard_map`` over 2, 4 and 8 virtual CPU
  devices bit for bit; the gather's backward is straight-through.
"""
import numpy as np
import pytest
import torch

import jax_zero_reference as JR
import torch_zero_worker as W
from deepspeed_tpu_torch.runtime import custom_collectives as cc
from deepspeed_tpu_torch.runtime import quantization as qz

SEED = 5
BLOCK = 32
SHAPES = [(3, 4096), (2, 1000), (4, 77), (1, 5)]
# (kind, w, intra_size, shape, dim, block_size)
COLLECTIVES = [
    ("reduce_scatter", 2, 0, (6, 64), 0, BLOCK),
    ("reduce_scatter", 4, 0, (8, 300), 1, BLOCK),
    ("reduce_scatter", 4, 2, (8, 300), 1, BLOCK),
    ("reduce_scatter", 8, 2, (16, 40), 0, BLOCK),
    ("reduce_scatter", 8, 4, (24, 16), 0, 128),
    ("all_gather", 2, 0, (6, 64), 0, BLOCK),
    ("all_gather", 4, 0, (8, 300), 1, BLOCK),
    ("all_gather", 8, 0, (16, 40), 0, BLOCK),
]


def _jax_side(out):
    return JR.run([("codec", "codec", dict(shapes=SHAPES, seed=SEED,
                                            block_size=BLOCK)),
                   ("collectives", "collectives",
                    dict(cases=COLLECTIVES, seed=SEED))], out)


@pytest.fixture(scope="session")
def jax_side(tmp_path_factory):
    get = W.session_worlds(tmp_path_factory, {"quant_jax": _jax_side})
    return lambda: get("quant_jax")


def t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("case", range(len(SHAPES)))
def test_codec_matches_the_jax_functions_bit_for_bit(jax_side, case):
    want = jax_side()["codec"][case]
    x = t(want["x"])
    q, s = qz.quantize_rows(x, BLOCK)
    np.testing.assert_array_equal(q.numpy(), want["q"])
    np.testing.assert_array_equal(s.numpy(), want["s"])
    np.testing.assert_array_equal(
        qz.dequantize_rows(q, s, x.shape[1]).numpy(), want["deq"])
    ef = qz.quantize_blockwise_ef(x[0], t(want["res"]), BLOCK)
    for got, w in zip(ef, want["ef"]):
        np.testing.assert_array_equal(got.numpy(), w)
    # the blockwise pair is the row pair over the flattened tensor
    qb, sb = qz.quantize_blockwise(x[0].reshape(1, -1), BLOCK)
    np.testing.assert_array_equal(qb.numpy(), want["q"][0])
    np.testing.assert_array_equal(
        qz.dequantize_blockwise(qb, sb, (x.shape[1],)).numpy(),
        want["deq"][0])


@pytest.mark.parametrize("case", range(len(SHAPES)))
def test_host_twins_match_the_numpy_twins_bit_for_bit(jax_side, case):
    want = jax_side()["codec"][case]
    x = want["x"]
    q, s = qz.quantize_blockwise_np(x[0], BLOCK)
    np.testing.assert_array_equal(q.numpy(), want["q_np"])
    np.testing.assert_array_equal(s.numpy(), want["s_np"])
    np.testing.assert_array_equal(
        qz.dequantize_blockwise_np(q, s, x.shape[1]).numpy(),
        want["deq_np"])
    packed, scales = qz.quantize_signs_rows_np(x, BLOCK)
    np.testing.assert_array_equal(packed.numpy(), want["signs_np"][0])
    np.testing.assert_allclose(scales.numpy(), want["signs_np"][1],
                               rtol=5e-7, atol=0)


@pytest.mark.parametrize("case", range(len(SHAPES)))
def test_sign_codes_match_the_jax_functions(jax_side, case):
    want = jax_side()["codec"][case]
    x = t(want["x"])
    packed, scales = qz.quantize_signs_rows(x, BLOCK)
    np.testing.assert_array_equal(packed.numpy(), want["signs"])
    np.testing.assert_allclose(scales.numpy(), want["sign_scales"],
                               rtol=5e-7, atol=0)
    # decoded from the JAX scales, every element is +-its block's scale
    np.testing.assert_array_equal(
        qz.dequantize_signs_rows(packed, t(want["sign_scales"]), x.shape[1],
                                 block_size=BLOCK).numpy(),
        want["sign_deq"])
    assert qz.sign_pack_layout(x.shape[1], BLOCK)[3] == packed.shape[1]


def test_nonfinite_block_poisons_its_block_and_codes_zero():
    x = torch.randn(2, 96)
    x[0, 5] = float("nan")
    x[1, 70] = float("inf")
    for q, s, n in ((*qz.quantize_rows(x, BLOCK), 96),):
        deq = qz.dequantize_rows(q, s, n)
        assert not torch.isfinite(deq[0, :32]).any()
        assert not torch.isfinite(deq[1, 64:96]).any()
        assert torch.isfinite(deq[0, 32:]).all()
        assert torch.isfinite(deq[1, :64]).all()
        # the non-finite elements code 0 (an int8 cast of nan is
        # platform-defined); the block's scale carries the marker
        assert q[0, 5] == 0 and q[1, 70] == 0
    qn, sn = qz.quantize_blockwise_np(x[0].numpy(), BLOCK)
    assert qn[5] == 0 and not torch.isfinite(sn[0])
    assert not torch.isfinite(qz.dequantize_blockwise_np(qn, sn, 96)[:32]) \
        .any()
    # the numpy twin of the JAX package codes 0 too
    from deepspeed_tpu.runtime import quantization as jqz

    jq, js = jqz.quantize_blockwise_np(x[0].numpy(), BLOCK)
    np.testing.assert_array_equal(qn.numpy(), jq)


def test_block_layout_clamps_to_the_row():
    assert qz.block_layout(5, 128) == (5, 1, 5)
    assert qz.block_layout(300, 128) == (128, 3, 384)
    assert qz.block_layout(256, 128) == (128, 2, 256)
    assert qz.sign_pack_layout(5, 128) == (5, 1, 5, 1)
    assert qz.sign_pack_layout(300, 128) == (128, 3, 384, 48)
    with pytest.raises(AssertionError):
        qz.block_layout(0)


@pytest.mark.parametrize("case", range(len(COLLECTIVES)))
def test_virtual_collectives_match_the_jax_shard_map(jax_side, case):
    kind, w, k, shape, dim, block = COLLECTIVES[case]
    inp, want = jax_side()["collectives"][case]
    if kind == "reduce_scatter":
        got = cc.quantized_reduce_scatter_virtual(
            [t(x) for x in inp], dim=dim, block_size=block, intra_size=k)
        got = torch.stack(got).numpy()
        # JAX stacks every device's shard along the sharded axis 0 of x
        want = want.reshape((w,) + got.shape[1:])
    else:
        shards = torch.from_numpy(inp).chunk(w, dim)
        got = cc.quantized_all_gather_virtual(list(shards), dim=dim,
                                              block_size=block).numpy()
    np.testing.assert_array_equal(got, want)


def test_virtual_gather_backward_is_straight_through():
    """round's derivative (0) is not applied: each shard's gradient is its
    part of the cotangent, and a loss of the gathered leaf has the
    gradients of the same loss of the dequantized weights."""
    full = torch.randn(8, 300)
    shards = [s.clone().requires_grad_(True) for s in full.chunk(4, 1)]
    gathered = cc.quantized_all_gather_virtual(shards, dim=1)
    weight = torch.randn(8, 300)
    (gathered * weight).sum().backward()
    for r, s in enumerate(shards):
        torch.testing.assert_close(s.grad, weight.chunk(4, 1)[r],
                                   rtol=0, atol=0)
    deq = gathered.detach().requires_grad_(True)
    (deq * weight).sum().backward()
    torch.testing.assert_close(torch.cat([s.grad for s in shards], 1),
                               deq.grad, rtol=0, atol=0)


def test_virtual_reduce_scatter_sum_and_mean_and_bound():
    """Without ``mean`` the sum; every shard within the int8 bound of the
    dense mean: half a code step of each virtual rank's block scale."""
    xs = [torch.randn(8, 256) for _ in range(4)]
    mean = cc.quantized_reduce_scatter_virtual(xs, dim=0)
    total = cc.quantized_reduce_scatter_virtual(xs, dim=0, mean=False)
    dense = torch.stack(xs).mean(0).chunk(4, 0)
    for m, s, d in zip(mean, total, dense):
        torch.testing.assert_close(m * 4, s, rtol=0, atol=0)
        bound = sum(x.abs().max() for x in xs) / 127 / 2 / 4
        assert (m - d).abs().max() <= bound * (1 + 1e-6)


@pytest.mark.parametrize("dim", [0, 1, 2])
def test_leaf_rows_round_trip(dim):
    x = torch.arange(24.0).reshape(2, 3, 4)
    w = x.shape[dim]
    rows = cc.leaf_rows(x, dim, w)
    assert rows.shape == (w, x.numel() // w)
    torch.testing.assert_close(rows[1], x.select(dim, 1).reshape(-1))
    torch.testing.assert_close(cc.rows_to_leaf(rows, x.shape, dim), x)
    with pytest.raises(ValueError, match="divide"):
        cc.leaf_rows(x, dim, 5)



class _Mirror:
    """A stand-in data group of ``size`` ranks that all hold this rank's
    shards: a gather writes its input into every rank's slot."""

    def __init__(self, size):
        self.size = size
        self.posted = []

    def quantized_all_gather(self, out, inp, prefix, leaves):
        self.posted.append((prefix, leaves))
        out.copy_(inp.repeat(self.size))


@pytest.mark.parametrize("pass_elements", [64, cc.BUCKET_PASS_ELEMENTS])
def test_bucketed_codec_is_each_leafs_own(monkeypatch, pass_elements):
    """The bucketed codec (every leaf of a bucket coded and decoded in
    passes of at most ``BUCKET_PASS_ELEMENTS``, short rows on a clamped
    block) gives each leaf the codes, scales, sums and gathered rows of
    coding it alone, bit for bit, with many passes or one; the gather
    posts one int8 and one scales gather per leaf, in order."""
    monkeypatch.setattr(cc, "BUCKET_PASS_ELEMENTS", pass_elements)
    rng = np.random.default_rng(3)
    lengths = [300, 17, 128, 5, 1000, 17, 256]
    w = 4
    rows = [torch.from_numpy(rng.standard_normal((w, n)).astype(np.float32))
            for n in lengths]
    q, s, lay, passes = cc._quantize_bucket(rows, 128)
    blocks = {qz.block_layout(n, 128)[0] for n in lengths}
    assert (len(passes) > len(blocks)) == (pass_elements == 64)
    sums = cc._dequantize_sum(q, s, lay, passes)
    for r, (qa, npad, sa, nb, n), total in zip(rows, lay, sums):
        q1, s1 = qz.quantize_rows(r, 128)
        assert torch.equal(q[:, qa:qa + npad], q1)
        assert torch.equal(s[:, sa:sa + nb], s1)
        assert torch.equal(total, cc.dequantize_sum(q1, s1, n))
    group = _Mirror(w)
    names = [f"leaf{j}" for j in range(len(lengths))]
    got = cc.quantized_gather_rows([r[0] for r in rows], group, names,
                                   torch.bfloat16, 128)
    for r, g in zip(rows, got):
        q1, s1 = qz.quantize_rows(r[:1], 128)
        want = qz.dequantize_rows(q1, s1, r.shape[1], torch.bfloat16)
        assert torch.equal(g, want.expand(w, -1))
    assert [(p, [nm for nm, _ in leaves]) for p, leaves in group.posted] \
        == [(p, [nm]) for nm in names for p in ("qwz_ag", "qwz_scales")]
