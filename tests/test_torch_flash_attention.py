"""Flash attention of the PyTorch port against the JAX package's Pallas
kernels.

The Pallas kernels run in interpreter mode on the CPU, as
tests/unit/test_flash_attention.py runs them; the port's side on the CPU is
the plain PyTorch version of each CUDA kernel (a CPU tensor takes it). The
same numpy inputs go through both. The CUDA kernels themselves run only on
a GPU (tests/test_torch_cuda.py, skipped elsewhere).

Tolerances (fp32, (2, 2, 256, 64) unit-normal inputs): outputs and lse at
atol 1e-5, gradients at atol 1e-4. Both sides compute in fp32 with
different block sizes (512/1024 vs 128) and summation orders; rounding
differences of fp32 sums over 256 keys are ~1e-6 on the outputs and grow
to ~1e-5 on the gradients, which sum products over both sequence axes.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.transformer import flash_attention as jfa
from deepspeed_tpu_torch.ops.transformer import flash_attention as tfa
from deepspeed_tpu_torch.ops.transformer.functional import (
    scaled_dot_product_attention)

B, H, S, D = 2, 2, 256, 64
OUT_ATOL = 1e-5
GRAD_ATOL = 1e-4
SEED = 20240611
CASES = {
    "noncausal": dict(causal=False),
    "causal": dict(causal=True),
    "key_bias": dict(causal=False, bias="key"),
    "full_bias": dict(causal=True, bias="full"),
    "dropout": dict(causal=True, dropout_rate=0.1),
}


def _inputs(case):
    rng = np.random.default_rng(sorted(CASES).index(case))
    q, k, v, g = (rng.standard_normal((B, H, S, D)).astype(np.float32)
                  for _ in range(4))
    bias = None
    kind = CASES[case].get("bias")
    if kind == "key":
        bias = (2.0 * rng.standard_normal((B, 1, 1, S))).astype(np.float32)
        bias[:, :, :, -9:] = -1e30               # padded keys
    elif kind == "full":
        bias = rng.standard_normal((B, H, S, S)).astype(np.float32)
    return q, k, v, g, bias


def _kwargs(case):
    kw = {k: v for k, v in CASES[case].items() if k != "bias"}
    if kw.get("dropout_rate"):
        kw["dropout_seed"] = SEED
    return kw


@functools.lru_cache(maxsize=None)
def _jax_result(case):
    """(out, (dq, dk, dv)) of the Pallas kernels for ``sum(out * g)``."""
    q, k, v, g, bias = _inputs(case)
    kw = _kwargs(case)
    jb = None if bias is None else jnp.asarray(bias)

    def f(q, k, v):
        out = jfa.flash_attention(q, k, v, bias=jb, interpret=True, **kw)
        return jnp.sum(out * g), out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                         has_aux=True)(q, k, v)
    return np.asarray(out), tuple(np.asarray(x) for x in grads)


def _torch_result(case, fn):
    q, k, v, g, bias = _inputs(case)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    tb = None if bias is None else torch.tensor(bias)
    out = fn(tq, tk, tv, bias=tb, **_kwargs(case))
    (out * torch.tensor(g)).sum().backward()
    return out.detach().numpy(), (tq.grad.numpy(), tk.grad.numpy(),
                                  tv.grad.numpy())


@pytest.mark.parametrize("path", ["autograd_reference", "plain_kernels"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_port_matches_pallas_kernels(case, path):
    """flash_attention_reference (autograd through the blockwise forward)
    and flash_attention on CPU tensors (the autograd Function running the
    plain versions of the three kernels) both match the Pallas kernels:
    causal and not, both bias kinds, and dropout with one int32 seed."""
    fn = tfa.flash_attention_reference if path == "autograd_reference" \
        else tfa.flash_attention
    before = dict(tfa.LAUNCHES)
    out, grads = _torch_result(case, fn)
    assert tfa.LAUNCHES == before, "a CPU tensor must not count a launch"
    j_out, j_grads = _jax_result(case)
    np.testing.assert_allclose(out, j_out, atol=OUT_ATOL, rtol=0)
    for name, a, b in zip("qkv", grads, j_grads):
        np.testing.assert_allclose(a, b, atol=GRAD_ATOL, rtol=0,
                                   err_msg=f"d{name}")


BF16_MAX_DIFFERING = 0.01     # share of elements not equal to Pallas's
BF16_MAX_REL_DIFF = 2.5e-3    # largest difference / largest magnitude
# the Pallas blocks at bf16: the port's plain block, so that both round p
# relative to the running max of the same k blocks
BF16_BLOCK = tfa._PLAIN_BLOCK


def _bf16_differences(got, want):
    """(share of elements that differ, largest difference over the
    tensor's largest magnitude) of two bf16 results held as fp32."""
    diff = np.abs(got - want)
    return float((diff > 0).mean()), float(diff.max() / np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _bf16_results(case):
    """(name -> (port, pallas)) for out, dq, dk, dv at bf16; the port's side
    runs the plain kernels on CPU tensors and flash_attention_reference."""
    q, k, v, g, bias = _inputs(case)
    kw = _kwargs(case)
    jb = None if bias is None else jnp.asarray(bias)
    jq, jk, jv, jg = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, g))

    def f(q, k, v):
        out = jfa.flash_attention(q, k, v, bias=jb, interpret=True,
                                  block_q=BF16_BLOCK, block_k=BF16_BLOCK, **kw)
        return jnp.sum(out.astype(jnp.float32) * jg.astype(jnp.float32)), out

    (_, j_out), j_grads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                             has_aux=True)(jq, jk, jv)
    want = [np.asarray(x.astype(jnp.float32)) for x in (j_out, *j_grads)]
    tq, tk, tv = (torch.tensor(x).bfloat16().requires_grad_(True)
                  for x in (q, k, v))
    tb = None if bias is None else torch.tensor(bias)
    tg = torch.tensor(g).bfloat16().float()
    out = tfa.flash_attention(tq, tk, tv, bias=tb, **kw)
    (out.float() * tg).sum().backward()
    ref = tfa.flash_attention_reference(tq.detach(), tk.detach(), tv.detach(),
                                        bias=tb, **kw)
    got = [x.detach().float().numpy()
           for x in (out, tq.grad, tk.grad, tv.grad)]
    pairs = dict(zip(("out", "dq", "dk", "dv"), zip(got, want)))
    pairs["reference out"] = (ref.float().numpy(), want[0])
    return pairs


@pytest.mark.parametrize("name", ["out", "dq", "dk", "dv", "reference out"])
@pytest.mark.parametrize("case", ["causal", "key_bias", "dropout"])
def test_bf16_port_rounds_p_and_ds_as_the_pallas_kernels_do(case, name):
    """At bf16 the port computes the Pallas kernels' function: p and dS are
    rounded to bf16 before the second product of each pair, as
    ``p_acc.astype(v.dtype)``, ``p_drop.astype(do.dtype)`` and
    ``ds.astype(q.dtype)`` round them there. Kept in fp32 instead (the
    port before this rounding), 37-42 % of the elements of out, dq, dk and
    dv differ from the Pallas result, by up to 5.5e-3 of the tensor's
    largest magnitude in the causal case; with the rounding at most 0.17 %
    differ, by at most 1.3e-3 (CPU runs of these cases). The limits, 1 %
    and 2.5e-3, sit between the two. Both sides walk the same 128-key
    blocks: p is rounded relative to its block's running max, so other
    blocks round other elements. At fp32 the rounding is a no-op and the
    fp32 tests above hold the tighter tolerances."""
    got, want = _bf16_results(case)[name]
    differing, rel = _bf16_differences(got, want)
    assert differing <= BF16_MAX_DIFFERING, (differing, rel)
    assert rel <= BF16_MAX_REL_DIFF, (differing, rel)


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("bh,q_start,k_start", [(0, 0, 0), (3, 128, 256),
                                                (37, 4096, 130)])
def test_dropout_hash_is_bit_exact(bh, q_start, k_start, rate):
    """The port's keep mask equals the Pallas kernel's _dropout_keep
    element for element (same uint32 murmur3 arithmetic)."""
    bq, bk = 64, 96
    seed = jnp.asarray([SEED], jnp.int32)
    want = np.asarray(jfa._dropout_keep(seed, bh, q_start, k_start, bq, bk,
                                        bk, rate))
    got = tfa.dropout_keep_mask(SEED, bh + 1, q_start, bq, k_start, bk,
                                rate, "cpu")[bh].numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.0 < 1.0 - got.mean() < 1.0


@pytest.mark.parametrize("case", ["causal", "key_bias", "dropout"])
def test_each_plain_kernel_matches_its_pallas_kernel(case):
    """Kernel by kernel: flash_fwd_plain against _flash_fwd (out and lse),
    then flash_bwd_dkdv_plain / flash_bwd_dq_plain against _flash_bwd fed
    the same residuals."""
    q, k, v, g, bias = _inputs(case)
    kw = _kwargs(case)
    causal = kw.get("causal", False)
    rate = kw.get("dropout_rate", 0.0)
    bh = B * H
    q3, k3, v3, g3 = (x.reshape(bh, S, D) for x in (q, k, v, g))
    kind = "none" if bias is None else CASES[case]["bias"]
    jbias = None if bias is None else jnp.asarray(bias[:, 0, 0, :])
    jseed = jnp.asarray([SEED], jnp.int32) if rate else None
    common = dict(scale=D ** -0.5, causal=causal, bias_kind=kind,
                  num_heads=H, dropout_rate=rate)
    blocks = dict(block_q=S, block_k=S, interpret=True)
    j_out, j_lse = jfa._flash_fwd(q3, k3, v3, jbias, jseed, **common,
                                  **blocks)
    tbias = None if bias is None else torch.tensor(bias[:, 0, 0, :])
    tq, tk, tv, tg = (torch.tensor(x) for x in (q3, k3, v3, g3))
    seed = SEED if rate else None
    out, lse = tfa.flash_fwd(tq, tk, tv, tbias, seed, **common)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out),
                               atol=OUT_ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse),
                               atol=OUT_ATOL, rtol=0)
    res = (q3, k3, v3, jbias, jseed, j_out, j_lse)
    j_dq, j_dk, j_dv = jfa._flash_bwd(res, g3, **common, **blocks)
    delta = (tg * out).sum(-1)
    dk, dv = tfa.flash_bwd_dkdv(tq, tk, tv, tg, lse, delta, tbias, seed,
                                **common)
    dq = tfa.flash_bwd_dq(tq, tk, tv, tg, lse, delta, tbias, seed, **common)
    for a, b in ((dq, j_dq), (dk, j_dk), (dv, j_dv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL,
                                   rtol=0)


def test_dispatch_on_cpu_never_counts_a_launch():
    """use_pallas=None on CPU tensors takes the plain einsum path;
    use_pallas=True takes flash_attention's CPU route; both agree and
    neither counts a kernel launch."""
    q, k, v, _, _ = _inputs("causal")
    tq, tk, tv = (torch.tensor(x) for x in (q, k, v))
    before = dict(tfa.LAUNCHES)
    plain = scaled_dot_product_attention(tq, tk, tv, causal=True)
    flash = scaled_dot_product_attention(tq, tk, tv, causal=True,
                                         use_pallas=True)
    assert tfa.LAUNCHES == before
    np.testing.assert_allclose(flash.numpy(), plain.numpy(), atol=OUT_ATOL,
                               rtol=0)


def test_wrappers_refuse_unknown_devices_and_bad_arguments():
    t = torch.zeros(1, 8, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        tfa.flash_fwd(t, t, t, None, None, scale=1.0, causal=False,
                      bias_kind="none", num_heads=1, dropout_rate=0.0)
    x = torch.zeros(1, 1, 8, 64)
    with pytest.raises(ValueError, match="equal q/k lengths"):
        tfa.flash_attention(x, torch.zeros(1, 1, 16, 64),
                            torch.zeros(1, 1, 16, 64), causal=True)
    with pytest.raises(ValueError, match="dropout_seed"):
        tfa.flash_attention(x, x, x, dropout_rate=0.1)
    # shapes the kernels would index out of bounds are refused up front
    q, s = torch.zeros(4, 16, 64), torch.zeros(4, 16)
    with pytest.raises(ValueError, match="k has shape"):
        tfa._check_shapes(q, q[:, :, :32], q, None, None, None, None,
                          "none", 2)
    with pytest.raises(ValueError, match="lse has shape"):
        tfa._check_shapes(q, q, q, q, s[:, :8], s, None, "none", 2)
    with pytest.raises(ValueError, match="bias has shape"):
        tfa._check_shapes(q, q, q, None, None, None, torch.zeros(4, 16),
                          "key", 2)
    with pytest.raises(TypeError, match="lse and delta must be float32"):
        tfa._check_shapes(q, q, q, q, s.double(), s, None, "none", 2)


@pytest.mark.parametrize("variant", ["causal", "key_bias", "mask",
                                     "full_bias"])
def test_plain_attention_path_matches_jax(variant):
    """The plain (einsum) path of scaled_dot_product_attention against the
    JAX package's jnp path on the same inputs."""
    from deepspeed_tpu.ops.transformer.functional import \
        scaled_dot_product_attention as jsdpa

    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((2, 2, 32, 16)).astype(np.float32)
               for _ in range(3))
    kw, tkw = {"causal": variant == "causal"}, {}
    if variant == "key_bias":
        bias = rng.standard_normal((2, 1, 1, 32)).astype(np.float32)
        kw["bias"], tkw["bias"] = jnp.asarray(bias), torch.tensor(bias)
    elif variant == "full_bias":
        bias = rng.standard_normal((2, 2, 32, 32)).astype(np.float32)
        kw["bias"], tkw["bias"] = jnp.asarray(bias), torch.tensor(bias)
    elif variant == "mask":
        mask = rng.random((2, 1, 1, 32)) > 0.3
        kw["mask"], tkw["mask"] = jnp.asarray(mask), torch.tensor(mask)
    want = jsdpa(q, k, v, use_pallas=False, **kw)
    got = scaled_dot_product_attention(
        *(torch.tensor(x) for x in (q, k, v)), causal=kw["causal"], **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OUT_ATOL,
                               rtol=0)


def test_elementwise_ops_match_jax():
    from deepspeed_tpu.ops.transformer import functional as jf
    from deepspeed_tpu_torch.ops.transformer import functional as tf

    rng = np.random.default_rng(12)
    x, r = (rng.standard_normal((3, 5, 16)).astype(np.float32)
            for _ in range(2))
    b, gamma, beta = (rng.standard_normal(16).astype(np.float32)
                      for _ in range(3))
    t = torch.tensor
    pairs = [
        (tf.gelu(t(x)), jf.gelu(x)),
        (tf.gelu(t(x), approximate=False), jf.gelu(x, approximate=False)),
        (tf.bias_gelu(t(x), t(b)), jf.bias_gelu(x, b)),
        (tf.layer_norm(t(x), t(gamma), t(beta)),
         jf.layer_norm(x, gamma, beta)),
        (tf.bias_residual_layer_norm(t(x), t(b), t(r), t(gamma), t(beta),
                                     eps=1e-5),
         jf.bias_residual_layer_norm(x, b, r, gamma, beta, eps=1e-5)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
    gen = torch.Generator().manual_seed(0)
    dropped = tf.dropout(t(np.ones((1000,), np.float32)), gen, 0.25)
    kept = dropped != 0
    assert torch.all(dropped[kept] == 1.0 / 0.75)
    assert 0.2 < 1.0 - kept.float().mean().item() < 0.3
    assert torch.equal(tf.dropout(t(x), gen, 0.25, deterministic=True),
                       t(x))


def test_cuda_dispatch_refuses_what_the_kernels_cannot_take():
    """The reasons a CUDA call would be refused (raised, never rerouted)."""
    from deepspeed_tpu_torch.ops.transformer.functional import \
        _flash_refusal

    q = torch.zeros(1, 2, 16, 80)
    assert "head_dim 80" in _flash_refusal(q, q, None, None, 0.0, None)
    q = torch.zeros(1, 2, 16, 64)
    assert "dropout_rng" in _flash_refusal(q, q, None, None, 0.1, None)
    full = torch.zeros(1, 2, 16, 16)
    assert "full-shaped bias" in _flash_refusal(q, q, None, full, 0.0, None)
    key = torch.zeros(1, 1, 1, 16)
    assert _flash_refusal(q, q, None, key, 0.0, None) is None


def test_plain_path_runs_on_cpu_tensors_only():
    """A tensor off the CPU never takes the plain path: use_pallas=False
    raises, and None routes it to the kernels (which raise here, on a
    device that has none)."""
    q = torch.zeros(1, 2, 16, 64, device="meta")
    with pytest.raises(ValueError, match="CPU tensors only"):
        scaled_dot_product_attention(q, q, q, causal=True, use_pallas=False)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        scaled_dot_product_attention(q, q, q, causal=True)
