"""Ring attention of the PyTorch port (parallel/ring_attention.py), in the
gloo worlds of tests/torch_sp_worlds.py, held against the JAX package's
``make_ring_attention`` on its virtual CPU devices, inputs from numpy
seeds.

- fp32, causal and not, N in {2, 4}: the joined output and dQ, dK, dV
  (against ``jax.grad``) at rtol 2e-5, atol 2e-5 (the same recurrence in
  fp32; the JAX package's own test holds its ring to dense attention at
  2e-5 forward and rtol 5e-4, atol 5e-5 for the gradients).
- bf16 (inputs and output in bf16, the rounds in fp32): against the JAX
  ring at one bf16 rounding of the output (rtol 1e-2, atol 1e-2), and
  against dense fp32 attention at the JAX test's 0.1.
- The hops counted: N - 1 of K/V forward, N - 1 of K/V and N of their
  fp32 gradients backward.
- ``ring_virtual`` (the rounds composed for N virtual ranks on one device,
  what chip_smoke.py runs on the card) equals the distributed ring and
  plain attention.
- The engine: GPT-2 at {"seq": 4} with ``attention_sp_mode="ring"``, 5
  Adam steps against the JAX engine at the same mesh (losses rtol 2e-5,
  masters rtol 1e-4, atol 1e-5), against the port's Ulysses run, and its
  counted collectives in closed form; ring attention with dropout raises.
"""
import numpy as np
import pytest
import torch

import torch_sp_worlds as SP
import torch_zero_worker as W
from deepspeed_tpu_torch.parallel import ring_attention as tra

FN_RTOL = FN_ATOL = 2e-5
RING_FNS = ["ring_n4_causal", "ring_n4_full", "ring_n2_causal",
            "ring_n2_full"]


@pytest.fixture(scope="session")
def world(tmp_path_factory):
    return W.session_worlds(tmp_path_factory, SP.WORLDS)


def _plain(q, k, v, causal):
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * q.shape[-1] ** -0.5
    if causal:
        n = q.shape[2]
        s = s.masked_fill(~torch.ones(n, n, dtype=torch.bool).tril(), -1e30)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v)


@pytest.mark.parametrize("case", RING_FNS)
def test_ring_matches_jax(world, case):
    n, mode, shape, seed, causal, _, _ = SP.ATTENTION_CASES[case]
    got = SP.gathered(world, case, n)
    want = SP.jax_function(mode, n, shape, seed, causal)
    SP.assert_function_close(got, want, FN_RTOL, FN_ATOL, case)


def test_ring_bf16(world):
    import jax.numpy as jnp

    case = "ring_n4_bf16"
    n, mode, shape, seed, causal, _, _ = SP.ATTENTION_CASES[case]
    got = SP.gathered(world, case, n)
    assert world("sp_w4")[0][case]["dtype"] == "torch.bfloat16"
    want = SP.jax_function(mode, n, shape, seed, causal, dtype=jnp.bfloat16)
    SP.assert_function_close(got, want, 1e-2, 1e-2, case)
    q, k, v, _ = (torch.as_tensor(x).bfloat16().float()
                  for x in SP.attention_inputs(shape, seed))
    np.testing.assert_allclose(got["out"], _plain(q, k, v, causal).numpy(),
                               rtol=0.1, atol=0.1)


@pytest.mark.parametrize("case", RING_FNS)
def test_ring_counts_its_hops(world, case):
    n, _, (b, h, s, d), *_ = SP.ATTENTION_CASES[case]
    chunk = 2 * b * h * (s // n) * d
    for rank in world(f"sp_w{n}"):
        comm = rank[case]["comm"]
        assert comm["calls"] == {"collective-permute": 3 * n - 2}
        got = {c["name"]: (c["elements"], c["count_per_step"],
                           c["bytes_per_step"])
               for c in comm["collectives"]}
        assert got == {"sp_ring:kv": (chunk, n - 1, (n - 1) * chunk * 4),
                       "sp_ring:kv_bwd": (chunk, n - 1,
                                          (n - 1) * chunk * 4),
                       "sp_ring:dkv_bwd": (chunk, n, n * chunk * 4)}


@pytest.mark.parametrize("case", RING_FNS)
def test_virtual_ring_is_the_distributed_ring(world, case):
    """The rounds composed for N virtual ranks on one device: the
    distributed ring's output and gradients (the same rounds in the same
    order, so to fp32 summation order of dK/dV), and plain attention's."""
    n, _, shape, seed, causal, _, _ = SP.ATTENTION_CASES[case]
    q, k, v, do = (torch.as_tensor(x) for x in
                   SP.attention_inputs(shape, seed))
    (out, _), (dq, dk, dv) = tra.ring_virtual(q, k, v, n, causal=causal,
                                              do=do)
    got = SP.gathered(world, case, n)
    SP.assert_function_close(got, {"out": out.numpy(), "dq": dq.numpy(),
                                "dk": dk.numpy(), "dv": dv.numpy()},
                          1e-5, 1e-6, case)
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    ref = _plain(qq, kk, vv, causal)
    ref.backward(do)
    np.testing.assert_allclose(out.numpy(), ref.detach().numpy(), rtol=2e-5,
                               atol=2e-5)
    for a, b in ((dq, qq), (dk, kk), (dv, vv)):
        np.testing.assert_allclose(a.numpy(), b.grad.numpy(), rtol=5e-4,
                                   atol=5e-5)


def test_engine_ring_matches_jax_at_the_same_mesh(world):
    SP.assert_engine_matches_jax(world, "gpt2_s4_ring")


def test_engine_ring_trains_as_ulysses_does(world):
    """The two schemes compute the same attention: the same losses and
    masters to fp32 summation order."""
    for rank in world("sp_w4"):
        ring, uly = rank["gpt2_s4_ring"], rank["gpt2_s4_ulysses"]
        np.testing.assert_allclose(ring["losses"], uly["losses"], rtol=1e-5)
        W.assert_master_close(ring["master"], uly["master"], 1e-4, 1e-5,
                              SP.STEPS, SP.LR, "ring vs ulysses")


def test_engine_ring_counted_collectives(world):
    SP.assert_counted_collectives(world, "gpt2_s4_ring")


def test_ring_with_dropout_raises(world):
    got = world("sp_w2")[0]["refusals"]["ring_dropout"]
    assert got == ("ValueError", "attention_sp_mode='ring' has no dropout "
                                 "path")
