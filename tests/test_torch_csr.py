"""CSR gradients (``sparse_gradients``) of the PyTorch port
(runtime/csr_tensor.py and the engine's two paths), held against the JAX
package's, on the embedding model of the JAX tests (its torch counterpart
``torch_zero_worker.EmbedModel``: an untied table whose gradient is
nonzero only on the looked-up rows).

- ``CSRTensor`` (nonzero rows, a fixed capacity padded with -1, back to
  dense, sizes, merge) equals the JAX ``CSRTensor`` on numpy inputs.
- Plain data parallelism (gloo world of 2, stage 0 and 1; the worlds of
  tests/torch_a13b_cases.py): the table's rows move by two all-gathers
  (indices, values) at the capacity of the micro-batch's tokens, in place
  of its all-reduce; the run equals the dense run (losses rtol 1e-6, the
  master rtol 1e-6, atol 1e-7: the rows of the ranks add in another
  order) and the JAX engine's (losses rtol 1e-5, master rtol 1e-4, atol
  1e-5: tests/test_torch_zero.py's dense tolerance); the comm report
  equals the JAX engine's at stage 0, which withholds its dense figure
  (``grad_path_modeled`` false).
- ZeRO-Offload at dp 1: the table goes down as (indices, values) of
  rows x dim, not vocab x dim, and is scatter-added on the host; the run
  equals the dense offload run (losses bit for bit, the master within
  rtol 1e-6: the table moves to the end of the host's flat buffer, and
  the host Adam's vector body and scalar tail round apart, measured 4.5e-8)
  and the JAX engine's (rtol 1e-5 / rtol 1e-4, atol 1e-5); a capacity
  that would drop rows raises, and so does a batch no capacity can be
  read from.
"""
import numpy as np
import pytest
import torch

import test_torch_zero3 as Z3
import torch_a13b_cases as A
import torch_zero_worker as W
from deepspeed_tpu.runtime.csr_tensor import CSRTensor as JCSRTensor
from deepspeed_tpu_torch.runtime.csr_tensor import CSRTensor


@pytest.fixture(scope="session")
def world(tmp_path_factory):
    return Z3.worlds(tmp_path_factory)


def _grad(vocab=32, dim=8, rows=(2, 5, 9), seed=0):
    rng = np.random.default_rng(seed)
    g = np.zeros((vocab, dim), np.float32)
    for r in rows:
        g[r] = rng.standard_normal(dim)
    return g


@pytest.mark.parametrize("max_rows", [None, 3, 8])
def test_csr_tensor_matches_the_jax_one(max_rows):
    g = _grad()
    got = CSRTensor.from_dense(torch.from_numpy(g), max_rows=max_rows)
    want = JCSRTensor.from_dense(g, max_rows=max_rows)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.to_dense().numpy(),
                                  np.asarray(want.to_dense()))
    assert got.sparse_size() == want.sparse_size()
    merged = got.add(CSRTensor.from_dense(torch.from_numpy(
        _grad(rows=(5, 11), seed=1))))
    jmerged = want.add(JCSRTensor.from_dense(_grad(rows=(5, 11), seed=1)))
    np.testing.assert_array_equal(merged.to_dense().numpy(),
                                  np.asarray(jmerged.to_dense()))
    if max_rows == 8:
        assert (got.indices == -1).sum() == 5


@pytest.mark.parametrize("stage", [0, 1])
def test_data_parallel_csr_matches_dense_and_the_jax_engine(world, stage):
    ranks = world("z3_dp2_q")
    got = ranks[0][f"csr2s{stage}"]
    dense = ranks[0]["dense2s0"]
    want = world("a13b_jax_dp2")["csr2s0"]
    for r in ranks[1:]:
        assert r[f"csr2s{stage}"]["losses"] == got["losses"]
    assert got["csr"] == ["emb"] and dense["csr"] == []
    np.testing.assert_allclose(got["losses"], dense["losses"], rtol=1e-6)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    for name, b in want["master"].items():
        np.testing.assert_allclose(got["master"][name],
                                   dense["master"][name], rtol=1e-6,
                                   atol=1e-7, err_msg=name)
        np.testing.assert_allclose(got["master"][name], b, rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    if stage == 0:
        assert got["reports"][-1] == want["reports"][-1]
    assert got["reports"][-1]["grad_path_modeled"] is False
    cap = W.MICRO * W.EMBED_SEQ                  # the micro-batch's tokens
    dim = W.EMBED["dim"]
    for comm in got["comm"]:
        by = {c["name"]: c for c in comm["collectives"]}
        assert "grad_ar:emb" not in by
        # two micro steps: each gathers both ranks' rows at the capacity
        assert by["csr_values:emb"]["count_per_step"] == 2
        assert by["csr_values:emb"]["bytes_per_device"] == cap * dim * 4
        assert by["csr_indices:emb"]["bytes_per_device"] == cap * 8
    for comm in dense["comm"]:
        assert any(c["name"] == "grad_ar:emb" for c in comm["collectives"])


def _offload_engine(sparse, tokens=None):
    import deepspeed_tpu_torch

    cfg = W.ds_config(1, 0, 2, clipping=0.0, offload=True, sparse=sparse)
    model = W.EmbedModel(**W.EMBED)
    if tokens is not None:
        model.sparse_grad_tokens = tokens
    eng = deepspeed_tpu_torch.initialize(model=model, config_params=cfg,
                                         device="cpu")[0]
    eng.load_module_state_dict({k: torch.from_numpy(np.array(v))
                                for k, v in A.embed_init().items()})
    return eng


def _embed_steps(eng, steps=A.CSR_STEPS):
    data = W.embed_batches(A.SEED, steps, 2, W.MICRO)
    return [eng.train_batch(batch={"ids": data["ids"][s],
                                   "y": data["y"][s]}).item()
            for s in range(steps)]


def test_offload_csr_matches_dense_and_the_jax_engine(world):
    eng = _offload_engine(True)
    assert [eng.param_names[i] for i in eng._csr_idx] == ["emb"]
    losses = _embed_steps(eng)
    ref = _offload_engine(False)
    assert ref._csr_idx == []
    assert losses == _embed_steps(ref)
    for a, b in zip(eng.master, ref.master):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=0)
    want = world("a13b_jax_dp2")["csr1off"]
    np.testing.assert_allclose(losses, want["losses"], rtol=1e-5)
    master = dict(zip(eng.param_names, eng.master))
    for name, b in want["master"].items():
        np.testing.assert_allclose(master[name].numpy(), b, rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    # the copy down: rows x dim and their indices, not vocab x dim
    got = eng.last_fetch_bytes
    cap = W.MICRO * W.EMBED_SEQ
    dim, vocab = W.EMBED["dim"], W.EMBED["vocab"]
    assert got["csr"]["emb"] == cap * dim * 4 + cap * 8 + 8
    assert got["csr_dense"]["emb"] == vocab * dim * 4
    assert ref.last_fetch_bytes["dense"] == \
        got["dense"] + got["csr_dense"]["emb"]


def test_offload_csr_refuses_to_drop_rows():
    eng = _offload_engine(True, tokens=lambda batch: 1)
    with pytest.raises(RuntimeError, match="CSR capacity too small"):
        _embed_steps(eng, 1)
    eng = _offload_engine(True, tokens=lambda batch: 0)
    with pytest.raises(ValueError, match="cannot size the CSR row "
                                         "capacity"):
        _embed_steps(eng, 1)
