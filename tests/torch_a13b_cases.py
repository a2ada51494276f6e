"""The cases of the 1-bit Adam, 0/1 Adam and CSR tests of the PyTorch port
(tests/test_torch_onebit.py, test_torch_zeroone.py, test_torch_csr.py):
the port's jobs, which ride the gloo worlds of tests/test_torch_zero3.py
(``z3_dp2_q``, ``z3_dp4``), and the JAX engines beside them,
one JAX reference process per world (``a13b_jax_dp2``, ``a13b_jax_dp4``;
tests/jax_zero_reference.py). Everything at fp32 (bf16 quantized wires
abort the JAX CPU backend, ROADMAP C-w1) and from numpy seeds.

- ``ob<dp>``: OneBitAdam, freeze_step 2, 4 steps (2 warmup, 2 frozen).
- ``zo<dp>``: ZeroOneAdam, var_freeze_step 2, local_steps 2, 6 steps
  (2 warmup, then two rounds of k 2: local, sync); at dp 4 hierarchical
  (intra size 2). At dp 2 both engines save a tag after step 4 (the
  same leaves, shapes and dtypes), and the port resumes from its own in
  the world (``zo2_resume``).
- ``csr2s0`` / ``csr2s1``: sparse_gradients under plain data
  parallelism at stage 0 / 1 on the embedding model
  (torch_zero_worker.EmbedModel), beside ``dense2s0``, the same run
  dense.
- ``wires<dp>``: compressed_allreduce and quantized_all_reduce over the
  world, 3 rounds with the residuals carried.
"""
import os

import numpy as np

import torch_zero_worker as W

SEED = 17
LR = 1e-3
ONEBIT = {"freeze_step": 2}
ZEROONE = {"var_freeze_step": 2, "local_steps": 2}
ZEROONE_HIER = dict(ZEROONE, intra_size=2)
WIRE_N = 512
CSR_STEPS = 3
ZO_SAVE = 4
# name: (optimizer, opt_params, steps)
WIRE_CASES = {
    "ob2": ("OneBitAdam", ONEBIT, 4), "zo2": ("ZeroOneAdam", ZEROONE, 6),
    "ob4": ("OneBitAdam", ONEBIT, 4), "zo4": ("ZeroOneAdam", ZEROONE_HIER, 6),
}

_inits = {}


def gpt2_init():
    """The JAX engine's initial parameters of the tiny GPT-2 (seed 42)."""
    if "gpt2" not in _inits:
        from test_torch_zero import _jax_init

        _inits["gpt2"] = _jax_init()
    return _inits["gpt2"]


def embed_init():
    """The JAX engine's initial parameters of the SimpleEmbedModel (seed
    42), as numpy."""
    if "embed" not in _inits:
        import deepspeed_tpu
        import jax
        from deepspeed_tpu.runtime.engine import _first_micro
        from unit.simple_model import SimpleEmbedModel

        eng = deepspeed_tpu.initialize(
            model=SimpleEmbedModel(**W.EMBED),
            config_params=dict(W.ds_config(1, 0, 1, clipping=0.0),
                               mesh={"data": 1, "allow_partial": True}))[0]
        data = W.embed_batches(0, 1, 1, W.MICRO)
        eng._ensure_state(_first_micro({"ids": data["ids"][0],
                                        "y": data["y"][0]}))
        _inits["embed"] = jax.tree_util.tree_map(
            np.asarray, jax.device_get(eng.state.params))
    return _inits["embed"]


def tag_dir(out, who):
    return os.path.join(out, f"a13b_{who}_tag")


def _wire_job(name, dp, case=None, **kw):
    optimizer, params, steps = WIRE_CASES[case or name]
    return (name, "wire", dict(dict(dp=dp, gas=2, steps=steps, seed=SEED,
                                    init=gpt2_init(), optimizer=optimizer,
                                    opt_params=params), **kw))


def _csr_job(name, dp, **kw):
    return (name, "wire", dict(dict(dp=dp, gas=2, steps=CSR_STEPS, seed=SEED,
                                    init=embed_init(), model="embed"), **kw))


def port_jobs(dp, out):
    """The port's jobs in the world of ``dp`` ranks (``out``: its
    directory)."""
    if dp == 4:
        return [_wire_job("ob4", 4), _wire_job("zo4", 4),
                ("wires4", "wires", dict(dp=4, seed=SEED, n=WIRE_N))]
    tag = tag_dir(out, "port")
    return [_wire_job("ob2", 2),
            _wire_job("zo2", 2, save=tag, save_at=ZO_SAVE),
            _wire_job("zo2_resume", 2, case="zo2", load=tag, init=None),
            _csr_job("csr2s0", 2, sparse=True),
            _csr_job("csr2s1", 2, sparse=True, stage=1),
            _csr_job("dense2s0", 2),
            ("wires2", "wires", dict(dp=2, seed=SEED, n=WIRE_N)),
            ("wire_refusals", "wire_refusals", dict(dp=2))]


def _jax_wire(name, dp, **kw):
    optimizer, params, steps = WIRE_CASES[name]
    return (name, "wire", dict(dict(dp=dp, gas=2, steps=steps, seed=SEED,
                                    optimizer=optimizer, opt_params=params),
                               **kw))


def jax_jobs(dp, out):
    """The JAX engines and functions beside the world of ``dp`` ranks."""
    if dp == 4:
        return [_jax_wire("ob4", 4), _jax_wire("zo4", 4),
                ("wires4", "wire_fns", dict(w=4, seed=SEED, n=WIRE_N))]
    return [_jax_wire("ob2", 2),
            _jax_wire("zo2", 2, save=tag_dir(out, "jax"), save_at=ZO_SAVE),
            ("csr2s0", "wire", dict(dp=2, gas=2, steps=CSR_STEPS, seed=SEED,
                                    model="embed", sparse=True)),
            ("csr1off", "wire", dict(dp=1, gas=2, steps=CSR_STEPS, seed=SEED,
                                     model="embed", sparse=True,
                                     offload=True)),
            ("wires2", "wire_fns", dict(w=2, seed=SEED, n=WIRE_N))]


def assert_within_one_flip(got, want, m, v, compressed, lr=LR, eps=1e-8,
                           rtol=1e-4, atol=1e-5, beyond=0.10, what=""):
    """Every master element of ``got`` within the dense tolerance of
    ``want`` or, beyond it, within one sign flip per compressed step: a
    1-bit step moves an element by lr * k * m / (sqrt(v) + eps) with |m|
    at most the leaf's largest compressed momentum, so a sign the two
    engines round apart (an element whose momentum lies within rounding
    noise of 0: the key third of a c_attn bias, rows no token reaches)
    moves it by twice that. ``compressed``: the compressed steps times
    their k. At most ``beyond`` of all elements may lean on the flip
    allowance. ``m`` and ``v``: the port's final moments by name."""
    assert set(got) == set(want)
    leaning = total = 0
    for name in want:
        a = np.asarray(got[name], np.float64).ravel()
        b = np.asarray(want[name], np.float64).ravel()
        flip = 2 * lr * compressed * np.abs(m[name]).max() / (
            np.sqrt(v[name].astype(np.float64).ravel()) + eps)
        d = np.abs(a - b)
        dense = atol + rtol * np.abs(b)
        worst = np.max(d / (dense + flip))
        assert worst <= 1.0, (what, name, float(worst))
        leaning += int((d > dense).sum())
        total += a.size
    assert leaning <= beyond * total, (what, leaning, total)
    return leaning, total


def wire_collectives(records):
    """(name, op, dtype, elements, bytes_per_step, link) of each record."""
    return sorted((c["name"], c["op"], c["dtype"], c["elements"],
                   c["bytes_per_step"], c["link"]) for c in records)
