"""The gloo worlds and the JAX references of the tensor-parallel tests
(tests/test_torch_tp.py).

Four worlds, each run once per test session (torch_zero_worker
``session_worlds``) and all four side by side when any is asked for
(``COMPANIONS``): the port's worlds ``tp_w2`` (``{"model": 2}``) and
``tp_w4`` (``{"data": 2, "model": 2}``), and two JAX reference processes
(tests/jax_zero_reference.py), ``tp_jax_gpt2`` and ``tp_jax_bert``, each
JAX engine at the port's mesh (``allow_partial`` on the 8 virtual CPU
devices). Each JAX process first writes its model's initial parameters
(the JAX engine's, seed 42), which the port's ranks wait for and load;
the port's
``{"data": 2, "model": 2}`` run writes a tag after its last step, which
the JAX engine and the port's model-2 world load (waiting for it).
"""
import os

import jax_zero_reference as JR
import torch
import torch_zero_worker as W

STEPS = 3
GAS = 2
SEED = 23
LR = 1e-3
# losses: fp32 at 1e-5 relative; bf16 at ROADMAP C-w18's 5e-5 (the JAX
# bf16 tanh-GeLU is eight bf16 operations, the port's one rounding); fp16
# at tests/test_torch_pipe.py's 2e-5
LOSS_RTOL = {"fp32": 1e-5, "bf16": 5e-5, "fp16": 2e-5}
# masters at tests/test_torch_zero.py's tolerances (assert_master_close);
# below fp32 every element within 0.1 * lr but at most FLIP_SHARE of a
# leaf's, those within 2 * steps * lr (tests/test_torch_pipe.py
# MASTER_ATOL and FLIP_SHARE: a gradient's rounding can flip the sign of
# a near-zero element's update). Measured against the JAX engine: in bf16
# at most 1/16 of a leaf (4 of the 64 q and v elements of h_0's c_attn
# bias; 154 of wte's 4096), each within 2.3e-3; in fp16 at most 1/128.
# bf16 is held to 1/8, fp16 to the pipeline's 1/16: a dropped gradient
# leaves nearly every element of its leaf beyond 0.1 * lr, since Adam
# moves an element by about lr a step
RTOL = 1e-4
MASTER_ATOL = {"fp32": 1e-5, "bf16": 0.1 * LR, "fp16": 0.1 * LR}
FLIP_SHARE = {"fp32": 0.0, "bf16": 1 / 8, "fp16": 1 / 16}
ATOL = MASTER_ATOL["fp32"]
# the fp16 overflow case: an inf planted in the first step's gradient of
# a leaf split over ``model``, on world rank 1 alone (data 0, model 1)
PLANT = (1, "h.0.attn.c_attn.weight")

# the port's engine cases: name -> (world, kind, mesh, stage, model
# overrides, dtype, the JAX run it is held against (None: a port run))
CASES = {
    "gpt2_m2": ("tp_w2", "gpt2", {"model": 2}, 0, {}, "fp32", "gpt2_m2"),
    "gpt2_d2m2_z0": ("tp_w4", "gpt2", {"data": 2, "model": 2}, 0, {},
                     "fp32", "gpt2_d2m2"),
    "gpt2_d2m2_z1": ("tp_w4", "gpt2", {"data": 2, "model": 2}, 1, {},
                     "fp32", "gpt2_d2m2"),
    "gpt2_d2m2_z2": ("tp_w4", "gpt2", {"data": 2, "model": 2}, 2, {},
                     "fp32", "gpt2_d2m2"),
    "gpt2_d2m2_bf16": ("tp_w4", "gpt2", {"data": 2, "model": 2}, 2, {},
                       "bf16", "gpt2_d2m2_bf16"),
    "gpt2_d2m2_fp16": ("tp_w4", "gpt2", {"data": 2, "model": 2}, 2, {},
                       "fp16", "gpt2_d2m2_fp16"),
    "bert_m2": ("tp_w2", "bert", {"model": 2}, 0, {}, "fp32", "bert_m2"),
    "bert_m2_sparse": ("tp_w2", "bert", {"model": 2}, 0, {"sparse": True},
                       "fp32", "bert_m2_sparse"),
    # port-only: dropout (the hash's head offset) and remat at model 2
    "gpt2_m2_dropout": ("tp_w2", "gpt2", {"model": 2}, 0,
                        {"dropout": 0.1}, "fp32", None),
    "gpt2_m2_remat": ("tp_w2", "gpt2", {"model": 2}, 0, {"remat": True},
                      "fp32", None),
}
JAX_CASES = sorted({c[-1] for c in CASES.values() if c[-1]})
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16,
          "fp16": torch.float16}


def init_path(root, kind):
    return os.path.join(root, f"tp_init_{kind}.pkl")


def tag_dir(root):
    return os.path.join(root, "tp_tag")


def _root(out):
    """The session's worlds directory (every world's ``out`` lies in
    it)."""
    return os.path.dirname(out)


def _port_job(name, root):
    _, kind, mesh, stage, model, dtype, _ = CASES[name]
    kw = dict(kind=kind, mesh=mesh, stage=stage, gas=GAS, steps=STEPS,
              seed=SEED, model=model, dtype=DTYPES[dtype], lr=LR,
              init_path=init_path(root, kind))
    if name == "gpt2_d2m2_z2":
        kw["save"] = tag_dir(root)
    return (name, "seq", kw)


def _world_w2(out):
    root = _root(out)
    jobs = [_port_job(n, root) for n, c in CASES.items() if c[0] == "tp_w2"]
    jobs.append(("load", "seq_load", dict(mesh={"model": 2}, stage=0,
                                          load=tag_dir(root), wait=True)))
    return W.run_world(2, jobs, out, timeout=300)


def _world_w4(out):
    root = _root(out)
    jobs = [_port_job(n, root) for n, c in CASES.items() if c[0] == "tp_w4"]
    # fp16 with an overflow on one rank only: every rank skips the step
    jobs.append(("overflow", "seq", dict(
        kind="gpt2", mesh={"data": 2, "model": 2}, stage=2, gas=GAS,
        steps=2, seed=SEED, dtype=torch.float16, lr=LR, plant=PLANT,
        init_path=init_path(root, "gpt2"))))
    # the MFU report's counts of one step (armed telemetry)
    jobs.append(("mfu", "seq", dict(
        kind="gpt2", mesh={"data": 2, "model": 2}, stage=2, gas=GAS,
        steps=1, seed=SEED, telemetry=True, master=None)))
    return W.run_world(4, jobs, out, timeout=300)


def _jax_train(name, kind, mesh, stage, **kw):
    return (name, "tp_train", dict(kind=kind, mesh=mesh, stage=stage,
                                   gas=GAS, steps=STEPS, seed=SEED, **kw))


def _jax_gpt2(out):
    """GPT-2's JAX reference: the initial parameters first, then the fp32
    and fp16 engines, then the load of the port's tag."""
    root = _root(out)
    return JR.run([
        ("init", "tp_init", dict(kind="gpt2", path=init_path(root, "gpt2"))),
        _jax_train("gpt2_m2", "gpt2", {"model": 2}, 0),
        _jax_train("gpt2_d2m2", "gpt2", {"data": 2, "model": 2}, 2),
        _jax_train("gpt2_d2m2_fp16", "gpt2", {"data": 2, "model": 2}, 2,
                   fp16=True),
        ("load", "tp_load", dict(
            load=tag_dir(root), kind="gpt2", mesh={"data": 2, "model": 2},
            stage=2, gas=GAS, seed=SEED, steps=STEPS + 1, step=STEPS))],
        out, timeout=900)


def _jax_bert(out):
    """BERT's JAX reference (its initial parameters first), and GPT-2's
    bf16 engine."""
    root = _root(out)
    return JR.run([
        ("init", "tp_init", dict(kind="bert", path=init_path(root, "bert"))),
        _jax_train("bert_m2", "bert", {"model": 2}, 0),
        _jax_train("bert_m2_sparse", "bert", {"model": 2}, 0, sparse=True),
        _jax_train("gpt2_d2m2_bf16", "gpt2", {"data": 2, "model": 2}, 2,
                   bf16=True)], out, timeout=900)


WORLDS = {"tp_w2": _world_w2, "tp_w4": _world_w4, "tp_jax_gpt2": _jax_gpt2,
          "tp_jax_bert": _jax_bert}
COMPANIONS = {k: [o for o in WORLDS if o != k] for k in WORLDS}


def jax_result(world, name):
    """The JAX run ``name`` (``JAX_CASES``; ``load``: the port's tag
    loaded)."""
    key = "tp_jax_gpt2" if name in ("gpt2_m2", "gpt2_d2m2", "gpt2_d2m2_fp16",
                                    "load") else "tp_jax_bert"
    return world(key)[name]


def port_ranks(world, name):
    """Every rank's result of the port's case ``name``."""
    return [rank[name] for rank in world(CASES[name][0])]
