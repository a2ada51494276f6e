"""The gloo worlds and the JAX references of the sequence-parallel tests
(tests/test_torch_ulysses.py, tests/test_torch_ring_attention.py).

Two worlds, each started once per test session (torch_zero_worker
``session_worlds``): ``sp_w4`` (4 ranks) and ``sp_w2`` (2 ranks). Each
runs the attention functions on numpy inputs (Ulysses and the ring over
the world as one seq group) and the engine jobs (``job_seq``) of both
test modules, so that no test starts a world of its own. The JAX side
runs in the test process on its 8 virtual CPU devices, at the same mesh,
from the same initial parameters (the JAX engine's, seed 42, carried over
with models/convert.py) and the same global batches.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import deepspeed_tpu
import torch_zero_worker as W
from deepspeed_tpu.models.bert import BertConfig as JBertConfig
from deepspeed_tpu.models.bert import BertForPreTraining as JBert
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2Model as JGPT2Model
from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu.parallel.ring_attention import make_ring_attention
from deepspeed_tpu.parallel.ulysses import make_ulysses_attention
from deepspeed_tpu.runtime.engine import _first_micro
from deepspeed_tpu_torch.models.convert import (bert_params_from_jax,
                                                params_from_jax)
from deepspeed_tpu_torch.runtime import comm_accounting as tca
from deepspeed_tpu_torch.runtime.zero.partition import ZeroPartition

STEPS = 5
GAS = 2
SEED = 21
LR = 1e-3
# the engine against the JAX engine: losses, and the masters at
# tests/test_torch_zero.py's tolerances
LOSS_RTOL = 2e-5
RTOL, ATOL = 1e-4, 1e-5
# the attention functions' inputs: (B, H, S, D) per case
ULYSSES_SHAPE = (2, 8, 128, 16)       # tests/unit/test_ulysses.py
RING_SHAPE = (2, 3, 64, 16)           # tests/unit/test_ring_attention.py
DROPOUT = (0.1, 1234)                 # (rate, generator seed)
# engine cases: name -> (kind, mesh, stage, model overrides)
ENGINE_CASES = {
    "gpt2_s4_ulysses": ("gpt2", {"seq": 4}, 2, {}),
    "gpt2_s4_ring": ("gpt2", {"seq": 4}, 2, {"attention_sp_mode": "ring"}),
    "gpt2_d2s2_z0": ("gpt2", {"data": 2, "seq": 2}, 0, {}),
    "gpt2_d2s2_z2": ("gpt2", {"data": 2, "seq": 2}, 2, {}),
    "bert_d2s2_dense": ("bert", {"data": 2, "seq": 2}, 1, {}),
    "bert_d2s2_sparse": ("bert", {"data": 2, "seq": 2}, 1,
                         {"sparse": True}),
}


def attention_inputs(shape, seed):
    """q, k, v and the output gradient, fp32 normal, from a numpy seed."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


# attention-function cases: name -> (world, mode, shape, seed, causal,
# dtype, dropout)
ATTENTION_CASES = {
    "ulysses_n4_causal": (4, "ulysses", ULYSSES_SHAPE, 0, True,
                          torch.float32, None),
    "ulysses_n4_full": (4, "ulysses", ULYSSES_SHAPE, 1, False,
                        torch.float32, None),
    "ulysses_n2_causal": (2, "ulysses", ULYSSES_SHAPE, 2, True,
                          torch.float32, None),
    "ulysses_n4_dropout": (4, "ulysses", (2, 4, 128, 64), 3, True,
                           torch.float32, DROPOUT),
    "ulysses_n2_dropout": (2, "ulysses", (2, 4, 128, 64), 3, True,
                           torch.float32, DROPOUT),
    "ring_n4_causal": (4, "ring", RING_SHAPE, 4, True, torch.float32, None),
    "ring_n4_full": (4, "ring", RING_SHAPE, 5, False, torch.float32, None),
    "ring_n2_causal": (2, "ring", (2, 3, 16, 16), 6, True, torch.float32,
                       None),
    "ring_n2_full": (2, "ring", (2, 3, 16, 16), 7, False, torch.float32,
                     None),
    "ring_n4_bf16": (4, "ring", (2, 3, 32, 16), 8, True, torch.bfloat16,
                     None),
}


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------
def jax_model(kind, **over):
    if kind == "gpt2":
        return JGPT2Model(JGPT2Config(dtype=jnp.float32,
                                      **dict(W.SP_GPT2, **over)))
    sparse = over.pop("sparse", False)
    return JBert(JBertConfig(
        dtype=jnp.float32, sparsity_config=jsa.FixedSparsityConfig(
            **W.SP_SPARSITY) if sparse else None, **dict(W.SP_BERT, **over)))


def jax_engine(kind, mesh, stage, gas=GAS, model=None):
    dp = mesh.get("data", 1)
    cfg = dict(W.ds_config(dp, stage, gas, lr=LR),
               mesh=dict({"data": 1}, **mesh, allow_partial=True))
    return deepspeed_tpu.initialize(model=jax_model(kind, **(model or {})),
                                    config_params=cfg)[0]


def global_batch(kind, step, dp, seed=SEED, steps=STEPS, gas=GAS):
    """Step ``step``'s global batch: (gas, micro * dp, S) per entry."""
    return {k: v[step] for k, v in
            W.sp_batches(kind, seed, steps, gas, W.MICRO * dp).items()}


@functools.lru_cache(maxsize=None)
def jax_init(kind, sparse=False):
    """The JAX engine's initial parameters (seed 42) as numpy (the
    sparsity config adds no parameter)."""
    jeng = jax_engine(kind, {"data": 1}, 0, gas=1)
    jeng._ensure_state(_first_micro(global_batch(kind, 0, 1, gas=1,
                                                 steps=1)))
    return jax.tree_util.tree_map(np.asarray,
                                  jax.device_get(jeng.state.params))


@functools.lru_cache(maxsize=None)
def jax_run(case):
    """The JAX engine at the case's mesh over STEPS global batches: its
    losses, its final params by leaf path, its comm report, analytic
    memory and program registry."""
    kind, mesh, stage, model = ENGINE_CASES[case]
    jeng = jax_engine(kind, mesh, stage, model=model)
    dp = mesh.get("data", 1)
    losses = [float(jeng.train_batch(batch=global_batch(kind, s, dp)))
              for s in range(STEPS)]
    params = jax.tree_util.tree_map(np.asarray,
                                    jax.device_get(jeng.state.params))
    return {"losses": losses, "params": params, "engine": jeng}


# ---------------------------------------------------------------------------
# the comparisons both test modules make
# ---------------------------------------------------------------------------
def gathered(world, name, n):
    """The world's per-rank chunks of a function case, joined along S."""
    ranks = world(f"sp_w{n}")
    return {k: np.concatenate([r[name][k] for r in ranks], axis=2)
            for k in ("out", "dq", "dk", "dv")}


def jax_function(mode, n, shape, seed, causal, dtype=jnp.float32):
    """The JAX package's sequence-parallel function at N = n on the
    virtual devices: its output and jax.grad of sum(out * do)."""
    q, k, v, do = (jnp.asarray(x, dtype) for x in
                   attention_inputs(shape, seed))
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("seq",))
    make = make_ulysses_attention if mode == "ulysses" \
        else make_ring_attention
    fn = make(mesh, "seq", causal=causal)
    sh = NamedSharding(mesh, P(None, None, "seq", None))
    args = [jax.device_put(x, sh) for x in (q, k, v)]
    out = jax.jit(fn)(*args)
    grads = jax.jit(jax.grad(
        lambda a, b, c: jnp.sum(fn(a, b, c).astype(jnp.float32)
                                * do.astype(jnp.float32)),
        argnums=(0, 1, 2)))(*args)
    return {"out": np.asarray(out, np.float32),
            **{f"d{x}": np.asarray(g, np.float32)
               for x, g in zip("qkv", grads)}}


def assert_function_close(got, want, rtol, atol, what):
    """The output and the three gradients within rtol/atol."""
    for key in ("out", "dq", "dk", "dv"):
        np.testing.assert_allclose(got[key], want[key], rtol=rtol, atol=atol,
                                   err_msg=f"{what}: {key}")


def assert_engine_matches_jax(world, case):
    """Every rank's losses, and the replicated master of every rank, against
    the JAX engine's at the case's mesh."""
    kind = ENGINE_CASES[case][0]
    want = jax_run(case)
    ranks = world("sp_w4")
    for r, rank in enumerate(ranks):
        got = rank[case]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=LOSS_RTOL, err_msg=f"{case} rank {r}")
    convert = params_from_jax if kind == "gpt2" else bert_params_from_jax
    module = W.sp_model(kind, **dict(ENGINE_CASES[case][3]))
    jmaster = {n: t.numpy() for n, t in
               convert(want["params"], module.config).items()}
    W.assert_master_close(ranks[0][case]["master"], jmaster, RTOL, ATOL,
                          STEPS, LR, case)
    # every rank holds the same replicated master
    for rank in ranks[1:]:
        for name, m in rank[case]["master"].items():
            np.testing.assert_array_equal(m, ranks[0][case]["master"][name])


def seq_axis_collectives(case, n, micro=W.MICRO):
    """{name: (op, elements, count per step)} of the seq axis's
    collectives in one step of ``case``: the gradient all-reduce of the
    accumulator once per step (every leaf, at ZeRO 2 this rank's shard of
    each sharded one), the attention's all-to-alls (Ulysses) or hops (the
    ring) per layer and micro step, and BERT's [CLS] broadcast per micro
    step."""
    kind, mesh, stage, model = ENGINE_CASES[case]
    module = W.sp_model(kind, **dict(model))
    dp = mesh.get("data", 1)
    out = {f"sp_grad_ar:{leaf.name}": (
        "all-reduce", leaf.elements // dp
        if stage >= 2 and leaf.shard_dim is not None else leaf.elements, 1)
        for leaf in leaf_specs(module, dp, stage)}
    if kind == "gpt2":
        layers, heads, width = (W.SP_GPT2["n_layer"], W.SP_GPT2["n_head"],
                                W.SP_GPT2["n_embd"])
        seq = W.SEQ
    else:
        layers, heads, width = (W.SP_BERT["num_hidden_layers"],
                                W.SP_BERT["num_attention_heads"],
                                W.SP_BERT["hidden_size"])
        seq = W.SP_BERT_SEQ
        out["sp_bcast:cls"] = ("broadcast", micro * width, GAS)
    chunk = micro * width * (seq // n)          # B * H * S/N * D
    calls = layers * GAS
    if model.get("attention_sp_mode") == "ring":
        out.update({"sp_ring:kv": ("collective-permute", 2 * chunk,
                                   (n - 1) * calls),
                    "sp_ring:kv_bwd": ("collective-permute", 2 * chunk,
                                       (n - 1) * calls),
                    "sp_ring:dkv_bwd": ("collective-permute", 2 * chunk,
                                        n * calls)})
    else:
        out.update({f"sp_a2a:{x}": ("all-to-all", m * chunk, calls)
                    for x, m in (("qkv", 3), ("out", 1), ("out_bwd", 1),
                                 ("qkv_bwd", 3))})
    assert heads % n == 0
    return out


def leaf_specs(module, dp=1, stage=0):
    """The model's JAX leaves, as the engine's partition names them, each
    with its ZeRO dimension at ``dp`` and ``stage``."""
    named = list(module.named_parameters())
    part = ZeroPartition(module, [n for n, _ in named],
                         [p for _, p in named], dp, 0, stage, ())
    return part.leaves


def by_name(collectives):
    return {c["name"]: c for c in collectives}


def assert_counted_collectives(world, case):
    """The counted step: the report's collectives over ``data`` (at data 1
    it prices all-reduces of 0 bytes over an axis of 1, which nothing
    posts; at ZeRO 1 the port also posts the parameter all-gather the
    report omits, C-w7), and the seq axis's in closed form, which the
    report omits (C-w14)."""
    kind, mesh, stage, _ = ENGINE_CASES[case]
    n, dp = mesh["seq"], mesh.get("data", 1)
    for rank in world("sp_w4"):
        got = rank[case]
        report = by_name(got["report"]["collectives"])
        assert not any(c["name"].startswith("sp_") for c in report.values())
        for step in got["comm"]:
            counted = by_name(step["collectives"])
            data = {k: v for k, v in counted.items()
                    if not k.startswith("sp_")}
            if dp == 1:
                assert data == {}
                assert all(c["bytes_per_step"] == 0 for c in report.values())
            else:
                if stage == 1:
                    # the parameter all-gather the JAX program posts and
                    # its report does not price (ROADMAP C-w7)
                    gathers = [k for k in data if k.startswith("param_ag:")]
                    assert gathers
                    for k in gathers:
                        del data[k]
                assert data == report
            seq = {k: v for k, v in counted.items() if k.startswith("sp_")}
            want = seq_axis_collectives(case, n)
            assert set(seq) == set(want)
            for name, (op, elements, count) in want.items():
                c = seq[name]
                es = 4 if c["dtype"] == "float32" else 2
                assert (c["op"], c["elements"], c["count_per_step"],
                        c["axis_size"]) == (op, elements, count, n), name
                assert c["bytes_per_device"] == tca._RING_BYTES[op](
                    elements, es, n), name


# ---------------------------------------------------------------------------
# the worlds
# ---------------------------------------------------------------------------
def _attention_jobs(world):
    jobs = []
    for name, (n, mode, shape, seed, causal, dtype, drop) in \
            ATTENTION_CASES.items():
        if n != world:
            continue
        q, k, v, do = attention_inputs(shape, seed)
        jobs.append((name, "seq_attention", dict(
            mode=mode, q=q, k=k, v=v, do=do, causal=causal, dtype=dtype,
            heads_dropout=drop)))
    return jobs


def _engine_job(case, **kw):
    kind, mesh, stage, model = ENGINE_CASES[case]
    return (case, "seq", dict(kind=kind, mesh=mesh, stage=stage, gas=GAS,
                              steps=STEPS, seed=SEED, lr=LR, model=model,
                              init=jax_init(kind), **kw))


def _world_w4(out):
    jobs = _attention_jobs(4)
    jobs += [_engine_job(case, programs=case == "gpt2_s4_ulysses")
             for case in ENGINE_CASES]
    return W.run_world(4, jobs, out, timeout=240)


def jax_tag(out):
    """The JAX engine's tag at seq 2 (GPT-2, stage 2) after two steps."""
    path = os.path.join(out, "jax_tag")
    jeng = jax_engine("gpt2", {"seq": 2}, 2)
    for s in range(2):
        jeng.train_batch(batch=global_batch("gpt2", s, 1))
    jeng.save_checkpoint(path, backend="npz")
    return path


def _world_w2(out):
    jtag = jax_tag(out)
    jobs = _attention_jobs(2)
    jobs += [
        # dropout 0.1 under Ulysses, against the port at seq 1
        ("dropout", "seq", dict(kind="gpt2", mesh={"seq": 2}, stage=0,
                                gas=GAS, steps=3, seed=SEED, lr=LR,
                                model={"dropout": 0.1},
                                init=jax_init("gpt2"))),
        ("save", "seq", dict(kind="gpt2", mesh={"seq": 2}, stage=2, gas=GAS,
                             steps=2, seed=SEED, lr=LR,
                             init=jax_init("gpt2"), telemetry=True,
                             save=os.path.join(out, "port_tag"))),
        ("offload", "seq", dict(kind="gpt2", mesh={"seq": 2}, stage=2,
                                gas=GAS, steps=3, seed=SEED, lr=LR,
                                init=jax_init("gpt2"), offload=True)),
        ("load_jax", "seq_load", dict(mesh={"seq": 2}, stage=2, load=jtag)),
        ("refusals", "seq_refusals", {}),
    ]
    return W.run_world(2, jobs, out, timeout=240)


WORLDS = {"sp_w4": _world_w4, "sp_w2": _world_w2}
