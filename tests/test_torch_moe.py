"""The PyTorch port's mixture-of-experts (deepspeed_tpu_torch/moe/, GPT-2's
MoE blocks, their decode and the single-process engine) against the JAX
package's (deepspeed_tpu/moe/, models/gpt2.py, models/generation.py, the
JAX engine) on the CPU.

Inputs come from numpy seeds and weights from the JAX init, carried over
with models/convert.py. fp32 throughout but the bf16 rounding case (H1).

Routing flips (ROADMAP hazard H3): an argmax decided by less than the two
packages' rounding moves a whole token to another expert. Each parity
test measures the router logits' difference between the packages and
the smallest probability gap among the routing decisions (every one of
the k choices against the next), and requires the gap to exceed the
difference tenfold, so that a flip cannot hide behind a chosen seed: a
seed whose gap were smaller would fail loudly here rather than pass by
luck.

Jitter (H6) draws ``jax.random.uniform``, which no torch generator
reproduces (as C-w2, C-w6): parity holds at jitter 0; with jitter only the
factor's support [1 - j, 1 + j] is held.
"""
import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import torch_zero_worker as W
from deepspeed_tpu.models.generation import generate as jgenerate
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2Model as JGPT2Model
from deepspeed_tpu.moe import MoE as JMoE
from deepspeed_tpu.moe import layer as jlayer
from deepspeed_tpu.moe import moe_capacity as jmoe_capacity
from deepspeed_tpu.moe import moe_leaf_spec as jmoe_leaf_spec
from deepspeed_tpu.moe import sum_moe_losses as jsum_moe_losses
from deepspeed_tpu.moe import top_k_gating as jtop_k_gating
from deepspeed_tpu.runtime.engine import _first_micro
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.generation import decode_params, generate
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from deepspeed_tpu_torch.moe import (MoE, expert_parallel, layer,
                                     moe_capacity, moe_leaf_spec,
                                     sum_moe_losses, top_k_gating)
from deepspeed_tpu_torch.ops.transformer.transformer import replayable
from deepspeed_tpu_torch.runtime.activation_checkpointing import \
    checkpointing as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
# GPT-2 with MoE blocks: 4 layers (blocks 1 and 3 MoE), 4 experts
TINY = dict(vocab_size=128, n_positions=64, n_embd=32, n_layer=4, n_head=2,
            moe_num_experts=4)


def _np(t):
    return np.asarray(t.detach().float()) if torch.is_tensor(t) \
        else np.asarray(t)


def _close(got, want, what, rtol=RTOL):
    """Elementwise within rtol of the larger of |want| and the tensor's
    max (an element near zero reads against the tensor's scale)."""
    got, want = _np(got), _np(want)
    floor = rtol * max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor,
                               err_msg=what)


def _routing_margin(logits_a, logits_b, k):
    """(smallest gap, largest logit difference): the gap is the smallest
    difference between the i-th and (i+1)-th largest router probability
    over i < k+1 (every top-k decision and the one after it); the
    difference the largest |logit_a - logit_b| between the packages."""
    a = np.asarray(logits_a, np.float64)
    p = np.exp(a - a.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    top = -np.sort(-p, axis=-1)[..., :k + 1]
    gap = float(np.min(top[..., :-1] - top[..., 1:])) \
        if top.shape[-1] > 1 else np.inf
    diff = float(np.max(np.abs(a - np.asarray(logits_b, np.float64))))
    return gap, diff


def _assert_no_flip(logits_a, logits_b, k):
    gap, diff = _routing_margin(logits_a, logits_b, k)
    assert gap > 10 * diff, \
        f"a routing decision within the packages' rounding: gap {gap:.3e}, " \
        f"logit difference {diff:.3e} (H3)"


# ---------------------------------------------------------------------------
# gating
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("args", [(128, 8, 2, 1.0), (128, 8, 1, 1.25),
                                  (4, 64, 1, 1.0), (8, 2, 2, 100.0),
                                  (1024, 16, 2, 1.25)])
def test_capacity_is_the_reference_formula(args):
    assert moe_capacity(*args) == jmoe_capacity(*args)
    assert moe_capacity(1024, 16, 2, 1.25) == 160


GATING = [
    # (G, S, E, k, capacity, normalize, scale)
    (2, 16, 4, 1, None, True, 1.0),
    (2, 16, 4, 2, None, True, 1.0),
    (3, 32, 8, 2, 3, True, 2.0),        # capacity overflow: drops
    (2, 16, 4, 2, None, False, 1.0),    # unnormalized top-2
    (1, 24, 6, 1, 2, True, 3.0),        # top-1 overflow
    (2, 16, 8, 3, None, True, 1.0),     # k = 3
]


@pytest.mark.parametrize("G,S,E,k,capacity,normalize,scale", GATING)
def test_top_k_gating_matches_jax(G, S, E, k, capacity, normalize, scale):
    logits = np.random.default_rng(G * 100 + S + E + k).standard_normal(
        (G, S, E)).astype(np.float32) * scale
    jc, jd, jaux, jm = jtop_k_gating(jnp.asarray(logits), k=k,
                                     capacity=capacity, normalize=normalize)
    c, d, aux, m = top_k_gating(torch.as_tensor(logits), k=k,
                                capacity=capacity, normalize=normalize)
    _assert_no_flip(logits, logits, k)
    assert c.shape == jc.shape and c.dtype == torch.float32
    assert d.dtype == torch.bool
    np.testing.assert_array_equal(_np(d), np.asarray(jd))
    _close(c, jc, "combine")
    _close(aux, jaux, "aux")
    assert set(m) == set(jm)
    for key in m:
        _close(m[key], jm[key], key)
    if capacity is not None and capacity < S * k // E:
        assert float(m["moe_dropped_frac"]) > 0


def test_first_index_of_a_tie_as_jnp_argmax():
    """Equal logits: both packages route to the lowest index first."""
    logits = np.zeros((1, 4, 4), np.float32)
    logits[0, :, 1] = logits[0, :, 3] = 1.0
    jc = jtop_k_gating(jnp.asarray(logits), k=2, capacity=4)[0]
    c = top_k_gating(torch.as_tensor(logits), k=2, capacity=4)[0]
    np.testing.assert_array_equal(_np(c), np.asarray(jc))
    assert float(c[0, 0, 1].sum()) > 0 and float(c[0, 0, 3].sum()) > 0


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------
def _layers(M, E, Fd, dtype=torch.float32, seed=0, **kw):
    """The JAX MoE and the port's, with the JAX init carried over."""
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jmoe = JMoE(num_experts=E, d_ff=Fd, dtype=jdt, **kw)
    x0 = jnp.zeros((1, 4, M), jnp.float32)
    params = jmoe.init({"params": jax.random.PRNGKey(seed)}, x0,
                       train=False)["params"]
    moe = MoE(M, num_experts=E, d_ff=Fd, dtype=dtype, **kw)
    with torch.no_grad():
        moe.router.weight.copy_(torch.tensor(
            np.asarray(params["router"]["kernel"])).t())
        for n in ("w_in", "b_in", "w_out", "b_out"):
            getattr(moe.experts, n).copy_(torch.tensor(
                np.asarray(params["experts"][n])))
    return jmoe, params, moe


LAYER = [
    # (k, capacity_factor, train, extra)
    (2, 1.25, True, {}),
    (1, 1.0, True, {}),
    (2, 0.5, True, {}),                                   # drops
    (2, 0.5, False, {"eval_capacity_factor": 4.0}),       # eval capacity
    (2, 1.25, True, {"router_z_loss_coef": 0.01}),        # z-loss
    (1, 1.25, True, {"aux_loss_coef": 0.1, "min_capacity": 1}),
]


@pytest.mark.parametrize("k,cf,train,extra", LAYER)
def test_layer_output_and_grads_match_jax(k, cf, train, extra):
    B, S, M, E, Fd = 2, 16, 8, 4, 16
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, S, M)).astype(np.float32)
    w = rng.standard_normal((B, S, M)).astype(np.float32)
    jmoe, params, moe = _layers(M, E, Fd, k=k, capacity_factor=cf, **extra)

    def jloss(p, xx):
        y, col = jmoe.apply({"params": p}, xx, train=train,
                            mutable=["losses"],
                            rngs={"dropout": jax.random.PRNGKey(0)})
        aux = jsum_moe_losses(col["losses"])
        return jnp.sum(y * w) + aux, (y, aux)

    (jl, (jy, jaux)), (jg, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    y, aux = moe(xt, train=train)
    loss = (y * torch.as_tensor(w)).sum() + aux
    loss.backward()
    with torch.no_grad():
        _assert_no_flip(np.asarray(jnp.asarray(x) @ params["router"]
                                   ["kernel"]), _np(moe.router(xt)), k)
    _close(y, jy, "out")
    _close(aux, jaux, "aux")
    _close(xt.grad, jgx, "grad x")
    _close(moe.router.weight.grad.t(), jg["router"]["kernel"], "grad router")
    for n in ("w_in", "b_in", "w_out", "b_out"):
        _close(getattr(moe.experts, n).grad, jg["experts"][n], f"grad {n}")


def test_layer_with_bf16_rounds_combine_and_dispatch(monkeypatch):
    """H1: at bf16 the combine weights are rounded to bf16 before the
    combine product, as the JAX layer casts them. Each expert here outputs
    a constant bf16 vector (zero kernels, large biases of alternating sign,
    so that the two choices nearly cancel) and nothing else rounds: the
    port's output equals the JAX layer's bit for bit, and the same layer
    with the combine left in fp32 is a different result on most
    elements."""
    from deepspeed_tpu_torch.moe import sharded_moe

    B, S, M, E, Fd = 2, 32, 16, 4, 32
    x = np.random.default_rng(3).standard_normal((B, S, M)).astype(
        np.float32)
    jmoe, params, moe = _layers(M, E, Fd, dtype=torch.bfloat16, k=2)
    ex = {n: np.zeros_like(np.asarray(v))
          for n, v in params["experts"].items()}
    ex["b_out"] = np.repeat(np.array([96., -100., 104., -92.], np.float32)
                            [:, None], M, 1) \
        + np.linspace(0, 4, M, dtype=np.float32)[None]
    params = {"router": params["router"], "experts": ex}
    with torch.no_grad():
        for n, v in ex.items():
            getattr(moe.experts, n).copy_(torch.as_tensor(v))
    jy, _ = jax.jit(lambda p, xx: jmoe.apply(
        {"params": p}, xx, train=False, mutable=["losses"]))(
        params, jnp.asarray(x, jnp.bfloat16))
    xt = torch.as_tensor(x).to(torch.bfloat16)
    cast, einsum = sharded_moe._cast, torch.einsum

    def keep_combine_fp32(t, dtype, ct):
        # the combine weights: the only fp32 operand of rank 4 cast
        return t if t.dtype == torch.float32 and t.dim() == 4 \
            else cast(t, dtype, ct)

    def fp32_combine(eq, a, b):
        if eq == "egcm,gsec->gsm":
            return einsum(eq, a.float(), b.float()).to(a.dtype)
        return einsum(eq, a, b)

    with torch.no_grad():
        y, _ = moe(xt, train=False)
        monkeypatch.setattr(sharded_moe, "_cast", keep_combine_fp32)
        monkeypatch.setattr(torch, "einsum", fp32_combine)
        y32, _ = moe(xt, train=False)
    want = np.asarray(jy, np.float32)
    assert y.dtype == y32.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(y), want)
    assert (_np(y32) != want).mean() > 0.25


def test_single_expert_is_the_dense_ffn():
    """E = 1, k = 1: the gate is exactly 1, so the layer is GELU-FFN(x)."""
    x = torch.randn(2, 8, 16, generator=torch.Generator().manual_seed(0))
    moe = MoE(16, num_experts=1, d_ff=32, k=1, capacity_factor=1.0,
              min_capacity=8, dtype=torch.float32,
              generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        y, _ = moe(x, train=False)
        ex = moe.experts
        want = torch.nn.functional.gelu(x @ ex.w_in[0] + ex.b_in[0],
                                        approximate="tanh") @ ex.w_out[0] \
            + ex.b_out[0]
    torch.testing.assert_close(y, want, rtol=2e-5, atol=2e-5)


def test_router_jitter_stays_in_its_support():
    """H6: jitter multiplies the router input by a uniform factor in [1 -
    j, 1 + j] drawn from the layer's generator (train only)."""
    M, E, j = 8, 4, 0.01
    moe = MoE(M, num_experts=E, d_ff=16, router_jitter=j,
              dtype=torch.float32, generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 16, M, generator=torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        logits = moe.gate(x, train=True, generator=gen)[0]
        noise = torch.empty(x.shape).uniform_(
            1 - j, 1 + j, generator=torch.Generator().manual_seed(5))
        assert float(noise.min()) >= 1 - j and float(noise.max()) <= 1 + j
        torch.testing.assert_close(logits, moe.router(x * noise), rtol=0,
                                   atol=0)
        assert not torch.equal(logits, moe.router(x))
        torch.testing.assert_close(moe.gate(x, train=False)[0],
                                   moe.router(x), rtol=0, atol=0)


def test_factory_maps_deepspeed_arguments_as_the_reference():
    kw = dict(num_experts=4, k=2, capacity_factor=1.5,
              eval_capacity_factor=2.0, min_capacity=2, aux_loss_coef=0.02)
    for policy in (None, "Jitter"):
        jm = jlayer.MoE(64, noisy_gate_policy=policy, **kw)
        m = layer.MoE(64, noisy_gate_policy=policy, **kw)
        for field in ("num_experts", "d_ff", "k", "capacity_factor",
                      "eval_capacity_factor", "min_capacity",
                      "aux_loss_coef", "router_jitter",
                      "router_z_loss_coef"):
            assert getattr(m, field) == getattr(jm, field), (policy, field)
    assert layer.MoE(64).d_ff == 256
    assert layer.MoE(64, expert_intermediate_size=100).d_ff == 100
    for moe in (jlayer.MoE, layer.MoE):
        with pytest.raises(ValueError, match="RSample"):
            moe(64, noisy_gate_policy="RSample")


def test_leaf_spec_and_loss_sum_are_the_references():
    from jax.sharding import PartitionSpec as P

    for path, ndim in (("h_1/moe/router/kernel", 2),
                       ("h_1/moe/experts/w_in", 3),
                       ("h_1/moe/experts/w_out", 3),
                       ("h_1/moe/experts/b_in", 2),
                       ("h_1/moe/experts/b_out", 2),
                       ("h_1/attn/c_attn/kernel", 2)):
        want = jmoe_leaf_spec(path, np.zeros((2,) * ndim))
        got = moe_leaf_spec(path)
        assert (got is None) == (want is None), path
        if want is not None:
            assert P(*got) == want, path
    vals = [torch.tensor(0.5), None, torch.tensor(0.25)]
    assert float(sum_moe_losses(vals)) == 0.75
    assert float(sum_moe_losses({"a": vals[0], "b": vals[2]})) == 0.75


def test_expert_split_refuses_what_the_jax_engine_refuses():
    """The JAX engine cannot place E experts over a data axis that does
    not divide E (its expert leaves are P('data', ...)); the port raises
    at the split, naming the stack."""
    class Group:
        def __init__(self, size, rank):
            self.size, self.rank = size, rank

    model = GPT2Model(GPT2Config(dtype=torch.float32, **TINY))
    with pytest.raises(ValueError, match="4 experts do not split"):
        expert_parallel(model, Group(3, 0))
    w_in = model.h[1].moe.experts.w_in.detach().clone()
    group = Group(2, 1)
    names = expert_parallel(model, group)
    assert len(names) == 8
    assert torch.equal(model.h[1].moe.experts.w_in, w_in[2:])
    assert model.h[1].moe.expert_group is group


def test_moe_package_imports_no_jax():
    """The AST scan of tests/test_torch_engine.py walks the port; it
    reaches the moe package too."""
    root = os.path.join(REPO, "deepspeed_tpu_torch", "moe")
    files = [os.path.join(root, n) for n in sorted(os.listdir(root))
             if n.endswith(".py")]
    assert len(files) == 3
    for path in files:
        roots = set()
        for node in ast.walk(ast.parse(open(path).read())):
            if isinstance(node, ast.Import):
                roots |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                roots.add(node.module.split(".")[0])
        assert not roots & {"jax", "flax", "deepspeed_tpu"}, path


# ---------------------------------------------------------------------------
# GPT-2 with MoE blocks
# ---------------------------------------------------------------------------
def _models(chunk=0, seed=0, **over):
    kw = dict(TINY, loss_chunk_tokens=chunk, **over)
    jmodel = JGPT2Model(JGPT2Config(dtype=jnp.float32, **kw))
    ids = np.random.default_rng(seed).integers(0, TINY["vocab_size"],
                                               (2, 32))
    batch = {"input_ids": ids, "labels": ids.copy()}
    params = jmodel.init(jax.random.PRNGKey(seed), batch)
    cfg = GPT2Config(dtype=torch.float32, **kw)
    model = GPT2Model(cfg)
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), cfg))
    return jmodel, params, model, cfg, batch


def _torch_batch(batch):
    return {k: torch.as_tensor(v).long() for k, v in batch.items()}


def _router_logits(jmodel, params, model, batch):
    """Each MoE block's router logits from both packages."""
    _, state = jmodel.module.apply(
        {"params": params}, batch["input_ids"], train=True,
        rngs={"dropout": jax.random.PRNGKey(1)},
        capture_intermediates=True, mutable=["intermediates", "losses"])
    inter = state["intermediates"]
    seen = {}
    hooks = [b.moe.router.register_forward_hook(
        lambda mod, a, out, i=i: seen.setdefault(i, out))
        for i, b in enumerate(model.h) if b.use_moe]
    with torch.no_grad():
        model.loss(_torch_batch(batch), train=True)
    for h in hooks:
        h.remove()
    return [(np.asarray(inter[f"h_{i}"]["moe"]["router"]["__call__"][0]),
             _np(seen[i])) for i in sorted(seen)]


@pytest.mark.parametrize("chunk", [0, 8192])
def test_gpt2_moe_loss_and_grads_match_jax(chunk):
    jmodel, params, model, cfg, batch = _models(chunk)

    def loss_fn(p):
        return jmodel.loss(p, batch, jax.random.PRNGKey(1), train=True)

    (jl, jmet), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    loss, metrics = model.loss(_torch_batch(batch), train=True)
    loss.backward()
    for jlog, plog in _router_logits(jmodel, params, model, batch):
        _assert_no_flip(jlog, plog, cfg.moe_top_k)
    assert set(metrics) == set(jmet) == {"loss", "moe_aux_loss"}
    assert metrics["loss"] is loss
    _close(loss, jl, "loss")
    _close(metrics["moe_aux_loss"], jmet["moe_aux_loss"], "moe_aux_loss")
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jg), cfg)
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    assert "h.1.moe.experts.w_in" in got and "h.1.mlp.c_fc.weight" not in got
    for name, p in got.items():
        _close(p.grad, want[name], name, rtol=1e-4)
    # eval: no aux in the loss, none in the metrics
    jeval = jmodel.loss(params, batch, jax.random.PRNGKey(1), train=False)
    with torch.no_grad():
        ev, evm = model.loss(_torch_batch(batch), train=False)
    assert set(evm) == set(jeval[1]) == {"loss"}
    _close(ev, jeval[0], "eval loss")


def test_reference_tree_and_leaf_specs_follow_the_jax_tree():
    jmodel, params, model, cfg, _ = _models()
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    paths = ["/".join(str(getattr(k, "key", k)) for k in p) for p, _ in flat]
    assert model.reference_leaf_paths() == paths
    shapes = dict(model.named_parameters())
    for (names, transposed), (_, leaf) in zip(model.reference_leaf_specs(),
                                              flat):
        shape = tuple(shapes[names].shape)
        assert (shape[::-1] if transposed else shape) == np.shape(leaf)
    assert model.expert_dim("h_1/moe/experts/w_in") == 0
    assert model.expert_dim("h_1/moe/router/kernel") is None
    assert model.tp_taken("h_1/moe/experts/w_in", 3) == (2,)
    assert model.tp_taken("h_1/moe/router/kernel", 2) == ()


def test_moe_requires_unrolled_layers_as_the_reference():
    with pytest.raises(AssertionError, match="scan_layers=False"):
        GPT2Model(GPT2Config(dtype=torch.float32, scan_layers=True, **TINY))
    with pytest.raises(AssertionError, match="scan_layers=False"):
        JGPT2Model(JGPT2Config(scan_layers=True, **TINY)).init(
            jax.random.PRNGKey(0), {"input_ids": np.zeros((1, 8), np.int32)})


def _checkpoint_blocks(model):
    for block in model.h:
        def forward(x, train, generator, _inner=block.forward):
            return ckpt.checkpoint(replayable(_inner, generator), x, train)
        block.forward = forward
    return model


@pytest.mark.parametrize("policy", ["nothing", "attn_out", "dots",
                                    "checkpoint_in_cpu"])
def test_remat_carries_the_aux_bit_for_bit(policy):
    """H4: each remat policy, and blocks under checkpointing.checkpoint
    with checkpoint_in_cpu, give the loss, the aux and every gradient of
    the model without remat bit for bit: the aux leaves each recomputed
    segment as its output, counted once, its gradient reaching the
    router. Router jitter on (its draw replayed)."""
    over = dict(remat=policy != "checkpoint_in_cpu", remat_policy=policy)
    base = GPT2Model(GPT2Config(dtype=torch.float32, **TINY))
    for b in base.h:
        if b.use_moe:
            b.moe.router_jitter = 0.01
    model = GPT2Model(GPT2Config(dtype=torch.float32, **dict(TINY, **over)))
    model.load_state_dict(base.state_dict())
    for b in model.h:
        if b.use_moe:
            b.moe.router_jitter = 0.01
    if policy == "checkpoint_in_cpu":
        ckpt.reset()
        ckpt.configure(checkpoint_in_cpu=True)
        _checkpoint_blocks(model)
    batch = _torch_batch(_models()[4])
    try:
        runs = []
        for m in (base, model):
            loss, metrics = m.loss(batch, generator=torch.Generator()
                                   .manual_seed(3), train=True)
            loss.backward()
            runs.append((loss, metrics["moe_aux_loss"],
                         {n: p.grad for n, p in m.named_parameters()}))
    finally:
        ckpt.reset()
    (l0, a0, g0), (l1, a1, g1) = runs
    assert torch.equal(l0, l1) and torch.equal(a0, a1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    assert float(g1["h.1.moe.router.weight"].abs().sum()) > 0


def test_dots_keeps_what_the_jax_dots_saveable_keeps_of_an_moe_block(
        monkeypatch):
    """H4, 'dots': the outputs the port's selective checkpoint saves are
    the dot outputs jax.checkpoint's dots_saveable keeps in the JAX model
    (saved_residuals), element count for element count: c_attn, c_proj
    and c_fc of the dense block; c_attn, c_proj, the router and the
    dispatch, expert-hidden and expert-output products of the MoE block,
    not its combine (which reaches only the residual add)."""
    from jax._src.ad_checkpoint import saved_residuals
    from torch.utils.checkpoint import CheckpointPolicy

    from deepspeed_tpu_torch.models import gpt2 as tgpt2

    kw = dict(TINY, n_layer=2, loss_chunk_tokens=0, remat=True,
              remat_policy="dots")
    jmodel = JGPT2Model(JGPT2Config(dtype=jnp.float32, **kw))
    ids = np.random.default_rng(0).integers(0, TINY["vocab_size"], (2, 32))
    batch = {"input_ids": ids, "labels": ids}
    params = jmodel.init(jax.random.PRNGKey(0), batch)
    want = sorted(int(np.prod(aval.shape)) for aval, why in saved_residuals(
        lambda p: jmodel.loss(p, batch, jax.random.PRNGKey(1))[0], params)
        if "linear.py" in why or "sharded_moe.py" in why)
    saved = []
    original = tgpt2._dots_policy

    def recording(**kwargs):
        policy = original(**kwargs)

        def record(ctx, op, *args, **kw):
            decision = policy(ctx, op, *args, **kw)
            if decision == CheckpointPolicy.MUST_SAVE:
                saved.append(ctx.op_output.numel())
            return decision

        return record

    monkeypatch.setattr(tgpt2, "_dots_policy", recording)
    model = GPT2Model(GPT2Config(dtype=torch.float32, **kw))
    model.loss(_torch_batch(batch))[0].backward()
    assert len(want) == 9, want
    assert sorted(saved) == want


def test_generate_greedy_and_beam_match_jax():
    from test_torch_generation import _jax_logits, _min_top2_gap

    jmodel, params, model, cfg, _ = _models(seed=2)
    prompt = np.random.default_rng(1).integers(0, TINY["vocab_size"],
                                               (3, 6)).astype(np.int32)
    want = np.asarray(jgenerate(jmodel, params, prompt, 10))
    got, logits = generate(model, None, prompt, 10, device="cpu",
                           return_logits=True)
    # C-w9: the reference trajectory's top-2 gaps against the measured
    # logit difference, before the tokens are held equal
    jl = _jax_logits(jmodel, params, prompt, want[:, 6:])
    _close(logits, jl, "decode logits", rtol=1e-4)
    diff = float(np.abs(logits - jl).max())
    assert _min_top2_gap(jl) >= 10 * diff, (_min_top2_gap(jl), diff)
    np.testing.assert_array_equal(got, want)
    jbeam = jgenerate(jmodel, params, prompt, 6, num_beams=3)
    np.testing.assert_array_equal(
        generate(model, None, prompt, 6, num_beams=3, device="cpu"),
        np.asarray(jbeam))
    # the JAX tree itself is a decode_params source too
    tree = jax.tree_util.tree_map(np.asarray, params)
    np.testing.assert_array_equal(
        generate(model, tree, prompt, 10, device="cpu"), np.asarray(want))
    w = decode_params(model, None, "cpu")
    assert set(w["blocks"][1]) == {"ln_1", "attn", "ln_2", "moe"}
    assert w["blocks"][1]["moe"]["router"]["kernel"].shape == (32, 4)


def test_decode_gates_one_token_at_capacity_k():
    """A decode step's token takes at most one slot of each chosen expert:
    with nothing dropped, the greedy tokens are the training forward's
    argmax but at near ties (tests/unit/test_generation.py:134)."""
    jmodel, params, model, cfg, _ = _models(seed=4, moe_capacity_factor=8.0)
    prompt = np.random.default_rng(4).integers(0, TINY["vocab_size"],
                                               (2, 5)).astype(np.int32)
    seq, logits = generate(model, None, prompt, 8, device="cpu",
                           return_logits=True)
    with torch.no_grad():
        full = model(torch.as_tensor(seq[:, :-1]).long())
    want = full[:, 4:].argmax(-1).numpy()
    top2 = torch.topk(full[:, 4:], 2, dim=-1).values
    tie = (top2[..., 0] - top2[..., 1]).numpy() < 1e-5 * np.abs(
        top2[..., 0].numpy())
    assert not tie.any()
    np.testing.assert_array_equal(seq[:, 5:], want)


# ---------------------------------------------------------------------------
# the single-process engine
# ---------------------------------------------------------------------------
DS = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
      "gradient_accumulation_steps": 2,
      "optimizer": {"type": "Adam", "params": {"lr": 1e-3,
                                                "weight_decay": 0.01}},
      "gradient_clipping": 1.0, "steps_per_print": 10 ** 9}


def test_engine_matches_the_jax_engine_for_5_steps():
    """Losses, the model's moe_aux_loss before each step and the final
    master at rtol 1e-4 (the single-process engine's parity tolerance,
    tests/test_torch_engine.py); the registered programs are the JAX
    engine's and the comm report and analytic memory its own."""
    kw = dict(TINY, loss_chunk_tokens=0)
    jeng = deepspeed_tpu.initialize(
        model=JGPT2Model(JGPT2Config(dtype=jnp.float32, **kw)),
        config_params=dict(DS, mesh={"data": 1, "allow_partial": True}))[0]
    batches = np.random.default_rng(9).integers(0, 128, (5, 2, 2, 32))
    jeng._ensure_state(_first_micro({"input_ids": batches[0],
                                     "labels": batches[0]}))
    cfg = GPT2Config(dtype=torch.float32, **kw)
    eng = initialize(model=GPT2Model(cfg), config_params=DS, device="cpu")[0]
    eng.load_module_state_dict(params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax.device_get(jeng.state.params)), cfg))
    jaux_of = jax.jit(lambda p, m: jeng.module.loss(
        p, m, jax.random.PRNGKey(0), train=True)[1]["moe_aux_loss"])
    jl, jaux, pl, paux = [], [], [], []
    for b in batches:
        micro = {"input_ids": b[0], "labels": b[0]}
        jaux.append(float(jaux_of(jeng.state.params, micro)))
        with torch.no_grad():
            paux.append(float(eng.module.loss(_torch_batch(micro),
                                              train=True)[1]["moe_aux_loss"]))
        jl.append(float(jeng.train_batch(batch={"input_ids": b,
                                                "labels": b})))
        pl.append(eng.train_batch(batch={"input_ids": b,
                                         "labels": b}).item())
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    np.testing.assert_allclose(paux, jaux, rtol=1e-5)
    want = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax.device_get(jeng.state.params)), cfg)
    # the key third of each c_attn bias moves by rounding noise (its
    # gradient is zero in exact arithmetic): tests/test_torch_zero.py
    W.assert_master_close({n: _np(m) for n, m in zip(eng.param_names,
                                                     eng.master)},
                          {n: t.numpy() for n, t in want.items()},
                          1e-4, 1e-5, 5, 1e-3, "moe engine")
    assert sorted(eng.program_registry.names()) == \
        sorted(jeng.program_registry.names())
    jrep, rep = jeng.comm_volume_report(), eng.comm_volume_report()
    assert rep["total_bytes_per_step"] == jrep["total_bytes_per_step"] == 0
    assert eng._analytic_memory_components()["components"] == {
        k: v for k, v in jeng._analytic_memory_components()[
            "components"].items()
        if k in eng._analytic_memory_components()["components"]}


def test_meta_flop_count_covers_the_moe_products():
    """The MFU replay on meta tensors counts the router, the dispatch and
    combine products and both expert products of an MoE layer."""
    from deepspeed_tpu_torch.telemetry import mfu

    G, S, M, E, Fd, k = 2, 16, 8, 4, 32, 2
    moe = MoE(M, num_experts=E, d_ff=Fd, k=k, dtype=torch.float32)
    C = moe_capacity(S, E, k, 1.25)
    x = torch.zeros(G, S, M)
    cost = mfu.fn_flops(lambda xx: moe(xx, train=False), (x,))
    want = 2 * G * S * M * E + 2 * (2 * G * S * E * C * M) \
        + 2 * (2 * E * G * C * M * Fd)
    assert cost["matmul_flops"] == want
    # the model's parameter count for 6ND: every expert of every stack
    eng = initialize(model=GPT2Model(GPT2Config(dtype=torch.float32,
                                                **TINY)),
                     config_params=dict(DS, telemetry={"enabled": True,
                                                       "mfu": True}),
                     device="cpu")[0]
    ids = np.zeros((2, 2, 32), np.int64)
    eng.train_batch(batch={"input_ids": ids, "labels": ids})
    assert eng._mfu_n_params == sum(p.numel()
                                    for p in eng.module.parameters())
    assert eng.telemetry_report()["mfu"]["per_jit"]["micro_step"]["flops"]
