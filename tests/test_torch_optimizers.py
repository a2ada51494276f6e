"""The rest of the port's single-device engine against the JAX package:
LAMB and SGD, progressive layer drop, the activation-checkpointing API and
the GPT-2 remat policies.

Tolerances: optimizer updates at rtol 1e-5 / atol 1e-6, as
tests/test_torch_engine.py holds FusedAdam (fp32 element-wise arithmetic,
the per-tensor norms of LAMB summed in other orders); PLD theta exactly
(the same float64 formula); remat gradients bit-exact against no remat (the
recompute repeats the same operations).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2Model as JGPT2Model
from deepspeed_tpu.ops.adam.sgd import SGD as JSGD
from deepspeed_tpu.ops.lamb.fused_lamb import FusedLamb as JFusedLamb
from deepspeed_tpu.runtime.progressive_layer_drop import \
    ProgressiveLayerDrop as JPLD
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam
from deepspeed_tpu_torch.ops.adam.sgd import SGD
from deepspeed_tpu_torch.ops.lamb.fused_lamb import FusedLamb
from deepspeed_tpu_torch.ops.transformer import flash_attention as tfa
from deepspeed_tpu_torch.runtime.activation_checkpointing import \
    checkpointing as ckpt
from deepspeed_tpu_torch.runtime.progressive_layer_drop import \
    ProgressiveLayerDrop

TINY = dict(vocab_size=256, n_positions=64, n_embd=64, n_layer=2, n_head=2)


def _run_both(ours, theirs, steps=3, zero_tensor=False):
    rng = np.random.default_rng(5)
    p0 = [rng.standard_normal((6, 4)).astype(np.float32),
          rng.standard_normal(9).astype(np.float32)]
    if zero_tensor:
        p0.append(np.zeros(3, np.float32))     # trust ratio 1 at ||p|| = 0
    jparams = [jnp.asarray(p) for p in p0]
    jstate = theirs.init_state(jparams)
    params = [torch.tensor(p) for p in p0]
    ours.init_state(params)
    for step in range(steps):
        g = [rng.standard_normal(p.shape).astype(np.float32) for p in p0]
        scale = 4.0 if step == 1 else 1.0
        jparams, jstate = theirs.update([jnp.asarray(x) for x in g], jstate,
                                        jparams, scale=scale)
        ours.update(params, [torch.tensor(x) for x in g], scale=scale)
        for a, b in zip(params, jparams):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)
    assert int(ours.step) == int(jstate.step) == steps


@pytest.mark.parametrize("kw", [
    dict(lr=1e-2, weight_decay=0.1),
    dict(lr=1e-2, eps_inside_sqrt=True, bias_correction=False),
    # a clamp at both ends of the trust ratio
    dict(lr=1e-2, weight_decay=0.01, max_coeff=0.5, min_coeff=0.2),
])
def test_lamb_matches_jax(kw):
    _run_both(FusedLamb(**kw), JFusedLamb(**kw), zero_tensor=True)


@pytest.mark.parametrize("kw", [
    dict(lr=1e-2), dict(lr=1e-2, momentum=0.9, weight_decay=0.01),
    dict(lr=1e-2, momentum=0.9, nesterov=True)])
def test_sgd_matches_jax(kw):
    _run_both(SGD(**kw), JSGD(**kw))


def test_a_skipped_step_leaves_params_and_state_unchanged():
    """Each optimizer's in-place update with ``skip`` true leaves params
    and state bit for bit as they were, whatever its finite gradient and
    with weight decay and momentum on (a non-finite accumulator is zeroed
    by the engine first: test_an_overflowed_step_leaves_the_state_alone)."""
    for opt in (FusedAdam(lr=1e-2, weight_decay=0.01, adam_w_mode=False),
                FusedAdam(lr=1e-2, weight_decay=0.01),
                FusedLamb(lr=1e-2, weight_decay=0.01),
                SGD(lr=1e-2, momentum=0.9, weight_decay=0.01),
                SGD(lr=1e-2, momentum=0.9, nesterov=True)):
        params = [torch.ones(4)]
        opt.init_state(params)
        opt.update(params, [torch.ones(4)])
        before = [params[0].clone()] + [t.clone() for lst in
                                        opt.state_lists() for t in lst]
        opt.update(params, [torch.full((4,), 3.0)],
                   skip=torch.tensor(True))
        after = [params[0]] + [t for lst in opt.state_lists() for t in lst]
        for a, b in zip(before, after):
            assert torch.equal(a, b)
        assert int(opt.step) == 1


DS = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
      "gradient_accumulation_steps": 2, "steps_per_print": 10 ** 9}


@pytest.mark.parametrize("optimizer", [
    {"type": "Lamb", "params": {"lr": 1e-2}},
    {"type": "SGD", "params": {"lr": 0.3, "momentum": 0.9}}])
def test_engine_builds_lamb_and_sgd_and_trains(optimizer):
    eng, opt, _, _ = deepspeed_tpu_torch.initialize(
        model=GPT2Model(GPT2Config(dtype=torch.float32, **TINY)),
        config_params=dict(DS, optimizer=optimizer), device="cpu")
    assert isinstance(opt, (FusedLamb, SGD))
    ids = np.random.default_rng(3).integers(0, 256, (2, 2, 64))
    losses = [eng.train_batch(batch={"input_ids": ids, "labels": ids}).item()
              for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


@pytest.mark.parametrize("bad", [float("inf"), float("nan")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_an_overflowed_step_leaves_the_state_alone(dtype, bad):
    """A non-finite element in the accumulator skips the step on the
    device: master, the module's parameters and Adam's step, m and v stay
    bit for bit as they were, the skipped count rises, the reported norm
    is 0 and the accumulator is zeroed for the next step."""
    precision = {} if dtype == torch.float32 else {"bf16": {"enabled": True}}
    eng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=GPT2Model(GPT2Config(dtype=dtype, **TINY)),
        config_params=dict(DS, optimizer={"type": "AdamW", "params": {
            "lr": 1e-2, "weight_decay": 0.01}}, gradient_clipping=1.0,
            **precision), device="cpu")
    ids = np.random.default_rng(3).integers(0, 256, (2, 2, 64))
    batch = {"input_ids": ids, "labels": ids}
    eng.train_batch(batch=batch)

    def state():
        return [t.clone() for t in [eng.optimizer.step] + eng.master
                + eng.params + eng.optimizer.m + eng.optimizer.v]

    before = state()
    for i in range(2):
        eng.backward(eng({k: v[i] for k, v in batch.items()}))
    eng.accum[3].view(-1)[5] = bad
    eng.step()
    for a, b in zip(before, state()):
        assert torch.equal(a, b)
    assert eng.skipped_steps == 1 and eng.global_steps == 2
    assert float(eng._last_metrics["grad_norm"]) == 0.0
    assert not any(bool(a.any()) for a in eng.accum)
    loss = eng.train_batch(batch=batch)
    assert torch.isfinite(loss) and eng.skipped_steps == 1


def test_client_optimizers_and_the_unknown_adafactor():
    model = GPT2Model(GPT2Config(dtype=torch.float32, **TINY))
    for opt in (FusedLamb(lr=1e-3), SGD(lr=1e-3)):
        eng, got, _, _ = deepspeed_tpu_torch.initialize(
            model=model, optimizer=opt, config_params=DS, device="cpu")
        assert got is opt
    with pytest.raises(NotImplementedError, match="client optimizer"):
        deepspeed_tpu_torch.initialize(model=model, optimizer=object(),
                                       config_params=DS, device="cpu")
    # the JAX package has no Adafactor: its _configure_basic_optimizer
    # raises this ValueError
    with pytest.raises(ValueError, match="Unknown optimizer type"):
        deepspeed_tpu_torch.initialize(
            model=model, config_params=dict(
                DS, optimizer={"type": "Adafactor", "params": {}}),
            device="cpu")


def test_progressive_layer_drop_matches_jax_and_rides_the_batch():
    ours, theirs = ProgressiveLayerDrop(0.5, 0.01), JPLD(0.5, 0.01)
    for step in range(0, 500, 7):
        ours.update_state(step)
        theirs.update_state(step)
        assert ours.get_theta() == theirs.get_theta()
    assert ours.get_state() == theirs.get_state()
    seen = []

    class Probe(GPT2Model):
        def loss(self, batch, generator=None, train=True):
            seen.append(float(batch["pld_theta"]))
            return super().loss(batch, generator, train)

    cfg = dict(DS, progressive_layer_drop={"enabled": True, "theta": 0.5,
                                           "gamma": 0.01})
    eng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=Probe(GPT2Config(dtype=torch.float32, **TINY)),
        config_params=cfg, device="cpu")
    ids = np.random.default_rng(3).integers(0, 256, (2, 2, 64))
    for _ in range(3):
        eng.train_batch(batch={"input_ids": ids, "labels": ids})
    ref = JPLD(0.5, 0.01)
    want = []
    for step in range(3):
        want += [float(np.float32(ref.get_theta()))] * 2
        ref.update_state(step + 1)
    assert seen == want
    assert eng.progressive_layer_drop.get_theta() == ref.get_theta()


def test_checkpoint_api_recomputes_with_the_same_randomness():
    """checkpoint(fn, *args) gives the gradients of fn itself, dropout
    included (the default generator is replayed in the recompute)."""
    ckpt.reset()
    ckpt.configure(deepspeed_config={
        "train_batch_size": 1,
        "activation_checkpointing": {"partition_activations": True,
                                     "number_checkpoints": 2}})
    assert ckpt.is_configured() and ckpt._CONFIG["partition_activations"]
    lin = torch.nn.Linear(8, 8)

    def fn(x):
        return torch.nn.functional.dropout(torch.tanh(lin(x)), 0.5) * 2.0

    x = torch.randn(4, 8, requires_grad=True)
    torch.manual_seed(0)
    ckpt.checkpoint(fn, x).sum().backward()
    got = (x.grad.clone(), lin.weight.grad.clone())
    x.grad, lin.weight.grad = None, None
    torch.manual_seed(0)
    fn(x).sum().backward()
    assert torch.equal(got[0], x.grad) and torch.equal(got[1],
                                                       lin.weight.grad)
    with pytest.raises(ValueError, match="num_checkpoints"):
        ckpt.reset()
        ckpt.configure(contiguous_checkpointing=True)
    # checkpoint_in_cpu (ROADMAP A14b) is accepted and replays the same
    # dropout: the matmul's output comes back from host memory
    ckpt.reset()
    ckpt.configure(checkpoint_in_cpu=True)
    assert ckpt._CONFIG["checkpoint_in_cpu"]
    x.grad, lin.weight.grad = None, None
    torch.manual_seed(0)
    ckpt.checkpoint(fn, x).sum().backward()
    assert torch.equal(got[0], x.grad) and torch.equal(got[1],
                                                       lin.weight.grad)
    ckpt.reset()


def test_rng_tracker_streams():
    ckpt.model_parallel_seed(1234, model_parallel_rank=1)
    tracker = ckpt.get_rng_tracker()
    assert ckpt.get_cuda_rng_tracker() is tracker
    assert set(tracker.get_states()) == {"default", "model-parallel-rng"}
    states = tracker.get_states()
    a = torch.rand(4, generator=tracker.fork())
    b = torch.rand(4, generator=tracker.fork())
    assert not torch.equal(a, b)                 # the stream advanced
    tracker.set_states(states)
    assert torch.equal(torch.rand(4, generator=tracker.fork()), a)
    other = ckpt.RNGStatesTracker()
    other.add("model-parallel-rng", 1234 + 2718 + 1)
    assert torch.equal(torch.rand(4, generator=other.fork()), a)
    with pytest.raises(Exception, match="already exists"):
        tracker.add("default", 1)
    with pytest.raises(Exception, match="is not added"):
        tracker.fork("missing")


# ---------------------------------------------------------------------------
# GPT-2 remat policies
# ---------------------------------------------------------------------------
REMAT = dict(vocab_size=256, n_positions=128, n_embd=128, n_layer=2,
             n_head=2)


def _reference_flash_forwards(policy):
    """pallas_call equations in the jaxpr of jax.grad of the JAX model's
    loss (Pallas flash attention in interpret mode): the forward kernel
    runs once per layer plus once more per layer when the backward
    recomputes it, and the two backward sweeps once each."""
    cfg = JGPT2Config(dtype=jnp.float32, remat=policy is not None,
                      remat_policy=policy or "nothing",
                      use_pallas_attention=True, **REMAT)
    model = JGPT2Model(cfg)
    ids = np.random.default_rng(0).integers(0, 256, (2, 128))
    batch = {"input_ids": ids, "labels": ids}
    params = model.init(jax.random.PRNGKey(0), batch)
    jaxpr = jax.make_jaxpr(jax.grad(
        lambda p: model.loss(p, batch, jax.random.PRNGKey(1))[0]))(params)
    return _count(jaxpr.jaxpr, "pallas_call") - 2 * cfg.n_layer


def _count(jaxpr, name):
    from jax.extend.core import ClosedJaxpr, Jaxpr

    n = 0
    for eqn in jaxpr.eqns:
        n += eqn.primitive.name == name
        for p in eqn.params.values():
            for sub in (p if isinstance(p, (tuple, list)) else (p,)):
                if isinstance(sub, ClosedJaxpr):
                    n += _count(sub.jaxpr, name)
                elif isinstance(sub, Jaxpr):
                    n += _count(sub, name)
    return n


@pytest.mark.parametrize("policy", [None, "nothing", "attn_out", "dots"])
def test_remat_policies_match_no_remat_and_the_reference_count(
        policy, monkeypatch):
    """Each policy's loss and gradients equal no remat's bit for bit, with
    dropout; and the flash forward runs as often as the JAX model's
    pallas forward under the same policy (its residuals are neither
    named nor dots, so every policy re-runs it in the backward)."""
    calls = [0]
    forward = tfa.flash_fwd

    def counted(*args, **kw):
        calls[0] += 1
        return forward(*args, **kw)

    monkeypatch.setattr(tfa, "flash_fwd", counted)
    ids = torch.tensor(np.random.default_rng(0).integers(0, 256, (2, 128)))
    results = []
    for p in (None, policy):
        cfg = GPT2Config(dtype=torch.float32, remat=p is not None,
                         remat_policy=p or "nothing", dropout=0.1,
                         use_pallas_attention=True, **REMAT)
        model = GPT2Model(cfg)
        calls[0] = 0
        loss, _ = model.loss({"input_ids": ids, "labels": ids},
                             generator=torch.Generator().manual_seed(5))
        loss.backward()
        results.append((loss.detach(), [q.grad for q in model.parameters()],
                        calls[0]))
    (l0, g0, _), (l1, g1, n_fwd) = results
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert n_fwd == _reference_flash_forwards(policy)


def test_unknown_remat_policy_raises_as_the_reference_does():
    with pytest.raises(ValueError, match="unknown remat_policy"):
        GPT2Model(GPT2Config(dtype=torch.float32, remat=True,
                             remat_policy="everything", **TINY))


def test_dots_saves_the_three_matmul_outputs_the_reference_saves(
        monkeypatch):
    """Under 'dots' each block keeps the outputs of c_attn, attn.c_proj and
    c_fc: the widths of the dot outputs jax.checkpoint's dots_saveable keeps
    in the JAX model (saved_residuals), and nothing else."""
    # the list print_saved_residuals prints
    from jax._src.ad_checkpoint import saved_residuals
    from torch.utils.checkpoint import CheckpointPolicy

    from deepspeed_tpu_torch.models import gpt2 as tgpt2

    cfg = JGPT2Config(dtype=jnp.float32, remat=True, remat_policy="dots",
                      loss_chunk_tokens=0, **dict(REMAT, n_layer=1))
    model = JGPT2Model(cfg)
    ids = np.random.default_rng(0).integers(0, 256, (2, 128))
    batch = {"input_ids": ids, "labels": ids}
    params = model.init(jax.random.PRNGKey(0), batch)
    want = sorted(aval.shape[-1] for aval, why in saved_residuals(
        lambda p: model.loss(p, batch, jax.random.PRNGKey(1))[0], params)
        if "linear.py" in why)
    saved = []
    original = tgpt2._dots_policy

    def recording():
        policy = original()

        def record(ctx, op, *args, **kw):
            decision = policy(ctx, op, *args, **kw)
            if decision == CheckpointPolicy.MUST_SAVE:
                saved.append(ctx.op_output.shape[-1])
            return decision

        return record

    monkeypatch.setattr(tgpt2, "_dots_policy", recording)
    tmodel = GPT2Model(GPT2Config(dtype=torch.float32, remat=True,
                                  remat_policy="dots",
                                  **dict(REMAT, n_layer=1)))
    tids = torch.tensor(ids)
    tmodel.loss({"input_ids": tids, "labels": tids})[0].backward()
    assert want == [128, 384, 512], want
    assert sorted(saved) == want
