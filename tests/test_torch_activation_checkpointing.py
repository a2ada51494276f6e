"""Activation checkpoints in host memory (``checkpoint_in_cpu``,
``activation_checkpointing.cpu_checkpointing``) in the port's
runtime/activation_checkpointing/checkpointing.py, against the JAX
package's.

The JAX package asks for ``jax.checkpoint_policies
.offload_dot_products_with_no_batch_dims("device", "pinned_host")``; the
installed jax names that policy ``offload_dot_with_no_batch_dims``, so the
JAX function takes its own fallback, warns and recomputes everything
(ROADMAP C-w11). Its gradients are the same either way, so the port (which
implements the stated policy: matmul outputs with no batch dims saved in
host memory, the rest recomputed) is held against that output at the JAX
test's tolerance (rtol 1e-4, atol 1e-6: the JAX side's remat replays the
forward in another fusion), and against its own on-device remat bit for
bit (the saved outputs are the forward's own).
"""
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from deepspeed_tpu_torch.ops.transformer.transformer import replayable
from deepspeed_tpu_torch.runtime.activation_checkpointing import \
    checkpointing as ckpt
from deepspeed_tpu_torch.telemetry.program_lint import lint_programs

RTOL, ATOL = 1e-4, 1e-6
ACTS = ckpt.HOST_ACTIVATIONS


@pytest.fixture(autouse=True)
def _reset():
    ckpt.reset()
    ACTS.reset()
    yield
    ckpt.reset()


def _mlp_params(seed=0):
    # tests/unit/test_activation_checkpointing.py's MLP and inputs
    rng = np.random.default_rng(seed)
    return {"w1": rng.standard_normal((8, 16)).astype(np.float32),
            "w2": rng.standard_normal((16, 8)).astype(np.float32)}


def _x():
    return np.random.default_rng(1).standard_normal((4, 8)) \
        .astype(np.float32)


def _port_loss_and_grads(params, x, in_cpu, dtype=torch.float32):
    ckpt.reset()
    ckpt.configure(checkpoint_in_cpu=in_cpu)
    w = {k: torch.tensor(v, dtype=dtype, requires_grad=True)
         for k, v in params.items()}

    def mlp(w1, w2, x):
        return torch.tanh(torch.tanh(x @ w1) @ w2)

    x = torch.tensor(x, dtype=dtype)
    loss = (ckpt.checkpoint(mlp, w["w1"], w["w2"], x) ** 2).sum()
    loss.backward()
    return loss.detach(), {k: t.grad for k, t in w.items()}


def test_checkpoint_in_cpu_matches_the_jax_function():
    """The JAX test's MLP and input values, both sides in float64: at
    float32 one gradient element of 128 differs by 1.29e-6 where the
    tolerance allows 1.28e-6, and there the JAX function is 3.0e-6 from
    the float64 gradient while the port is 7.5e-7 from it (XLA's CPU
    arithmetic, not the policy); in float64 both sides agree far inside
    the tolerance and the comparison sees the policy alone."""
    # the JAX side is imported here: the cuda-marked case below runs on a
    # card's machine, which has no JAX
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.runtime.activation_checkpointing import \
        checkpointing as jckpt

    params, x = _mlp_params(), _x()
    jckpt.reset()
    jckpt.configure(checkpoint_in_cpu=True)
    with jax.enable_x64(True):
        jp = {k: jnp.asarray(v, jnp.float64) for k, v in params.items()}

        def jloss(p):
            def mlp(p, x):
                return jnp.tanh(jnp.tanh(x @ p["w1"]) @ p["w2"])
            return jnp.sum(jckpt.checkpoint(
                mlp, p, jnp.asarray(x, jnp.float64)) ** 2)

        want, jgrads = jax.value_and_grad(jloss)(jp)
        want = float(want)
        jgrads = {k: np.asarray(v) for k, v in jgrads.items()}
    jckpt.reset()
    assert jgrads["w1"].dtype == np.float64
    loss, grads = _port_loss_and_grads(params, x, True, torch.float64)
    assert (ACTS.saved, ACTS.served) == (2, 2)
    np.testing.assert_allclose(float(loss), want, rtol=RTOL, atol=ATOL)
    for k in params:
        np.testing.assert_allclose(grads[k].numpy(), jgrads[k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_checkpoint_in_cpu_equals_on_device_remat_bit_for_bit():
    params, x = _mlp_params(), _x()
    remat = _port_loss_and_grads(params, x, in_cpu=False)
    assert (ACTS.saved, ACTS.served) == (0, 0)
    host = _port_loss_and_grads(params, x, in_cpu=True)
    assert torch.equal(remat[0], host[0])
    for k in params:
        assert torch.equal(remat[1][k], host[1][k]), k
    assert (ACTS.saved, ACTS.served) == (2, 2)


class _Ops(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


def test_policy_saves_exactly_the_matmul_outputs():
    """A dense layer on a (B, S, D) input (addmm), one without bias (mm)
    and a batched product (bmm, not saved): the forward saves exactly the
    two matmul outputs, the recompute takes both back from host memory
    and runs every other op of the forward again."""
    g = torch.Generator().manual_seed(0)
    w1 = torch.randn(16, 8, generator=g, requires_grad=True)
    b1 = torch.randn(16, generator=g, requires_grad=True)
    w2 = torch.randn(8, 16, generator=g, requires_grad=True)
    x = torch.randn(2, 5, 8, generator=g)

    def fn(w1, b1, w2, x):
        h = torch.nn.functional.gelu(torch.nn.functional.linear(x, w1, b1))
        y = torch.nn.functional.linear(h, w2)
        return torch.bmm(y, y.transpose(1, 2)).tanh()

    with _Ops() as plain:
        fn(w1, b1, w2, x)
    mm = [op for op in plain.ops if op in ckpt._MATMULS]
    assert [str(op) for op in mm] == ["aten.addmm.default", "aten.mm.default"]
    assert torch.ops.aten.bmm.default in plain.ops
    ckpt.configure(checkpoint_in_cpu=True)
    out = ckpt.checkpoint(fn, w1, b1, w2, x)
    assert (ACTS.saved, ACTS.served, ACTS.recomputed) == (2, 0, 0)
    assert ACTS.saved_bytes == 2 * 5 * (16 + 8) * 4
    out.sum().backward()
    assert ACTS.served == 2
    # every other op again (autograd's own detaches of saved tensors are
    # not recomputation, and are counted on neither side)
    rest = [op for op in plain.ops if op not in ckpt._MATMULS
            and op is not torch.ops.aten.detach.default]
    assert ACTS.recomputed == len(rest) == 10
    ckpt.reset()
    grads = [t.grad.clone() for t in (w1, b1, w2)]
    for t in (w1, b1, w2):
        t.grad = None
    fn(w1, b1, w2, x).sum().backward()
    assert all(torch.equal(a, t.grad) for a, t in zip(grads, (w1, b1, w2)))


# one head of 64: the flash kernels' head_dim on the card
TINY = dict(vocab_size=128, n_positions=32, n_embd=64, n_layer=2, n_head=1)
DS = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
      "gradient_accumulation_steps": 2,
      "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
      "steps_per_print": 10 ** 9}


def checkpoint_blocks(model):
    """Each GPT-2 block's forward under the user-level
    ``checkpointing.checkpoint`` (its dropout replayed)."""
    for block in model.h:
        def forward(x, train, generator, _inner=block.forward):
            if not torch.is_grad_enabled():
                return _inner(x, train, generator)
            return ckpt.checkpoint(replayable(_inner, generator), x, train)
        block.forward = forward
    return model


def _train(in_cpu, device="cpu", steps=2, linted=False, dtype=None):
    ckpt.reset()
    cfg = dict(DS, activation_checkpointing={"cpu_checkpointing": in_cpu})
    if dtype is torch.bfloat16:
        cfg["bf16"] = {"enabled": True}
    model = checkpoint_blocks(GPT2Model(GPT2Config(
        dtype=dtype or torch.float32, dropout=0.1, **TINY)))
    eng = deepspeed_tpu_torch.initialize(model=model, config_params=cfg,
                                         device=device)[0]
    # the user's call, as in the reference: the engine accepts the key
    ckpt.configure(deepspeed_config=cfg)
    assert ckpt._CONFIG["checkpoint_in_cpu"] == in_cpu
    eng.program_registry.observing = linted
    ids = np.random.default_rng(0).integers(0, 128, (2, 2, 32))
    batch = {"input_ids": ids, "labels": ids}
    losses = [eng.train_batch(batch=batch).detach() for _ in range(steps)]
    return eng, torch.stack(losses)


def test_engine_trains_with_cpu_checkpointing_as_with_device_remat():
    """initialize() with activation_checkpointing.cpu_checkpointing,
    blocks under checkpointing.checkpoint, dropout 0.1: the losses and
    the weights after two steps equal the on-device remat's bit for bit,
    and the step's program stays clean under the lint."""
    remat, want = _train(False)
    host, got = _train(True, linted=True)
    assert torch.equal(want, got)
    for a, b in zip(remat.master, host.master):
        assert torch.equal(a, b)
    # 4 matmuls per block, 2 blocks, 2 micro steps, 2 steps
    assert ACTS.saved == ACTS.served == 4 * 2 * 2 * 2
    res = lint_programs([host.program_registry], use_baseline=False)
    assert res.new == [] and host.program_registry.names() == \
        ["fused_train_step"]


@pytest.mark.cuda
def test_cpu_checkpointing_on_the_card_pinned_and_without_sync():
    """On the card at bf16: the same losses and weights as the on-device
    remat, every saved matmul output in pinned host memory, and a
    steady-state step under set_sync_debug_mode("error") (the lint's
    observer too) without a host sync."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: pinned memory and the sync "
                    "debug mode are CUDA's")
    remat, want = _train(False, device="cuda", dtype=torch.bfloat16)
    host, got = _train(True, device="cuda", dtype=torch.bfloat16)
    assert torch.equal(want, got)
    for a, b in zip(remat.master, host.master):
        assert torch.equal(a, b)
    assert ACTS.saved and ACTS.pinned_bytes == ACTS.saved_bytes
    ids = torch.randint(0, 128, (2, 2, 32), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        host.train_batch(batch={"input_ids": ids, "labels": ids})
    finally:
        torch.cuda.set_sync_debug_mode(0)
