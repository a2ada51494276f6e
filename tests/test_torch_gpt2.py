"""GPT-2 of the PyTorch port against the JAX package's GPT-2.

One tiny fp32 config; the JAX model runs its Pallas flash kernel in
interpreter mode (use_pallas_attention=True) and the port runs the plain
versions of its CUDA kernels (CPU tensors). Parameters go across with
models.convert.params_from_jax, from both the unrolled and the scan-stacked
layout.

Tolerance: loss and gradients at rtol 1e-4. A gradient element near zero
has no meaningful relative error (sums of many fp32 products taken in a
different order), so each tensor also gets an absolute floor of 1e-4 of its
largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2Model as JGPT2Model
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.gpt2 import (GPT2_SIZES, GPT2Config,
                                             GPT2Model, gpt2_config)

TINY = dict(vocab_size=256, n_positions=128, n_embd=128, n_layer=2,
            n_head=2)
RTOL = 1e-4


def _batch(seed=0, b=2, s=128):
    ids = np.random.default_rng(seed).integers(0, TINY["vocab_size"], (b, s))
    return {"input_ids": ids, "labels": ids.copy()}


def _torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _assert_close_tensor(got, want, name):
    want = np.asarray(want)
    floor = RTOL * max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL, atol=floor,
                               err_msg=name)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("scan_layers", [False, True])
def test_loss_and_grads_match_jax(scan_layers):
    jcfg = JGPT2Config(dtype=jnp.float32, use_pallas_attention=True,
                       scan_layers=scan_layers, **TINY)
    jmodel = JGPT2Model(jcfg)
    batch = _batch()
    params = jmodel.init(jax.random.PRNGKey(0), batch)

    def loss_fn(p):
        return jmodel.loss(p, batch, jax.random.PRNGKey(1), train=True)[0]

    jloss, jgrads = jax.value_and_grad(loss_fn)(params)

    cfg = GPT2Config(dtype=torch.float32, use_pallas_attention=True, **TINY)
    model = GPT2Model(cfg)
    model.load_state_dict(params_from_jax(_numpy_tree(params), cfg))
    loss, metrics = model.loss(_torch_batch(batch), train=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
    assert metrics["loss"] is loss
    want = params_from_jax(_numpy_tree(jgrads), cfg)
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        _assert_close_tensor(p.grad.numpy(), want[name].numpy(), name)


def test_logits_match_jax_and_are_sliced_to_vocab():
    jcfg = JGPT2Config(dtype=jnp.float32, vocab_size=250, **{
        k: v for k, v in TINY.items() if k != "vocab_size"})
    jmodel = JGPT2Model(jcfg)
    batch = _batch()
    params = jmodel.init(jax.random.PRNGKey(3), batch)
    jlogits = jmodel.module.apply({"params": params}, batch["input_ids"])
    cfg = GPT2Config(dtype=torch.float32, vocab_size=250, **{
        k: v for k, v in TINY.items() if k != "vocab_size"})
    model = GPT2Model(cfg)
    model.load_state_dict(params_from_jax(_numpy_tree(params), cfg))
    assert model.wte.shape[0] == cfg.padded_vocab_size == 256
    with torch.no_grad():
        logits = model(torch.as_tensor(batch["input_ids"]))
    assert logits.shape == (2, 128, 250)
    _assert_close_tensor(logits.numpy(), np.asarray(jlogits), "logits")


@pytest.mark.parametrize("chunk", [64, 100])
def test_chunked_loss_equals_dense_loss(chunk):
    """The chunked head (even and ragged chunks) gives the dense loss and
    the dense gradients."""
    dense = GPT2Model(GPT2Config(dtype=torch.float32, loss_chunk_tokens=0,
                                 **TINY))
    chunked = GPT2Model(GPT2Config(dtype=torch.float32,
                                   loss_chunk_tokens=chunk, **TINY))
    chunked.load_state_dict(dense.state_dict())
    batch = _torch_batch(_batch(seed=4))
    batch["labels"][0, :9] = -100            # ignored positions
    results = []
    for m in (dense, chunked):
        loss, _ = m.loss(batch)
        loss.backward()
        results.append((loss.item(), {n: p.grad for n, p in
                                      m.named_parameters()}))
    (ld, gd), (lc, gc) = results
    np.testing.assert_allclose(lc, ld, rtol=1e-6)
    for name in gd:
        _assert_close_tensor(gc[name].numpy(), gd[name].numpy(), name)


def test_remat_matches_no_remat_with_dropout():
    """Per-block recomputation gives the same loss and gradients, dropout
    included (the recompute replays the generator)."""
    base = GPT2Model(GPT2Config(dtype=torch.float32, dropout=0.1, **TINY))
    remat = GPT2Model(GPT2Config(dtype=torch.float32, dropout=0.1,
                                 remat=True, **TINY))
    remat.load_state_dict(base.state_dict())
    batch = _torch_batch(_batch(seed=5))
    results = []
    for m in (base, remat):
        loss, _ = m.loss(batch, generator=torch.Generator().manual_seed(9))
        loss.backward()
        results.append((loss.item(), {n: p.grad for n, p in
                                      m.named_parameters()}))
    (lb, gb), (lr, gr) = results
    np.testing.assert_allclose(lr, lb, rtol=1e-6)
    for name in gb:
        _assert_close_tensor(gr[name].numpy(), gb[name].numpy(), name)


def test_config_mirrors_jax_config():
    jfields = {f.name for f in JGPT2Config.__dataclass_fields__.values()}
    fields = {f.name for f in GPT2Config.__dataclass_fields__.values()}
    assert fields == jfields
    assert GPT2Config().padded_vocab_size == 50304
    assert GPT2_SIZES["gpt2-350m"] == dict(n_layer=24, n_embd=1024,
                                           n_head=16)
    assert gpt2_config("gpt2-350m").head_dim == 64


@pytest.mark.parametrize("override,item", [
    (dict(remat=True, remat_policy="dots", attention_sp_mode="ring"),
     "A15"),
    (dict(attention_sp_mode="ring"), "A15"),
])
def test_unported_model_options_raise(override, item):
    """Ring attention, once refused here until ROADMAP ``item`` ported it,
    builds; outside sequence parallelism (seq 1) it takes the same path
    as the Ulysses mode, as in the JAX model: loss and gradients bit for
    bit."""
    batch = _torch_batch(_batch())
    results = []
    for mode in ("ring", "ulysses"):
        model = GPT2Model(GPT2Config(dtype=torch.float32, **dict(
            TINY, **dict(override, attention_sp_mode=mode))),
            torch.Generator().manual_seed(3))
        loss, _ = model.loss(batch)
        loss.backward()
        results.append((loss, [p.grad for p in model.parameters()]))
    (ring, ring_grads), (uly, uly_grads) = results
    assert item == "A15" and torch.equal(ring, uly)
    for a, b in zip(ring_grads, uly_grads):
        assert torch.equal(a, b)


def test_seeded_init_is_deterministic_and_flax_shaped():
    a = GPT2Model(GPT2Config(**TINY), torch.Generator().manual_seed(1))
    b = GPT2Model(GPT2Config(**TINY), torch.Generator().manual_seed(1))
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
    assert a.wte.dtype == torch.float32
    assert torch.all(a.h[0].ln_1.weight == 1)
    assert torch.all(a.h[0].attn.c_attn.bias == 0)
    w = a.h[0].mlp.c_fc.weight
    std = (1.0 / w.shape[1]) ** 0.5 / 0.87962566103423978
    assert w.abs().max() <= 2 * std
    assert abs(a.wte.std().item() - 0.02) < 2e-3


@pytest.mark.parametrize("shape,seed", [((64, 256), 0), ((128, 3), 7),
                                        ((4099,), 3)])
def test_truncated_normal_draws_as_the_redraw_everything_loop(shape, seed):
    """The Dense initializer redraws only out-of-range elements and scales
    in place; its values are those of redrawing every out-of-range element
    of the whole tensor each round, draw for draw."""
    from deepspeed_tpu_torch.ops.transformer.transformer import _trunc_normal_

    def plain(t, std, generator):
        x = torch.empty(t.shape).normal_(generator=generator)
        bad = x.abs() > 2.0
        while bad.any():
            x[bad] = torch.empty(int(bad.sum())).normal_(generator=generator)
            bad = x.abs() > 2.0
        t.copy_(x * std)

    got, want = torch.empty(shape), torch.empty(shape)
    gen_a, gen_b = (torch.Generator().manual_seed(seed) for _ in range(2))
    _trunc_normal_(got, 0.05, gen_a)
    plain(want, 0.05, gen_b)
    assert torch.equal(got, want)
    # both generators drew alike: the next draw is the same
    assert torch.equal(torch.randn(4, generator=gen_a),
                       torch.randn(4, generator=gen_b))
