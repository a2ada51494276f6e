"""BERT and the fused transformer layer of the PyTorch port against the JAX
package.

One tiny fp32 configuration (vocab 256, hidden 128, 2 layers, 2 heads so
head_dim 64, seq 256), dense and block-sparse
(FixedSparsityConfig(2, block=64, num_local_blocks=2)). Parameters go
across with models.convert.bert_params_from_jax. On the CPU both sides take
their masked dense attention paths; once more, the JAX side is forced onto
the Pallas block-sparse kernel (interpreter mode) and the port's onto the
plain versions of its CUDA kernels, so the whole path is held against the
kernels. Gradients come from jax.grad and autograd (no finite
differences).

Tolerance: loss and gradients at rtol 1e-4. A gradient element near zero
has no meaningful relative error (sums of many fp32 products taken in a
different order), so each tensor also gets an absolute floor of 1e-4 of
its largest magnitude.
"""
import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.bert import BertConfig as JBertConfig
from deepspeed_tpu.models.bert import BertForPreTraining as JBert
from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu.ops.sparse_attention import sparse_self_attention as jssa
from deepspeed_tpu.ops.transformer import transformer as jtr
from deepspeed_tpu_torch.models import bert as tbert
from deepspeed_tpu_torch.models.convert import (
    bert_params_from_jax, transformer_layer_params_from_jax)
from deepspeed_tpu_torch.ops import sparse_attention as tsa
from deepspeed_tpu_torch.ops.sparse_attention import \
    block_sparse_kernel as tbsk
from deepspeed_tpu_torch.ops.sparse_attention import \
    sparse_self_attention as tssa
from deepspeed_tpu_torch.ops.transformer import transformer as ttr

RTOL = 1e-4
TINY = dict(vocab_size=256, hidden_size=128, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=256,
            max_position_embeddings=256, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
SPARSITY = dict(num_heads=2, block=64, num_local_blocks=2)
SEQ = 256
DS_CONFIG = {
    "train_batch_size": 4,
    "train_micro_batch_size_per_gpu": 2,
    "gradient_accumulation_steps": 2,
    "optimizer": {"type": "Adam",
                  "params": {"lr": 3e-3, "weight_decay": 0.01}},
    "scheduler": {"type": "WarmupLR",
                  "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 3e-3,
                             "warmup_num_steps": 2}},
    "gradient_clipping": 0.5,
    "steps_per_print": 10 ** 9,
}


def _assert_close_tensor(got, want, name):
    want = np.asarray(want)
    floor = RTOL * max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL, atol=floor,
                               err_msg=name)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _configs(sparse, **over):
    kw = dict(TINY, **over)
    jcfg = JBertConfig(dtype=jnp.float32, sparsity_config=(
        jsa.FixedSparsityConfig(**SPARSITY) if sparse else None), **kw)
    tcfg = tbert.BertConfig(dtype=torch.float32, sparsity_config=(
        tsa.FixedSparsityConfig(**SPARSITY) if sparse else None), **kw)
    return jcfg, tcfg


def _batch(seed=0, b=2, lead=(), nsp=True):
    """numpy batch: padded keys at the end of row 1, 15 % MLM labels with
    both ignore values (-1 and -100), token types, NSP labels."""
    rng = np.random.default_rng(seed)
    shape = lead + (b, SEQ)
    ids = rng.integers(0, TINY["vocab_size"], shape)
    mask = np.ones(shape, np.int32)
    mask[..., 1, -20:] = 0
    labels = np.where(rng.random(shape) < 0.15, ids,
                      np.where(rng.random(shape) < 0.5, -1, -100))
    batch = {"input_ids": ids, "attention_mask": mask,
             "token_type_ids": rng.integers(0, 2, shape),
             "masked_lm_labels": labels}
    if nsp:
        batch["next_sentence_label"] = rng.integers(0, 2, lead + (b,))
    return batch


def _torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _jax_loss_and_grads(jcfg, batch, seed=0):
    jmodel = JBert(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed), batch)

    def loss_fn(p):
        return jmodel.loss(p, batch, jax.random.PRNGKey(1), train=True)[0]

    loss, grads = jax.value_and_grad(loss_fn)(params)
    return params, float(loss), grads


def _port_matches(tcfg, params, jloss, jgrads, batch):
    model = tbert.BertForPreTraining(tcfg)
    model.load_state_dict(bert_params_from_jax(_numpy_tree(params), tcfg))
    before = dict(tbsk.LAUNCHES)
    loss, metrics = model.loss(_torch_batch(batch), train=True)
    loss.backward()
    assert tbsk.LAUNCHES == before, "a CPU tensor must not count a launch"
    assert metrics["loss"] is loss
    assert ("nsp_loss" in metrics) == ("next_sentence_label" in batch)
    np.testing.assert_allclose(loss.item(), jloss, rtol=RTOL)
    want = bert_params_from_jax(_numpy_tree(jgrads), tcfg)
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        # without NSP labels the pooler and NSP head get no gradient: JAX
        # reports zeros, autograd None
        grad = p.grad if p.grad is not None else torch.zeros_like(p)
        _assert_close_tensor(grad.numpy(), want[name].numpy(), name)


@pytest.mark.parametrize("nsp", [True, False])
@pytest.mark.parametrize("sparse", [False, True])
def test_loss_and_grads_match_jax(sparse, nsp):
    jcfg, tcfg = _configs(sparse)
    batch = _batch(seed=1, nsp=nsp)
    params, jloss, jgrads = _jax_loss_and_grads(jcfg, batch)
    _port_matches(tcfg, params, jloss, jgrads, batch)


def test_sparse_bert_on_the_kernels_matches_jax_on_pallas():
    """The JAX side forced onto the Pallas block-sparse kernel (interpreter
    mode), the port's onto the plain versions of its three CUDA kernels:
    the whole BERT path held against the kernels."""
    jcfg, tcfg = _configs(True)
    batch = _batch(seed=2)
    with mock.patch.object(
            jssa, "block_sparse_attention",
            functools.partial(jssa.block_sparse_attention, use_pallas=True)):
        params, jloss, jgrads = _jax_loss_and_grads(jcfg, batch, seed=3)
    with mock.patch.object(
            tssa, "block_sparse_attention",
            functools.partial(tssa.block_sparse_attention, use_pallas=True)):
        _port_matches(tcfg, params, jloss, jgrads, batch)


def test_logits_match_jax_and_are_sliced_to_vocab():
    jcfg, tcfg = _configs(True, vocab_size=250)
    batch = _batch(seed=4)
    jmodel = JBert(jcfg)
    params = jmodel.init(jax.random.PRNGKey(5), batch)
    jlogits, jnsp = jmodel.module.apply(
        {"params": params}, batch["input_ids"], batch["attention_mask"],
        batch["token_type_ids"])
    model = tbert.BertForPreTraining(tcfg)
    model.load_state_dict(bert_params_from_jax(_numpy_tree(params), tcfg))
    assert model.embeddings.word_embeddings.shape[0] == 256
    t = _torch_batch(batch)
    with torch.no_grad():
        logits, nsp = model(t["input_ids"], t["attention_mask"],
                            t["token_type_ids"])
    assert logits.shape == (2, SEQ, 250)
    _assert_close_tensor(logits.numpy(), jlogits, "logits")
    _assert_close_tensor(nsp.numpy(), jnsp, "nsp logits")


def test_three_train_batch_steps_match_jax_engine():
    from deepspeed_tpu.runtime.engine import _first_micro

    jcfg, tcfg = _configs(True)
    batch = _batch(seed=6, lead=(2,))
    jeng, _, _, _ = deepspeed_tpu.initialize(
        model=JBert(jcfg), config_params=dict(
            DS_CONFIG, mesh={"data": 1, "allow_partial": True}))
    # the parameters the JAX engine starts from (seed 42)
    jeng._ensure_state(_first_micro(batch))
    init = _numpy_tree(jeng.state.params)

    eng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=tbert.BertForPreTraining(tcfg), config_params=DS_CONFIG,
        device="cpu")
    eng.module.load_state_dict(bert_params_from_jax(init, tcfg))
    for step in range(3):
        jloss = float(jeng.train_batch(batch=batch))
        loss = eng.train_batch(batch=batch)
        np.testing.assert_allclose(loss.item(), jloss, rtol=RTOL,
                                   err_msg=f"loss of step {step + 1}")
        np.testing.assert_allclose(
            float(eng._last_metrics["grad_norm"]),
            float(jeng._last_metrics["grad_norm"]), rtol=RTOL,
            err_msg=f"grad norm of step {step + 1}")
    assert eng.global_steps == 3 and eng.micro_steps == 6


def test_replace_self_attention_matches_jax_and_a_direct_build():
    """The swap to sparse attention (position rows tiled to 512) gives the
    JAX swap's loss, and the loss of a sparse BERT built directly with the
    same parameters."""
    from deepspeed_tpu.ops.sparse_attention import \
        SparseAttentionUtils as JUtils

    jcfg, tcfg = _configs(False)
    batch = _batch(seed=7)
    jmodel = JBert(jcfg)
    params = jmodel.init(jax.random.PRNGKey(8), batch)
    jnew, jparams = \
        JUtils.replace_model_self_attention_with_sparse_self_attention(
            jmodel, params, 512,
            sparsity_config=jsa.FixedSparsityConfig(**SPARSITY))
    jloss = float(jnew.loss(jparams, batch, jax.random.PRNGKey(0),
                            train=False)[0])

    dense = tbert.BertForPreTraining(tcfg)
    dense.load_state_dict(bert_params_from_jax(_numpy_tree(params), tcfg))
    new = tsa.SparseAttentionUtils \
        .replace_model_self_attention_with_sparse_self_attention(
            dense, 512, sparsity_config=tsa.FixedSparsityConfig(**SPARSITY))
    assert new.config.max_position_embeddings == 512
    assert new.config.sparsity_config is not None
    assert new.embeddings.position_embeddings.shape == (512, 128)
    direct = tbert.BertForPreTraining(new.config)
    state = dense.state_dict()
    state["embeddings.position_embeddings"] = \
        tsa.SparseAttentionUtils.extend_position_embedding(
            state["embeddings.position_embeddings"], 512)
    direct.load_state_dict(state)
    t = _torch_batch(batch)
    with torch.no_grad():
        loss = new.loss(t, train=False)[0].item()
        assert direct.loss(t, train=False)[0].item() == loss
    np.testing.assert_allclose(loss, jloss, rtol=RTOL)
    with pytest.raises(TypeError, match="BertForPreTraining"):
        tsa.SparseAttentionUtils \
            .replace_model_self_attention_with_sparse_self_attention(
                torch.nn.Linear(2, 2), 512)


# ---------------------------------------------------------------------------
# the fused layer
# ---------------------------------------------------------------------------
LAYER = dict(batch_size=2, hidden_size=128, intermediate_size=256, heads=2,
             attn_dropout_ratio=0.0, hidden_dropout_ratio=0.0,
             num_hidden_layers=2, initializer_range=0.02)
LAYER_SEQ = 128


def _layer_configs(pre_ln, sparse, **over):
    kw = dict(LAYER, pre_layer_norm=pre_ln, **over)
    sc = dict(num_heads=2, block=32, num_local_blocks=2)
    return (jtr.DeepSpeedTransformerConfig(
                sparsity_config=jsa.FixedSparsityConfig(**sc)
                if sparse else None, **kw),
            ttr.DeepSpeedTransformerConfig(
                sparsity_config=tsa.FixedSparsityConfig(**sc)
                if sparse else None, **kw))


def _layer_inputs(mask):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, LAYER_SEQ, 128)).astype(np.float32)
    g = rng.standard_normal((2, LAYER_SEQ, 128)).astype(np.float32)
    m = None
    if mask:
        m = np.zeros((2, 1, 1, LAYER_SEQ), np.float32)
        m[1, ..., -10:] = -1e30
    return x, g, m


@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("pre_ln", [True, False])
def test_layer_matches_jax_layer(pre_ln, sparse, mask):
    jcfg, tcfg = _layer_configs(pre_ln, sparse)
    x, g, m = _layer_inputs(mask)
    jm = None if m is None else jnp.asarray(m)
    jlayer = jtr.DeepSpeedTransformerLayer(jcfg)
    params = jlayer.init({"params": jax.random.PRNGKey(0),
                          "dropout": jax.random.PRNGKey(0)}, x, jm,
                         train=False)["params"]

    def f(p, x):
        out = jlayer.apply({"params": p}, x, jm, train=True)
        return jnp.sum(out * g), out

    (_, jout), (jgp, jgx) = jax.value_and_grad(f, argnums=(0, 1),
                                               has_aux=True)(params, x)
    layer = ttr.DeepSpeedTransformerLayer(tcfg)
    layer.load_state_dict(transformer_layer_params_from_jax(
        _numpy_tree(params)))
    tx = torch.tensor(x, requires_grad=True)
    out = layer(tx, None if m is None else torch.tensor(m), train=True)
    (out * torch.tensor(g)).sum().backward()
    _assert_close_tensor(out.detach().numpy(), jout, "out")
    _assert_close_tensor(tx.grad.numpy(), jgx, "dx")
    want = transformer_layer_params_from_jax(_numpy_tree(jgp))
    for name, p in layer.named_parameters():
        _assert_close_tensor(p.grad.numpy(), want[name].numpy(), name)


@pytest.mark.parametrize("sparse", [False, True])
def test_layer_remat_equals_no_remat_with_dropout(sparse):
    """Recomputing the body in the backward (any memory flag) gives the
    same output and gradients, dropout included (the generator is
    replayed)."""
    drop = dict(hidden_dropout_ratio=0.1,
                attn_dropout_ratio=0.0 if sparse else 0.1)
    _, base_cfg = _layer_configs(True, sparse, **drop)
    _, remat_cfg = _layer_configs(True, sparse, gelu_checkpoint=True, **drop)
    assert remat_cfg.remat and not base_cfg.remat
    x, g, m = _layer_inputs(True)
    results = []
    for cfg in (base_cfg, remat_cfg):
        layer = ttr.DeepSpeedTransformerLayer(cfg)
        tx = torch.tensor(x, requires_grad=True)
        out = layer(tx, torch.tensor(m), train=True,
                    generator=torch.Generator().manual_seed(3))
        (out * torch.tensor(g)).sum().backward()
        results.append((out.detach(), tx.grad,
                        {n: p.grad for n, p in layer.named_parameters()}))
    (ob, xb, gb), (orm, xr, gr) = results
    torch.testing.assert_close(orm, ob, rtol=0, atol=0)
    torch.testing.assert_close(xr, xb, rtol=1e-6, atol=1e-7)
    for name in gb:
        torch.testing.assert_close(gr[name], gb[name], rtol=1e-6, atol=1e-7)


def test_sparse_layer_refuses_dropout_and_per_query_masks():
    _, cfg = _layer_configs(True, True, attn_dropout_ratio=0.1)
    layer = ttr.DeepSpeedTransformerLayer(cfg)
    x = torch.zeros(1, LAYER_SEQ, 128)
    with pytest.raises(ValueError, match="attention dropout"):
        layer(x, train=True, generator=torch.Generator())
    layer(x, train=False)                      # eval mode has no dropout
    _, cfg = _layer_configs(True, True)
    layer = ttr.DeepSpeedTransformerLayer(cfg)
    with pytest.raises(ValueError, match="key-padding masks"):
        layer(x, torch.zeros(1, 1, LAYER_SEQ, LAYER_SEQ), train=True)


def test_configs_mirror_the_jax_configs():
    jfields = {f.name for f in JBertConfig.__dataclass_fields__.values()}
    fields = {f.name for f in tbert.BertConfig.__dataclass_fields__.values()}
    assert fields == jfields
    assert tbert.BertConfig().padded_vocab_size == 30592
    assert tbert.BERT_SIZES == {
        k: dict(v) for k, v in __import__(
            "deepspeed_tpu.models.bert", fromlist=["BERT_SIZES"])
        .BERT_SIZES.items()}
    assert tbert.bert_config("bert-base").hidden_size == 768
    assert vars(ttr.DeepSpeedTransformerConfig()) == vars(
        jtr.DeepSpeedTransformerConfig())
    cfg = ttr.DeepSpeedTransformerConfig.from_dict(
        {"hidden_size": 64, "heads": 4, "bf16": True})
    assert cfg.hidden_size == 64 and cfg.compute_dtype == torch.bfloat16
    assert ttr.DeepSpeedTransformerConfig(fp16=True).compute_dtype \
        == torch.float16
    assert not cfg.remat
    assert ttr.DeepSpeedTransformerConfig(normalize_invertible=True).remat


def test_seeded_init_is_deterministic_and_scaled():
    cfg = tbert.BertConfig(dtype=torch.float32, **TINY)
    a = tbert.BertForPreTraining(cfg, torch.Generator().manual_seed(1))
    b = tbert.BertForPreTraining(cfg, torch.Generator().manual_seed(1))
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
    body = a.encoder.layers[0].body
    assert abs(body.qkv.weight.std().item() - 0.02) < 2e-3
    # adjust_init_range: the output projections at 0.02 / sqrt(2 * layers)
    assert abs(body.ffn_out.weight.std().item() - 0.01) < 1e-3
    assert torch.all(body.attn_ln.weight == 1) and torch.all(a.mlm_bias == 0)
    assert abs(a.embeddings.word_embeddings.std().item() - 0.02) < 2e-3
    assert all(p.dtype == torch.float32 for p in a.parameters())


def test_bert_trains_on_the_port_engine_in_bf16():
    """bf16 compute over fp32 master weights, sparse attention, hidden
    dropout: losses finite and falling on the CPU; the master weights are
    fp32 and the module's parameters their bf16 copy."""
    _, tcfg = _configs(True, hidden_dropout_prob=0.1)
    tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    eng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=tbert.BertForPreTraining(tcfg),
        config_params=dict(DS_CONFIG, bf16={"enabled": True}), device="cpu")
    batch = _batch(seed=10, lead=(2,))
    losses = [eng.train_batch(batch=batch).item() for _ in range(4)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert all(p.dtype == torch.float32 for p in eng.master)
    assert all(p.dtype == torch.bfloat16 for p in eng.module.parameters())
