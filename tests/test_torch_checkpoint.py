"""Checkpoints of the PyTorch port: save_checkpoint / load_checkpoint in
the JAX engine's layout (model_states.npz with the TrainState's leaves,
metadata.pkl, the manifest and the ``latest`` pointer).

- A port -> port round trip is bit-exact at fp32, bf16 and fp16: every
  state tensor, and the losses and parameters of two more steps.
- A tag the JAX engine saved loads into the port, and one more step gives
  the JAX engine's loss and gradient norm at the fp32 parity tolerance of
  tests/test_torch_engine.py (rtol 1e-4: the same fp32 arithmetic summed
  in other orders), and its parameters within 5e-5: Adam moves an element
  whose gradient is near zero by up to lr (3e-3 here) on the ratio of two
  tiny moments, so summation-order differences move it by up to a few
  percent of lr (CPU reading: 1.7e-5).
- A port tag loads into the JAX engine: params, master, Adam's m, v and
  step, and the loss scale are equal (bit for bit); the rng leaf is not
  compared (a torch generator cannot continue a jax key).
- A torn write (a payload file truncated) fails verify_tag and the load.
"""
import io
import pickle
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2Model as JGPT2Model
from deepspeed_tpu.runtime.resilience import atomic as jatomic
from deepspeed_tpu.models.bert import BertForPreTraining as JBert
from deepspeed_tpu.models.bert import bert_config as jbert_config
from deepspeed_tpu_torch.models.bert import BertForPreTraining, bert_config
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from deepspeed_tpu_torch.runtime import checkpoint_utils
from deepspeed_tpu_torch.runtime.resilience import atomic

TINY = dict(vocab_size=256, n_positions=128, n_embd=128, n_layer=2,
            n_head=2)
RTOL = 1e-4
PARAM_ATOL = 5e-5
PRECISIONS = {
    "fp32": ({}, torch.float32, jnp.float32),
    "bf16": ({"bf16": {"enabled": True}}, torch.bfloat16, jnp.bfloat16),
    "fp16": ({"fp16": {"enabled": True, "loss_scale": 0,
                       "initial_scale_power": 12, "hysteresis": 2}},
             torch.float16, jnp.float16),
}


def _config(precision):
    return {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
            "gradient_accumulation_steps": 2,
            "optimizer": {"type": "Adam",
                          "params": {"lr": 3e-3, "weight_decay": 0.01}},
            "scheduler": {"type": "WarmupLR",
                          "params": {"warmup_min_lr": 0.0,
                                     "warmup_max_lr": 3e-3,
                                     "warmup_num_steps": 3}},
            "gradient_clipping": 1.0, "steps_per_print": 10 ** 9,
            **PRECISIONS[precision][0]}


def _batch(seed):
    ids = np.random.default_rng(seed).integers(0, TINY["vocab_size"],
                                               (2, 2, 128))
    return {"input_ids": ids, "labels": ids.copy()}


def _port(precision):
    cfg = GPT2Config(dtype=PRECISIONS[precision][1], **TINY)
    eng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=GPT2Model(cfg), config_params=_config(precision), device="cpu")
    return eng


def _reference(precision):
    from deepspeed_tpu.runtime.engine import _first_micro

    eng, _, _, _ = deepspeed_tpu.initialize(
        model=JGPT2Model(JGPT2Config(dtype=PRECISIONS[precision][2], **TINY)),
        config_params=dict(_config(precision),
                           mesh={"data": 1, "allow_partial": True}))
    eng._ensure_state(_first_micro(_batch(0)))
    return eng


def _state(eng):
    """The engine's TrainState leaves as tensors (the rng key, a uint32
    numpy leaf, as int64)."""
    return [t.detach().clone() if isinstance(t, torch.Tensor)
            else torch.from_numpy(t.astype(np.int64))
            for t in eng._state_leaves()]


@pytest.mark.parametrize("precision", sorted(PRECISIONS))
def test_port_round_trip_is_bit_exact(tmp_path, precision):
    a = _port(precision)
    for seed in (1, 2):
        a.train_batch(batch=_batch(seed))
    a.save_checkpoint(str(tmp_path), client_state={"epoch": 3})
    assert atomic.read_latest(str(tmp_path)) == "global_step2"
    b = _port(precision)
    path, client = b.load_checkpoint(str(tmp_path))
    assert client == {"epoch": 3} and path.endswith("global_step2")
    assert (b.global_steps, b.micro_steps) == (2, 4)
    assert b.get_lr() == a.get_lr()
    for x, y in zip(_state(a), _state(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    for seed in (3, 4):
        assert torch.equal(a.train_batch(batch=_batch(seed)),
                           b.train_batch(batch=_batch(seed)))
    for x, y in zip(a.master, b.master):
        assert torch.equal(x, y)
    if precision == "fp16":
        assert a.loss_scale() == b.loss_scale() == 2.0 ** 12


def test_npz_leaves_round_trip_every_dtype():
    leaves = [torch.randn(3, 4).bfloat16(), torch.randn(5).half(),
              torch.randn(2, 2), torch.tensor(7, dtype=torch.int32),
              np.array([0, 42], np.uint32)]
    back = checkpoint_utils.npz_dict_to_leaves(
        _npz_round_trip(checkpoint_utils.leaves_to_npz_dict(leaves)))
    for x, y in zip(leaves, back):
        x = torch.as_tensor(x)
        assert x.dtype == y.dtype and torch.equal(x, y)


def _npz_round_trip(arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    buf.seek(0)
    return np.load(buf)


def test_reference_tag_loads_into_the_port_and_trains_on(tmp_path):
    """The JAX engine trains 2 steps and saves (npz); the port loads that
    tag; one more step of each gives the same loss, gradient norm and
    parameters (fp32, rtol 1e-4)."""
    jeng = _reference("fp32")
    for seed in (1, 2):
        jeng.train_batch(batch=_batch(seed))
    jeng.save_checkpoint(str(tmp_path), backend="npz",
                         client_state={"note": "jax"})
    eng = _port("fp32")
    _, client = eng.load_checkpoint(str(tmp_path))
    assert client == {"note": "jax"} and eng.global_steps == 2
    jloss = float(jeng.train_batch(batch=_batch(3)))
    loss = float(eng.train_batch(batch=_batch(3)))
    np.testing.assert_allclose(loss, jloss, rtol=RTOL)
    np.testing.assert_allclose(float(eng._last_metrics["grad_norm"]),
                               float(jeng._last_metrics["grad_norm"]),
                               rtol=RTOL)
    want = params_from_jax(jax.device_get(jeng.state.params), eng.module
                           .config)
    for name, p in zip(eng.param_names, eng.params):
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=PARAM_ATOL, err_msg=name)


def test_port_tag_loads_into_the_reference(tmp_path):
    """The port trains 2 fp16 steps and saves; the JAX engine's
    load_checkpoint (manifest verified) takes the tag, and its params,
    master, Adam state and loss scale equal the port's, bit for bit."""
    eng = _port("fp16")
    for seed in (1, 2):
        eng.train_batch(batch=_batch(seed))
    eng.save_checkpoint(str(tmp_path))
    jeng = _reference("fp16")
    path, _ = jeng.load_checkpoint(str(tmp_path))
    assert path is not None and jeng.global_steps == 2
    st = jax.device_get(jeng.state)
    got = _state(eng)
    want = jax.tree_util.tree_leaves(st)
    assert len(got) == len(want)
    # every leaf but the rng key (the last)
    for i, (x, y) in enumerate(zip(got[:-1], want[:-1])):
        y = np.asarray(y)
        x = x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
        assert x.shape == y.shape, i
        np.testing.assert_array_equal(x, y.astype(x.dtype), err_msg=str(i))
    assert float(st.scaler.loss_scale) == eng.loss_scale()
    assert int(st.opt_state.step) == int(eng.optimizer.step)


def test_torn_write_fails_verification(tmp_path):
    eng = _port("fp32")
    eng.train_batch(batch=_batch(1))
    eng.save_checkpoint(str(tmp_path), tag="t1")
    tag = os.path.join(str(tmp_path), "t1")
    assert atomic.verify_tag(tag) == (True, "ok")
    assert jatomic.verify_tag(tag)[0]           # the JAX package agrees
    payload = os.path.join(tag, "model_states.npz")
    size = os.path.getsize(payload)
    with open(payload, "r+b") as f:
        f.truncate(size // 2)
    ok, reason = atomic.verify_tag(tag)
    assert not ok and "size mismatch" in reason
    with pytest.raises(atomic.CheckpointCorrupt, match="verification"):
        _port("fp32").load_checkpoint(str(tmp_path), tag="t1")
    assert _port("fp32").load_checkpoint(str(tmp_path / "none")) == (None,
                                                                      {})


def test_unported_checkpoint_options_raise(tmp_path):
    """Orbax, the JAX package's own checkpoint library, is neither written
    nor read, with the reason; auto_resume runs now (nothing to resume
    from: nothing loaded)."""
    eng = _port("fp32")
    with pytest.raises(NotImplementedError, match="orbax is the JAX "
                       "package's checkpoint library"):
        eng.save_checkpoint(str(tmp_path), backend="orbax")
    eng.save_checkpoint(str(tmp_path), tag="t")
    meta_path = os.path.join(tmp_path, "t", "metadata.pkl")
    with open(meta_path, "rb") as f:
        meta = pickle.load(f)
    with open(meta_path, "wb") as f:
        pickle.dump(dict(meta, backend="orbax"), f)
    manifest = atomic.load_manifest(os.path.join(tmp_path, "t"))
    atomic.write_manifest(os.path.join(tmp_path, "t"), {
        k: v for k, v in manifest.items() if k not in ("files", "version")})
    with pytest.raises(NotImplementedError, match="does not read"):
        eng.load_checkpoint(str(tmp_path), tag="t")
    assert eng.load_checkpoint(str(tmp_path / "none"),
                               auto_resume=True) == (None, {})


@pytest.mark.parametrize("model", ["gpt2", "gpt2_scan", "bert"])
def test_leaf_specs_follow_the_reference_tree(model):
    """The checkpoint's parameter leaves are the JAX model's, in its flatten
    order: each spec's parameter (transposed for a Dense kernel, stacked
    for a scanned stack) has the shape of the JAX leaf at that position,
    and the specs name every parameter once."""
    rng = jax.random.PRNGKey(0)
    if model == "bert":
        kw = dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=2,
                  intermediate_size=256, vocab_size=128,
                  max_position_embeddings=64)
        ours = BertForPreTraining(bert_config("bert-base", dtype=torch.float32,
                                              **kw))
        jm = JBert(jbert_config("bert-base", dtype=jnp.float32, **kw))
        ids = np.zeros((1, 64), np.int32)
        batch = {"input_ids": ids, "masked_lm_labels": ids,
                 "attention_mask": np.ones_like(ids)}
    else:
        scan = model == "gpt2_scan"
        ours = GPT2Model(GPT2Config(dtype=torch.float32, scan_layers=scan,
                                    **TINY))
        jm = JGPT2Model(JGPT2Config(dtype=jnp.float32, scan_layers=scan,
                                    **TINY))
        ids = np.zeros((1, 128), np.int32)
        batch = {"input_ids": ids, "labels": ids}
    want = [leaf.shape for leaf in
            jax.tree_util.tree_leaves(jm.init(rng, batch))]
    params = dict(ours.named_parameters())
    specs = ours.reference_leaf_specs()
    got, named = [], []
    for names, transposed in specs:
        group = names if isinstance(names, tuple) else (names,)
        shape = params[group[0]].shape
        shape = tuple(reversed(shape)) if transposed else tuple(shape)
        got.append((len(group),) + shape if isinstance(names, tuple)
                   else shape)
        named += group
    assert got == [tuple(s) for s in want]
    assert sorted(named) == sorted(params)
