"""Parameters of the JAX package's GPT-2 and BERT -> this package's
state_dicts.

The JAX GPT2LMHead keeps its parameters as a nested dict (deepspeed_tpu
models/gpt2.py:220-275): ``wte``, ``wpe``, ``ln_f``, and the blocks either
unrolled as ``h_{i}`` or scan-stacked under ``h/block`` with a leading (L,)
axis. Handed over as nested dicts of numpy arrays, they map onto
``GPT2Model``'s names: a flax Dense ``kernel`` (in, out) becomes a Linear
``weight`` (out, in), a LayerNorm ``scale`` becomes ``weight``, and ``wte``
keeps its padded vocab rows. The JAX BERT's tree (deepspeed_tpu
models/bert.py) maps the same way onto ``BertForPreTraining``
(``bert_params_from_jax``).
"""
import numpy as np
import torch

_DENSE = ("attn.c_attn", "attn.c_proj", "mlp.c_fc", "mlp.c_proj")
_NORMS = ("ln_1", "ln_2")


def _tensor(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _block(tree, prefix, out, index=None):
    """One block's entries; ``index`` picks layer i of a stacked tree."""
    def leaf(*path):
        node = tree
        for key in path:
            node = node[key]
        return node if index is None else node[index]

    for name in _NORMS:
        out[f"{prefix}.{name}.weight"] = _tensor(leaf(name, "scale"))
        out[f"{prefix}.{name}.bias"] = _tensor(leaf(name, "bias"))
    for name in _DENSE:
        path = name.split(".")
        out[f"{prefix}.{name}.weight"] = _tensor(leaf(*path, "kernel")).t() \
            .contiguous()
        out[f"{prefix}.{name}.bias"] = _tensor(leaf(*path, "bias"))


def params_from_jax(tree, cfg):
    """state_dict for ``GPT2Model(cfg)`` from the JAX parameter tree
    ``tree`` (nested dicts of numpy arrays, unrolled or scan-stacked)."""
    out = {"wte": _tensor(tree["wte"]), "wpe": _tensor(tree["wpe"]),
           "ln_f.weight": _tensor(tree["ln_f"]["scale"]),
           "ln_f.bias": _tensor(tree["ln_f"]["bias"])}
    if "h" in tree:
        stacked = tree["h"]["block"]
        for i in range(cfg.n_layer):
            _block(stacked, f"h.{i}", out, index=i)
    else:
        for i in range(cfg.n_layer):
            _block(tree[f"h_{i}"], f"h.{i}", out)
    if out["wte"].shape[0] != cfg.padded_vocab_size:
        raise ValueError(f"wte has {out['wte'].shape[0]} rows, the config "
                         f"pads the vocab to {cfg.padded_vocab_size}")
    return out


_BERT_BODY_NORMS = ("attn_ln", "ffn_ln")
_BERT_BODY_DENSE = ("qkv", "attn_out", "ffn_inter", "ffn_out")


def _norm(node, prefix, out):
    out[f"{prefix}.weight"] = _tensor(node["scale"])
    out[f"{prefix}.bias"] = _tensor(node["bias"])


def _dense(node, prefix, out):
    out[f"{prefix}.weight"] = _tensor(node["kernel"]).t().contiguous()
    out[f"{prefix}.bias"] = _tensor(node["bias"])


def transformer_layer_params_from_jax(tree, prefix=""):
    """state_dict entries for ``DeepSpeedTransformerLayer`` from the JAX
    layer's tree ``{"body": {...}}``, each name under ``prefix``."""
    body = tree["body"]
    out = {}
    for name in _BERT_BODY_NORMS:
        _norm(body[name], f"{prefix}body.{name}", out)
    for name in _BERT_BODY_DENSE:
        _dense(body[name], f"{prefix}body.{name}", out)
    return out


def bert_params_from_jax(tree, cfg):
    """state_dict for ``BertForPreTraining(cfg)`` from the JAX BERT's
    parameter tree ``tree`` (nested dicts of numpy arrays): embeddings,
    ``encoder/layer_{i}/body/*``, ``encoder/final_ln`` (pre-LN), and the
    MLM and NSP heads. The padded vocab rows are kept."""
    emb = tree["embeddings"]
    out = {f"embeddings.{name}": _tensor(emb[name]) for name in (
        "word_embeddings", "position_embeddings", "token_type_embeddings")}
    _norm(emb["ln"], "embeddings.ln", out)
    for i in range(cfg.num_hidden_layers):
        out.update(transformer_layer_params_from_jax(
            tree["encoder"][f"layer_{i}"], f"encoder.layers.{i}."))
    if cfg.pre_layer_norm:
        _norm(tree["encoder"]["final_ln"], "encoder.final_ln", out)
    for name in ("mlm_transform", "pooler", "nsp"):
        _dense(tree[name], name, out)
    _norm(tree["mlm_ln"], "mlm_ln", out)
    out["mlm_bias"] = _tensor(tree["mlm_bias"])
    if out["embeddings.word_embeddings"].shape[0] != cfg.padded_vocab_size:
        raise ValueError(f"word_embeddings has "
                         f"{out['embeddings.word_embeddings'].shape[0]} rows, "
                         f"the config pads the vocab to "
                         f"{cfg.padded_vocab_size}")
    return out
