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
(``bert_params_from_jax``). An MoE block (``h_{i}/moe``) holds the
router's ``kernel`` (M, E), which becomes ``moe.router.weight`` (E, M)
like any Dense kernel, and the expert stacks ``experts/{w_in, b_in, w_out,
b_out}``, which keep the JAX layout. Under tensor parallelism a model
rank holds its shard of each (``model_rank_shard``, whose inverse is
``model_rank_join``).
"""
import numpy as np
import torch

_DENSE = ("attn.c_attn", "attn.c_proj", "mlp.c_fc", "mlp.c_proj")
_NORMS = ("ln_1", "ln_2")
_EXPERTS = ("w_in", "b_in", "w_out", "b_out")


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
    moe = "moe" in tree
    for name in _DENSE[:2] if moe else _DENSE:
        path = name.split(".")
        out[f"{prefix}.{name}.weight"] = _tensor(leaf(*path, "kernel")).t() \
            .contiguous()
        out[f"{prefix}.{name}.bias"] = _tensor(leaf(*path, "bias"))
    if moe:
        out[f"{prefix}.moe.router.weight"] = _tensor(
            leaf("moe", "router", "kernel")).t().contiguous()
        for name in _EXPERTS:
            out[f"{prefix}.moe.experts.{name}"] = _tensor(
                leaf("moe", "experts", name))


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


# ---------------------------------------------------------------------------
# the JAX package's parameter tree, leaf by leaf (checkpoint layout)
# ---------------------------------------------------------------------------
def _dense_spec(prefix):
    return {"kernel": (f"{prefix}.weight", True),
            "bias": (f"{prefix}.bias", False)}


def _norm_spec(prefix):
    return {"scale": (f"{prefix}.weight", False),
            "bias": (f"{prefix}.bias", False)}


def _gpt2_block_spec(prefix, moe=False):
    spec = {"attn": {"c_attn": _dense_spec(f"{prefix}.attn.c_attn"),
                     "c_proj": _dense_spec(f"{prefix}.attn.c_proj")},
            "ln_1": _norm_spec(f"{prefix}.ln_1"),
            "ln_2": _norm_spec(f"{prefix}.ln_2")}
    if moe:
        spec["moe"] = {
            "router": {"kernel": (f"{prefix}.moe.router.weight", True)},
            "experts": {n: (f"{prefix}.moe.experts.{n}", False)
                        for n in _EXPERTS}}
    else:
        spec["mlp"] = {"c_fc": _dense_spec(f"{prefix}.mlp.c_fc"),
                       "c_proj": _dense_spec(f"{prefix}.mlp.c_proj")}
    return spec


def gpt2_moe_block(cfg, i):
    """Whether block i of the GPT-2 ``cfg`` is an MoE block (every
    ``moe_layer_freq``-th, the JAX model's alternation)."""
    freq = cfg.moe_layer_freq
    return bool(cfg.moe_num_experts) and i % freq == freq - 1


def _stacked(trees):
    """One tree whose leaves stack the leaves of ``trees`` (a scanned
    stack's leading (L,) axis): (tuple of names, transposed)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stacked([t[k] for t in trees]) for k in first}
    return tuple(t[0] for t in trees), first[1]


def gpt2_reference_tree(cfg):
    """The JAX GPT2LMHead's parameter tree with each leaf the name (or, for
    a scanned stack, the names) of this package's parameter and whether
    the JAX leaf is its transpose."""
    tree = {"wte": ("wte", False), "wpe": ("wpe", False),
            "ln_f": _norm_spec("ln_f")}
    blocks = [_gpt2_block_spec(f"h.{i}", gpt2_moe_block(cfg, i))
              for i in range(cfg.n_layer)]
    if cfg.scan_layers:
        tree["h"] = {"block": _stacked(blocks)}
    else:
        tree.update({f"h_{i}": b for i, b in enumerate(blocks)})
    return tree


def bert_reference_tree(cfg):
    """The JAX BertForPreTraining's parameter tree, as gpt2_reference_tree
    (the names ``bert_params_from_jax`` maps)."""
    emb = {name: (f"embeddings.{name}", False) for name in (
        "word_embeddings", "position_embeddings", "token_type_embeddings")}
    emb["ln"] = _norm_spec("embeddings.ln")
    encoder = {}
    for i in range(cfg.num_hidden_layers):
        body = {n: _norm_spec(f"encoder.layers.{i}.body.{n}")
                for n in _BERT_BODY_NORMS}
        body.update({n: _dense_spec(f"encoder.layers.{i}.body.{n}")
                     for n in _BERT_BODY_DENSE})
        encoder[f"layer_{i}"] = {"body": body}
    if cfg.pre_layer_norm:
        encoder["final_ln"] = _norm_spec("encoder.final_ln")
    tree = {"embeddings": emb, "encoder": encoder,
            "mlm_ln": _norm_spec("mlm_ln"), "mlm_bias": ("mlm_bias", False)}
    tree.update({n: _dense_spec(n) for n in ("mlm_transform", "pooler",
                                             "nsp")})
    return tree


def leaf_specs(tree):
    """[(name or tuple of names, transposed)] of a reference tree's leaves
    in the JAX package's flatten order (a dict flattens in sorted key
    order): the layout of a checkpoint's parameter-shaped fields."""
    out = []

    def walk(node):
        for key in sorted(node):
            if isinstance(node[key], dict):
                walk(node[key])
            else:
                out.append(node[key])

    walk(tree)
    return out


def leaf_paths(tree):
    """The '/'-joined key path of each of a reference tree's leaves, in
    ``leaf_specs`` order (the JAX package's leaf names)."""
    out = []

    def walk(node, prefix):
        for key in sorted(node):
            path = f"{prefix}{key}"
            if isinstance(node[key], dict):
                walk(node[key], path + "/")
            else:
                out.append(path)

    walk(tree, "")
    return out


def gpt2_tp_taken(path, ndim, stacked=False):
    """The dims of a JAX GPT-2 leaf that its tensor-parallel spec gives to
    the ``model`` axis (deepspeed_tpu models/gpt2.py ``gpt2_tp_leaf_spec``:
    QKV and MLP-in kernels their output dim and biases, the c_proj
    kernels their input dim, wte its vocab dim, an MoE leaf the dims its
    ``moe_leaf_spec`` gives ``model``; a scanned stack's leading (L,) dim
    is never taken). ZeRO shards another dim."""
    if ndim == 0 or "wpe" in path:
        return ()
    if "moe" in path:
        from deepspeed_tpu_torch.moe.sharded_moe import moe_leaf_spec

        spec = moe_leaf_spec(path)
        if spec is not None:
            return tuple(d for d, a in enumerate(spec) if a == "model")
    if "wte" in path:
        return (0,)
    lead = 1 if stacked else 0
    kernel = ndim - lead == 2
    if "c_attn" in path or "c_fc" in path:
        return (lead + 1,) if kernel else (lead,)
    if "c_proj" in path and kernel:
        return (lead,)
    return ()


def bert_tp_taken(path, ndim):
    """As ``gpt2_tp_taken`` for the JAX BERT (deepspeed_tpu models/bert.py
    ``param_partition_spec``): word embeddings their vocab dim, the QKV
    and FFN-in kernels their output dim, attn-out and FFN-out their input
    dim."""
    if ndim == 0:
        return ()
    if "word_embeddings" in path:
        return (0,)
    if ndim == 2 and ("qkv" in path or "ffn_inter" in path):
        return (1,)
    if ndim == 2 and ("attn_out" in path or "ffn_out" in path):
        return (0,)
    return ()


def tp_param_specs(module):
    """{port parameter name: (dim, fused blocks)} of every parameter of
    ``module`` that tensor parallelism splits, derived from the JAX spec
    the module states (``tp_taken``) through its reference leaves: a JAX
    kernel is the transpose of the port's weight, and a scanned stack's
    leading dim belongs to no parameter. The fused QKV projection
    (GPT-2's ``c_attn``, BERT's ``qkv``) splits each of its [q|k|v]
    blocks alike: a rank holds its heads' columns of each, where the JAX
    spec's contiguous third of [q|k|v] would hand it other columns of the
    same size (parallel/tensor_parallel.py). A module without
    ``tp_taken`` splits nothing."""
    if not hasattr(module, "tp_taken"):
        return {}
    ndims = {n: p.dim() for n, p in module.named_parameters()}
    out = {}
    for path, (names, transposed) in zip(module.reference_leaf_paths(),
                                         module.reference_leaf_specs()):
        stacked = isinstance(names, tuple)
        for name in names if stacked else (names,):
            ndim = ndims[name]
            for d in module.tp_taken(path, ndim + int(stacked), stacked):
                d -= int(stacked)
                fused = 3 if name.split(".")[-2:-1] in (["c_attn"],
                                                        ["qkv"]) else 1
                out[name] = (ndim - 1 - d if transposed else d, fused)
    return out


def fused_local(t, spec, rank, size):
    """Model rank ``rank``'s part of the whole tensor ``t`` that ``spec``
    (dim, fused blocks) splits over ``size`` ranks: the rank's columns of
    each block along dim, concatenated."""
    dim, fused = spec
    per = t.shape[dim] // fused
    if per % size:
        raise ValueError(f"a dim of {per} does not split over model={size}")
    n = per // size
    return torch.cat([t.narrow(dim, b * per + rank * n, n)
                      for b in range(fused)], dim)


def fused_join(parts, spec):
    """The inverse of ``fused_local``: every rank's part (rank order) ->
    the whole tensor, each block's columns back in rank order."""
    dim, fused = spec
    n = parts[0].shape[dim] // fused
    return torch.cat([p.narrow(dim, b * n, n) for b in range(fused)
                      for p in parts], dim)


def model_rank_shard(state, specs, rank, size):
    """Model rank ``rank``'s part of a whole state_dict (as
    ``params_from_jax`` or ``bert_params_from_jax`` give it) under tensor
    parallelism over ``size`` ranks: each parameter that ``specs``
    (``tp_param_specs``) splits as ``fused_local`` takes it, the others
    as they are."""
    return {name: fused_local(t, specs[name], rank, size)
            if name in specs else t for name, t in state.items()}


def model_rank_join(shards, specs):
    """The inverse of ``model_rank_shard``: every rank's state_dict (rank
    order) -> the whole state_dict, ``c_attn`` / ``qkv`` back in [q|k|v]
    column order."""
    return {name: fused_join([sh[name] for sh in shards], specs[name])
            if name in specs else t for name, t in shards[0].items()}


# ---------------------------------------------------------------------------
# pipeline modules (runtime/pipe/module.py): the JAX PipelineModule's tree
# ---------------------------------------------------------------------------
def _walk_pairs(ref, tree, fn, path=()):
    """fn(leaf spec, the tree's node at the same path, path) over a reference
    tree's leaves."""
    for key in sorted(ref):
        node = None if tree is None else tree[key]
        if isinstance(ref[key], dict):
            _walk_pairs(ref[key], node, fn, path + (key,))
        else:
            fn(ref[key], node, path + (key,))


def pipe_params_from_jax(tree, module):
    """state_dict for the port's PipelineModule ``module`` from the JAX
    PipelineModule's parameter tree (nested dicts of numpy arrays keyed
    ``layer_XX`` / ``tied_<key>``): a Dense kernel transposed into its
    Linear weight, every other leaf as it is."""
    out = {}

    def put(spec, leaf, _):
        name, transposed = spec
        t = _tensor(leaf)
        out[name] = t.t().contiguous() if transposed else t

    _walk_pairs(module.reference_tree(), tree, put)
    return out


def pipe_params_to_jax(state_dict, module):
    """The JAX PipelineModule's parameter tree (nested dicts of fp32 numpy
    arrays) from the port's ``module`` state_dict: the inverse of
    ``pipe_params_from_jax``."""
    out = {}

    def put(spec, _, path):
        name, transposed = spec
        t = state_dict[name].detach().float().cpu()
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = (t.t() if transposed else t).contiguous().numpy()

    _walk_pairs(module.reference_tree(), None, put)
    return out


def pipe_params_from_gpt2(state_dict, module):
    """state_dict for a GPT-2 PipelineModule (models/gpt2_pipe.py) from a
    ``GPT2Model`` state_dict of the same config: the embeddings into the
    first layer (``tied_embed`` or ``layer_00``), block i into layer i + 1,
    ``ln_f`` into the final norm, and ``wte`` again into an untied head,
    so that the pipeline starts from the monolithic model's weights."""
    layers = module.layers
    out = {}
    embed = layers[0].param_key
    for name in ("wte", "wpe"):
        out[f"{embed}.{name}"] = state_dict[name]
    n_blocks = len(layers) - 3
    for name, t in state_dict.items():
        if name.startswith("h."):
            i, rest = name[2:].split(".", 1)
            out[f"{layers[int(i) + 1].param_key}.block.{rest}"] = t
    out[f"{layers[n_blocks + 1].param_key}.ln_f.weight"] = \
        state_dict["ln_f.weight"]
    out[f"{layers[n_blocks + 1].param_key}.ln_f.bias"] = \
        state_dict["ln_f.bias"]
    head = layers[-1].param_key
    if head != embed:
        out[f"{head}.wte"] = state_dict["wte"]
    return out
