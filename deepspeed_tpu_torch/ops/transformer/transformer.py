"""DeepSpeedTransformerLayer: the fused BERT-style encoder layer.

Port of deepspeed_tpu/ops/transformer/transformer.py (reference
deepspeed/ops/transformer/transformer.py:39-614). One ``nn.Module`` whose
parameter names mirror the JAX layer's (``body.{attn_ln, qkv, attn_out,
ffn_ln, ffn_inter, ffn_out}``), pre- or post-LN, computing in the config's
dtype (over fp32 parameters cast at use, or the engine's compute-dtype
copy). The attention core is
``functional.scaled_dot_product_attention`` (the flash kernels for CUDA
tensors) or, with a ``sparsity_config``, the block-sparse path
(ops/sparse_attention: the block-sparse kernels for CUDA tensors). The
memory-saving flags (normalize_invertible / attn_dropout_checkpoint /
gelu_checkpoint) recompute the layer body in the backward
(torch.utils.checkpoint), replaying its dropout generator. Under sequence
parallelism (``sp_group``, set by the model) the body holds its rank's
chunk of the sequence, and the attention core, dense or block-sparse,
runs on the rank's heads over the whole sequence between Ulysses's
all-to-alls (parallel/ulysses.py), as the JAX layer's sharding flip does;
the (B, 1, 1, S) key mask is the whole row's, which every rank holds.
Under tensor parallelism (the model's ``set_tensor_parallel``) the
body holds its model rank's heads: ``qkv`` and ``ffn_inter`` split by
output (their biases whole, as the JAX spec replicates them, each rank
adding its part), ``attn_out`` and ``ffn_out`` by input, all-reduced
before their biases (parallel/tensor_parallel.py); the attention core,
dense or block-sparse, runs on the rank's heads at their offset among
all of them.

Also home to the building blocks the port's models share: ``Dense`` and
``LayerNorm`` (computing in the input's dtype from parameters of any
float dtype, flax's initializers) and ``replayable``.
"""
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import \
    SparseSelfAttention
from deepspeed_tpu_torch.ops.transformer.functional import (
    gelu, scaled_dot_product_attention, seq_dropout)
from deepspeed_tpu_torch.parallel.ulysses import ulysses_attention


def _trunc_normal_(t, std, generator):
    """Normal(0, std) truncated at +-2 std (flax's lecun_normal draws a
    truncated normal): out-of-range draws are redrawn, all of them in index
    order each round. Only the redrawn elements are checked again, and the
    scale is applied in place: the values of redrawing every out-of-range
    element of the whole tensor each round, at under half its host time
    (a 4.2B-parameter model initializes in minutes on the host)."""
    with torch.no_grad():
        x = torch.empty(t.shape).normal_(generator=generator)
        flat = x.view(-1)
        idx = (flat.abs() > 2.0).nonzero().squeeze(1)
        while idx.numel():
            draws = torch.empty(idx.numel()).normal_(generator=generator)
            flat[idx] = draws
            idx = idx[draws.abs() > 2.0]
        t.copy_(x.mul_(std))


class Dense(nn.Linear):
    """Linear layer computing in the input's dtype: under the engine its
    parameters already are the compute-dtype copy and the casts are no-ops;
    fp32 parameters (the module on its own) are cast at use. Initialized
    like flax's Dense: a lecun_normal kernel (or normal(std) when ``std``
    is given), zero bias."""

    def reset_with(self, generator, std: Optional[float] = None):
        with torch.no_grad():
            if std is None:
                # flax's variance_scaling(1, fan_in, truncated_normal)
                _trunc_normal_(self.weight, math.sqrt(1.0 / self.in_features)
                               / 0.87962566103423978, generator)
            else:
                self.weight.copy_(torch.empty(self.weight.shape).normal_(
                    generator=generator) * std)
            self.bias.zero_()

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class LayerNorm(nn.LayerNorm):
    """LayerNorm with fp32 statistics, output in the input's dtype. The
    weight and bias take part as they are stored (the engine's
    compute-dtype copy under bf16 or fp16, as the JAX engine hands them
    over), converted exactly to fp32."""

    def forward(self, x):
        y = F.layer_norm(x.float(), self.normalized_shape,
                         self.weight.float(), self.bias.float(), self.eps)
        return y.to(x.dtype)

    def reset_with(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()


def replayable(module, generator):
    """module(*args, generator) that draws the same dropout randomness when
    the backward recomputes it: the generator's state is rewound to where
    the forward found it (torch.utils.checkpoint only replays the default
    generators)."""
    state = None if generator is None else generator.get_state()

    def run(*args):
        if generator is not None:
            generator.set_state(state)
        return module(*args, generator)

    return run


class TransformerConfig:
    """Base config (reference transformer.py:21-37)."""

    def __init__(self, batch_size=-1, hidden_size=-1, intermediate_size=-1,
                 heads=-1, attn_dropout_ratio=-1, hidden_dropout_ratio=-1,
                 num_hidden_layers=-1, initializer_range=-1):
        self.layer_id = -1
        self.batch_size = batch_size
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.heads = heads
        self.attn_dropout_ratio = attn_dropout_ratio
        self.hidden_dropout_ratio = hidden_dropout_ratio
        self.num_hidden_layers = num_hidden_layers
        self.initializer_range = initializer_range


class DeepSpeedTransformerConfig(TransformerConfig):
    """Config with the reference surface (transformer.py:39-140). fp16 / bf16
    select the compute dtype; local_rank, seed and test_gemm are accepted
    for compatibility (device and randomness belong to the engine)."""

    def __init__(self, batch_size=-1, hidden_size=-1, intermediate_size=-1,
                 heads=-1, attn_dropout_ratio=-1, hidden_dropout_ratio=-1,
                 num_hidden_layers=-1, initializer_range=-1,
                 layer_norm_eps=1e-12, local_rank=-1, seed=-1, fp16=False,
                 bf16=False, pre_layer_norm=True, normalize_invertible=False,
                 gelu_checkpoint=False, adjust_init_range=True,
                 attn_dropout_checkpoint=False, stochastic_mode=False,
                 huggingface=False, training=True, sparsity_config=None):
        super().__init__(
            batch_size, hidden_size,
            intermediate_size if intermediate_size > 0 else 4 * hidden_size,
            heads, attn_dropout_ratio, hidden_dropout_ratio,
            num_hidden_layers, initializer_range)
        self.fp16 = fp16
        self.bf16 = bf16
        self.pre_layer_norm = pre_layer_norm
        self.local_rank = local_rank
        self.seed = seed
        self.normalize_invertible = normalize_invertible
        self.gelu_checkpoint = gelu_checkpoint
        self.adjust_init_range = adjust_init_range
        self.test_gemm = False
        self.layer_norm_eps = layer_norm_eps
        self.training = training
        self.is_grad_enabled = True
        self.attn_dropout_checkpoint = attn_dropout_checkpoint
        self.stochastic_mode = stochastic_mode
        self.huggingface = huggingface
        # a SparsityConfig (ops/sparse_attention) routes the attention core
        # through the block-sparse path: same parameters, another pattern
        self.sparsity_config = sparsity_config

    @classmethod
    def from_dict(cls, json_object):
        config = cls()
        for key, value in json_object.items():
            config.__dict__[key] = value
        return config

    @property
    def compute_dtype(self):
        if self.fp16:
            return torch.float16
        if self.bf16:
            return torch.bfloat16
        return torch.float32

    @property
    def remat(self):
        """Any memory-saving flag -> recompute the layer body."""
        return (self.normalize_invertible or self.gelu_checkpoint
                or self.attn_dropout_checkpoint)


class _EncoderBody(nn.Module):
    """BERT encoder layer body (attention + FFN), pre- or post-LN."""
    # the seq group under sequence parallelism (the model sets it)
    sp_group = None

    def __init__(self, config: DeepSpeedTransformerConfig, name="body"):
        super().__init__()
        from deepspeed_tpu_torch.parallel.tensor_parallel import (
            ColumnParallelDense, RowParallelDense)

        self.config = config
        e, eps = config.hidden_size, config.layer_norm_eps
        self.attn_ln = LayerNorm(e, eps=eps)
        self.qkv = ColumnParallelDense(e, 3 * e, fused=3,
                                       bias_replicated=True,
                                       name=f"{name}/qkv")
        self.attn_out = RowParallelDense(e, e, name=f"{name}/attn_out")
        self.ffn_ln = LayerNorm(e, eps=eps)
        self.ffn_inter = ColumnParallelDense(e, config.intermediate_size,
                                             bias_replicated=True,
                                             name=f"{name}/ffn_inter")
        self.ffn_out = RowParallelDense(config.intermediate_size, e,
                                        name=f"{name}/ffn_out")
        # no parameters; keeps the layout of each sequence length
        self.sparse_attn = None if config.sparsity_config is None else \
            SparseSelfAttention(config.sparsity_config,
                                key_padding_mask_mode="add")

    def reset_with(self, generator):
        cfg = self.config
        std = cfg.initializer_range
        out_std = std / math.sqrt(2.0 * max(1, cfg.num_hidden_layers)) \
            if cfg.adjust_init_range else std
        self.attn_ln.reset_with()
        self.qkv.reset_with(generator, std)
        self.attn_out.reset_with(generator, out_std)
        self.ffn_ln.reset_with()
        self.ffn_inter.reset_with(generator, std)
        self.ffn_out.reset_with(generator, out_std)

    def _attention(self, qh, kh, vh, attention_mask, train, generator):
        tp = self.qkv.group
        if tp is not None:
            return self._core(qh, kh, vh, attention_mask, train, generator,
                              head_offset=tp.rank * qh.shape[1],
                              total_heads=self.config.heads)
        if self.sp_group is None:
            return self._core(qh, kh, vh, attention_mask, train, generator)
        return ulysses_attention(
            qh, kh, vh, group=self.sp_group,
            attention_fn=lambda q, k, v, **heads: self._core(
                q, k, v, attention_mask, train, generator, **heads))

    def _core(self, qh, kh, vh, attention_mask, train, generator,
              head_offset=0, total_heads=None):
        """The attention over heads [head_offset, head_offset + H) of
        ``total_heads`` (default: all) over the whole sequence."""
        cfg = self.config
        drop = train and cfg.attn_dropout_ratio > 0
        if self.sparse_attn is None:
            return scaled_dot_product_attention(
                qh, kh, vh, causal=False, bias=attention_mask,
                dropout_rng=generator if drop else None,
                dropout_rate=cfg.attn_dropout_ratio if drop else 0.0,
                head_offset=head_offset, total_heads=total_heads)
        if drop:
            raise ValueError("sparsity_config does not support attention "
                             "dropout (the reference's sparse path has none "
                             "either); set attn_dropout_ratio=0")
        # HF extended additive mask (B,1,1,S) -> per-key additions; a mask
        # with per-query structure cannot become a key bias
        kpm = None
        if attention_mask is not None:
            if attention_mask.dim() != 4 or attention_mask.shape[1] != 1 \
                    or attention_mask.shape[2] != 1:
                raise ValueError(
                    f"sparsity_config supports key-padding masks (B, 1, 1, S)"
                    f" only; got attention_mask shape "
                    f"{tuple(attention_mask.shape)}: per-query masks need "
                    f"the dense path (sparsity_config=None)")
            kpm = attention_mask[:, 0, 0, :]
        return self.sparse_attn(qh, kh, vh, key_padding_mask=kpm,
                                head_offset=head_offset,
                                total_heads=total_heads)

    def forward(self, hidden_states, attention_mask, train, generator=None):
        cfg = self.config
        b, s, e = hidden_states.shape
        x = hidden_states.to(cfg.compute_dtype)
        hidden_drop = train and cfg.hidden_dropout_ratio > 0

        # --- attention ---------------------------------------------------
        residual = x
        attn_in = self.attn_ln(x) if cfg.pre_layer_norm else x
        qkv = self.qkv(attn_in)
        # this model rank's heads (all of them at model 1)
        el = qkv.shape[-1] // 3
        head_dim = e // cfg.heads
        q, k, v = qkv.split(el, dim=-1)

        def split_heads(t):
            return t.reshape(b, s, el // head_dim, head_dim).transpose(1, 2)

        ctx = self._attention(split_heads(q), split_heads(k), split_heads(v),
                              attention_mask, train, generator)
        attn_out = self.attn_out(ctx.transpose(1, 2).reshape(b, s, el))
        if hidden_drop:
            attn_out = seq_dropout(attn_out, generator,
                                   cfg.hidden_dropout_ratio, self.sp_group)
        x = residual + attn_out
        if not cfg.pre_layer_norm:
            x = self.attn_ln(x)

        # --- feed-forward ------------------------------------------------
        residual = x
        ffn_in = self.ffn_ln(x) if cfg.pre_layer_norm else x
        h = gelu(self.ffn_inter(ffn_in), approximate=False)
        h = self.ffn_out(h)
        if hidden_drop:
            h = seq_dropout(h, generator, cfg.hidden_dropout_ratio,
                            self.sp_group)
        x = residual + h
        if not cfg.pre_layer_norm:
            x = self.ffn_ln(x)
        return x


class DeepSpeedTransformerLayer(nn.Module):
    """Drop-in encoder layer (reference transformer.py:470-614).

    forward(hidden_states, attention_mask) -> hidden_states, where
    attention_mask is an additive bias broadcastable to (B, H, S, S)
    (HF-style extended mask) or None; ``generator`` draws the dropout.
    """

    def __init__(self, config: DeepSpeedTransformerConfig, name="layer"):
        super().__init__()
        self.config = config
        self.body = _EncoderBody(config, name=name)
        self.reset_with(torch.Generator().manual_seed(0))

    def reset_with(self, generator):
        self.body.reset_with(generator)

    def forward(self, hidden_states, attention_mask=None,
                train: Optional[bool] = None,
                generator: Optional[torch.Generator] = None):
        train = self.config.training if train is None else train
        if self.config.remat and train and torch.is_grad_enabled():
            return checkpoint(replayable(self.body, generator), hidden_states,
                              attention_mask, train, use_reentrant=False)
        return self.body(hidden_states, attention_mask, train, generator)
