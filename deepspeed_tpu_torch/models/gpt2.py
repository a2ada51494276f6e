"""GPT-2 family: the flagship LM of the training path.

Port of deepspeed_tpu/models/gpt2.py: pre-LN decoder blocks, fused QKV
projection, attention through ops.transformer.functional (the flash kernels
for CUDA tensors), tied LM head sliced back to ``vocab_size``, and the
chunked LM loss. Parameters are fp32, cast to ``config.dtype`` where they
are used, as flax modules with ``dtype=`` do; under the engine at bf16 or
fp16 they are the engine's compute-dtype copy and the casts are no-ops.
``remat=True`` recomputes each block in the backward
(torch.utils.checkpoint) under ``remat_policy``.

Size table mirrors the reference perf harness configs
(tests/model/Megatron_GPT2/run_perf_test.py:18-84).
"""
import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from deepspeed_tpu_torch.models.api import (chunked_lm_cross_entropy,
                                            cross_entropy_loss,
                                            pad_to_multiple)
from deepspeed_tpu_torch.models.convert import (gpt2_reference_tree,
                                                leaf_paths, leaf_specs,
                                                gpt2_tp_taken)
from deepspeed_tpu_torch.ops.transformer.functional import (
    dropout, gelu, scaled_dot_product_attention)
from deepspeed_tpu_torch.ops.transformer.transformer import (Dense,
                                                            LayerNorm,
                                                            replayable)


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    # embedding/LM-head vocab dim padded to a multiple of this (50257 ->
    # 50304); ids stay < vocab_size and logits are sliced back. 0 disables.
    pad_vocab_multiple: int = 128
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    dropout: float = 0.0
    layer_norm_epsilon: float = 1e-5
    dtype: Any = torch.bfloat16    # compute dtype
    remat: bool = False            # activation checkpointing per block
    # what the per-block checkpoint saves (the JAX package's policies):
    # 'nothing' (the block's input), 'attn_out' (and the attention output
    # before c_proj), 'dots' (and the matmul outputs the backward reads)
    remat_policy: str = "nothing"
    # the JAX package scans stacked (L, ...) block params; the port always
    # keeps a list of blocks and reads either layout (models/convert.py)
    scan_layers: bool = False
    # None: kernels on CUDA, plain path on CPU; False: plain path (CPU only)
    use_pallas_attention: Optional[bool] = None
    loss_chunk_tokens: int = 8192  # chunked LM-head xent (0 = dense logits)
    attention_sp_mode: str = "ulysses"
    moe_num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_layer_freq: int = 2
    moe_aux_loss_coef: float = 0.01

    @property
    def head_dim(self):
        return self.n_embd // self.n_head

    @property
    def padded_vocab_size(self):
        return pad_to_multiple(self.vocab_size, self.pad_vocab_multiple)


GPT2_SIZES = {
    "gpt2-125m": dict(n_layer=12, n_embd=768, n_head=12),
    "gpt2-350m": dict(n_layer=24, n_embd=1024, n_head=16),
    "gpt2-760m": dict(n_layer=24, n_embd=1536, n_head=16),
    "gpt2-1.5b": dict(n_layer=48, n_embd=1600, n_head=25),
    "gpt2-4b": dict(n_layer=64, n_embd=2304, n_head=24),
    "gpt2-8b": dict(n_layer=72, n_embd=3072, n_head=24),
    "gpt2-10b": dict(n_layer=50, n_embd=4096, n_head=32),
}


def gpt2_config(name: str, **overrides) -> GPT2Config:
    base = dict(GPT2_SIZES[name])
    base.update(overrides)
    return GPT2Config(**base)


REMAT_POLICIES = ("nothing", "", None, "attn_out", "dots")
# the Dense layers' matmuls of a block in the order of its forward: c_attn,
# attn.c_proj, c_fc, mlp.c_proj; 'dots' saves the first three (what
# jax.checkpoint's dots_saveable keeps of them: mlp.c_proj's output reaches
# only the residual add, whose backward does not read it). The attention is
# the flash kernels on the card; the batched products of the CPU's plain
# attention are recomputed.
_MATMULS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}
_DOTS_SAVED = 3


def _dots_policy():
    """The selective-checkpoint policy of one block call under 'dots': its
    first three matmul outputs are kept, everything else (LayerNorm, GeLU,
    the attention, whose kernels launch outside PyTorch's dispatcher) is
    recomputed, as under the JAX package's dots_saveable."""
    seen = [0]

    def policy(ctx, op, *args, **kwargs):
        if op not in _MATMULS:
            return CheckpointPolicy.PREFER_RECOMPUTE
        seen[0] += 1
        return CheckpointPolicy.MUST_SAVE if seen[0] <= _DOTS_SAVED \
            else CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def _dots_contexts():
    return create_selective_checkpoint_contexts(_dots_policy())


def _check_supported(cfg: GPT2Config):
    if cfg.moe_num_experts:
        raise NotImplementedError(
            "GPT-2 mixture-of-experts is not ported yet (ROADMAP A15)")
    if cfg.remat and cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r} "
                         "(expected nothing|attn_out|dots)")
    if cfg.attention_sp_mode == "ring":
        raise NotImplementedError(
            "ring attention (sequence parallelism) is not ported yet "
            "(ROADMAP A15)")


class CausalSelfAttention(nn.Module):
    def __init__(self, config: GPT2Config):
        super().__init__()
        self.config = config
        e = config.n_embd
        self.c_attn = Dense(e, 3 * e)
        self.c_proj = Dense(e, e)

    def forward(self, x, train, generator):
        return self.project(self.attend(x, train, generator), train,
                            generator)

    def attend(self, x, train, generator):
        """Attention of the LayerNorm output x: (B, S, E) before c_proj,
        the tensor the JAX model names 'attn_out'."""
        cfg = self.config
        B, S, E = x.shape
        q, k, v = self.c_attn(x).split(E, dim=-1)

        def heads(t):
            return t.reshape(B, S, cfg.n_head, cfg.head_dim).transpose(1, 2)

        drop = train and cfg.dropout > 0
        y = scaled_dot_product_attention(
            heads(q), heads(k), heads(v), causal=True,
            dropout_rng=generator if drop else None,
            dropout_rate=cfg.dropout if drop else 0.0,
            use_pallas=cfg.use_pallas_attention)
        return y.transpose(1, 2).reshape(B, S, E)

    def project(self, y, train, generator):
        y = self.c_proj(y)
        if train and self.config.dropout > 0:
            y = dropout(y, generator, self.config.dropout)
        return y


class MLP(nn.Module):
    def __init__(self, config: GPT2Config):
        super().__init__()
        self.config = config
        self.c_fc = Dense(config.n_embd, 4 * config.n_embd)
        self.c_proj = Dense(4 * config.n_embd, config.n_embd)

    def forward(self, x, train, generator):
        h = self.c_proj(gelu(self.c_fc(x), approximate=True))
        if train and self.config.dropout > 0:
            h = dropout(h, generator, self.config.dropout)
        return h


class Block(nn.Module):
    def __init__(self, config: GPT2Config):
        super().__init__()
        eps = config.layer_norm_epsilon
        self.ln_1 = LayerNorm(config.n_embd, eps=eps)
        self.attn = CausalSelfAttention(config)
        self.ln_2 = LayerNorm(config.n_embd, eps=eps)
        self.mlp = MLP(config)

    def forward(self, x, train, generator):
        return self.rest(x, self.attend(x, train, generator), train,
                         generator)

    def attend(self, x, train, generator):
        return self.attn.attend(self.ln_1(x), train, generator)

    def rest(self, x, y, train, generator):
        """The block after the attention output y."""
        x = x + self.attn.project(y, train, generator)
        return x + self.mlp(self.ln_2(x), train, generator)

    def remat(self, x, train, generator, policy):
        """The block with its activations recomputed in the backward,
        keeping what ``policy`` saves (the JAX package's remat_policy):
        'nothing' the block's input; 'attn_out' the input and the attention
        output, two segments split there, so the backward re-runs
        LayerNorm, c_attn and the attention for the first and the rest for
        the second; 'dots' the input and three matmul outputs. Each segment
        replays the dropout it drew (``replayable``); every policy re-runs
        the attention's forward kernel, as the JAX model's does (its
        residuals are neither named nor dots)."""
        if policy == "attn_out":
            y = checkpoint(replayable(self.attend, generator), x, train,
                           use_reentrant=False)
            return checkpoint(replayable(self.rest, generator), x, y, train,
                              use_reentrant=False)
        kw = {"context_fn": _dots_contexts} if policy == "dots" else {}
        return checkpoint(replayable(self, generator), x, train,
                          use_reentrant=False, **kw)


class GPT2Model(nn.Module):
    """GPT-2 LM with the engine's model contract (models/api.py).

    Parameter names follow the JAX package's tree: ``wte``, ``wpe``,
    ``h.<i>.{ln_1,attn.c_attn,attn.c_proj,ln_2,mlp.c_fc,mlp.c_proj}``,
    ``ln_f``. ``generator`` seeds the initial weights (seed 0 if None).
    """

    def __init__(self, config: GPT2Config,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_supported(config)
        self.config = config
        e = config.n_embd
        self.wte = nn.Parameter(torch.empty(config.padded_vocab_size, e))
        self.wpe = nn.Parameter(torch.empty(config.n_positions, e))
        self.h = nn.ModuleList(Block(config) for _ in range(config.n_layer))
        self.ln_f = LayerNorm(e, eps=config.layer_norm_epsilon)
        self.init_weights(generator if generator is not None
                          else torch.Generator().manual_seed(0))

    def init_weights(self, generator: torch.Generator):
        """Every parameter from ``generator`` (a CPU generator, so a seed
        gives the same weights on any device): wte ~ N(0, 0.02), wpe ~
        N(0, 0.01), dense kernels lecun-normal, biases 0, LayerNorm 1/0."""
        with torch.no_grad():
            self.wte.copy_(torch.empty(self.wte.shape).normal_(
                generator=generator) * 0.02)
            self.wpe.copy_(torch.empty(self.wpe.shape).normal_(
                generator=generator) * 0.01)
        for m in self.modules():
            if isinstance(m, (Dense, LayerNorm)):
                m.reset_with(generator)

    def reference_leaf_specs(self):
        """This model's parameters in the JAX package's tree order, the
        layout of the engine's checkpoints (models/convert.py)."""
        return leaf_specs(gpt2_reference_tree(self.config))

    def reference_leaf_paths(self):
        """The JAX package's name of each ``reference_leaf_specs`` leaf."""
        return leaf_paths(gpt2_reference_tree(self.config))

    @staticmethod
    def tp_taken(path, ndim, stacked=False):
        """The dims of the JAX leaf ``path`` that its tensor-parallel spec
        takes; ZeRO shards the leaf along another (runtime/zero)."""
        return gpt2_tp_taken(path, ndim, stacked)

    def hidden(self, input_ids, train=False, generator=None):
        """Final-LayerNorm activations (B, S, E) in the compute dtype."""
        cfg = self.config
        dt = cfg.dtype
        S = input_ids.shape[1]
        x = F.embedding(input_ids, self.wte).to(dt) \
            + self.wpe[:S].to(dt)[None]
        if train and cfg.dropout > 0:
            x = dropout(x, generator, cfg.dropout)
        for block in self.h:
            if cfg.remat and torch.is_grad_enabled():
                x = block.remat(x, train, generator, cfg.remat_policy)
            else:
                x = block(x, train, generator)
        return self.ln_f(x)

    def forward(self, input_ids, train=False, generator=None):
        """Logits (B, S, vocab_size): the tied head at the padded width,
        pad columns sliced off."""
        x = self.hidden(input_ids, train, generator)
        logits = x @ self.wte.to(x.dtype).t()
        return logits[..., :self.config.vocab_size]

    def loss(self, batch, generator=None, train=True):
        """Next-token LM loss of ``batch`` {"input_ids", "labels"} (B, S)."""
        cfg = self.config
        ids = batch["input_ids"]
        labels = batch["labels"]
        if cfg.loss_chunk_tokens:
            x = self.hidden(ids, train, generator)
            return chunked_lm_cross_entropy(
                x[:, :-1], self.wte, labels[:, 1:],
                chunk_tokens=cfg.loss_chunk_tokens, ignore_index=-100,
                valid_vocab=cfg.vocab_size)
        logits = self.forward(ids, train, generator)
        return cross_entropy_loss(logits[:, :-1], labels[:, 1:],
                                  ignore_index=-100)

    def num_params(self):
        return sum(p.numel() for p in self.parameters())
