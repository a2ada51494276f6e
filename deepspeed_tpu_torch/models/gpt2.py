"""GPT-2 family: the flagship LM of the training path.

Port of deepspeed_tpu/models/gpt2.py: pre-LN decoder blocks, fused QKV
projection, attention through ops.transformer.functional (the flash kernels
for CUDA tensors), tied LM head sliced back to ``vocab_size``, and the
chunked LM loss. Parameters are fp32, cast to ``config.dtype`` where they
are used, as flax modules with ``dtype=`` do; under the engine at bf16 or
fp16 they are the engine's compute-dtype copy and the casts are no-ops.
``remat=True`` recomputes each block in the backward
(torch.utils.checkpoint) under ``remat_policy``.

Mixture-of-experts (``moe_num_experts > 0``): every ``moe_layer_freq``-th
block (the odd ones by default, GShard's alternation) swaps its MLP for
the MoE layer (moe/sharded_moe.py). Each block returns its output and its
aux loss (None for a dense block), so that a checkpointed block hands its
aux out of the recomputed segment; ``loss`` adds their sum when training,
as the JAX model adds its sown ``losses`` collection.

Sequence parallelism (``set_sequence_parallel``, called by the engine at
mesh ``seq`` N > 1): the model sees this rank's chunk of S/N positions
of each row (position embeddings from the chunk's offset, dropout masks
the chunk's slice of the whole sequence's), the attention runs through
Ulysses (parallel/ulysses.py) or, with ``attention_sp_mode="ring"``, ring
attention (parallel/ring_attention.py), and the loss pairs the chunk's
hidden states with the next positions' labels of the whole row (the last
rank's final position has none). At N = 1 nothing of this runs, whatever
the mode, as in the JAX model. In a world of several ranks the loss is the
whole micro-batch's (``set_loss_group``, models/api.py).

Tensor parallelism (``set_tensor_parallel``, called by the engine at mesh
``model`` M > 1; parallel/tensor_parallel.py): the layout of the JAX
model's ``param_partition_spec`` (``gpt2_tp_leaf_spec``), with the
collectives GSPMD would insert. Model rank m holds heads [m*H/M,
(m+1)*H/M): ``c_attn`` split by output (its heads' q, k and v columns),
``c_proj`` by input with its bias added after the all-reduce, ``c_fc``
by output and the MLP's ``c_proj`` by input, ``wte`` by vocabulary rows
(a vocabulary-parallel lookup, and the tied head's logits of the rank's
rows only, into a vocabulary-parallel loss); ``wpe`` and the LayerNorms
are replicated. The attention runs on the rank's heads with their offset
among all H, so the flash kernels' dropout hash draws the masks one
process draws over all heads.

Size table mirrors the reference perf harness configs
(tests/model/Megatron_GPT2/run_perf_test.py:18-84).
"""
import dataclasses
from typing import Any, Optional

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from deepspeed_tpu_torch.models.api import (chunked_lm_cross_entropy,
                                            cross_entropy_loss,
                                            pad_to_multiple)
from deepspeed_tpu_torch.models.convert import (gpt2_moe_block,
                                                gpt2_reference_tree,
                                                leaf_paths, leaf_specs,
                                                gpt2_tp_taken,
                                                tp_param_specs)
from deepspeed_tpu_torch.moe.sharded_moe import (MoE, moe_leaf_spec,
                                                 sum_moe_losses)
from deepspeed_tpu_torch.ops.transformer.functional import (
    gelu, scaled_dot_product_attention, seq_dropout)
from deepspeed_tpu_torch.parallel.ring_attention import ring_attention
from deepspeed_tpu_torch.parallel.tensor_parallel import (
    ColumnParallelDense, RowParallelDense, column_linear, shard_module,
    vocab_parallel_embedding)
from deepspeed_tpu_torch.parallel.ulysses import ulysses_attention
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
# attention are recomputed. In an MoE block the third matmul is the router
# (its logits feed the softmax's backward), and dots_saveable keeps the
# MoE's batched products too: the dispatched tokens, the experts' hidden
# and output products are kept (the backward reads each), the combine's
# output, which reaches only the residual add, is not.
_MATMULS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}
_BATCHED = torch.ops.aten.bmm.default
_DOTS_SAVED = 3
_MOE_BATCHED_SAVED = 3


def _dots_policy(moe=False):
    """The selective-checkpoint policy of one block call under 'dots': its
    first three matmul outputs are kept (and in an MoE block the first
    three batched products after them), everything else (LayerNorm, GeLU,
    the gating, the attention, whose kernels launch outside PyTorch's
    dispatcher) is recomputed, as under the JAX package's
    dots_saveable."""
    seen = [0, 0]

    def policy(ctx, op, *args, **kwargs):
        if op in _MATMULS:
            seen[0] += 1
            keep = seen[0] <= _DOTS_SAVED
        elif moe and op is _BATCHED and seen[0] >= _DOTS_SAVED:
            seen[1] += 1
            keep = seen[1] <= _MOE_BATCHED_SAVED
        else:
            keep = False
        return CheckpointPolicy.MUST_SAVE if keep \
            else CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def _dots_contexts(moe=False):
    return lambda: create_selective_checkpoint_contexts(
        _dots_policy(moe=True) if moe else _dots_policy())


def _check_supported(cfg: GPT2Config):
    # heterogeneous layers (dense/MoE alternation) cannot share one scanned
    # body: the JAX model asserts it
    assert not (cfg.moe_num_experts and cfg.scan_layers), \
        "moe_num_experts > 0 requires scan_layers=False"
    if cfg.remat and cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r} "
                         "(expected nothing|attn_out|dots)")


class CausalSelfAttention(nn.Module):
    # the seq group under sequence parallelism (set_sequence_parallel)
    sp_group = None

    def __init__(self, config: GPT2Config, name: str = "attn"):
        super().__init__()
        self.config = config
        e = config.n_embd
        self.c_attn = ColumnParallelDense(e, 3 * e, fused=3,
                                          name=f"{name}/c_attn")
        self.c_proj = RowParallelDense(e, e, name=f"{name}/c_proj")

    def forward(self, x, train, generator):
        return self.project(self.attend(x, train, generator), train,
                            generator)

    def attend(self, x, train, generator):
        """Attention of the LayerNorm output x: (B, S, E) before c_proj,
        the tensor the JAX model names 'attn_out'."""
        cfg = self.config
        B, S, _ = x.shape
        qkv = self.c_attn(x)
        # this model rank's heads (all of them at model 1)
        E = qkv.shape[-1] // 3
        H = E // cfg.head_dim
        q, k, v = qkv.split(E, dim=-1)

        def heads(t):
            return t.reshape(B, S, H, cfg.head_dim).transpose(1, 2)

        drop = train and cfg.dropout > 0
        kw = dict(causal=True, dropout_rng=generator if drop else None,
                  dropout_rate=cfg.dropout if drop else 0.0,
                  use_pallas=cfg.use_pallas_attention)
        tp = self.c_attn.group
        if tp is not None:
            kw.update(head_offset=tp.rank * H, total_heads=cfg.n_head)
        sp = self.sp_group
        if sp is None:
            y = scaled_dot_product_attention(heads(q), heads(k), heads(v),
                                             **kw)
        elif cfg.attention_sp_mode == "ring":
            # K/V blocks pass around the seq group: attention memory
            # O(S/N) per rank
            if drop:
                raise ValueError("attention_sp_mode='ring' has no dropout "
                                 "path")
            y = ring_attention(heads(q), heads(k), heads(v), group=sp,
                               causal=True)
        else:
            # the whole sequence of this rank's heads, between two
            # all-to-alls
            y = ulysses_attention(heads(q), heads(k), heads(v), group=sp,
                                  **kw)
        return y.transpose(1, 2).reshape(B, S, E)

    def project(self, y, train, generator):
        y = self.c_proj(y)
        if train and self.config.dropout > 0:
            y = seq_dropout(y, generator, self.config.dropout, self.sp_group)
        return y


class MLP(nn.Module):
    sp_group = None

    def __init__(self, config: GPT2Config, name: str = "mlp"):
        super().__init__()
        self.config = config
        self.c_fc = ColumnParallelDense(config.n_embd, 4 * config.n_embd,
                                        name=f"{name}/c_fc")
        self.c_proj = RowParallelDense(4 * config.n_embd, config.n_embd,
                                       name=f"{name}/c_proj")

    def forward(self, x, train, generator):
        h = self.c_proj(gelu(self.c_fc(x), approximate=True))
        if train and self.config.dropout > 0:
            h = seq_dropout(h, generator, self.config.dropout, self.sp_group)
        return h


class Block(nn.Module):
    """One pre-LN block; its FFN is the MoE layer (``moe``) when
    ``use_moe``, else the dense ``mlp``. Returns (output, aux): aux is the
    MoE layer's scaled aux loss, None for a dense block."""

    def __init__(self, config: GPT2Config, use_moe: bool = False,
                 index: int = 0):
        super().__init__()
        eps = config.layer_norm_epsilon
        self.use_moe = use_moe
        self.ln_1 = LayerNorm(config.n_embd, eps=eps)
        self.attn = CausalSelfAttention(config, name=f"h_{index}/attn")
        self.ln_2 = LayerNorm(config.n_embd, eps=eps)
        if use_moe:
            self.moe = MoE(config.n_embd, num_experts=config.moe_num_experts,
                           d_ff=4 * config.n_embd, k=config.moe_top_k,
                           capacity_factor=config.moe_capacity_factor,
                           aux_loss_coef=config.moe_aux_loss_coef,
                           dtype=config.dtype, name=f"h_{index}/moe")
        else:
            self.mlp = MLP(config, name=f"h_{index}/mlp")

    def forward(self, x, train, generator):
        return self.rest(x, self.attend(x, train, generator), train,
                         generator)

    def attend(self, x, train, generator):
        return self.attn.attend(self.ln_1(x), train, generator)

    def rest(self, x, y, train, generator):
        """The block after the attention output y: (output, aux)."""
        x = x + self.attn.project(y, train, generator)
        h = self.ln_2(x)
        if self.use_moe:
            f, aux = self.moe(h, train, generator)
            return x + f, aux
        return x + self.mlp(h, train, generator), None

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
        kw = {"context_fn": _dots_contexts(self.use_moe)} \
            if policy == "dots" else {}
        return checkpoint(replayable(self, generator), x, train,
                          use_reentrant=False, **kw)


class GPT2Model(nn.Module):
    """GPT-2 LM with the engine's model contract (models/api.py).

    Parameter names follow the JAX package's tree: ``wte``, ``wpe``,
    ``h.<i>.{ln_1,attn.c_attn,attn.c_proj,ln_2,mlp.c_fc,mlp.c_proj}``,
    ``ln_f``, and in an MoE block ``h.<i>.moe.router.weight`` and
    ``h.<i>.moe.experts.{w_in,b_in,w_out,b_out}`` in place of the mlp's.
    ``generator`` seeds the initial weights (seed 0 if None); ``device``
    holds the parameters from the start (default: the CPU).
    """
    sp_group = None
    loss_group = None
    # the model line under tensor parallelism (set_tensor_parallel)
    tp_group = None

    def __init__(self, config: GPT2Config,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        _check_supported(config)
        self.config = config
        e = config.n_embd
        self.wte = nn.Parameter(torch.empty(config.padded_vocab_size, e))
        self.wpe = nn.Parameter(torch.empty(config.n_positions, e))
        self.h = nn.ModuleList(
            Block(config, use_moe=gpt2_moe_block(config, i), index=i)
            for i in range(config.n_layer))
        self.ln_f = LayerNorm(e, eps=config.layer_norm_epsilon)
        if device is not None:
            self.to(device)
        self.init_weights(generator if generator is not None
                          else torch.Generator().manual_seed(0))

    def init_weights(self, generator: torch.Generator):
        """Every parameter from ``generator`` (a CPU generator, so a seed
        gives the same weights on any device, but the expert stacks:
        StackedExperts.reset_with): wte ~ N(0, 0.02), wpe ~ N(0, 0.01),
        dense kernels and the router lecun-normal, expert kernels N(0,
        0.02), biases 0, LayerNorm 1/0."""
        with torch.no_grad():
            self.wte.copy_(torch.empty(self.wte.shape).normal_(
                generator=generator) * 0.02)
            self.wpe.copy_(torch.empty(self.wpe.shape).normal_(
                generator=generator) * 0.01)
        for m in self.modules():
            if isinstance(m, (Dense, LayerNorm, MoE)):
                m.reset_with(generator)

    def set_sequence_parallel(self, group):
        """Run under sequence parallelism over ``group`` (the engine's seq
        group, parallel/mesh.py ``SequenceParallelGroup``; None: off).
        MoE blocks under it raise, as ROADMAP A15's residue."""
        if group is not None and self.config.moe_num_experts:
            raise NotImplementedError(
                "MoE blocks under sequence parallelism (mesh seq > 1) are "
                "not ported yet (ROADMAP A15)")
        if group is not None and self.config.attention_sp_mode != "ring":
            from deepspeed_tpu_torch.parallel.ulysses import check_heads

            check_heads(self.config.n_head, group)
        for m in self.modules():
            if isinstance(m, (GPT2Model, CausalSelfAttention, MLP)):
                m.sp_group = group

    def set_loss_group(self, group):
        """The whole micro-batch's loss over ``group`` (models/api.py)."""
        self.loss_group = group

    def set_tensor_parallel(self, group):
        """Keep this model rank's shards of the whole model's parameters
        and run tensor parallel over ``group`` (the engine's model line,
        parallel/mesh.py ``ModelParallelGroup``), module docstring. Call
        it once, on the whole model; MoE blocks raise (ROADMAP A7c)."""
        if group is None or group.size == 1:
            return
        cfg = self.config
        if cfg.moe_num_experts:
            raise NotImplementedError(
                "MoE blocks under tensor parallelism (mesh model > 1) are "
                "not ported yet (ROADMAP A7c)")
        if cfg.n_head % group.size or cfg.padded_vocab_size % group.size:
            raise ValueError(
                f"model={group.size} must divide n_head={cfg.n_head} and "
                f"the padded vocabulary {cfg.padded_vocab_size}")
        shard_module(self, group, tp_param_specs(self))
        self.tp_group = group

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

    @staticmethod
    def expert_dim(path):
        """The dim of the JAX leaf ``path`` that expert parallelism splits
        over ``data`` (an expert stack's E, by ``moe_leaf_spec``), or None;
        ZeRO leaves such a leaf alone, as ``zero_merge_spec`` does."""
        spec = moe_leaf_spec(path) if "moe" in path else None
        return spec.index("data") if spec and "data" in spec else None

    def hidden_and_aux(self, input_ids, train=False, generator=None):
        """Final-LayerNorm activations (B, S, E) in the compute dtype, and
        the sum of the MoE blocks' aux losses (None for a dense model).
        Under sequence parallelism ``input_ids`` is this rank's chunk."""
        cfg = self.config
        dt = cfg.dtype
        S = input_ids.shape[1]
        sp = self.sp_group
        off = 0 if sp is None else sp.offset(S)
        x = vocab_parallel_embedding(input_ids, self.wte, self.tp_group, dt) \
            + self.wpe[off:off + S].to(dt)[None]
        if train and cfg.dropout > 0:
            x = seq_dropout(x, generator, cfg.dropout, sp)
        losses = []
        for block in self.h:
            if cfg.remat and torch.is_grad_enabled():
                x, aux = block.remat(x, train, generator, cfg.remat_policy)
            else:
                x, aux = block(x, train, generator)
            losses.append(aux)
        aux = sum_moe_losses(losses) if cfg.moe_num_experts else None
        return self.ln_f(x), aux

    def hidden(self, input_ids, train=False, generator=None):
        """Final-LayerNorm activations (B, S, E) in the compute dtype."""
        return self.hidden_and_aux(input_ids, train, generator)[0]

    def forward(self, input_ids, train=False, generator=None):
        """Logits (B, S, vocab_size): the tied head at the padded width,
        pad columns sliced off. Under tensor parallelism, this model
        rank's columns of the padded vocabulary (B, S, V_pad / M)."""
        x = self.hidden(input_ids, train, generator)
        if self.tp_group is not None:
            return column_linear(x, self.wte.to(x.dtype), None,
                                 self.tp_group, "head_bwd")
        logits = x @ self.wte.to(x.dtype).t()
        return logits[..., :self.config.vocab_size]

    def loss(self, batch, generator=None, train=True):
        """Next-token LM loss of ``batch`` {"input_ids", "labels"} (B, S),
        and its metrics. With MoE blocks and ``train``, the blocks' aux
        losses are added and the metrics gain ``moe_aux_loss`` and ``loss``
        (the eval loss stays comparable to a dense model's)."""
        cfg = self.config
        ids = batch["input_ids"]
        labels = batch["labels"]
        x, aux = self.hidden_and_aux(ids, train, generator)
        sp = self.sp_group
        if sp is None:
            x, labels = x[:, :-1], labels[:, 1:]
        else:
            # this chunk's positions against the next positions' labels of
            # the whole row; the sequence's last position has none
            labels = sp.chunk(labels, 1, shift=1)
            x = x[:, :labels.shape[1]]
        # under tensor parallelism the head is the rank's vocabulary rows
        tp = self.tp_group
        if cfg.loss_chunk_tokens:
            loss, metrics = chunked_lm_cross_entropy(
                x, self.wte, labels, chunk_tokens=cfg.loss_chunk_tokens,
                ignore_index=-100, valid_vocab=cfg.vocab_size,
                group=self.loss_group, model_group=tp)
        else:
            if tp is None:
                logits = (x @ self.wte.to(x.dtype).t())[..., :cfg.vocab_size]
            else:
                logits = column_linear(x, self.wte.to(x.dtype), None, tp,
                                       "head_bwd")
            loss, metrics = cross_entropy_loss(
                logits, labels, ignore_index=-100, group=self.loss_group,
                model_group=tp, valid_vocab=cfg.vocab_size)
        if aux is not None and train:
            loss = loss + aux
            metrics = dict(metrics, moe_aux_loss=aux, loss=loss)
        return loss, metrics

    def num_params(self):
        return sum(p.numel() for p in self.parameters())
