"""BERT: the encoder model family built on DeepSpeedTransformerLayer.

Port of deepspeed_tpu/models/bert.py: word + position + token-type
embeddings in the compute dtype then LayerNorm, the encoder layers (plus a
final LayerNorm when pre-LN), the masked-LM head (transform, exact GELU,
LayerNorm, decoder tied to the word embeddings plus ``mlm_bias``, logits
sliced back to ``vocab_size``) and the NSP head (tanh pooler over [CLS]).
With a ``sparsity_config`` every layer attends through the block-sparse
path (long-sequence BERT). Parameters are fp32 and cast to
``config.dtype`` at use; under the engine at bf16 or fp16 they are the
engine's compute-dtype copy and the casts are no-ops.

Sequence parallelism (``set_sequence_parallel``, called by the engine at
mesh ``seq`` N > 1): the model sees this rank's chunk of S/N positions
(``input_ids`` and ``token_type_ids``; the attention mask and the labels
are the whole row's). Position embeddings start at the chunk's offset,
every layer attends through Ulysses, dense or block-sparse (its heads'
rows of the layout), and the NSP head reads [CLS] from seq rank 0, whose
copy alone takes the NSP loss's gradient. In a world of several ranks the
losses are the whole micro-batch's (``set_loss_group``, models/api.py):
MLM Σnll / Σcount, NSP the mean over every row.

Tensor parallelism (``set_tensor_parallel``, called by the engine at mesh
``model`` M > 1): the JAX model's ``param_partition_spec``. The encoder
layers hold their rank's heads (ops/transformer/transformer.py), the word
embeddings their rank's vocabulary rows (a vocabulary-parallel lookup),
and the MLM decoder, tied to them, computes the rank's vocabulary columns
into a vocabulary-parallel loss. ``mlm_bias``, replicated as the JAX spec
has it, is whole on every rank, which adds its columns' part; its
gradient, like the ``qkv`` and ``ffn_inter`` biases', is summed over the
model line (``tp_grad_ar``).
"""
import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.models.api import pad_to_multiple
from deepspeed_tpu_torch.parallel.mesh import from_first_rank, group_ratio
from deepspeed_tpu_torch.parallel.tensor_parallel import (
    column_linear, copy_to_model, shard_module, vocab_parallel_embedding,
    vocab_parallel_logz_gold)
from deepspeed_tpu_torch.models.convert import (bert_reference_tree,
                                                fused_local, leaf_paths,
                                                leaf_specs, bert_tp_taken,
                                                tp_param_specs)
from deepspeed_tpu_torch.ops.transformer.functional import gelu, seq_dropout
from deepspeed_tpu_torch.ops.transformer.transformer import (
    Dense, DeepSpeedTransformerConfig, DeepSpeedTransformerLayer, LayerNorm)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    # embedding / tied MLM-head vocab dim padded to a multiple of this
    # (30522 -> 30592); logits are sliced back, ids stay < vocab_size
    pad_vocab_multiple: int = 128
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    pre_layer_norm: bool = True
    dtype: Any = torch.bfloat16
    remat: bool = False
    # ops/sparse_attention SparsityConfig: every encoder layer attends
    # through the block-sparse path; parameters are the dense model's
    sparsity_config: Any = None

    @property
    def padded_vocab_size(self):
        return pad_to_multiple(self.vocab_size, self.pad_vocab_multiple)


BERT_SIZES = {
    "bert-base": dict(hidden_size=768, num_hidden_layers=12,
                      num_attention_heads=12, intermediate_size=3072),
    "bert-large": dict(hidden_size=1024, num_hidden_layers=24,
                       num_attention_heads=16, intermediate_size=4096),
}


def bert_config(name: str, **overrides) -> BertConfig:
    base = dict(BERT_SIZES[name])
    base.update(overrides)
    return BertConfig(**base)


def _layer_config(cfg: BertConfig) -> DeepSpeedTransformerConfig:
    return DeepSpeedTransformerConfig(
        hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size,
        heads=cfg.num_attention_heads,
        attn_dropout_ratio=cfg.attention_probs_dropout_prob,
        hidden_dropout_ratio=cfg.hidden_dropout_prob,
        num_hidden_layers=cfg.num_hidden_layers,
        initializer_range=cfg.initializer_range,
        layer_norm_eps=cfg.layer_norm_eps,
        bf16=cfg.dtype == torch.bfloat16,
        fp16=cfg.dtype == torch.float16,
        pre_layer_norm=cfg.pre_layer_norm,
        normalize_invertible=cfg.remat,
        sparsity_config=cfg.sparsity_config)


class BertEmbeddings(nn.Module):
    sp_group = None
    tp_group = None

    def __init__(self, config: BertConfig):
        super().__init__()
        self.config = config
        e = config.hidden_size
        self.word_embeddings = nn.Parameter(
            torch.empty(config.padded_vocab_size, e))
        self.position_embeddings = nn.Parameter(
            torch.empty(config.max_position_embeddings, e))
        self.token_type_embeddings = nn.Parameter(
            torch.empty(config.type_vocab_size, e))
        self.ln = LayerNorm(e, eps=config.layer_norm_eps)

    def reset_with(self, generator):
        with torch.no_grad():
            for table in (self.word_embeddings, self.position_embeddings,
                          self.token_type_embeddings):
                table.copy_(torch.empty(table.shape).normal_(
                    generator=generator) * self.config.initializer_range)
        self.ln.reset_with()

    def forward(self, input_ids, token_type_ids, train, generator=None):
        cfg = self.config
        dt = cfg.dtype
        s = input_ids.shape[1]
        off = 0 if self.sp_group is None else self.sp_group.offset(s)
        x = vocab_parallel_embedding(input_ids, self.word_embeddings,
                                     self.tp_group, dt,
                                     "embeddings/word_embeddings") \
            + self.position_embeddings[off:off + s].to(dt)[None] \
            + F.embedding(token_type_ids, self.token_type_embeddings).to(dt)
        x = self.ln(x)
        if train and cfg.hidden_dropout_prob > 0:
            x = seq_dropout(x, generator, cfg.hidden_dropout_prob,
                            self.sp_group)
        return x


class BertEncoder(nn.Module):
    def __init__(self, config: BertConfig):
        super().__init__()
        self.config = config
        layer_cfg = _layer_config(config)
        self.layers = nn.ModuleList(
            DeepSpeedTransformerLayer(layer_cfg,
                                      name=f"encoder/layer_{i}/body")
            for i in range(config.num_hidden_layers))
        self.final_ln = LayerNorm(config.hidden_size,
                                  eps=config.layer_norm_eps) \
            if config.pre_layer_norm else None

    def forward(self, x, attention_mask, train, generator=None):
        for layer in self.layers:
            x = layer(x, attention_mask, train=train, generator=generator)
        if self.final_ln is not None:
            x = self.final_ln(x)
        return x


class BertForPreTraining(nn.Module):
    """Embeddings -> encoder -> MLM head (tied decoder) + NSP head, with the
    engine's model contract (models/api.py).

    batch keys: input_ids, attention_mask (optional), token_type_ids
    (optional), masked_lm_labels (-1 or -100 = unmasked),
    next_sentence_label (optional). ``generator`` seeds the initial weights
    (seed 0 if None).
    """
    sp_group = None
    loss_group = None
    # the model line under tensor parallelism (set_tensor_parallel)
    tp_group = None

    def __init__(self, config: BertConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        e = config.hidden_size
        self.embeddings = BertEmbeddings(config)
        self.encoder = BertEncoder(config)
        self.mlm_transform = Dense(e, e)
        self.mlm_ln = LayerNorm(e, eps=config.layer_norm_eps)
        self.mlm_bias = nn.Parameter(torch.empty(config.padded_vocab_size))
        self.pooler = Dense(e, e)
        self.nsp = Dense(e, 2)
        self.init_weights(generator if generator is not None
                          else torch.Generator().manual_seed(0))

    def init_weights(self, generator: torch.Generator):
        """Every parameter from ``generator`` (a CPU generator, so a seed
        gives the same weights on any device): embeddings and the encoder's
        dense kernels ~ N(0, initializer_range) (the output projections
        scaled down by sqrt(2 * layers)), the heads' kernels lecun-normal,
        biases 0, LayerNorm 1/0."""
        self.embeddings.reset_with(generator)
        for layer in self.encoder.layers:
            layer.reset_with(generator)
        for m in (self.encoder.final_ln, self.mlm_ln):
            if m is not None:
                m.reset_with()
        for m in (self.mlm_transform, self.pooler, self.nsp):
            m.reset_with(generator)
        with torch.no_grad():
            self.mlm_bias.zero_()

    def set_sequence_parallel(self, group):
        """Run under sequence parallelism over ``group`` (the engine's seq
        group; None: off)."""
        if group is not None:
            from deepspeed_tpu_torch.parallel.ulysses import check_heads
            from deepspeed_tpu_torch.ops.transformer.transformer import \
                _EncoderBody

            check_heads(self.config.num_attention_heads, group)
        for m in self.modules():
            if isinstance(m, (BertForPreTraining, BertEmbeddings,
                              _EncoderBody)):
                m.sp_group = group

    def set_loss_group(self, group):
        """The whole micro-batch's losses over ``group`` (models/api.py)."""
        self.loss_group = group

    def set_tensor_parallel(self, group):
        """Keep this model rank's shards of the whole model's parameters
        and run tensor parallel over ``group`` (the engine's model line),
        module docstring. Call it once, on the whole model."""
        if group is None or group.size == 1:
            return
        cfg = self.config
        if cfg.num_attention_heads % group.size \
                or cfg.padded_vocab_size % group.size \
                or cfg.intermediate_size % group.size:
            raise ValueError(
                f"model={group.size} must divide the heads "
                f"({cfg.num_attention_heads}), the intermediate size "
                f"({cfg.intermediate_size}) and the padded vocabulary "
                f"({cfg.padded_vocab_size})")
        shard_module(self, group, tp_param_specs(self))
        self.embeddings.tp_group = self.tp_group = group

    def reference_leaf_specs(self):
        """This model's parameters in the JAX package's tree order, the
        layout of the engine's checkpoints (models/convert.py)."""
        return leaf_specs(bert_reference_tree(self.config))

    def reference_leaf_paths(self):
        """The JAX package's name of each ``reference_leaf_specs`` leaf."""
        return leaf_paths(bert_reference_tree(self.config))

    @staticmethod
    def tp_taken(path, ndim, stacked=False):
        """The dims of the JAX leaf ``path`` that its tensor-parallel spec
        takes; ZeRO shards the leaf along another (runtime/zero)."""
        return bert_tp_taken(path, ndim)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                train=False, generator=None):
        """(MLM logits (B, S, vocab_size), NSP logits (B, 2)) in the
        compute dtype. Under tensor parallelism the MLM logits are this
        model rank's columns of the padded vocabulary (B, S, V_pad / M)."""
        cfg = self.config
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        # HF-style extended additive mask: (B, 1, 1, S), 0 keep / -1e30 drop
        ext_mask = None
        if attention_mask is not None:
            ext_mask = (1.0 - attention_mask[:, None, None, :].float()) \
                * -1e30
        x = self.embeddings(input_ids, token_type_ids, train, generator)
        x = self.encoder(x, ext_mask, train, generator)

        h = gelu(self.mlm_transform(x), approximate=False)
        h = self.mlm_ln(h)
        tp = self.tp_group
        bias = self.mlm_bias
        if tp is not None:
            # this rank's vocabulary columns; the whole bias's gradient
            # is a partial on each rank, summed over the model line
            bias = fused_local(copy_to_model(bias, tp, "mlm_bias",
                                             "tp_grad_ar"),
                               (0, 1), tp.rank, tp.size)
            logits = column_linear(
                h, self.embeddings.word_embeddings.to(h.dtype),
                bias.to(h.dtype), tp, "mlm_head_bwd")
        else:
            logits = h @ self.embeddings.word_embeddings.to(h.dtype).t() \
                + bias.to(h.dtype)
            # drop the alignment pad columns before the loss/softmax
            logits = logits[..., :cfg.vocab_size]

        cls = x[:, 0]
        if self.sp_group is not None:
            # [CLS] lives on seq rank 0
            cls = from_first_rank(cls, self.sp_group, "cls")
        pooled = torch.tanh(self.pooler(cls))
        return logits, self.nsp(pooled)

    def loss(self, batch, generator=None, train=True):
        """Masked-LM loss over the labels >= 0 (plus the NSP loss when the
        batch has ``next_sentence_label``) -> (loss, metrics)."""
        logits, nsp_logits = self.forward(
            batch["input_ids"], batch.get("attention_mask"),
            batch.get("token_type_ids"), train=train, generator=generator)
        labels = batch["masked_lm_labels"]
        sp = self.sp_group
        if sp is not None:
            # this rank's chunk of the whole row's labels
            labels = sp.chunk(labels, 1)
        logits = logits.float()
        if self.tp_group is not None:
            logz, gold = vocab_parallel_logz_gold(
                logits, labels.clamp(min=0), self.tp_group, "mlm",
                valid_vocab=self.config.vocab_size)
        else:
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1,
                                labels.clamp(min=0)[..., None].long())[..., 0]
        mask = (labels >= 0).float()
        num = ((logz - gold) * mask).sum()
        group = self.loss_group
        mlm_loss = num / mask.sum().clamp(min=1.0) if group is None \
            else group_ratio(num, mask.sum(), group)
        total = mlm_loss
        metrics = {"mlm_loss": mlm_loss}
        if "next_sentence_label" in batch:
            nsp_logp = torch.log_softmax(nsp_logits.float(), dim=-1)
            nll = -torch.gather(
                nsp_logp, 1, batch["next_sentence_label"][:, None].long())
            if group is None:
                nsp_loss = nll.mean()
            else:
                # the mean over every row of the micro-batch: the rows of
                # a seq line count once, on its rank 0
                first = sp is None or sp.rank == 0
                nsp_loss = group_ratio(
                    nll.sum() if first else nll.sum().detach() * 0.0,
                    torch.tensor(float(nll.numel() if first else 0),
                                 device=nll.device), group)
            total = total + nsp_loss
            metrics["nsp_loss"] = nsp_loss
        metrics["loss"] = total
        return total, metrics

    def num_params(self):
        return sum(p.numel() for p in self.parameters())
