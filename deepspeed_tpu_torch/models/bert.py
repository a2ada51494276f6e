"""BERT: the encoder model family built on DeepSpeedTransformerLayer.

Port of deepspeed_tpu/models/bert.py: word + position + token-type
embeddings in the compute dtype then LayerNorm, the encoder layers (plus a
final LayerNorm when pre-LN), the masked-LM head (transform, exact GELU,
LayerNorm, decoder tied to the word embeddings plus ``mlm_bias``, logits
sliced back to ``vocab_size``) and the NSP head (tanh pooler over [CLS]).
With a ``sparsity_config`` every layer attends through the block-sparse
path (long-sequence BERT). Parameters are fp32 and cast to
``config.dtype`` at use.
"""
import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.models.api import pad_to_multiple
from deepspeed_tpu_torch.ops.transformer.functional import dropout, gelu
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
        x = F.embedding(input_ids, self.word_embeddings).to(dt) \
            + self.position_embeddings[:s].to(dt)[None] \
            + F.embedding(token_type_ids, self.token_type_embeddings).to(dt)
        x = self.ln(x)
        if train and cfg.hidden_dropout_prob > 0:
            x = dropout(x, generator, cfg.hidden_dropout_prob)
        return x


class BertEncoder(nn.Module):
    def __init__(self, config: BertConfig):
        super().__init__()
        self.config = config
        layer_cfg = _layer_config(config)
        self.layers = nn.ModuleList(DeepSpeedTransformerLayer(layer_cfg)
                                    for _ in range(config.num_hidden_layers))
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

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                train=False, generator=None):
        """(MLM logits (B, S, vocab_size), NSP logits (B, 2)) in the
        compute dtype."""
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
        logits = h @ self.embeddings.word_embeddings.to(h.dtype).t() \
            + self.mlm_bias.to(h.dtype)
        # drop the alignment pad columns before the loss/softmax
        logits = logits[..., :cfg.vocab_size]

        pooled = torch.tanh(self.pooler(x[:, 0]))
        return logits, self.nsp(pooled)

    def loss(self, batch, generator=None, train=True):
        """Masked-LM loss over the labels >= 0 (plus the NSP loss when the
        batch has ``next_sentence_label``) -> (loss, metrics)."""
        logits, nsp_logits = self.forward(
            batch["input_ids"], batch.get("attention_mask"),
            batch.get("token_type_ids"), train=train, generator=generator)
        labels = batch["masked_lm_labels"]
        logits = logits.float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            labels.clamp(min=0)[..., None].long())[..., 0]
        mask = (labels >= 0).float()
        mlm_loss = ((logz - gold) * mask).sum() / mask.sum().clamp(min=1.0)
        total = mlm_loss
        metrics = {"mlm_loss": mlm_loss}
        if "next_sentence_label" in batch:
            nsp_logp = torch.log_softmax(nsp_logits.float(), dim=-1)
            nsp_loss = -torch.gather(
                nsp_logp, 1,
                batch["next_sentence_label"][:, None].long()).mean()
            total = total + nsp_loss
            metrics["nsp_loss"] = nsp_loss
        metrics["loss"] = total
        return total, metrics

    def num_params(self):
        return sum(p.numel() for p in self.parameters())
