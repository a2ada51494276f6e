"""GPT-2 as a PipelineModule: the flagship model in pipeline form.

Port of deepspeed_tpu/models/gpt2_pipe.py: embedding -> n_layer blocks ->
final LayerNorm -> LM head, as LayerSpecs. The head is tied to the
embedding (a TiedLayerSpec reusing GPT2Embed's ``wte``, the reference's
canonical tied-weight example, module.py:71-83) or, with ``untied_head``,
its own matrix (the zb-h1 schedule cannot host tied weights). Each block
is models/gpt2.py's ``Block``, so its attention is the flash kernels on
the card; MoE blocks sit where GPT2Model puts them, and return their aux
loss. The loss is the cross entropy of the full logits (the JAX pipeline
module's ``loss_fn``), a plain matrix product outside any kernel.

Parameters are fp32, cast to ``config.dtype`` where they are used, as in
GPT2Model; their names are the JAX pipeline module's tree
(``tied_embed.wte``, ``layer_01.block.attn.c_attn.weight``, ...; each
layer's ``reference_tree`` maps them onto the JAX leaves).
"""
import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.models.api import cross_entropy_loss
from deepspeed_tpu_torch.models.convert import (_gpt2_block_spec,
                                                _norm_spec, gpt2_moe_block,
                                                gpt2_tp_taken)
from deepspeed_tpu_torch.models.gpt2 import Block, GPT2Config, GPT2Model
from deepspeed_tpu_torch.moe.sharded_moe import MoE
from deepspeed_tpu_torch.ops.transformer.functional import seq_dropout
from deepspeed_tpu_torch.ops.transformer.transformer import Dense, LayerNorm
from deepspeed_tpu_torch.runtime.pipe.module import (LayerSpec,
                                                     PipelineModule,
                                                     TiedLayerSpec)


class _GPT2Layer(nn.Module):
    """The GPT-2 layers' leaf rules (models/gpt2.py): the dims the JAX
    tensor-parallel spec takes, which ZeRO leaves alone, and an expert
    stack's expert dim."""
    tp_taken = staticmethod(gpt2_tp_taken)
    expert_dim = staticmethod(GPT2Model.expert_dim)


class GPT2Embed(_GPT2Layer):
    """Token + position embeddings; owns the tied ``wte`` matrix."""

    def __init__(self, config: GPT2Config):
        super().__init__()
        self.config = config
        self.wte = nn.Parameter(torch.empty(config.padded_vocab_size,
                                            config.n_embd))
        self.wpe = nn.Parameter(torch.empty(config.n_positions,
                                            config.n_embd))

    def init_weights(self, generator):
        """wte ~ N(0, 0.02), wpe ~ N(0, 0.01), as GPT2Model."""
        with torch.no_grad():
            self.wte.copy_(torch.empty(self.wte.shape).normal_(
                generator=generator) * 0.02)
            self.wpe.copy_(torch.empty(self.wpe.shape).normal_(
                generator=generator) * 0.01)

    def reference_tree(self, prefix):
        return {"wte": (f"{prefix}wte", False),
                "wpe": (f"{prefix}wpe", False)}

    def forward(self, input_ids, train=False, generator=None):
        cfg = self.config
        dt = cfg.dtype
        S = input_ids.shape[1]
        x = F.embedding(input_ids, self.wte).to(dt) \
            + self.wpe[:S].to(dt)[None]
        if train and cfg.dropout > 0:
            x = seq_dropout(x, generator, cfg.dropout)
        return x


class GPT2LMHead(_GPT2Layer):
    """UNTIED LM head: its own vocab projection matrix (named ``wte`` so
    that the tied head's checkpoints line up shape-wise)."""

    def __init__(self, config: GPT2Config):
        super().__init__()
        self.config = config
        self.wte = nn.Parameter(torch.empty(config.padded_vocab_size,
                                            config.n_embd))

    def init_weights(self, generator):
        with torch.no_grad():
            self.wte.copy_(torch.empty(self.wte.shape).normal_(
                generator=generator) * 0.02)

    def reference_tree(self, prefix):
        return {"wte": (f"{prefix}wte", False)}

    def forward(self, x, train=False, generator=None):
        return _logits(x, self.wte, self.config.vocab_size)


class GPT2BlockLayer(_GPT2Layer):
    """One GPT-2 block (models/gpt2.py ``Block``); an MoE block returns
    (output, aux loss)."""

    def __init__(self, config: GPT2Config, use_moe: bool = False,
                 index: int = 0):
        super().__init__()
        self.has_aux = use_moe
        self.block = Block(config, use_moe=use_moe, index=index)

    def init_weights(self, generator):
        for m in self.modules():
            if isinstance(m, (Dense, LayerNorm, MoE)):
                m.reset_with(generator)

    def reference_tree(self, prefix):
        return {"block": _gpt2_block_spec(f"{prefix}block", self.has_aux)}

    def forward(self, x, train=False, generator=None):
        y, aux = self.block(x, train, generator)
        return (y, aux) if self.has_aux else y


class GPT2FinalNorm(_GPT2Layer):
    def __init__(self, config: GPT2Config):
        super().__init__()
        self.ln_f = LayerNorm(config.n_embd, eps=config.layer_norm_epsilon)

    def init_weights(self, generator):
        self.ln_f.reset_with(generator)

    def reference_tree(self, prefix):
        return {"ln_f": _norm_spec(f"{prefix}ln_f")}

    def forward(self, x, train=False, generator=None):
        return self.ln_f(x)


def _logits(x, wte, vocab_size):
    """Logits at the padded vocab width, pad columns sliced off."""
    return (x @ wte.to(x.dtype).t())[..., :vocab_size]


def _tied_lm_head(module, x):
    """forward_fn of the tied head: logits against the shared ``wte``."""
    return _logits(x, module.wte, module.config.vocab_size)


def gpt2_pipeline_module(config: GPT2Config, partition_method="parameters",
                         activation_checkpoint_interval=0,
                         untied_head=False):
    """The LayerSpec pipeline of a GPT-2 config. MoE configs
    (``moe_num_experts > 0``) alternate dense and MoE blocks as GPT2Model
    does; each MoE block's load-balance loss joins the objective in the
    chunk that holds it.

    untied_head: give the LM head its OWN matrix instead of tying it to
    the input embedding: tied weights block the zb-h1 schedule (deferred
    wgrads against the cross-stage tied-gradient reduction)."""
    if untied_head:
        specs = [LayerSpec(GPT2Embed, config)]
    else:
        specs = [TiedLayerSpec("embed", GPT2Embed, config)]
    for i in range(config.n_layer):
        specs.append(LayerSpec(GPT2BlockLayer, config,
                               use_moe=gpt2_moe_block(config, i), index=i))
    specs.append(LayerSpec(GPT2FinalNorm, config))
    if untied_head:
        specs.append(LayerSpec(GPT2LMHead, config))
    else:
        specs.append(TiedLayerSpec("embed", GPT2Embed, config,
                                   forward_fn=_tied_lm_head))

    def loss_fn(logits, batch):
        return cross_entropy_loss(logits[:, :-1], batch["labels"][:, 1:],
                                  ignore_index=-100)

    return PipelineModule(
        specs, loss_fn=loss_fn, partition_method=partition_method,
        input_fn=lambda batch: batch["input_ids"],
        activation_checkpoint_interval=activation_checkpoint_interval)
