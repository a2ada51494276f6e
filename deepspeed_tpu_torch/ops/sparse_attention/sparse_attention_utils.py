"""Helpers for using block-sparse attention with real models.

Port of deepspeed_tpu/ops/sparse_attention/sparse_attention_utils.py
(reference deepspeed/ops/sparse_attention/sparse_attention_utils.py:13-225):
pad and unpad sequences to a block multiple, extend position embeddings,
and swap a model's self-attention for the block-sparse path. The sparse and
dense BERT share their parameters (the same QKV and output projections), so
the swap builds the port's ``BertForPreTraining`` anew with the
SparsityConfig in its config and the old parameters, the position rows
tiled to the new length.
"""
import copy
import dataclasses

import torch
import torch.nn.functional as F


class SparseAttentionUtils:
    @staticmethod
    def extend_position_embedding(pos_embedding, max_position: int):
        """Tile an existing (P, E) position-embedding table to cover
        max_position rows (reference :25-59)."""
        p = pos_embedding.shape[0]
        if max_position <= p:
            raise ValueError(f"max_position {max_position} must exceed the "
                             f"current {p}")
        reps = -(-max_position // p)
        return pos_embedding.repeat(reps, 1)[:max_position]

    @staticmethod
    def update_tokenizer_model_max_length(tokenizer, max_position: int):
        """Reference :68-83: point the tokenizer at the extended length."""
        tokenizer.model_max_length = max_position
        if hasattr(tokenizer, "init_kwargs"):
            tokenizer.init_kwargs["model_max_length"] = max_position
        return tokenizer

    @staticmethod
    def replace_model_self_attention_with_sparse_self_attention(
            model, max_position: int, sparsity_config=None):
        """Reference :85-121: a new ``BertForPreTraining`` on the device of
        ``model`` whose encoder layers attend through the block-sparse path
        and whose position table covers ``max_position`` rows (the old rows
        tiled); every other parameter is the old one."""
        from deepspeed_tpu_torch.models.bert import BertForPreTraining
        from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import \
            FixedSparsityConfig

        if not isinstance(model, BertForPreTraining):
            raise TypeError(
                "replace_model_self_attention_with_sparse_self_attention "
                f"supports models/bert.BertForPreTraining, got {type(model)}"
                ": build other families with sparsity_config directly")
        if sparsity_config is None:
            sparsity_config = FixedSparsityConfig(
                num_heads=model.config.num_attention_heads)
        state = model.state_dict()
        key = "embeddings.position_embeddings"
        if max_position > state[key].shape[0]:
            state[key] = SparseAttentionUtils.extend_position_embedding(
                state[key], max_position)
        elif max_position < state[key].shape[0]:
            raise ValueError(f"max_position {max_position} is below the "
                             f"model's {state[key].shape[0]} positions")
        cfg = dataclasses.replace(
            model.config, sparsity_config=sparsity_config,
            max_position_embeddings=max_position,
            attention_probs_dropout_prob=0.0)
        new_model = BertForPreTraining(cfg).to(state[key].device)
        new_model.load_state_dict(state)
        return new_model

    @staticmethod
    def replace_self_attention_layer_with_sparse_self_attention_layer(
            layer_config, sparsity_config):
        """Reference :123-150, layer granularity: a DeepSpeedTransformerConfig
        whose attention core is the block-sparse path (same parameter
        names, so existing layer parameters load unchanged)."""
        new_cfg = copy.copy(layer_config)
        new_cfg.sparsity_config = sparsity_config
        new_cfg.attn_dropout_ratio = 0.0
        return new_cfg

    @staticmethod
    def pad_to_block_size(block_size: int, input_ids=None, attention_mask=None,
                          token_type_ids=None, position_ids=None,
                          inputs_embeds=None, pad_token_id: int = 0,
                          model_embeddings=None):
        """Pad the sequence dim (axis 1) up to a block multiple.

        Returns (pad_len, input_ids, attention_mask, token_type_ids,
        position_ids, inputs_embeds), the reference's tuple (reference
        :61-147). Padded attention-mask entries are 0, so padding never
        attends or is attended to.
        """
        ref = input_ids if input_ids is not None else inputs_embeds
        if ref is None:
            raise ValueError("need input_ids or inputs_embeds")
        seq_len = ref.shape[1]
        pad_len = (-seq_len) % block_size
        if pad_len == 0:
            return (0, input_ids, attention_mask, token_type_ids,
                    position_ids, inputs_embeds)

        def pad(x, value=0):
            if x is None:
                return None
            widths = [0, 0] * (x.dim() - 2) + [0, pad_len]
            return F.pad(x, widths, value=value)

        input_ids = pad(input_ids, pad_token_id)
        attention_mask = pad(attention_mask, 0)
        token_type_ids = pad(token_type_ids, 0)
        if position_ids is not None:
            # continue positions monotonically so extended tables index fine
            extra = torch.arange(seq_len, seq_len + pad_len,
                                 device=position_ids.device,
                                 dtype=position_ids.dtype)
            extra = extra.expand(*position_ids.shape[:-1], pad_len)
            position_ids = torch.cat([position_ids, extra], dim=1)
        if inputs_embeds is not None:
            b, _, e = inputs_embeds.shape
            if model_embeddings is None and pad_token_id != 0:
                raise ValueError("padding embeddings needs the embedding "
                                 "table")
            if model_embeddings is not None:
                pad_block = model_embeddings[pad_token_id].to(
                    inputs_embeds.dtype).expand(b, pad_len, e)
            else:
                pad_block = inputs_embeds.new_zeros((b, pad_len, e))
            inputs_embeds = torch.cat([inputs_embeds, pad_block], dim=1)
        return (pad_len, input_ids, attention_mask, token_type_ids,
                position_ids, inputs_embeds)

    @staticmethod
    def unpad_sequence_output(pad_len: int, sequence_output):
        """Strip the padding added by pad_to_block_size (reference :149-163)."""
        if pad_len == 0:
            return sequence_output
        return sequence_output[:, :-pad_len]
