"""Model contract consumed by the engine, and the LM loss heads.

Port of deepspeed_tpu/models/api.py. A model is an ``nn.Module`` exposing

  - ``init_weights(generator)``  (re)initialize every parameter (fp32) from a
    ``torch.Generator``; the engine calls it with its ``seed``
  - ``loss(batch, generator=None, train=True) -> (loss, metrics_dict)``

  - ``set_loss_group(group)`` (optional): in a world of several ranks the
    engine hands the model the group over which a micro-batch's rows
    (data) and positions (seq) are spread; the model's loss is then the
    whole micro-batch's, Σnll / Σcount over the group (parallel/mesh.py
    ``group_ratio``), the same on every rank, as the JAX engine's, not
    the mean of the ranks' means, and the engine sums the ranks'
    gradients. A model without it is averaged over the data axis.
  - ``set_tensor_parallel(group)`` (optional): at mesh ``model`` M > 1 the
    engine hands the model its ``model`` line; the model keeps its rank's
    shards (models/convert.py ``tp_param_specs``, from ``tp_taken``) and
    runs the collectives of parallel/tensor_parallel.py. A model without
    it cannot run at M > 1.

``param_partition_spec`` describes a model's tensor-parallel layout as
the JAX package's contract method does (the JAX leaves' PartitionSpecs,
here tuples of axis names), and ``replicated_spec`` the layout of a model
without one.
"""
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.parallel.mesh import MODEL_AXIS, group_ratio
from deepspeed_tpu_torch.parallel.tensor_parallel import (
    vocab_parallel_chunked_nll, vocab_parallel_logz_gold)


def replicated_spec(module):
    """{JAX leaf path: ()} of every leaf: nothing split over ``model``."""
    return {path: () for path in _leaf_paths(module)}


def param_partition_spec(module):
    """{JAX leaf path: spec} of the model's tensor-parallel layout, each
    spec a tuple with ``"model"`` at the dims the JAX package's
    ``param_partition_spec`` gives the axis and None elsewhere (the
    leaf's rank long; () for a replicated leaf). A model without
    ``tp_taken`` is replicated."""
    if not hasattr(module, "tp_taken"):
        return replicated_spec(module)
    out = {}
    for path, (names, transposed) in zip(module.reference_leaf_paths(),
                                         module.reference_leaf_specs()):
        stacked = isinstance(names, tuple)
        first = names[0] if stacked else names
        ndim = dict(module.named_parameters())[first].dim() + int(stacked)
        taken = module.tp_taken(path, ndim, stacked)
        out[path] = tuple(MODEL_AXIS if d in taken else None
                          for d in range(ndim)) if taken else ()
    return out


def _leaf_paths(module):
    if hasattr(module, "reference_leaf_paths"):
        return list(module.reference_leaf_paths())
    return [n for n, _ in module.named_parameters()]


def pad_to_multiple(n: int, multiple: int) -> int:
    """Ceil `n` to a multiple (vocab-dim alignment); 0/None multiple returns
    n unchanged."""
    return -(-n // multiple) * multiple if multiple else n


def cross_entropy_loss(logits, labels, ignore_index: Optional[int] = None,
                       group=None, model_group=None,
                       valid_vocab: Optional[int] = None):
    """Token-level softmax cross entropy in fp32; returns (mean_loss,
    metrics). Ignored labels count neither in the sum nor the mean.
    ``group``: the loss group, the mean over its ranks' tokens.
    ``model_group``: ``logits`` are this model rank's vocabulary columns
    (parallel/tensor_parallel.py ``vocab_parallel_logz_gold``; columns
    at or beyond ``valid_vocab`` masked)."""
    logits = logits.float()
    safe = labels if ignore_index is None else \
        torch.where(labels == ignore_index, torch.zeros_like(labels), labels)
    if model_group is not None:
        logz, gold = vocab_parallel_logz_gold(logits, safe, model_group,
                                              valid_vocab=valid_vocab)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, safe[..., None].long())[..., 0]
    nll = logz - gold
    if ignore_index is not None:
        mask = (labels != ignore_index).float()
        num, den = (nll * mask).sum(), mask.sum()
    else:
        num, den = nll.sum(), torch.tensor(float(nll.numel()),
                                           device=nll.device)
    if group is not None:
        loss = group_ratio(num, den, group)
    elif ignore_index is not None:
        loss = num / den.clamp(min=1.0)
    else:
        loss = nll.mean()
    return loss, {"loss": loss}


def _chunk_nll(x, y, m, wte, valid_vocab):
    """(sum of masked nll, count) of one token chunk against the tied head;
    logits are fp32 softmax inputs, pad vocab columns forced to -1e9."""
    logits = (x @ wte.to(x.dtype).t()).float()               # (chunk, V)
    if valid_vocab is not None and valid_vocab < wte.shape[0]:
        logits[:, valid_vocab:] = -1e9
    logz = torch.logsumexp(logits, dim=-1)
    safe = torch.where(m > 0, y, torch.zeros_like(y))
    gold = torch.gather(logits, -1, safe[:, None].long())[:, 0]
    return ((logz - gold) * m).sum(), m.sum()


def chunked_lm_cross_entropy(hidden, wte, labels, chunk_tokens: int = 2048,
                             ignore_index: Optional[int] = -100,
                             valid_vocab: Optional[int] = None,
                             group=None, model_group=None):
    """LM head + softmax cross entropy without the full logits tensor.

    Walks token chunks; each chunk's (chunk, vocab) logits are recomputed
    in the backward (torch.utils.checkpoint) instead of being saved, so the
    extra memory is O(chunk_tokens * vocab), not O(tokens * vocab).

    hidden: (..., E) activations entering the head (already shifted);
    wte: (V, E) tied embedding; labels: (...) targets aligned to hidden;
    valid_vocab: columns >= valid_vocab (alignment padding) are masked.
    group: the loss group: the mean over its ranks' tokens.
    model_group: ``wte`` is this model rank's vocabulary rows and
    ``hidden`` is replicated over the line; each chunk's loss is
    vocabulary-parallel (parallel/tensor_parallel.py
    ``vocab_parallel_chunked_nll``: its backward on the rank's logits,
    the hidden states' gradient summed over the line).
    """
    E = hidden.shape[-1]
    x = hidden.reshape(-1, E)
    y = labels.reshape(-1)
    n = x.shape[0]
    chunk = max(1, min(chunk_tokens, n))
    if ignore_index is not None:
        valid = (y != ignore_index).float()
    else:
        valid = torch.ones(n, device=x.device)
    if model_group is not None:
        nll_sum, count = vocab_parallel_chunked_nll(
            x, wte, y, valid, chunk, model_group, valid_vocab)
        loss = group_ratio(nll_sum, count, group) if group is not None \
            else nll_sum / count.clamp(min=1.0)
        return loss, {"loss": loss}
    nll_sum = torch.zeros((), device=x.device)
    count = torch.zeros((), device=x.device)
    for i in range(0, n, chunk):
        s, c = checkpoint(_chunk_nll, x[i:i + chunk], y[i:i + chunk],
                          valid[i:i + chunk], wte, valid_vocab,
                          use_reentrant=False)
        nll_sum = nll_sum + s
        count = count + c
    loss = group_ratio(nll_sum, count, group) if group is not None \
        else nll_sum / count.clamp(min=1.0)
    return loss, {"loss": loss}
