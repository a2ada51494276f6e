"""Fused Adam/AdamW over fp32 master parameters.

Port of deepspeed_tpu/ops/adam/fused_adam.py (reference:
csrc/adam/multi_tensor_adam.cu + ops/adam/fused_adam.py:15-182). The JAX
update is plain jnp that XLA fuses; here it is PyTorch's multi-tensor
``_foreach_*`` ops, which update the whole parameter list in a few launches
per op, in place.

Semantics kept from the JAX package: the ``bias_correction`` flag, the
fused unscale by ``scale``, AdamW decay added to the update before the lr
multiply (``p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``), L2 mode
adding ``wd * p`` to the gradient, and ``amsgrad`` rejected. The step
count is a device int32, as ``AdamState.step`` is, so the bias corrections
and a skipped step (``skip``) are decided on the device, with the update
still in place (``keep_factor``).
"""
import torch


def keep_factor(skip, device):
    """1.0, or 0.0 where ``skip`` (a bool device scalar; None: no skip), as
    an fp32 device scalar. An optimizer multiplies its gradients and its
    update by it and makes each decay factor the identity with ``decay``,
    all in place: a skipped step leaves params and state as they were,
    decided on the device as ``lax.cond`` decides it in the JAX engine.
    The gradients of a skipped step must be finite: the engine zeroes an
    overflowed accumulator first."""
    if skip is None:
        return torch.ones((), device=device)
    return (~skip).float()


def decay(keep, beta):
    """``beta``, or 1.0 on a skipped step, as an fp32 device scalar (both
    exact: a moment times it keeps its value)."""
    return torch.where(keep > 0, beta, 1.0)


def masked_grads(grads, params, keep, scale=1.0, weight_decay=0.0):
    """The fp32 gradients divided by ``scale`` (the fused unscale), plus
    ``weight_decay * p`` (L2), times ``keep``: zero on a skipped step."""
    g = [x.float() for x in grads]
    if scale != 1.0:
        g = torch._foreach_mul(g, 1.0 / scale)
    if weight_decay > 0:
        g = torch._foreach_add(g, params, alpha=weight_decay)
    return torch._foreach_mul(g, keep)


def bias_corrections(step, beta1, beta2, enabled):
    """(1 - beta1^step, 1 - beta2^step) as fp32 device scalars (the JAX
    package's ``1.0 - b ** step.astype(float32)``), or (1, 1)."""
    if not enabled:
        return 1.0, 1.0
    t = step.float()
    return 1.0 - torch.pow(beta1, t), 1.0 - torch.pow(beta2, t)


class FusedAdam:
    """Adam/AdamW over fp32 master params; grads are cast to fp32."""

    name = "adam"

    def __init__(self, lr=1e-3, bias_correction=True, betas=(0.9, 0.999),
                 eps=1e-8, adam_w_mode=True, weight_decay=0.0, amsgrad=False):
        if amsgrad:
            raise ValueError("amsgrad not supported (parity with reference "
                             "fused_adam.py:61)")
        self.lr = lr
        self.bias_correction = bias_correction
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.adam_w_mode = adam_w_mode
        self.weight_decay = weight_decay
        self.step = None
        self.m = None
        self.v = None

    def init_state(self, params):
        """Zero moments shaped like ``params`` (fp32), step 0."""
        self.step = torch.zeros((), dtype=torch.int32,
                                device=params[0].device)
        self.m = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        self.v = [torch.zeros_like(p, dtype=torch.float32) for p in params]

    def state_lists(self):
        """The state's tensor lists in ``AdamState(step, m, v)`` order."""
        return [self.m, self.v]

    @torch.no_grad()
    def update(self, params, grads, lr=None, scale=1.0, skip=None):
        """One step over the lists ``params`` and ``grads`` (divided by
        ``scale``, the fused unscale), in place. ``skip``, a bool device
        scalar, leaves params and state as they were (``keep_factor``)."""
        if self.m is None:
            self.init_state(params)
        lr = self.lr if lr is None else lr
        keep = keep_factor(skip, self.step.device)
        b1, b2 = self.beta1, self.beta2
        bc1, bc2 = bias_corrections(self.step + 1, b1, b2,
                                    self.bias_correction)
        wd = self.weight_decay
        g = masked_grads(grads, params, keep, scale,
                         0.0 if self.adam_w_mode else wd)
        torch._foreach_mul_(self.m, decay(keep, b1))
        torch._foreach_add_(self.m, g, alpha=1.0 - b1)
        torch._foreach_mul_(self.v, decay(keep, b2))
        torch._foreach_addcmul_(self.v, g, g, value=1.0 - b2)
        denom = torch._foreach_div(self.v, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(self.m, bc1)
        torch._foreach_div_(upd, denom)
        if self.adam_w_mode and wd > 0:
            torch._foreach_add_(upd, params, alpha=wd)
        torch._foreach_mul_(upd, keep)
        torch._foreach_add_(params, upd, alpha=-lr)
        self.step = self.step + keep.int()
