"""Plain SGD with momentum, nesterov and weight decay over fp32 master
parameters.

Port of deepspeed_tpu/ops/adam/sgd.py (the reference passes
torch.optim.SGD through; the JAX package makes it a first-class fused
update): ``_foreach`` ops over the parameter list. ``SGDState(step,
momentum_buf)``: the step count is a device int32; ``skip`` leaves params
and state as they were, decided on the device with the update in place
(``keep_factor``).
"""
import torch

from deepspeed_tpu_torch.ops.adam.fused_adam import (decay, keep_factor,
                                                     masked_grads)


class SGD:
    name = "sgd"

    def __init__(self, lr=1e-3, momentum=0.0, weight_decay=0.0,
                 nesterov=False):
        self.lr = lr
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.nesterov = nesterov
        self.step = None
        self.momentum_buf = None

    def init_state(self, params):
        self.step = torch.zeros((), dtype=torch.int32,
                                device=params[0].device)
        self.momentum_buf = [torch.zeros_like(p, dtype=torch.float32)
                             for p in params]

    def state_lists(self):
        """The state's tensor lists in ``SGDState(step, momentum_buf)``
        order."""
        return [self.momentum_buf]

    @torch.no_grad()
    def update(self, params, grads, lr=None, scale=1.0, skip=None):
        if self.momentum_buf is None:
            self.init_state(params)
        lr = self.lr if lr is None else lr
        keep = keep_factor(skip, self.step.device)
        g = masked_grads(grads, params, keep, scale, self.weight_decay)
        d = g
        if self.momentum > 0:
            buf = self.momentum_buf
            torch._foreach_mul_(buf, decay(keep, self.momentum))
            torch._foreach_add_(buf, g)
            d = torch._foreach_add(g, buf, alpha=self.momentum) \
                if self.nesterov else buf
            d = torch._foreach_mul(d, keep)
        torch._foreach_add_(params, d, alpha=-lr)
        self.step = self.step + keep.int()
