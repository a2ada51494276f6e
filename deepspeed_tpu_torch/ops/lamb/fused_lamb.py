"""Fused LAMB over fp32 master parameters.

Port of deepspeed_tpu/ops/lamb/fused_lamb.py (reference:
csrc/lamb/fused_lamb_cuda_kernel.cu + ops/lamb/fused_lamb.py:12-189): NVLAMB
with a per-tensor trust ratio ||p|| / ||update|| clamped to [min_coeff,
max_coeff] (1 where either norm is 0). As in the JAX package, plain tensor
code: ``_foreach`` ops over the parameter list, the per-tensor norms from
``_foreach_norm``. The step count is a device int32 (``LambState.step``);
``skip`` leaves params and state as they were, decided on the device with
the update in place (``keep_factor``).

Under ZeRO the lists hold this rank's shards of some tensors
(``set_partition``): the trust ratio still takes the norms of the whole
tensors, the shards' squared norms summed over the data-parallel group in
one all-reduce.
"""
import torch

from deepspeed_tpu_torch.ops.adam.fused_adam import (bias_corrections,
                                                     decay, keep_factor,
                                                     masked_grads)


class FusedLamb:
    name = "lamb"

    def __init__(self, lr=1e-3, bias_correction=True, betas=(0.9, 0.999),
                 eps=1e-8, eps_inside_sqrt=False, weight_decay=0.0,
                 max_grad_norm=0.0, max_coeff=10.0, min_coeff=0.01,
                 amsgrad=False):
        if amsgrad:
            raise ValueError("amsgrad not supported (parity with reference "
                             "fused_lamb.py)")
        self.lr = lr
        self.bias_correction = bias_correction
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.eps_inside_sqrt = eps_inside_sqrt
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.max_coeff = max_coeff
        self.min_coeff = min_coeff
        self.step = None
        self.m = None
        self.v = None
        self._group = None
        self._partitioned = None

    def set_partition(self, group, partitioned):
        """``partitioned[i]``: whether parameter i of the lists is this
        rank's shard of a tensor split over ``group`` (the engine's
        ``DataParallelGroup``)."""
        if any(partitioned):
            self._group = group
            self._partitioned = list(partitioned)

    def init_state(self, params):
        self.step = torch.zeros((), dtype=torch.int32,
                                device=params[0].device)
        self.m = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        self.v = [torch.zeros_like(p, dtype=torch.float32) for p in params]

    def state_lists(self):
        """The state's tensor lists in ``LambState(step, m, v)`` order."""
        return [self.m, self.v]

    @torch.no_grad()
    def update(self, params, grads, lr=None, scale=1.0, skip=None):
        if self.m is None:
            self.init_state(params)
        lr = self.lr if lr is None else lr
        keep = keep_factor(skip, self.step.device)
        b1, b2 = self.beta1, self.beta2
        bc1, bc2 = bias_corrections(self.step + 1, b1, b2,
                                    self.bias_correction)
        g = masked_grads(grads, params, keep, scale)
        torch._foreach_mul_(self.m, decay(keep, b1))
        torch._foreach_add_(self.m, g, alpha=1.0 - b1)
        torch._foreach_mul_(self.v, decay(keep, b2))
        torch._foreach_addcmul_(self.v, g, g, value=1.0 - b2)
        m_hat = torch._foreach_div(self.m, bc1)
        v_hat = torch._foreach_div(self.v, bc2)
        if self.eps_inside_sqrt:
            torch._foreach_add_(v_hat, self.eps)
            torch._foreach_sqrt_(v_hat)
        else:
            torch._foreach_sqrt_(v_hat)
            torch._foreach_add_(v_hat, self.eps)
        upd = torch._foreach_div(m_hat, v_hat)
        if self.weight_decay > 0:
            torch._foreach_add_(upd, params, alpha=self.weight_decay)
        # per-tensor trust ratio (the CUDA kernel's two-pass reductions),
        # zero on a skipped step
        w_norm = torch.stack(torch._foreach_norm(params))
        u_norm = torch.stack(torch._foreach_norm(upd))
        if self._partitioned is not None:
            w_norm, u_norm = self._whole_norms(w_norm, u_norm)
        trust = torch.where((w_norm > 0) & (u_norm > 0),
                            torch.clamp(w_norm / u_norm, self.min_coeff,
                                        self.max_coeff),
                            torch.ones_like(w_norm))
        torch._foreach_mul_(upd, list((trust * keep).unbind()))
        torch._foreach_add_(params, upd, alpha=-lr)
        self.step = self.step + keep.int()

    def _whole_norms(self, w_norm, u_norm):
        """The norms of the whole tensors where the lists hold shards: the
        shards' squared norms summed over the group."""
        if not torch.is_tensor(self._partitioned):
            self._partitioned = torch.tensor(self._partitioned,
                                             device=w_norm.device)
        mask = self._partitioned
        sq = torch.stack([w_norm, u_norm]).square() * mask
        self._group.all_reduce(sq)
        return (torch.where(mask, sq[0].sqrt(), w_norm),
                torch.where(mask, sq[1].sqrt(), u_norm))
