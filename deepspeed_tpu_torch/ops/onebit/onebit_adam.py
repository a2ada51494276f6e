"""1-bit Adam: Adam whose variance freezes, after which the momentum is
exchanged over the error-compensated 1-bit wire.

Port of deepspeed_tpu/ops/onebit/onebit_adam.py (reference
deepspeed/runtime/fp16/onebit_adam.py:18-374):

- warmup (the optimizer steps up to ``freeze_step``): an exact Adam step
  without bias correction over the all-reduced mean gradient (the engine
  reduces it), ``p -= lr * (m / (sqrt(v) + eps) + wd * p)``: the port's
  FusedAdam with ``bias_correction=False``, op for op;
- frozen: ``v`` is held; ``m = b1 * m + (1 - b1) * g`` over the rank's
  own gradient goes through ``compressed_allreduce`` over the wire's
  group, each leaf flattened in the JAX tree's layout and padded to a
  multiple of 8 * w (the pad's residuals dropped every step), or, with
  no group, through ``quantize_with_error_feedback``; the result is the
  new ``m``.

State (``OnebitAdamState``): ``step``, ``m`` and ``v`` per parameter (as
FusedAdam's), ``worker_error`` and ``server_error`` per leaf of the leaf
map (``leaf_map``: the JAX tree's leaves; by default each parameter its
own leaf), flat in the leaf's layout: this rank's row of the JAX
engine's leading ``(axis_size,)`` dim when the wire is armed.
"""
import torch

from deepspeed_tpu_torch.ops.adam.fused_adam import (FusedAdam, decay,
                                                     keep_factor,
                                                     masked_grads)
from deepspeed_tpu_torch.runtime.custom_collectives import (
    compressed_allreduce, quantize_with_error_feedback)


class ParamLeaves:
    """The default leaf map: each parameter its own leaf, flattened in
    its own layout. A leaf map has ``names``, ``sizes``, ``gather(j,
    tensors)`` (leaf j flat, a copy where the layout differs) and
    ``scatter(j, tensors, flat)`` (written back in place)."""

    def __init__(self, params, names=None):
        self.names = list(names) if names is not None \
            else [f"p{i}" for i in range(len(params))]
        self.shapes = [tuple(p.shape) for p in params]
        self.sizes = [p.numel() for p in params]

    def gather(self, j, tensors):
        return tensors[j].reshape(-1)

    def scatter(self, j, tensors, flat):
        tensors[j].copy_(flat.view(tensors[j].shape))


class OnebitAdam(FusedAdam):
    name = "onebitadam"

    def __init__(self, lr=1e-3, freeze_step=100000, betas=(0.9, 0.999),
                 eps=1e-8, weight_decay=0.0, max_grad_norm=0.0,
                 bias_correction=True, amsgrad=False, cuda_aware=False,
                 eps_inside_sqrt=False, comm_backend_name="nccl"):
        if amsgrad:
            raise ValueError("1-bit Adam does not support the AMSGrad "
                             "variant.")
        # the update has no bias correction in either phase (JAX
        # onebit_adam.py ignores the flag, as the reference does)
        super().__init__(lr=lr, bias_correction=False, betas=betas,
                         eps=eps, adam_w_mode=True,
                         weight_decay=weight_decay)
        self.freeze_step = freeze_step
        # 'none' keeps the dense path even where the engine would arm the
        # wire
        self.comm_backend_name = comm_backend_name
        self.group = None
        self.leaf_map = None
        self.worker_error = None
        self.server_error = None

    def set_wire(self, group, leaf_map):
        """Arm the wire: the compressed all-reduce over ``group`` (a
        parallel.mesh.DataParallelGroup, or None for the local twin),
        leaf by leaf of ``leaf_map``. Before ``init_state``."""
        self.group = group
        self.leaf_map = leaf_map

    def _quantum(self):
        return 8 * self.group.size if self.group is not None else 1

    def init_state(self, params):
        super().init_state(params)
        if self.leaf_map is None:
            self.leaf_map = ParamLeaves(params)
        dev = params[0].device
        self.worker_error = [torch.zeros(n, device=dev)
                             for n in self.leaf_map.sizes]
        self.server_error = [torch.zeros(n, device=dev)
                             for n in self.leaf_map.sizes]

    def leaf_state_lists(self):
        """The per-leaf state in ``OnebitAdamState`` order:
        worker_error, server_error."""
        return [self.worker_error, self.server_error]

    def leaf_state_shapes(self):
        """Each per-leaf list's row shapes: the leaf's shape."""
        return [list(self.leaf_map.shapes)] * 2

    def frozen_at(self, step):
        """Whether optimizer step ``step`` (1-based) runs frozen."""
        return step > self.freeze_step

    @torch.no_grad()
    def update(self, params, grads, lr=None, scale=1.0, skip=None,
               frozen=None):
        """One step. ``frozen`` (None: from the step count, read on the
        host) selects the phase; ``skip``, a bool device scalar, leaves
        params and state as they were."""
        if self.m is None:
            self.init_state(params)
        if frozen is None:
            frozen = self.frozen_at(int(self.step) + 1)
        if not frozen:
            return super().update(params, grads, lr=lr, scale=scale,
                                  skip=skip)
        lr = self.lr if lr is None else lr
        keep = keep_factor(skip, self.step.device)
        b1 = self.beta1
        g = masked_grads(grads, params, keep, scale)
        # a skipped step leaves m as it was here (keep = 0), and the
        # compression keeps it so
        torch._foreach_mul_(self.m, decay(keep, b1))
        torch._foreach_add_(self.m, g, alpha=1.0 - b1)
        self.compress_momentum(skip)
        upd = torch._foreach_sqrt(self.v)
        torch._foreach_add_(upd, self.eps)
        upd = torch._foreach_div(self.m, upd)
        if self.weight_decay > 0:
            torch._foreach_add_(upd, params, alpha=self.weight_decay)
        torch._foreach_mul_(upd, keep)
        torch._foreach_add_(params, upd, alpha=-lr)
        self.step = self.step + keep.int()

    def compress_momentum(self, skip=None):
        """``m`` through the wire, leaf by leaf, in place, with the
        residuals carried (kept as they were where ``skip``)."""
        lm, group = self.leaf_map, self.group
        q = self._quantum()
        for j, n in enumerate(lm.sizes):
            flat = lm.gather(j, self.m)
            we, se = self.worker_error[j], self.server_error[j]
            if group is None:
                out, nwe, nse = quantize_with_error_feedback(flat, we, se)
            else:
                pad = (-n) % q
                padded = [torch.nn.functional.pad(t, (0, pad))
                          for t in (flat, we, se)]
                out, nwe, nse = compressed_allreduce(
                    *padded, group, name=lm.names[j], elements=n)
                out, nwe, nse = out[:n], nwe[:n], nse[:n]
            if skip is not None:
                out = torch.where(skip, flat, out)
                nwe = torch.where(skip, we, nwe)
                nse = torch.where(skip, se, nse)
            lm.scatter(j, self.m, out)
            we.copy_(nwe)
            se.copy_(nse)
