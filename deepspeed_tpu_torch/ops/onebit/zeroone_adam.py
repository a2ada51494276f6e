"""0/1 Adam: variance-frozen, 1-bit-compressed, locally-skipped Adam.

Port of deepspeed_tpu/ops/onebit/zeroone_adam.py (arxiv 2202.06009;
reference deepspeed/runtime/fp16/onebit/zoadam.py). After
``var_freeze_step`` optimizer steps the variance stops updating, and the
steps fall into rounds of k (``zeroone_cadence``, a pure function of the
completed-step count, so a resumed run re-derives its phase): k - 1
``local`` steps that only add the rank's gradient into ``local_accum``,
with no collective, then one ``sync`` step that sends ``(acc + g) / k``
through ``quantized_all_reduce`` (bits 1 or 8, flat or hierarchical)
and takes one update with ``lr * k`` and ``v`` frozen. ``warmup`` is a
dense Adam step without bias correction over the all-reduced mean (the
engine reduces it): the port's FusedAdam with ``bias_correction=False``.

State (``ZeroOneAdamState``): ``step`` (every phase counts), ``m`` and
``v`` per parameter; ``worker_error``, ``server_error`` and
``local_accum`` per leaf of the leaf map (the JAX tree's leaves), flat
in the leaf's layout: with the wire armed, this rank's row of the JAX
engine's leading ``(axis_size,)`` dim, the server residual its chunk of
the leaf padded to a multiple of w (``chunk``).
"""
import torch

from deepspeed_tpu_torch.ops.adam.fused_adam import (FusedAdam, decay,
                                                     keep_factor)
from deepspeed_tpu_torch.ops.onebit.onebit_adam import ParamLeaves
from deepspeed_tpu_torch.runtime.custom_collectives import (
    quantized_all_reduce, quantized_error_feedback)


def zeroone_cadence(completed_steps, var_freeze_step, local_steps=1,
                    local_step_scaler=0, local_step_clipper=16):
    """(phase, k_round) of the optimizer step taken after
    ``completed_steps`` finished ones (JAX zeroone_adam.py:38-70):
    ``('warmup', 1)`` before ``var_freeze_step``; after it, rounds of k
    steps, k - 1 'local' then one 'sync'; k starts at ``local_steps`` and
    doubles every ``local_step_scaler`` rounds (0: fixed), capped at
    ``local_step_clipper`` (0: uncapped)."""
    if completed_steps < var_freeze_step:
        return "warmup", 1
    j = completed_steps - var_freeze_step
    start, r = 0, 0
    while True:
        k = max(1, int(local_steps))
        if local_step_scaler:
            k = k * (2 ** (r // int(local_step_scaler)))
        if local_step_clipper:
            k = min(k, max(1, int(local_step_clipper)))
        if j < start + k:
            return ("sync" if j == start + k - 1 else "local"), k
        start += k
        r += 1


class ZeroOneAdam(FusedAdam):
    name = "zerooneadam"

    def __init__(self, lr=1e-3, var_freeze_step=100000, betas=(0.9, 0.999),
                 eps=1e-8, weight_decay=0.0, max_grad_norm=0.0,
                 local_steps=1, local_step_scaler=0, local_step_clipper=16,
                 bits=1, quantization_block_size=None, intra_size=0,
                 cuda_aware=False, comm_backend_name="nccl"):
        super().__init__(lr=lr, bias_correction=False, betas=betas,
                         eps=eps, adam_w_mode=True,
                         weight_decay=weight_decay)
        self.var_freeze_step = var_freeze_step
        self.local_steps = local_steps
        self.local_step_scaler = local_step_scaler
        self.local_step_clipper = local_step_clipper
        self.bits = bits
        self.quantization_block_size = quantization_block_size
        self.intra_size = intra_size
        self.comm_backend_name = comm_backend_name
        self.group = None
        self.leaf_map = None
        self.worker_error = None
        self.server_error = None
        self.local_accum = None

    def set_wire(self, group, leaf_map, intra_size=None):
        """Arm the wire: ``quantized_all_reduce`` over ``group`` (None:
        the local twin), leaf by leaf of ``leaf_map``, hierarchical over
        ``intra_size`` ranks when given. Before ``init_state``."""
        self.group = group
        self.leaf_map = leaf_map
        if intra_size is not None:
            self.intra_size = intra_size

    def cadence(self, completed_steps):
        return zeroone_cadence(completed_steps, self.var_freeze_step,
                               self.local_steps, self.local_step_scaler,
                               self.local_step_clipper)

    def chunk(self, n):
        """The server residual's length for an n-element leaf: the leaf
        padded to a multiple of w, over w (n with no wire)."""
        w = self.group.size if self.group is not None else 1
        return (n + (-n) % w) // w

    def init_state(self, params):
        super().init_state(params)
        if self.leaf_map is None:
            self.leaf_map = ParamLeaves(params)
        dev = params[0].device
        sizes = self.leaf_map.sizes
        self.worker_error = [torch.zeros(n, device=dev) for n in sizes]
        self.server_error = [torch.zeros(self.chunk(n), device=dev)
                             for n in sizes]
        self.local_accum = [torch.zeros(n, device=dev) for n in sizes]

    def leaf_state_lists(self):
        """The per-leaf state in ``ZeroOneAdamState`` order (after step,
        m and v): worker_error, server_error, local_accum."""
        return [self.worker_error, self.server_error, self.local_accum]

    def leaf_state_shapes(self):
        """Each per-leaf list's row shapes, as the JAX state holds a
        rank's row: the leaf's shape, the server residual's chunk where
        the wire is armed."""
        shapes = list(self.leaf_map.shapes)
        se = shapes if self.group is None else \
            [(self.chunk(n),) for n in self.leaf_map.sizes]
        return [shapes, se, shapes]

    @torch.no_grad()
    def update(self, params, grads, lr=None, scale=1.0, skip=None,
               phase="warmup", k_round=1):
        """One step of ``phase`` ('warmup' | 'local' | 'sync', from
        ``cadence``), ``k_round`` the round's length. ``skip`` (sync and
        warmup) leaves params, moments and residuals as they were and, at
        a sync, drops the round's accumulation."""
        if phase not in ("warmup", "sync", "local"):
            raise ValueError(f"unknown 0/1 Adam phase {phase!r}")
        if self.m is None:
            self.init_state(params)
        if phase == "warmup":
            return super().update(params, grads, lr=lr, scale=scale,
                                  skip=skip)
        lm = self.leaf_map
        g = [x.float() for x in grads]
        if scale != 1.0:
            g = torch._foreach_mul(g, 1.0 / scale)
        if phase == "local":
            # accumulate only: params, m and v untouched, no collective
            for j, acc in enumerate(self.local_accum):
                acc.add_(lm.gather(j, g))
            self.step = self.step + 1
            return None
        lr = self.lr if lr is None else lr
        keep = keep_factor(skip, self.step.device)
        b1 = self.beta1
        g_avg = [torch.empty_like(m) for m in self.m]
        self._sync_round(g, g_avg, float(k_round), skip)
        torch._foreach_mul_(self.m, decay(keep, b1))
        torch._foreach_mul_(g_avg, keep)
        torch._foreach_add_(self.m, g_avg, alpha=1.0 - b1)
        upd = torch._foreach_sqrt(self.v)
        torch._foreach_add_(upd, self.eps)
        upd = torch._foreach_div(self.m, upd)
        if self.weight_decay > 0:
            torch._foreach_add_(upd, params, alpha=self.weight_decay)
        torch._foreach_mul_(upd, keep)
        # one update stands in for the k steps of its round
        torch._foreach_add_(params, upd, alpha=-lr * k_round)
        for acc in self.local_accum:
            acc.zero_()
        self.step = self.step + keep.int()
        return None

    def _sync_round(self, g, g_avg, k, skip):
        """Each leaf's round gradient ``(local_accum + g) / k`` through the
        wire into ``g_avg`` (per parameter), the residuals carried (kept
        where ``skip``, whose round sends zeros)."""
        lm, group = self.leaf_map, self.group
        bs = self.quantization_block_size
        w = group.size if group is not None else 1
        for j, n in enumerate(lm.sizes):
            flat = (self.local_accum[j] + lm.gather(j, g)) / k
            if skip is not None:
                # the round's accumulation is poisoned: nothing of it
                # travels
                flat.masked_fill_(skip, 0.0)
            we, se = self.worker_error[j], self.server_error[j]
            if group is None:
                out, nwe, nse = quantized_error_feedback(
                    flat, we, se, bits=self.bits, block_size=bs)
            else:
                pad = (-n) % w
                out, nwe, nse = quantized_all_reduce(
                    torch.nn.functional.pad(flat, (0, pad)), group,
                    bits=self.bits, block_size=bs,
                    intra_size=self.intra_size,
                    worker_error=torch.nn.functional.pad(we, (0, pad)),
                    server_error=se, name=lm.names[j], elements=n)
                out, nwe = out[:n], nwe[:n]
            if skip is not None:
                nwe = torch.where(skip, we, nwe)
                nse = torch.where(skip, se, nse)
            lm.scatter(j, g_avg, out)
            we.copy_(nwe)
            se.copy_(nse)
