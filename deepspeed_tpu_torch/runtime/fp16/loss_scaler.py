"""Static and dynamic loss scaling.

Port of deepspeed_tpu/runtime/fp16/loss_scaler.py (reference semantics:
deepspeed/runtime/fp16/loss_scaler.py:56-221): ``DynamicLossScaler``
doubles every ``scale_window`` overflow-free iterations, halves on
overflow, with ``delayed_shift`` hysteresis and a ``min_scale`` floor.

The engine's form is ``LossScaleState``, four 0-dim tensors on the device,
updated by ``update_loss_scale`` with ``torch.where`` where the JAX package
takes ``lax.cond``: the overflow flag stays a device tensor and the step
never waits on the host for it. The host classes ``LossScaler`` /
``DynamicLossScaler`` keep the reference API for config plumbing and tests.
"""
from typing import NamedTuple

import torch

INITIAL_LOSS_SCALE = "init_scale"
SCALE_WINDOW = "scale_window"
DELAYED_SHIFT = "delayed_shift"
MIN_LOSS_SCALE = "min_scale"


class LossScaleState(NamedTuple):
    """Device-side scaler state (all 0-dim tensors)."""
    loss_scale: torch.Tensor          # f32
    cur_iter: torch.Tensor            # i32
    last_overflow_iter: torch.Tensor  # i32
    cur_hysteresis: torch.Tensor      # i32


def make_loss_scale_state(init_scale, delayed_shift=1, device=None):
    return LossScaleState(
        loss_scale=torch.tensor(float(init_scale), dtype=torch.float32,
                                device=device),
        cur_iter=torch.tensor(0, dtype=torch.int32, device=device),
        last_overflow_iter=torch.tensor(-1, dtype=torch.int32,
                                        device=device),
        cur_hysteresis=torch.tensor(int(delayed_shift), dtype=torch.int32,
                                    device=device))


def update_loss_scale(state: LossScaleState, overflow, *, scale_factor=2.0,
                      scale_window=1000, min_scale=1.0, delayed_shift=1,
                      consecutive_hysteresis=False, dynamic=True):
    """The reference's update_scale (loss_scaler.py:151) on device tensors:
    both branches are computed and ``overflow`` (a bool tensor) picks."""
    one = torch.ones_like(state.cur_iter)
    if not dynamic:
        return LossScaleState(state.loss_scale, state.cur_iter + one,
                              state.last_overflow_iter, state.cur_hysteresis)
    shift = torch.full_like(state.cur_hysteresis, int(delayed_shift))

    # overflow: halve (down to min_scale) once the hysteresis is used up
    shift_now = state.cur_hysteresis <= 1
    ov_scale = torch.where(
        shift_now,
        torch.clamp(state.loss_scale / scale_factor, min=float(min_scale)),
        state.loss_scale)
    ov_hyst = torch.where(shift_now, state.cur_hysteresis,
                          state.cur_hysteresis - one)

    # no overflow: double at every scale_window-th clean iteration
    if scale_window > 0:
        window_hit = torch.remainder(
            state.cur_iter - state.last_overflow_iter, scale_window) == 0
    else:
        window_hit = torch.zeros_like(shift_now)
    ok_scale = torch.where(window_hit, state.loss_scale * scale_factor,
                           state.loss_scale)
    ok_hyst = shift if consecutive_hysteresis \
        else torch.where(window_hit, shift, state.cur_hysteresis)

    return LossScaleState(
        loss_scale=torch.where(overflow, ov_scale, ok_scale),
        cur_iter=state.cur_iter + one,
        last_overflow_iter=torch.where(overflow, state.cur_iter,
                                       state.last_overflow_iter),
        cur_hysteresis=torch.where(overflow, ov_hyst, ok_hyst))


# ---------------------------------------------------------------------------
# Host-facing classes (API parity with reference loss_scaler.py)
# ---------------------------------------------------------------------------

class LossScalerBase:
    def __init__(self, cur_scale):
        self.cur_scale = cur_scale

    @property
    def loss_scale(self):
        return self.cur_scale

    def scale_gradient(self, grads):
        return [g * self.loss_scale for g in grads]

    def update_scale(self, overflow):
        pass

    def backward(self, loss):
        return loss * self.loss_scale


class LossScaler(LossScalerBase):
    """Static loss scale (reference :56-77): never reports overflow."""

    def __init__(self, scale=1):
        super().__init__(scale)

    def has_overflow(self, params):
        return False


class DynamicLossScaler(LossScalerBase):
    """Dynamic scaler (reference :79-221)."""

    def __init__(self, init_scale=2 ** 32, scale_factor=2., scale_window=1000,
                 min_scale=1, delayed_shift=1, consecutive_hysteresis=False):
        super().__init__(init_scale)
        self.cur_iter = 0
        self.last_overflow_iter = -1
        self.scale_factor = scale_factor
        self.scale_window = scale_window
        self.min_scale = min_scale
        self.delayed_shift = delayed_shift
        self.cur_hysteresis = delayed_shift
        self.consecutive_hysteresis = consecutive_hysteresis

    def update_scale(self, overflow):
        if overflow:
            if self.delayed_shift == 1 or self.cur_hysteresis == 1:
                self.cur_scale = max(self.cur_scale / self.scale_factor,
                                     self.min_scale)
            else:
                self.cur_hysteresis -= 1
            self.last_overflow_iter = self.cur_iter
        else:
            if self.consecutive_hysteresis:
                self.cur_hysteresis = self.delayed_shift
            if (self.cur_iter - self.last_overflow_iter) \
                    % self.scale_window == 0:
                if not self.consecutive_hysteresis:
                    self.cur_hysteresis = self.delayed_shift
                self.cur_scale *= self.scale_factor
        self.cur_iter += 1


def CreateLossScaler(static_loss_scale=0, dynamic_scale_args=None):
    """Factory matching the engine's config semantics: loss_scale == 0 =>
    dynamic."""
    if static_loss_scale and static_loss_scale > 0:
        return LossScaler(scale=static_loss_scale)
    if dynamic_scale_args:
        return DynamicLossScaler(
            init_scale=dynamic_scale_args.get(INITIAL_LOSS_SCALE, 2 ** 32),
            scale_window=dynamic_scale_args.get(SCALE_WINDOW, 1000),
            delayed_shift=dynamic_scale_args.get(DELAYED_SHIFT, 1),
            min_scale=dynamic_scale_args.get(MIN_LOSS_SCALE, 1))
    return DynamicLossScaler()
