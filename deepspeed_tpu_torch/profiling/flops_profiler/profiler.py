"""Flops profiler — a FLOP count of a callable replayed on meta tensors.

Port of deepspeed_tpu/profiling/flops_profiler/profiler.py (reference
behavior: deepspeed/profiling/flops_profiler/profiler.py:33-520, which
wraps torch.nn.functional to count flops per module). Where the JAX
package reads XLA's ``cost_analysis()`` of the compiled function, this
port counts: ``analyze_fn`` replays the callable on meta tensors under
the telemetry's FLOP count (telemetry/mfu.py: the aten matmuls plus each
hand-written attention kernel's own formula), and times the real call
with CUDA events over ``n_timing_runs`` (wall time off CUDA). Nothing is
instrumented on the step path.

Per-component breakdown: ``breakdown(fns)`` profiles a dict of
name -> (fn, args) pairs the same way; utilization is flops/sec against
a supplied or detected peak.
"""
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from deepspeed_tpu_torch.utils.logging import logger


def _fmt(value, units=None, precision=2):
    """Human units (reference number_to_string/flops_to_string :556-607)."""
    if value is None:
        return "n/a"
    for suffix, scale in [("T", 1e12), ("G", 1e9), ("M", 1e6), ("K", 1e3)]:
        if units == suffix or (units is None and value >= scale):
            return f"{value / scale:.{precision}f} {suffix}"
    return f"{value:.{precision}f} "


def number_to_string(num, precision=2):
    return _fmt(num, precision=precision)


def flops_to_string(flops, units=None, precision=2):
    return _fmt(flops, units, precision) + "FLOPS"


def params_to_string(params_num, units=None, precision=2):
    return _fmt(params_num, units, precision).rstrip()


def macs_to_string(macs, units=None, precision=2):
    return _fmt(macs, units, precision) + "MACs"


def duration_to_string(duration, units=None, precision=2):
    if duration is None:
        return "n/a"
    if duration > 1:
        return f"{duration:.{precision}f} s"
    if duration > 1e-3:
        return f"{duration * 1e3:.{precision}f} ms"
    return f"{duration * 1e6:.{precision}f} us"


def analyze_fn(fn: Callable, *args) -> Dict[str, Any]:
    """FLOPs of ``fn(*args)`` counted on meta tensors of the arguments'
    shapes and dtypes (telemetry/mfu.py ``fn_flops``): {'flops',
    'matmul_flops', 'kernel_flops', 'kernel_launches', 'bytes_accessed'
    (None: not counted)}. ``fn`` runs without gradient; a training step
    is ``FlopsProfiler.profile_step``."""
    from deepspeed_tpu_torch.telemetry.mfu import fn_flops

    return fn_flops(fn, args)


def _time_calls(fn, n_timing_runs, device):
    """Mean seconds of ``fn()`` over ``n_timing_runs`` calls after one
    warm-up: CUDA events on a CUDA device, the wall clock elsewhere."""
    fn()
    if device is not None and torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n_timing_runs):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / n_timing_runs
    t0 = time.perf_counter()
    for _ in range(n_timing_runs):
        fn()
    return (time.perf_counter() - t0) / n_timing_runs


class FlopsProfiler:
    """Profile the engine's (or any) jitted step.

    Reference API kept: start_profile/stop_profile/end_profile,
    get_total_flops/params/duration, print_model_profile.
    """

    def __init__(self, model=None, engine=None, peak_flops: Optional[float] = None):
        self.model = model
        self.engine = engine
        self.peak_flops = peak_flops
        self._flops = None
        self._params = None
        self._duration = None
        self._cost = {}
        self._comm = None
        self._started = None

    # --- measurement --------------------------------------------------
    def profile_fn(self, fn, *args, n_timing_runs=3, device=None):
        """Count (on meta tensors) and, with ``n_timing_runs``, time
        ``fn(*args)`` (no gradient) on ``device`` (default: the first
        tensor argument's)."""
        self._cost = analyze_fn(fn, *args)
        self._flops = self._cost.get("flops")
        if n_timing_runs:
            if device is None:
                device = next((a.device for a in args
                               if isinstance(a, torch.Tensor)), None)

            def call():
                with torch.no_grad():
                    fn(*args)

            self._duration = _time_calls(call, n_timing_runs, device)
        return self._cost

    def profile_step(self, module, batch, shapes=None):
        """Count one training micro step of ``module`` on ``batch`` (its
        loss forward and backward, telemetry/mfu.py ``loss_step_flops``,
        whose ``shapes`` this passes on); the engine times the real step
        itself (``_maybe_profile``)."""
        from deepspeed_tpu_torch.telemetry.mfu import loss_step_flops

        self._cost = loss_step_flops(module, batch, shapes)
        self._flops = self._cost.get("flops")
        return self._cost

    def profile_params(self, params):
        """Count the elements of ``params`` (tensors, or a module)."""
        if isinstance(params, torch.nn.Module):
            params = params.parameters()
        self._params = sum(int(p.numel()) for p in params)
        return self._params

    def breakdown(self, named_fns: Dict[str, Tuple[Callable, tuple]]):
        """Per-component costs: {name: cost_dict}."""
        return {name: analyze_fn(fn, *args)
                for name, (fn, args) in named_fns.items()}

    def profile_comm(self, report: Optional[Dict[str, Any]]):
        """Attach an analytic comm-volume report (the dict produced by
        DeepSpeedEngine.comm_volume_report / runtime.comm_accounting):
        per-step wire bytes show up in print_model_profile alongside the
        compute numbers."""
        self._comm = report
        return report

    # --- reference-API surface ---------------------------------------
    def start_profile(self, ignore_list=None):
        self._started = time.perf_counter()

    def stop_profile(self):
        if self._started is not None:
            self._duration = time.perf_counter() - self._started

    def end_profile(self):
        self._started = None

    def reset_profile(self):
        self._flops = self._params = self._duration = None
        self._cost = {}
        self._comm = None

    def get_total_flops(self, as_string=False):
        return flops_to_string(self._flops) if as_string else (self._flops or 0)

    def get_total_params(self, as_string=False):
        return params_to_string(self._params) if as_string \
            else (self._params or 0)

    def get_total_duration(self, as_string=False):
        return duration_to_string(self._duration) if as_string \
            else (self._duration or 0)

    def print_model_profile(self, profile_step=1, module_depth=-1,
                            top_modules=3, detailed=True):
        lines = [
            "-------------------------- DeepSpeed Flops Profiler "
            "--------------------------",
            f"Profile step:                   {profile_step}",
            f"Params:                         "
            f"{params_to_string(self._params) if self._params else 'n/a'}",
            f"Fwd/step FLOPs:                 "
            f"{flops_to_string(self._flops) if self._flops else 'n/a'}",
            f"Step latency:                   "
            f"{duration_to_string(self._duration)}",
        ]
        if self._flops and self._duration:
            achieved = self._flops / self._duration
            lines.append(f"Achieved:                       "
                         f"{flops_to_string(achieved)}")
            if self.peak_flops:
                lines.append(f"Utilization:                    "
                             f"{100 * achieved / self.peak_flops:.1f}% of "
                             f"{flops_to_string(self.peak_flops)} peak")
        for key in ("bytes accessed", "bytes_accessed", "temp_bytes",
                    "output_bytes"):
            if self._cost.get(key):
                lines.append(f"{key:<31} {_fmt(self._cost[key])}B")
        if self._comm:
            lines.append(f"Comm bytes/step (analytic):     "
                         f"{_fmt(self._comm['total_bytes_per_step'])}B")
            lines.append(f"  grad exchange:                "
                         f"{_fmt(self._comm['grad_exchange_bytes_per_step'])}B")
            red = self._comm.get("grad_reduction_vs_fp32")
            if red:
                lines.append(f"  vs fp32 dense exchange:       {red:.2f}x")
            if self._comm.get("inter_bytes_per_step"):
                lines.append(
                    f"  cross-group (inter) bytes:    "
                    f"{_fmt(self._comm['inter_bytes_per_step'])}B")
        lines.append("-" * 78)
        for line in lines:
            logger.info(line)
        return "\n".join(lines)


def get_model_profile(model_fn, args, print_profile=True, detailed=True,
                      warm_up=1, as_string=True):
    """Functional one-shot profile (reference get_model_profile :616-682):
    ``model_fn(*args)`` counted on meta tensors and timed."""
    prof = FlopsProfiler()
    prof.profile_fn(model_fn, *args, n_timing_runs=max(1, warm_up))
    flops = prof.get_total_flops(as_string)
    duration = prof.get_total_duration(as_string)
    if print_profile:
        prof.print_model_profile()
    return flops, None, duration
