"""deepspeed_tpu_torch.telemetry — structured step tracing, unified
metrics, and measured-vs-analytic MFU accounting.

Port of deepspeed_tpu/telemetry/__init__.py. One :class:`Telemetry`
session per engine bundles the three channels:

- ``tracer`` (:mod:`.trace`): ring-buffer span/instant recorder with
  Chrome-trace/Perfetto export (host time: see trace.py);
- ``registry`` + ``stream`` (:mod:`.metrics`): counters/gauges/
  histograms and the step-aligned JSONL time series;
- ``mfu`` (:mod:`.mfu`): per-program FLOPs, counted by a replay on meta
  tensors, → MFU/HFU.

Engines arm it through ``_arm_telemetry`` (config block ``"telemetry"``
for the training engine, the ``telemetry=`` kwarg for the serving
engine); disarmed engines hold ``None`` and pay one attribute check per
instrumentation site.

Beside the session, every engine keeps a ``ProgramRegistry``
(:mod:`.programs`): each program it dispatches, with its declarative
contract, which the program lint (:mod:`.program_lint`, checks in
:mod:`.program_checks`) holds to an observed dispatch.
"""
import time

from deepspeed_tpu_torch.telemetry.metrics import (Counter, Gauge, Histogram,
                                                   MetricsRegistry,
                                                   MetricsStream,
                                                   nearest_rank)
from deepspeed_tpu_torch.telemetry.mfu import (MfuAccounting,
                                               model_flops_per_step,
                                               peak_flops_per_device)
from deepspeed_tpu_torch.telemetry.programs import (ProgramRegistry,
                                                    register_program)
from deepspeed_tpu_torch.telemetry.trace import (DEFAULT_CAPACITY, Tracer,
                                                 lane_utilization)

__all__ = [
    "Telemetry", "Tracer", "lane_utilization",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "MetricsStream",
    "nearest_rank",
    "MfuAccounting", "model_flops_per_step", "peak_flops_per_device",
    "ProgramRegistry", "register_program",
]


class Telemetry:
    """One engine's telemetry session (tracer + metrics + MFU).

    ``on_step(step, payload)`` is the single per-step hook every engine
    calls at its step boundary: it feeds the ``step_time_s`` histogram
    (wall delta between consecutive calls — the first step, which has no
    predecessor, is excluded from the mean by construction) and appends
    one JSONL record to the metrics stream when one is armed.
    """

    def __init__(self, *, trace=True, trace_capacity=None,
                 metrics_jsonl=None, metrics_fsync=False, mfu=True,
                 peak_tflops_per_device=0.0, clock=time.perf_counter):
        self.tracer = Tracer(trace_capacity or DEFAULT_CAPACITY,
                             clock=clock) if trace else None
        self.registry = MetricsRegistry()
        self.stream = MetricsStream(metrics_jsonl, fsync=metrics_fsync) \
            if metrics_jsonl else None
        self.mfu = MfuAccounting(peak_tflops_per_device) if mfu else None
        self._clock = clock
        self._last_step_t = None
        self.step_time_hist = self.registry.histogram("step_time_s")

    def on_step(self, step, payload=None):
        now = self._clock()
        if self._last_step_t is not None:
            self.step_time_hist.add(now - self._last_step_t)
        self._last_step_t = now
        self.registry.counter("steps").inc()
        if self.stream is not None:
            self.stream.emit(step, payload)

    def step_time_s(self):
        """Mean seconds per step over the retained window (None before
        two steps): host wall time between step boundaries."""
        return self.step_time_hist.mean()

    def close(self):
        if self.stream is not None:
            self.stream.close()
