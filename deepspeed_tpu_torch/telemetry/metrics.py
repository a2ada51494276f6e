"""Unified metrics: counters/gauges/histograms + a step-aligned JSONL
time-series stream.

Port of deepspeed_tpu/telemetry/metrics.py. One schema for every
producer (the training engine, the serving engine, the checkpoint commit
path):

- ``Counter`` — monotonically increasing event count;
- ``Gauge`` — last-written value;
- ``Histogram`` — bounded sample reservoir with the repo's single
  nearest-rank percentile implementation (``nearest_rank``), which
  ``serving/metrics.py`` also routes through: empty input is ``None``
  (never raises), one sample IS every percentile, q clamps to [0, 1].

``MetricsRegistry.snapshot()`` is the dict the engines' unified
``telemetry_report()`` embeds next to the legacy report builders
(``_last_metrics`` / ``serving_report`` / ``comm_volume_report``)
without replacing them.

``MetricsStream`` is the on-disk time series: append-only JSONL, one
record per optimizer/serving step, flushed at every emit (optionally
fsync'd) — the request-journal idiom from the serving reliability
layer.  A crash can tear at most the final line; :meth:`replay`
tolerates exactly that (a torn tail is skipped, every complete record
is returned), so dead runs still leave a readable step trail.  Values
must be host values by the time they are emitted: ``_json_safe`` turns
a ``torch.Tensor`` into a number or a list, which for a CUDA tensor is
one device-to-host copy — the training engine fetches a step's scalars
in ONE copy before it emits (runtime/engine.py ``_host_metrics``).
"""
import json
import os
import threading
import time

from deepspeed_tpu_torch.utils.logging import logger


def nearest_rank(xs, q):
    """Nearest-rank percentile, total over its edge cases: empty input
    is ``None`` (never raises), a single sample IS every percentile,
    and q is clamped to [0, 1] — overload guards read p50/p95 off
    arbitrary slices of a run, including before the first sample."""
    if not xs:
        return None
    s = sorted(xs)
    q = min(1.0, max(0.0, q))
    return s[min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))]


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n=1):
        self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = None

    def set(self, value):
        self.value = value


class Histogram:
    """Sample collector with nearest-rank percentiles.

    ``max_samples`` bounds host memory: past it the reservoir keeps the
    most recent window (ring overwrite) — latency distributions are
    about the recent regime, and an unbounded list in a long serving
    run would be its own observability bug.  ``count``/``mean``/``max``
    stay exact over the WHOLE run (running total + running max);
    only the percentiles are windowed."""

    __slots__ = ("values", "count", "_total", "_hi", "_max", "_i")

    def __init__(self, max_samples=4096):
        self.values = []
        self.count = 0
        self._total = 0.0
        self._hi = None
        self._max = int(max_samples)
        self._i = 0

    def add(self, value):
        v = float(value)
        self.count += 1
        self._total += v
        if self._hi is None or v > self._hi:
            self._hi = v
        if len(self.values) < self._max:
            self.values.append(v)
        else:
            self.values[self._i] = v
            self._i = (self._i + 1) % self._max
    # an alias some metric producers read more naturally
    observe = add

    def mean(self):
        return self._total / self.count if self.count else None

    def pct(self, q):
        return nearest_rank(self.values, q)

    def max(self):
        return self._hi

    def summary(self):
        return {"count": self.count, "mean": self.mean(),
                "p50": self.pct(.5), "p95": self.pct(.95),
                "max": self.max()}


class MetricsRegistry:
    """Get-or-create registry; one instance per engine."""

    def __init__(self):
        self._counters = {}
        self._gauges = {}
        self._hists = {}
        self._lock = threading.Lock()

    def counter(self, name) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            return c

    def gauge(self, name) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge()
            return g

    def histogram(self, name, max_samples=4096) -> Histogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(max_samples)
            return h

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": {k: c.value for k, c in self._counters.items()},
                "gauges": {k: g.value for k, g in self._gauges.items()},
                "histograms": {k: h.summary()
                               for k, h in self._hists.items()},
            }


def _json_safe(x):
    """JSON default: torch tensors, numpy scalars/arrays and other exotics
    degrade to plain numbers/lists/strings instead of failing the step
    emit (a one-element tensor becomes its number, a larger one a list)."""
    import numpy as np

    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    if hasattr(x, "tolist") and hasattr(x, "numel"):   # torch.Tensor
        return x.item() if x.numel() == 1 else x.tolist()
    if hasattr(x, "item"):
        try:
            return x.item()
        except (TypeError, ValueError, RuntimeError):
            pass
    return str(x)


class MetricsStream:
    """Append-only step-aligned JSONL time series (see module docstring).

    Records are ``{"step": n, "t": unix_seconds, ...payload}``, one per
    line, flushed per emit so the tail is at most ONE torn record deep.
    """

    def __init__(self, path, fsync=False, clock=time.time):
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self.path = path
        self._fsync = bool(fsync)
        self._clock = clock
        self._fh = open(path, "a", encoding="utf-8")
        self._lock = threading.Lock()
        self.emitted = 0

    def emit(self, step, payload):
        rec = {"step": int(step), "t": self._clock()}
        rec.update(payload or {})
        line = json.dumps(rec, default=_json_safe)
        with self._lock:
            self._fh.write(line + "\n")
            self._fh.flush()
            if self._fsync:
                os.fsync(self._fh.fileno())
            self.emitted += 1

    def close(self):
        """Idempotent: an explicit close followed by the engine's
        GC-time close must not raise on the already-closed handle."""
        with self._lock:
            if self._fh.closed:
                return
            try:
                self._fh.flush()
            finally:
                self._fh.close()

    @staticmethod
    def replay(path):
        """Read every COMPLETE record of a metrics stream; a torn final
        line (crash mid-write) is skipped with a warning, any other
        malformed line raises — silent mid-stream corruption must not
        read as a clean shorter run."""
        out = []
        with open(path, "r", encoding="utf-8") as f:
            lines = f.read().split("\n")
        # a trailing "" after the final newline is normal; anything else
        # in the last slot is the torn tail
        body, tail = lines[:-1], lines[-1]
        for i, line in enumerate(body):
            if not line.strip():
                continue
            try:
                out.append(json.loads(line))
            except ValueError as e:
                raise ValueError(
                    f"{path}:{i + 1}: corrupt metrics record mid-stream "
                    f"({e}); only the final line may be torn") from e
        if tail.strip():
            try:
                out.append(json.loads(tail))
            except ValueError:
                logger.warning(
                    f"{path}: torn final metrics record skipped "
                    f"({len(tail)} bytes) — crash mid-emit")
        return out
