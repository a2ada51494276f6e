"""Metric primitives of the serving layer: the repo's one nearest-rank
percentile (``nearest_rank``) and the bounded-reservoir ``Histogram``.

Port of the part of deepspeed_tpu/telemetry/metrics.py that
``serving/metrics.py`` reads; the registry, gauges, counters and the
JSONL step stream come with the telemetry port (ROADMAP A17).
"""


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
