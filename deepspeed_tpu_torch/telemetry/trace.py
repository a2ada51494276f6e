"""Host-side span tracer: preallocated ring buffer, Chrome-trace export.

Port of deepspeed_tpu/telemetry/trace.py.

The hot path is numpy/stdlib only: one
clock read at ``begin()``, one clock read plus a handful of scalar array
writes at ``complete()``/``instant()``.  Nothing here ever touches a
device, forces a transfer, or allocates per event — the event payload is
five preallocated numpy columns (timestamp, duration, interned name id,
lane id, two integer args) written at a wrapping ring index under a
lock (the async checkpoint-commit thread and the training thread share
one tracer).

Disarmed is exactly free: engines hold ``self._tracer = None`` and every
instrumentation site is a single attribute-load-and-``is None`` branch —
no null-object dispatch, no clock reads, no recording, and (since
tracing is purely host-side) bit-identical device work either way.

Spans are HOST time.  CUDA launches are asynchronous, so a span around
a forward or an optimizer step measures how long the host took to
enqueue its kernels, not how long the card took to run them (the same
holds for the JAX package's spans over async dispatch).  Device time
is ``torch.profiler``'s; the wall time between step boundaries
(``Telemetry.step_time_s``) converges on the synchronised step time
only over several steps, once the host runs ahead of the card.

Export is the Chrome trace-event JSON format (``chrome://tracing`` /
Perfetto ``ui.perfetto.dev``): one process, one thread ("lane") per
logical actor — the training engine emits on ``train``/``ckpt``/``mem``
lanes, the serving engine on ``serve``.  Spans export as complete ``"X"``
events by default or as matched ``"B"``/``"E"`` pairs
(``complete_events=False``); instants as ``"i"``.

``lane_utilization(events)`` computes measured per-lane busy/idle
fractions (host time) from an event list.
"""
import json
import os
import threading
import time

import numpy as np

_PH_SPAN = 0
_PH_INSTANT = 1

DEFAULT_CAPACITY = 65536
MIN_CAPACITY = 256


class Tracer:
    """Ring-buffer span/instant recorder (see module docstring).

    ``capacity`` bounds host memory (5 numpy columns, ~34 B/event); once
    exceeded the OLDEST events are overwritten and ``dropped`` counts
    them — the tracer never grows and never throws on overflow.
    """

    def __init__(self, capacity=DEFAULT_CAPACITY, clock=time.perf_counter):
        capacity = max(MIN_CAPACITY, int(capacity))
        self.capacity = capacity
        self.clock = clock
        self._ts = np.zeros(capacity, np.float64)
        self._dur = np.zeros(capacity, np.float64)
        self._name = np.zeros(capacity, np.int32)
        self._lane = np.zeros(capacity, np.int32)
        self._ph = np.zeros(capacity, np.int8)
        self._a0 = np.full(capacity, -1, np.int64)
        self._a1 = np.full(capacity, -1, np.int64)
        self._n = 0                     # total events ever recorded
        self._names = []                # id -> name
        self._name_ids = {}             # name -> id
        self._arg_labels = {}           # name id -> (label0, label1)
        self._lanes = []                # id -> lane name
        self._lane_ids = {}             # lane name -> id
        self._lock = threading.Lock()

    # -- interning ------------------------------------------------------
    def lane(self, name):
        """Intern a lane (exported as a named Chrome thread); returns its
        integer id — cache it at arming time, pass it on the hot path."""
        with self._lock:
            lid = self._lane_ids.get(name)
            if lid is None:
                lid = len(self._lanes)
                self._lanes.append(str(name))
                self._lane_ids[name] = lid
            return lid

    def intern(self, name, args=()):
        """Intern an event name (optionally labelling its two integer
        args for export); returns the integer name id."""
        with self._lock:
            nid = self._name_ids.get(name)
            if nid is None:
                nid = len(self._names)
                self._names.append(str(name))
                self._name_ids[name] = nid
            if args:
                self._arg_labels[nid] = tuple(str(a) for a in args[:2])
            return nid

    # -- hot path -------------------------------------------------------
    def begin(self):
        """Timestamp for a span start; pair with :meth:`complete`."""
        return self.clock()

    def complete(self, name, lane, t0, a0=-1, a1=-1):
        """Record one finished span [t0, now] on ``lane``."""
        self._record(_PH_SPAN, name, lane, t0, self.clock() - t0, a0, a1)

    def instant(self, name, lane, a0=-1, a1=-1):
        """Record a zero-duration marker event."""
        self._record(_PH_INSTANT, name, lane, self.clock(), 0.0, a0, a1)

    def _record(self, ph, name, lane, ts, dur, a0, a1):
        with self._lock:
            nid = self._name_ids.get(name)
            if nid is None:
                nid = len(self._names)
                self._names.append(str(name))
                self._name_ids[name] = nid
            i = self._n % self.capacity
            self._ts[i] = ts
            self._dur[i] = dur
            self._name[i] = nid
            self._lane[i] = lane
            self._ph[i] = ph
            self._a0[i] = a0
            self._a1[i] = a1
            self._n += 1

    # -- read side ------------------------------------------------------
    @property
    def recorded(self):
        """Total events ever recorded (including overwritten ones)."""
        return self._n

    @property
    def dropped(self):
        """Events overwritten by ring wrap-around."""
        return max(0, self._n - self.capacity)

    def events(self):
        """Retained events oldest-first, as plain dicts:
        ``{name, lane, ph ('X'|'i'), ts, dur, a0, a1}`` (times in
        seconds; ``a0``/``a1`` are the caller's integer args, -1 =
        unset)."""
        with self._lock:
            n = min(self._n, self.capacity)
            start = self._n - n
            idx = [(start + k) % self.capacity for k in range(n)]
            out = []
            for i in idx:
                out.append({
                    "name": self._names[self._name[i]],
                    "lane": self._lanes[self._lane[i]],
                    "ph": "X" if self._ph[i] == _PH_SPAN else "i",
                    "ts": float(self._ts[i]),
                    "dur": float(self._dur[i]),
                    "a0": int(self._a0[i]),
                    "a1": int(self._a1[i]),
                })
            return out

    def reset(self):
        with self._lock:
            self._n = 0

    def summary(self):
        """Small host-side status dict for reports."""
        return {"recorded": self.recorded, "retained": min(self._n,
                                                           self.capacity),
                "dropped": self.dropped, "capacity": self.capacity,
                "lanes": list(self._lanes)}

    # -- export ---------------------------------------------------------
    def _event_args(self, nid, a0, a1):
        labels = self._arg_labels.get(nid, ("a0", "a1"))
        args = {}
        if a0 != -1:
            args[labels[0] if len(labels) > 0 else "a0"] = int(a0)
        if a1 != -1:
            args[labels[1] if len(labels) > 1 else "a1"] = int(a1)
        return args

    def export_chrome_trace(self, path, pid=0, complete_events=True,
                            process_name="deepspeed_tpu_torch"):
        """Write the retained events as Chrome-trace-event JSON (loadable
        in chrome://tracing and Perfetto).  Spans become complete ``X``
        events, or matched ``B``/``E`` pairs with
        ``complete_events=False``; instants become ``i`` with thread
        scope.  The write is atomic (temp file + rename) so a crash
        mid-export never leaves a torn trace.  Returns ``path``."""
        with self._lock:
            n = min(self._n, self.capacity)
            start = self._n - n
            trace_events = [{
                "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                "args": {"name": process_name},
            }]
            for lid, lname in enumerate(self._lanes):
                trace_events.append({
                    "ph": "M", "name": "thread_name", "pid": pid,
                    "tid": lid, "args": {"name": lname}})
                trace_events.append({
                    "ph": "M", "name": "thread_sort_index", "pid": pid,
                    "tid": lid, "args": {"sort_index": lid}})
            for k in range(n):
                i = (start + k) % self.capacity
                nid = int(self._name[i])
                ts_us = self._ts[i] * 1e6
                base = {"name": self._names[nid], "cat": "telemetry",
                        "pid": pid, "tid": int(self._lane[i]),
                        "args": self._event_args(nid, int(self._a0[i]),
                                                 int(self._a1[i]))}
                if self._ph[i] == _PH_INSTANT:
                    trace_events.append(dict(base, ph="i", s="t",
                                             ts=round(ts_us, 3)))
                elif complete_events:
                    trace_events.append(dict(
                        base, ph="X", ts=round(ts_us, 3),
                        dur=round(self._dur[i] * 1e6, 3)))
                else:
                    trace_events.append(dict(base, ph="B",
                                             ts=round(ts_us, 3)))
                    trace_events.append({
                        "ph": "E", "pid": pid, "tid": int(self._lane[i]),
                        "ts": round(ts_us + self._dur[i] * 1e6, 3)})
            payload = {"traceEvents": trace_events,
                       "displayTimeUnit": "ms",
                       "otherData": {"dropped_events": self.dropped}}
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
        return path


def lane_utilization(events, lanes=None):
    """Measured utilization per lane from an event list (the output of
    :meth:`Tracer.events`): summed span durations over the global [first
    start, last end] window, in host time (module docstring).

    Returns ``{lane: {busy_s, idle_fraction, spans}}`` plus the window
    under ``"_window_s"``.
    """
    spans = [e for e in events if e["ph"] == "X"
             and (lanes is None or e["lane"] in lanes)]
    if not spans:
        return {"_window_s": 0.0}
    t0 = min(e["ts"] for e in spans)
    t1 = max(e["ts"] + e["dur"] for e in spans)
    window = max(t1 - t0, 1e-12)
    out = {"_window_s": window}
    by_lane = {}
    for e in spans:
        by_lane.setdefault(e["lane"], []).append(e)
    for lane, evs in by_lane.items():
        busy = sum(e["dur"] for e in evs)
        out[lane] = {"busy_s": busy,
                     "idle_fraction": 1.0 - min(busy, window) / window,
                     "spans": len(evs)}
    return out
