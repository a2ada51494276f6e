"""Serving metrics: TTFT, TPOT, throughput, queue depth, pool occupancy.

Follows the engine's ``_last_metrics`` / ``comm_volume_report()`` idiom:
the engine feeds observations as plain host floats (never a device sync
— the decode token fetch already happened, batched, once per step) and
``report()`` assembles the summary dict that
``InferenceEngine.serving_report()`` returns.

Also home of :class:`DispatchShapes`, the eager counterpart of the JAX
package's compile counter: every decode and prefill dispatch records its
signature (program name plus the shape and dtype of each tensor it
reads), and steady-state serving (requests joining/leaving a warmed
engine) must add NO new signature — the fixed-shape discipline a later
CUDA-graph capture of the decode step relies on.
"""
import time
from typing import Dict, List

from deepspeed_tpu_torch.telemetry.metrics import Histogram, nearest_rank


class DispatchShapes:
    """The distinct (program name, input shapes and dtypes) signatures
    the engine's decode and prefill functions have been dispatched with.
    ``len()`` is the number of distinct signatures; ``dispatches`` counts
    every call."""

    def __init__(self):
        self.signatures: Dict[tuple, int] = {}
        self.dispatches = 0

    @staticmethod
    def signature(name, tensors):
        return (name,) + tuple((tuple(t.shape), str(t.dtype))
                               for t in tensors)

    def record(self, name, tensors) -> bool:
        """Count one dispatch of ``name`` over ``tensors``; True when its
        signature is new."""
        self.dispatches += 1
        sig = self.signature(name, tensors)
        if sig in self.signatures:
            self.signatures[sig] += 1
            return False
        self.signatures[sig] = 1
        return True

    def names(self):
        return sorted({sig[0] for sig in self.signatures})

    def __len__(self):
        return len(self.signatures)


def _mean(xs):
    return sum(xs) / len(xs) if xs else None


def _pct(xs, q):
    """Nearest-rank percentile, total over its edge cases: empty input
    is ``None`` (never raises), a single sample IS every percentile,
    and q is clamped to [0, 1] — the overload guard reads p50/p95 off
    arbitrary slices of a run, including before the first token.

    Delegates to the repo-wide shared implementation
    (``telemetry.metrics.nearest_rank``, the same one the telemetry
    ``Histogram`` percentiles use) — the edge-case contract above is
    pinned by test_serving_reliability.py and test_telemetry.py."""
    return nearest_rank(xs, q)


class ServingMetrics:
    """Per-request latency + per-step utilization accounting."""

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self.reset()

    def reset(self):
        self._arrival: Dict[int, float] = {}
        self._first_token: Dict[int, float] = {}
        self._last_token: Dict[int, float] = {}
        self._tokens: Dict[int, int] = {}
        self.ttft: List[float] = []
        self.completed = 0
        self.cancelled = 0
        self.migrated = 0              # handed off to another replica
        self.migrated_tokens = 0       # tokens billed at the destination
        self.evictions = 0
        # reliability-layer abort counters, keyed by abort reason
        # (expired / budget / shed / poisoned)
        self.aborted: Dict[str, int] = {}
        self.steps = 0
        self.decode_steps = 0
        self.slot_steps = 0            # decode lanes dispatched (incl. idle)
        self.active_slot_steps = 0     # decode lanes carrying a request
        self.total_tokens = 0          # generated tokens, all requests
        self.useful_tokens = 0         # tokens of requests that FINISHED
        self.wasted_tokens = 0         # tokens of aborted/shed/cancelled reqs
        # per-step utilization series ride the shared telemetry
        # Histogram (bounded reservoir; count/mean/max exact over the
        # whole run) instead of three ad-hoc unbounded lists
        self._queue_depth = Histogram()
        self._occupancy = Histogram()
        self._fragmentation = Histogram()
        self._t0 = None
        self._t_end = None
        self._step_dt_ema = None       # EMA of inter-step wall time
        # prefix cache (ROADMAP A10b): admission-time tree consults
        self.prefill_computed_tokens = 0   # positions actually dispatched
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefix_avoided_tokens = 0     # positions served from cache
        self.readmit_avoided_tokens = 0    # of those: journal-replay /
        #                                    migration re-submissions
        # speculative decoding (ROADMAP A10b): draft-verify accounting
        self.spec_verify_steps = 0         # verify dispatches (lane-steps)
        self.spec_accepted_tokens = 0      # tokens delivered by verifies
        self.spec_accept_hist: Dict[int, int] = {}  # accepted-length counts
        # sparse page attention (ROADMAP A10b): per-dispatch gather accounting
        self.sparse_gathered_pages = 0     # pages the dispatches gather
        self.sparse_dense_pages = 0        # what dense gathering would cost
        self.sparse_active_pages = 0       # non-padded entries (policy live)
        self.sparse_lane_steps = 0         # decode lanes the gathers served
        self.window_expired_frees = 0      # blocks early-freed by the window
        # per-class TTFT (long vs short under long-context contention)
        self._class_of: Dict[int, str] = {}
        self.ttft_by_class: Dict[str, List[float]] = {}

    # -- request lifecycle ---------------------------------------------
    def record_submit(self, rid, klass=None):
        """``klass`` (e.g. "short"/"long" by prompt length) buckets this
        request's eventual TTFT sample — the per-class view is how the
        long-context bench proves chatty short requests keep their
        latency while huge prompts prefill."""
        self._arrival[rid] = self._clock()
        if klass is not None:
            self._class_of[rid] = str(klass)

    def record_token(self, rid):
        now = self._clock()
        if rid not in self._first_token:
            self._first_token[rid] = now
            if rid in self._arrival:
                sample = now - self._arrival[rid]
                self.ttft.append(sample)
                klass = self._class_of.get(rid)
                if klass is not None:
                    self.ttft_by_class.setdefault(klass, []).append(sample)
        self._last_token[rid] = now
        self._tokens[rid] = self._tokens.get(rid, 0) + 1
        self.total_tokens += 1

    def record_finish(self, rid, reason="finished"):
        """Terminal accounting.  Only ``finished`` tokens count toward
        goodput — everything a cancelled/expired/shed/poisoned request
        generated was work the engine cannot bill, and the overload
        guard needs that honest denominator.  ``migrated`` is neither:
        the request left ALIVE for another replica, so its tokens are
        neither useful nor wasted here — they complete (and bill) at
        the destination."""
        if reason == "finished":
            self.completed += 1
            self.useful_tokens += self._tokens.get(rid, 0)
            return
        if reason == "migrated":
            self.migrated += 1
            self.migrated_tokens += self._tokens.pop(rid, 0)
            return
        self.wasted_tokens += self._tokens.get(rid, 0)
        if reason == "cancelled":
            self.cancelled += 1
        else:
            self.aborted[reason] = self.aborted.get(reason, 0) + 1

    def record_eviction(self, rid):
        self.evictions += 1

    def record_prefill(self, n_tokens):
        """Prefill positions actually DISPATCHED to the device — the
        numerator the prefix-cache ratio guard compares across cache
        on/off runs (cached positions never reach this counter)."""
        self.prefill_computed_tokens += int(n_tokens)

    def record_prefix_lookup(self, avoided_tokens, *, readmit=False):
        """One admission-time prefix-tree consult; ``avoided_tokens`` is
        the number of prompt positions served from cache (0 = miss).
        ``readmit`` marks journal-replay/migration re-submissions —
        counted separately so ``fleet_report()`` can attribute the
        recovery-path savings honestly."""
        self.prefix_lookups += 1
        if avoided_tokens > 0:
            self.prefix_hits += 1
            self.prefix_avoided_tokens += int(avoided_tokens)
            if readmit:
                self.readmit_avoided_tokens += int(avoided_tokens)

    def record_verify(self, accepted, lanes=1):
        """One speculative verify outcome per lane: ``accepted`` tokens
        (1..draft_len+1) were delivered by a single batched dispatch."""
        self.spec_verify_steps += int(lanes)
        self.spec_accepted_tokens += int(accepted)
        self.spec_accept_hist[int(accepted)] = \
            self.spec_accept_hist.get(int(accepted), 0) + 1

    def record_gather(self, lanes, gathered_pages, dense_pages,
                      active_pages=None):
        """One decode dispatch's KV gather bill: ``gathered_pages`` is
        what the dispatch actually pulled (lanes × K under a sparse policy,
        lanes × W dense), ``dense_pages`` what the dense path would have
        pulled for the same lanes — the A/B numerator/denominator of the
        ≥4x acceptance gate.  ``active_pages`` counts the non-padded
        entries (pages the policy genuinely needs)."""
        self.sparse_lane_steps += int(lanes)
        self.sparse_gathered_pages += int(gathered_pages)
        self.sparse_dense_pages += int(dense_pages)
        if active_pages is not None:
            self.sparse_active_pages += int(active_pages)

    def record_window_expired(self, n_blocks):
        """Blocks the pool early-freed because they fell below every
        remaining query's sliding window."""
        self.window_expired_frees += int(n_blocks)

    def class_ttft_p95(self, klass):
        """p95 TTFT of one request class (None before its first token —
        honest gap, not 0)."""
        xs = self.ttft_by_class.get(klass)
        return _pct(xs, .95) if xs else None

    def active_page_fraction(self):
        """Gathered pages as a fraction of the dense-equivalent gather
        (1.0 = dense, 1/K-ish under an effective window).  None before
        the first recorded gather (honest gap, not 0)."""
        if not self.sparse_dense_pages:
            return None
        return self.sparse_gathered_pages / self.sparse_dense_pages

    def tokens_per_verify(self):
        """Mean tokens delivered per speculative verify dispatch (the
        speedup signal: 1.0 = speculation never helps).  None before the
        first verify."""
        if not self.spec_verify_steps:
            return None
        return self.spec_accepted_tokens / self.spec_verify_steps

    def prefix_hit_rate(self):
        """Fraction of admission-time prefix lookups that found cached
        blocks.  None before the first lookup (honest gap, not 0)."""
        if not self.prefix_lookups:
            return None
        return self.prefix_hits / self.prefix_lookups

    # -- per step -------------------------------------------------------
    def record_step(self, *, queue_depth, running, slots, occupancy,
                    fragmentation, decoded):
        now = self._clock()
        if self._t0 is None:
            self._t0 = now
        elif self._t_end is not None:
            dt = now - self._t_end
            self._step_dt_ema = dt if self._step_dt_ema is None \
                else 0.8 * self._step_dt_ema + 0.2 * dt
        self._t_end = now
        self.steps += 1
        if decoded:
            self.decode_steps += 1
            self.slot_steps += slots
            self.active_slot_steps += running
        self._queue_depth.add(queue_depth)
        self._occupancy.add(occupancy)
        self._fragmentation.add(fragmentation)

    # -- summary --------------------------------------------------------
    def ttft_of(self, rid):
        """TTFT of ONE request (None when it has not produced a first
        token here, or arrived elsewhere — a migrated-in request keeps
        its TTFT at the replica that admitted it)."""
        if rid in self._first_token and rid in self._arrival:
            return self._first_token[rid] - self._arrival[rid]
        return None

    def export_timing(self, rid):
        """``(arrival, first_token)`` stamps of a migrating request —
        in-process fleet replicas share one clock, so the stamps carry
        across replicas verbatim."""
        return self._arrival.get(rid), self._first_token.get(rid)

    def adopt_timing(self, rid, arrival_s, first_token_s):
        """Carry a migrated-in request's original stamps so the fleet
        counts exactly ONE TTFT sample per rid: restoring the arrival
        makes the eventual sample include time spent waiting on the
        dead/drained source, and restoring the first-token stamp (when
        the source already emitted it) suppresses a duplicate sample
        here — :meth:`record_token` only samples an unseen rid."""
        if arrival_s is not None:
            self._arrival[rid] = arrival_s
        if first_token_s is not None and rid not in self._first_token:
            self._first_token[rid] = first_token_s

    def step_time(self):
        """EMA of the wall time between consecutive serving steps — the
        admission gate's measured-TPOT proxy (one decode step emits one
        token per running lane).  None before two steps completed."""
        return self._step_dt_ema

    def tpot_samples(self):
        """Per-request time-per-output-token of every request with >= 2
        tokens: (last token - first token) / (tokens - 1)."""
        return [(self._last_token[rid] - self._first_token[rid]) / (n - 1)
                for rid, n in self._tokens.items()
                if n >= 2 and rid in self._first_token]

    def tpot(self):
        """Mean time-per-output-token over requests with >= 2 tokens."""
        spans, counts = 0.0, 0
        for rid, n in self._tokens.items():
            if n >= 2 and rid in self._first_token:
                spans += self._last_token[rid] - self._first_token[rid]
                counts += n - 1
        return spans / counts if counts else None

    def report(self) -> dict:
        wall = (self._t_end - self._t0) if self._t0 is not None else 0.0
        return {
            "requests": {
                "completed": self.completed,
                "cancelled": self.cancelled,
                "migrated": self.migrated,
                "evictions": self.evictions,
                "aborted": dict(self.aborted),
            },
            "ttft_s": {"mean": _mean(self.ttft), "p50": _pct(self.ttft, .5),
                       "p95": _pct(self.ttft, .95),
                       "max": max(self.ttft) if self.ttft else None},
            "tpot_s": self.tpot(),
            "tpot_p50_s": _pct(self.tpot_samples(), .5),
            "tokens": {"generated": self.total_tokens,
                       "useful": self.useful_tokens,
                       "wasted": self.wasted_tokens,
                       "migrated_out": self.migrated_tokens},
            "throughput": {
                "wall_s": wall,
                "tokens_per_s": (self.total_tokens / wall) if wall > 0
                else None,
                # hardware-time proxy, deterministic on CPU: how full the
                # fixed decode batch ran (1.0 = every lane of every decode
                # dispatch carried a live request)
                "tokens_per_slot_step": (self.total_tokens / self.slot_steps)
                if self.slot_steps else None,
                # GOODPUT: only finished requests' tokens over the same
                # denominator — what the overload guard compares against
                # the steady-state baseline (shed/expired work is not
                # throughput, it is waste)
                "goodput_tokens_per_slot_step":
                    (self.useful_tokens / self.slot_steps)
                    if self.slot_steps else None,
                "useful_fraction": (self.useful_tokens / self.total_tokens)
                if self.total_tokens else None,
                "slot_utilization": (self.active_slot_steps / self.slot_steps)
                if self.slot_steps else None,
            },
            "steps": {"total": self.steps, "decode": self.decode_steps},
            "prefix_cache": {
                "lookups": self.prefix_lookups,
                "hits": self.prefix_hits,
                "hit_rate": self.prefix_hit_rate(),
                "avoided_prefill_tokens": self.prefix_avoided_tokens,
                "readmit_avoided_prefill_tokens":
                    self.readmit_avoided_tokens,
                "prefill_tokens_computed": self.prefill_computed_tokens,
            },
            "speculative": {
                "verify_steps": self.spec_verify_steps,
                "accepted_tokens": self.spec_accepted_tokens,
                "tokens_per_verify": self.tokens_per_verify(),
                "accept_len_hist": dict(sorted(
                    self.spec_accept_hist.items())),
            },
            "sparse_context": {
                "gathered_pages": self.sparse_gathered_pages,
                "dense_equivalent_pages": self.sparse_dense_pages,
                "active_page_fraction": self.active_page_fraction(),
                "gathered_pages_per_lane_step":
                    (self.sparse_gathered_pages / self.sparse_lane_steps)
                    if self.sparse_lane_steps else None,
                "active_pages_per_lane_step":
                    (self.sparse_active_pages / self.sparse_lane_steps)
                    if self.sparse_lane_steps else None,
                "window_expired_frees": self.window_expired_frees,
                "ttft_by_class": {
                    k: {"n": len(v), "mean": _mean(v), "p95": _pct(v, .95)}
                    for k, v in sorted(self.ttft_by_class.items())},
            },
            "queue_depth": {"mean": self._queue_depth.mean(),
                            "max": self._queue_depth.max()
                            if self._queue_depth.count else 0,
                            "p95": self._queue_depth.pct(.95)},
            "kv_pool": {"occupancy_mean": self._occupancy.mean(),
                        "occupancy_max": self._occupancy.max()
                        if self._occupancy.count else 0.0,
                        "fragmentation_mean": self._fragmentation.mean()},
        }
