"""Numerical-integrity defense, the sentinels: silent-corruption detection
in one process.

Port of the single-process half of
deepspeed_tpu/runtime/resilience/integrity.py. A flipped exponent bit, a
corrupted optimizer moment or a loss spike gives finite but wrong
numbers that no NaN or overflow check sees. The sentinels are three
statistics of each optimizer step: the loss, the global gradient norm
and the update ratio ||new master - master|| / ||master||. The engine
computes them on the device inside the step and fetches them with the
step's one batched host copy (``engine._host_metrics``), and the
:class:`IntegrityMonitor` classifies them on the host with an EMA
z-score window. Overflow-skipped steps are left out of the statistics
(the loss scaler at work, not corruption). A persistent anomaly becomes
a ``corrupt`` verdict, which the supervisor (supervisor.py) answers with
a rollback to the last integrity-clean tag and a skip of the data
window; an anomaly that clears on its own is counted as a false
positive.

Not ported here (ROADMAP A16b): the cross-replica checksum vote and the
duplicate-compute check. Both need data-parallel replicas, which the
port runs one per process; at dp 1 the JAX engine arms the sentinels
only as well, and says the vote is DISARMED.

``apply_chaos_faults`` is the test injector: an armed chaos bit flip
lands on one element of the live state at a step boundary, in place
through an integer view of the tensor, with no host copy.
"""
import math
from collections import Counter
from dataclasses import dataclass

import torch

from deepspeed_tpu_torch.utils.logging import logger

# verdict sources (the evidence behind a corrupt verdict)
SOURCE_STATE_VOTE = "state-vote"
SOURCE_DUP_CHECK = "dup-check"
SOURCE_SENTINEL = "sentinel"

SENTINEL_NAMES = ("loss", "grad_norm", "update_ratio")


@dataclass(frozen=True)
class IntegrityConfig:
    """Detection windows and cadences (the ``resilience.integrity``
    ds_config block, runtime/constants.py)."""
    window: int = 32                 # EMA window (steps) for the z-score
    z_threshold: float = 6.0         # |z| past this = anomalous sentinel
    min_history: int = 4             # steps of statistics before z fires
    confirm_steps: int = 2           # anomalous steps before a verdict
    clear_steps: int = 2             # normal steps that close an
    #                                  unconfirmed anomaly (false positive)
    vote_every_steps: int = 16       # vote cadence (the vote is A16b)
    dup_check_every_steps: int = 0   # duplicate-compute cadence (A16b)
    quarantine_after: int = 2        # corrupt verdicts on one rank before
    #                                  the supervisor quarantines it

    @staticmethod
    def from_resilience(res):
        return IntegrityConfig(
            window=res.integrity_window,
            z_threshold=res.integrity_z_threshold,
            min_history=res.integrity_min_history,
            confirm_steps=res.integrity_confirm_steps,
            clear_steps=res.integrity_clear_steps,
            vote_every_steps=res.integrity_vote_every_steps,
            dup_check_every_steps=res.integrity_dup_check_every_steps,
            quarantine_after=res.integrity_quarantine_after)


def classify_digests(rows):
    """Majority / minority classification of per-rank digest rows (the
    vote's counting rule): ``unanimous``; ``minority``, the ranks off the
    strict majority; ``tie``, no strict majority (the vote refuses a
    rank verdict)."""
    keyed = [tuple(int(x) for x in r) for r in rows]
    counts = Counter(keyed)
    if len(counts) == 1:
        return {"unanimous": True, "minority": [], "tie": False}
    ordered = counts.most_common()
    if len(ordered) > 1 and ordered[0][1] == ordered[1][1]:
        return {"unanimous": False, "minority": [], "tie": True}
    majority = ordered[0][0]
    minority = [i for i, k in enumerate(keyed) if k != majority]
    return {"unanimous": False, "minority": minority, "tie": False}


# ---------------------------------------------------------------------------
# chaos fault materialization (test-only; a no-op without an armed plan)
# ---------------------------------------------------------------------------
def _flip_element(t, element, bit):
    """XOR bit ``bit`` of the fp32 word of flat element ``element`` of
    ``t``, in place on its device: an fp32 tensor through its int32 view;
    a 16-bit one through fp32 and back, as the JAX injector flips the
    fp32 word of any dtype."""
    flat = t.view(-1)
    mask = (1 << bit) - (1 << 32 if bit == 31 else 0)   # as an int32
    if t.dtype == torch.float32:
        word = flat[element:element + 1].view(torch.int32)
        word.bitwise_xor_(mask)
        return
    wide = flat[element:element + 1].float()
    wide.view(torch.int32).bitwise_xor_(mask)
    flat[element:element + 1].copy_(wide)


def _flip_state_leaf(engine, tree_name, rank, leaf, element, bit):
    """Apply one armed bit flip to leaf ``leaf`` (the JAX TrainState's
    flatten order) of ``tree_name``: "params" (the compute parameters),
    "master" (the fp32 master; the parameters at fp32) or "opt_state"
    (the optimizer's step count, then each moment list) on dp rank
    ``rank`` only; ``element`` indexes the JAX leaf's flattened array."""
    specs = engine._leaf_specs()
    lists = {"params": engine.params, "master": engine.master}
    if rank != engine.dp_rank:
        return False
    if tree_name == "opt_state":
        states = engine.optimizer.state_lists()
        n = len(specs)
        if leaf == 0:
            # the optimizer's step count (its bias correction's t)
            with torch.no_grad():
                _flip_element(engine.optimizer.step, 0, bit)
            logger.warning(f"chaos: flipped bit {bit} of state.opt_state "
                           f"leaf 0 (the step count) on dp rank {rank} at "
                           f"step {engine.global_steps}")
            return True
        if not 1 <= leaf <= len(states) * n:
            logger.warning(f"chaos flip_bit: opt_state leaf {leaf} out of "
                           f"range; not injected")
            return False
        lst, leaf = states[(leaf - 1) // n], (leaf - 1) % n
    else:
        lst = lists[tree_name]
    if not 0 <= leaf < len(specs):
        logger.warning(f"chaos flip_bit: leaf {leaf} out of range for "
                       f"state.{tree_name} ({len(specs)} leaves); not "
                       f"injected")
        return False
    names, transposed = specs[leaf]
    group = names if isinstance(names, tuple) else (names,)
    index = {n: i for i, n in enumerate(engine.param_names)}
    tensors = [lst[index[n]] for n in group]
    per = tensors[0].numel()
    t = tensors[element // per]
    view = t.t() if transposed else t
    coords = []
    rest = element % per
    for size in reversed(view.shape):
        coords.append(rest % size)
        rest //= size
    coords = tuple(reversed(coords))
    # the element's offset in the tensor's own (row-major) layout
    offset = sum(c * s for c, s in zip(coords, view.stride()))
    with torch.no_grad():
        _flip_element(t, offset, bit)
    logger.warning(f"chaos: flipped bit {bit} of state.{tree_name} leaf "
                   f"{leaf} element {element} on dp rank {rank} at step "
                   f"{engine.global_steps}")
    return True


def apply_chaos_faults(engine):
    """Materialize the armed silent-corruption faults on the live state at
    a step boundary (``engine._observe_step_outcome``; a no-op without an
    armed plan)."""
    from deepspeed_tpu_torch.runtime.resilience import chaos

    tree = {"opt": "opt_state", "master": "master"}
    for target, rank, leaf, element, bit in \
            chaos.consume_bit_flips(engine.global_steps):
        _flip_state_leaf(engine, tree.get(target, "params"), rank, leaf,
                         element, bit)


# ---------------------------------------------------------------------------
# host-side monitor
# ---------------------------------------------------------------------------
class SentinelStat:
    """EMA mean / variance with a z-score read, one per sentinel.
    Anomalous samples are not folded in (a spike must not drag the mean
    toward itself). The z denominator has a relative floor (5 % of
    |mean|): the raw EMA std of smooth training can collapse toward 0,
    and the floor keeps drift from reading as 30 sigma, while a flipped
    exponent bit moves a statistic by orders of magnitude."""

    _REL_STD_FLOOR = 0.05

    def __init__(self, window):
        self.alpha = 2.0 / (max(2, int(window)) + 1.0)
        self.mean = 0.0
        self.var = 0.0
        self.count = 0

    def z(self, x):
        if not math.isfinite(x):
            return float("inf")
        if self.count == 0:
            return 0.0
        std = math.sqrt(max(self.var, 1e-24))
        floor = self._REL_STD_FLOOR * max(abs(self.mean), 1e-12)
        return (x - self.mean) / max(std, floor)

    def update(self, x):
        if not math.isfinite(x):
            return
        if self.count == 0:
            self.mean = x
        else:
            delta = x - self.mean
            self.mean += self.alpha * delta
            self.var = (1.0 - self.alpha) * (self.var
                                             + self.alpha * delta * delta)
        self.count += 1


class IntegrityMonitor:
    """Host-side brain of the sentinels. The engine feeds it once per
    optimizer step (``observe_step``, with the values of the step's one
    host fetch); the supervisor (or, unsupervised, the engine) calls
    ``decide`` after each step and ``resolve`` once a recovery landed.
    Pure host bookkeeping."""

    def __init__(self, config, dp, sentinels_armed=True, vote_armed=False,
                 dup_armed=False, vote_gathered=False, tracer=None):
        if vote_armed or dup_armed or vote_gathered:
            raise NotImplementedError(
                "the integrity cross-replica vote and the duplicate-compute "
                "check are not ported yet (ROADMAP A16b)")
        self.config = config
        self.dp = int(dp)
        self.sentinels_armed = bool(sentinels_armed)
        self.vote_armed = False
        self.dup_armed = False
        self.vote_gathered = False
        self.stats = {n: SentinelStat(config.window)
                      for n in SENTINEL_NAMES}
        self.anomaly_step = None      # first anomalous step of the window
        self.anomaly_streak = 0
        self.normal_streak = 0
        self.anomalies = 0
        self.false_positives = 0
        self.overflow_skips = 0
        self.votes = 0
        self.dup_checks = 0
        self.verdicts = []            # verdicts handed to the ladder
        self.detection_latencies = []
        self.last_observed_step = 0
        self._verdict_latch = False   # one verdict per incident
        self._tracer = tracer
        self._lane = 0
        if tracer is not None:
            self._lane = tracer.lane("integrity")
            for name in ("anomaly", "verdict", "false_positive",
                         "overflow_skip_excluded"):
                tracer.intern(name, args=("step",))
            tracer.intern("detection_latency", args=("steps",))

    def _instant(self, name, a0=0):
        if self._tracer is not None:
            self._tracer.instant(name, self._lane, a0=int(a0))

    def observe_step(self, step, loss=None, grad_norm=None,
                     update_ratio=None, overflow=False):
        """Classify one optimizer step's sentinel values: returns
        "overflow-skip" (left out of the statistics), "warmup" (too little
        history), "anomaly" or "ok". Anomalous samples never enter the
        window."""
        self.last_observed_step = int(step)
        if not self.sentinels_armed:
            return "ok"
        if overflow:
            self.overflow_skips += 1
            self._instant("overflow_skip_excluded", a0=step)
            return "overflow-skip"
        samples = {"loss": loss, "grad_norm": grad_norm,
                   "update_ratio": update_ratio}
        ready = all(self.stats[n].count >= self.config.min_history
                    for n, v in samples.items() if v is not None)
        anomalous = any(v is not None and not math.isfinite(v)
                        for v in samples.values())
        zs = {}
        if ready and not anomalous:
            for n, v in samples.items():
                if v is None:
                    continue
                zs[n] = self.stats[n].z(v)
            # one-sided: corruption blows these statistics up; a fall is
            # training converging
            anomalous = any(z > self.config.z_threshold
                            for z in zs.values())
        if anomalous:
            if self.anomaly_step is None:
                self.anomaly_step = int(step)
                self.anomalies += 1
                self._instant("anomaly", a0=step)
                logger.warning(
                    f"integrity: sentinel anomaly opened at step {step} "
                    f"(z-scores {({n: round(z, 1) for n, z in zs.items()})}"
                    f", threshold {self.config.z_threshold:g})")
            self.anomaly_streak += 1
            self.normal_streak = 0
            return "anomaly"
        for n, v in samples.items():
            if v is not None:
                self.stats[n].update(v)
        if self.anomaly_step is not None:
            self.normal_streak += 1
        return "ok" if ready else "warmup"

    def decide(self, engine, wall_step):
        """At most one ``corrupt`` verdict per incident: None (healthy, or
        still gathering evidence) or ``{"verdict": "corrupt", "culprits":
        [], "source": "sentinel", "step", "anomaly_step", "latency_steps",
        "tie": False}`` once an anomaly has lasted ``confirm_steps``."""
        if self._verdict_latch:
            return None
        step = int(engine.global_steps)
        cfg = self.config
        if self.anomaly_step is None:
            return None
        if self.anomaly_streak >= cfg.confirm_steps:
            # a persistent anomaly with no replica to vote: symmetric
            # corruption, rollback-and-skip with no culprit
            return self._verdict(step, [], SOURCE_SENTINEL)
        if self.normal_streak >= cfg.clear_steps:
            self.false_positives += 1
            self._instant("false_positive", a0=step)
            logger.warning(
                f"integrity: anomaly opened at step {self.anomaly_step} "
                f"cleared on its own after {self.normal_streak} normal "
                f"step(s) — counted as a false positive (no recovery)")
            self._reset_window()
        return None

    def _verdict(self, step, culprits, source, tie=False):
        opened = self.anomaly_step if self.anomaly_step is not None \
            else step
        latency = max(0, int(step) - int(opened))
        self.detection_latencies.append(latency)
        self._verdict_latch = True
        verdict = {"verdict": "corrupt", "culprits": sorted(culprits),
                   "source": source, "step": int(step),
                   "anomaly_step": int(opened),
                   "latency_steps": latency, "tie": bool(tie)}
        self.verdicts.append(dict(verdict))
        self._instant("verdict", a0=step)
        self._instant("detection_latency", a0=latency)
        logger.warning(
            f"integrity: CORRUPT verdict at step {step} via {source} — "
            + (f"minority rank(s) {sorted(culprits)}" if culprits else
               ("2-way tie: no quorum, escalating to rollback" if tie
                else "no culprit (symmetric anomaly)"))
            + f"; detection latency {latency} step(s)")
        return verdict

    def resolve(self, recovered=True):
        """Close the open incident after a recovery: verdicts re-arm."""
        self._reset_window()
        self._verdict_latch = False

    def _reset_window(self):
        self.anomaly_step = None
        self.anomaly_streak = 0
        self.normal_streak = 0

    def clean(self):
        """True when no anomaly window is open: the ``integrity_clean``
        stamp a commit records in its manifest."""
        return self.anomaly_step is None and not self._verdict_latch

    def report(self):
        """The ``integrity`` section of ``engine.telemetry_report()``."""
        lat = self.detection_latencies
        return {
            "armed": True,
            "sentinels_armed": self.sentinels_armed,
            "vote_armed": self.vote_armed,
            "vote_mode": None,
            "dup_check_armed": self.dup_armed,
            "dp": self.dp,
            "anomalies": self.anomalies,
            "false_positives": self.false_positives,
            "overflow_skips_excluded": self.overflow_skips,
            "open_anomaly_step": self.anomaly_step,
            "votes": self.votes,
            "dup_checks": self.dup_checks,
            "verdicts": [dict(v) for v in self.verdicts],
            "detection_latency_steps": {
                "mean": sum(lat) / len(lat) if lat else None,
                "max": max(lat) if lat else None,
                "last": lat[-1] if lat else None,
                "closed_verdicts": len(lat),
            },
            "sentinels": {
                n: {"mean": s.mean, "var": s.var, "count": s.count}
                for n, s in self.stats.items()},
        }
