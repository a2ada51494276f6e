"""Serving reliability layer: deadlines, SLO admission, drain, recovery.

The continuous-batching engine is a fair-weather system on its own:
no deadlines, no admission backpressure, no drain, and a host crash
loses every in-flight request.  This module is the serving analog of the
training side's resilience stack (atomic checkpoints, watchdog, chaos,
preemption) — graceful DEGRADATION instead of congestion collapse:

- **Deadlines & work budgets** — every request may carry a TTLT
  deadline (seconds from submit) and a work budget (total scheduled
  token-writes: prefill chunks + decode steps, so eviction re-prefill
  loops are bounded too).  Both are enforced at step boundaries by the
  engine's ``_enforce_deadlines``: expired requests are aborted with an
  explicit reason, their KV blocks freed — a stuck request can never
  wedge the shared decode batch.
- **SLO-aware admission / load shedding** — a predicted-TTFT gate: the
  queue's remaining prefill work (in steps of ``prefill_chunk``) times
  the measured per-step time (the TPOT proxy — one decode step emits
  one token per running lane).  When the prediction exceeds the SLO the
  gate shed the LOWEST-priority waiting work first and rejects the
  newcomer only when it is itself the least important.  Backpressure is
  visible in ``serving_report()["reliability"]``.
- **Request journal / crash recovery** — an append-only JSONL journal
  (prompt, sampling seed, priority, deadline, generated tokens)
  committed once per step.  ``InferenceEngine.recover()`` replays it on
  a fresh engine and re-submits every live request through the SAME
  eviction re-prefill path, so greedy continuations are bit-identical
  to the uninterrupted run.
- **Poison quarantine** — per-request fault isolation: non-finite
  logits (numeric blow-up in one lane) abort THAT request with reason
  ``poisoned`` instead of poisoning the shared batch.  Detection rides
  the decode step's existing batched fetch — zero new host syncs.

Arming follows the repo's DISARMED discipline (`_arm_shedding`), and the
whole layer preserves the engine's core contracts: ONE fixed-shape
decode step, no new dispatch shapes across churn, one host fetch per
dispatch.
"""
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

from deepspeed_tpu_torch.utils.logging import logger

# terminal non-finished statuses this layer introduces (results["status"])
ABORT_EXPIRED = "expired"      # deadline passed before completion
ABORT_BUDGET = "budget"        # work budget exhausted (incl. re-prefill)
ABORT_SHED = "shed"            # dropped by the overload guard
ABORT_POISONED = "poisoned"    # non-finite logits quarantined
ABORT_REASONS = (ABORT_EXPIRED, ABORT_BUDGET, ABORT_SHED, ABORT_POISONED)


@dataclass(frozen=True)
class ReliabilityConfig:
    """Knobs for the serving reliability layer (all optional — the
    zero-config default arms nothing and costs one ``is None`` per
    step, mirroring the chaos hooks)."""
    slo_ttft_s: Optional[float] = None      # admission gate target
    slo_headroom: float = 1.0               # gate fires at slo * headroom
    default_deadline_s: Optional[float] = None
    default_work_budget: Optional[int] = None
    journal_path: Optional[str] = None
    journal_fsync: bool = False             # fsync each step commit


class RequestJournal:
    """Append-only JSONL request journal (the serving analog of the
    training checkpoint, at request granularity).

    Record kinds::

        {"op": "submit", "rid", "prompt", "max_new", "priority",
         "eos", "seed", "deadline_s", "work_budget", "generated",
         "work_done"}
        {"op": "tok", "rid", "t": [tokens accepted this step]}
        {"op": "end", "rid", "status"}

    ``deadline_s`` is the request's RELATIVE budget: wall clocks are not
    comparable across processes (``time.monotonic``), so recovery grants
    a fresh deadline of the same length — documented, honest semantics.
    ``work_done`` is different: the work BUDGET bounds total scheduled
    token-writes across the request's whole life, so it must CARRY OVER
    — the submit record journals the work already charged at submission
    and :meth:`replay` adds the work provably done since (committed
    decode steps, plus the prefill that demonstrably ran if any token
    was committed), so repeated crash-migrate cycles keep accumulating
    against the bound instead of resetting it.
    Token records are buffered per step and flushed by :meth:`commit`
    (once per serving step), so a crash loses at most the current
    step's tokens and the journal is always record-aligned.
    """

    def __init__(self, path: str, *, fsync: bool = False):
        self.path = path
        self._fsync = bool(fsync)
        self._fh = open(path, "a", encoding="utf-8")
        self._pending: Dict[int, List[int]] = {}   # rid -> step's tokens
        self._live = set()                         # rids submitted, not ended
        self._order: List[int] = []                # flush order within a step

    # -- write side -----------------------------------------------------
    def record_submit(self, req) -> None:
        self._live.add(req.rid)
        self._write({
            "op": "submit", "rid": req.rid,
            "prompt": [int(t) for t in req.prompt],
            "max_new": int(req.max_new_tokens),
            "priority": int(req.priority),
            "eos": (None if req.eos_token_id is None
                    else int(req.eos_token_id)),
            "seed": int(req.seed),
            "deadline_s": req.deadline_s,
            "work_budget": req.work_budget,
            # non-empty for recovered requests: the re-prefill baseline
            "generated": [int(t) for t in req.generated],
            # work already charged at submission (non-zero for
            # recovered/migrated requests) — budgets carry over
            "work_done": int(req.work_done),
        })
        # the returned rid is an ACCEPTANCE acknowledgment — the submit
        # record must survive a crash in the same step, so it flushes
        # immediately (tokens stay buffered until the step commit)
        self._fh.flush()

    def record_token(self, rid: int, token: int) -> None:
        if rid not in self._pending:
            self._pending[rid] = []
            self._order.append(rid)
        self._pending[rid].append(int(token))

    def record_end(self, rid: int, status: str) -> None:
        self._flush_tokens(rid)
        self._live.discard(rid)
        self._write({"op": "end", "rid": rid, "status": status})
        # an end record changes what replay() migrates — a "migrated"
        # end left buffered while the host crashes would re-place a
        # request that already lives on another replica, so end records
        # flush immediately, same rationale as submit records
        self._fh.flush()

    def commit(self) -> None:
        """Step-boundary durability point: flush every buffered token
        record, then push the file to the OS (optionally fsync)."""
        for rid in list(self._order):
            self._flush_tokens(rid)
        self._order.clear()
        self._fh.flush()
        if self._fsync:
            os.fsync(self._fh.fileno())

    def close(self) -> None:
        self.commit()
        self._fh.close()

    @property
    def depth(self) -> int:
        """Live (journaled, not yet ended) requests."""
        return len(self._live)

    def _flush_tokens(self, rid: int) -> None:
        toks = self._pending.pop(rid, None)
        if toks:
            self._write({"op": "tok", "rid": rid, "t": toks})

    def _write(self, rec: dict) -> None:
        self._fh.write(json.dumps(rec, separators=(",", ":")) + "\n")

    # -- read side ------------------------------------------------------
    @staticmethod
    def replay(path: str) -> List[dict]:
        """Reconstruct the LIVE request set from a journal: submit
        records (in original FCFS order) minus ended ones, each with
        every committed generated token.  Tolerates a torn final line
        (the crash can land mid-write of the last record).

        ``work_done`` restoration (budgets carry over, deadlines do
        not): the submit record's journaled baseline, plus one work
        unit per token committed since (each committed token is one
        scheduled decode write), plus — when any token WAS committed —
        the prefill token-writes that demonstrably ran to produce it
        (prompt + the tokens the submit record already carried).  A
        request that never produced a token keeps its baseline alone.
        The estimate is deliberately >= the work actually scheduled, so
        repeated crash-migrate cycles converge ON OR BEFORE the budget
        bound, never past it."""
        live: Dict[int, dict] = {}
        order: List[int] = []
        with open(path, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    logger.warning(
                        "RequestJournal.replay: torn trailing record in "
                        "%s ignored (crash mid-write)", path)
                    continue
                op, rid = rec.get("op"), rec.get("rid")
                if op == "submit":
                    entry = dict(rec)
                    entry["generated"] = list(rec.get("generated", []))
                    entry["work_done"] = int(rec.get("work_done", 0))
                    entry["_committed_toks"] = 0
                    live[rid] = entry
                    order.append(rid)
                elif op == "tok" and rid in live:
                    live[rid]["generated"].extend(rec["t"])
                    live[rid]["_committed_toks"] += len(rec["t"])
                elif op == "end":
                    live.pop(rid, None)
        out = []
        for r in order:
            if r not in live:
                continue
            e = live[r]
            committed = e.pop("_committed_toks")
            if committed:
                prefill_paid = len(e.get("prompt", [])) \
                    + (len(e["generated"]) - committed)
                e["work_done"] += committed + prefill_paid
            out.append(e)
        return out

    @staticmethod
    def replay_many(paths) -> List[dict]:
        """Merge the live request sets of SEVERAL journals — the fleet
        router's whole-fleet recovery path, where each dead replica left
        its own journal.  Replicas hold DISTINCT rid namespaces (the
        router assigns globally-unique rids in arrival order), so the
        global FCFS order across journals IS ascending rid order; each
        journal individually tolerates its own torn final record.  A rid
        appearing live in more than one journal (a request migrated
        mid-flight whose source end record was lost with the crash)
        resolves to the LATER journal in ``paths`` — the router lists
        journals in migration order, so the freshest copy wins."""
        merged: Dict[int, dict] = {}
        for path in paths:
            for e in RequestJournal.replay(path):
                merged[e["rid"]] = e
        return [merged[r] for r in sorted(merged)]


class Reliability:
    """Per-engine reliability orchestrator: owns the journal, the
    admission gate state, and the abort counters.  The engine calls the
    ``on_*`` hooks; everything here is pure host work (no device
    syncs — graftlint holds these fns to the hot-path bar)."""

    def __init__(self, engine, config: ReliabilityConfig):
        self.engine = engine
        self.config = config
        self.journal: Optional[RequestJournal] = None
        if config.journal_path:
            self.journal = RequestJournal(config.journal_path,
                                          fsync=config.journal_fsync)
        self._arm_shedding()
        self.aborts = {r: 0 for r in ABORT_REASONS}
        self.rejected_at_admission = 0
        self.predicted_ttft_hist: List[float] = []
        self.last_predicted_ttft_s: Optional[float] = None
        self.overloaded = False

    # -- arming (DISARMED discipline) -----------------------------------
    def _arm_shedding(self) -> None:
        """Arm the SLO admission gate, or warn loudly (DISARMED) naming
        the blocker — the armed-or-warns discipline graftlint enforces
        on every ``_arm_*``/``*_armed`` site."""
        self.shedding_armed = False
        cfg = self.config
        if cfg.slo_ttft_s is None:
            return
        if cfg.slo_ttft_s <= 0:
            logger.warning(
                "serving reliability: SLO shedding DISARMED — "
                "slo_ttft_s=%g is not positive; admission gate off, "
                "overload will queue unboundedly.", cfg.slo_ttft_s)
            return
        if self.engine.scheduler.policy != "continuous":
            logger.warning(
                "serving reliability: SLO shedding DISARMED — the "
                "'%s' scheduler policy gates admission on batch "
                "membership, which the predicted-TTFT model does not "
                "describe; use policy='continuous'.",
                self.engine.scheduler.policy)
            return
        self.shedding_armed = True

    # -- predicted TTFT (the admission model) ---------------------------
    def measured_tpot_s(self) -> Optional[float]:
        """Measured per-token time: the finished-request TPOT when
        available, else the per-step wall-time EMA (one decode step =
        one token per running lane, so they coincide at steady state)."""
        m = self.engine.metrics
        return m.tpot() or m.step_time()

    def predicted_ttft_s(self, extra_tokens: int = 0) -> Optional[float]:
        """Queue-depth x measured-TPOT prediction of a new arrival's
        TTFT: steps to absorb every queued prefill token at one
        ``prefill_chunk`` per step (plus one final-chunk step per queued
        request), times the measured step time.  None until a step time
        has been measured (an idle engine admits freely)."""
        tpot = self.measured_tpot_s()
        if tpot is None:
            return None
        sch = self.engine.scheduler
        chunk = self.engine.prefill_chunk
        toks = sch.queued_prefill_tokens() + int(extra_tokens)
        steps = -(-toks // chunk) + len(sch.waiting())
        return steps * tpot

    # -- hooks the engine drives ----------------------------------------
    def on_submit(self, req) -> str:
        """Admission decision for ``req``: ``"admit"`` or ``"reject"``.
        Under predicted overload, lower-priority WAITING work is shed
        (aborted with reason ``shed``) before the newcomer is rejected;
        the newcomer is only turned away when it is itself the least
        important."""
        if not self.shedding_armed:
            if self.journal is not None:
                self.journal.record_submit(req)
            return "admit"
        limit = self.config.slo_ttft_s * self.config.slo_headroom
        extra = len(req.full_tokens)     # prompt (+ recovered generated)
        pred = self.predicted_ttft_s(extra_tokens=extra)
        if pred is not None:
            self.last_predicted_ttft_s = pred
            self.predicted_ttft_hist.append(pred)
        while pred is not None and pred > limit:
            victim = self._shed_victim(than=req)
            if victim is None:
                break
            self.engine._abort(victim, ABORT_SHED)
            pred = self.predicted_ttft_s(extra_tokens=extra)
        self.overloaded = pred is not None and pred > limit
        if self.overloaded:
            self.rejected_at_admission += 1
            self.aborts[ABORT_SHED] += 1
            return "reject"
        if self.journal is not None:
            self.journal.record_submit(req)
        return "admit"

    def _shed_victim(self, *, than):
        """Least-important (largest priority value), youngest WAITING
        request STRICTLY less important than ``than`` — shedding never
        touches running work (their KV investment is sunk) nor peers of
        equal importance (FCFS stays honest within a class)."""
        waiting = [r for r in self.engine.scheduler.waiting()
                   if r.priority > than.priority]
        if not waiting:
            return None
        return max(waiting, key=lambda r: (r.priority, r.submit_seq))

    def on_token(self, req, token: int) -> None:
        if self.journal is not None:
            self.journal.record_token(req.rid, token)

    def on_finish(self, req, reason: str) -> None:
        if reason in self.aborts:
            self.aborts[reason] += 1
        if self.journal is not None:
            self.journal.record_end(req.rid, reason)

    def on_step_end(self) -> None:
        """Step-boundary durability point (journal commit)."""
        if self.journal is not None:
            self.journal.commit()

    # -- reporting ------------------------------------------------------
    def journal_depth(self) -> int:
        return self.journal.depth if self.journal is not None else 0

    def report(self) -> dict:
        m = self.engine.metrics
        hist = self.predicted_ttft_hist
        return {
            "armed": {
                "shedding": self.shedding_armed,
                "journal": self.journal is not None,
                "deadlines": self.config.default_deadline_s is not None,
            },
            "aborts": dict(self.aborts),
            "admission": {
                "slo_ttft_s": self.config.slo_ttft_s,
                "slo_headroom": self.config.slo_headroom,
                "overloaded": self.overloaded,
                "rejected": self.rejected_at_admission,
                "predicted_ttft_s": {
                    "last": self.last_predicted_ttft_s,
                    "mean": (sum(hist) / len(hist)) if hist else None,
                },
                "measured_ttft_s": {
                    "mean": (sum(m.ttft) / len(m.ttft)) if m.ttft else None,
                },
                "measured_tpot_s": self.measured_tpot_s(),
            },
            "journal_depth": self.journal_depth(),
            "journal_path": (self.journal.path
                             if self.journal is not None else None),
            "draining": self.engine.scheduler.draining,
        }
