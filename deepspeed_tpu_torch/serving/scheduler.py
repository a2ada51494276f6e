"""Token-level continuous batching: admit / evict between decode steps.

The scheduler is pure host-side policy — no device state.  It owns the
waiting queue (priority classes, FCFS within a class), the running-slot
map, the single in-flight chunked prefill, and the victim choice for
eviction.  The engine consults it between decode steps; every decision
is deterministic (heap keyed on (priority, submit_seq)) so parity tests
can replay exact schedules.

Policies:

- ``continuous`` (the point of this subsystem): a slot freed by a
  finished/evicted/cancelled request is refilled on the very next step;
- ``static`` (the naive baseline tools/serve_bench.py measures against):
  admission only happens while the batch gate is open — the gate opens
  when the engine fully drains and closes once the batch is formed, so
  every batch runs to its slowest member like a classic batched
  ``generate()`` call.

Eviction: when the KV pool cannot cover a growth or an admission, the
victim is the least-important (highest priority value), youngest running
request — preempted requests keep their generated tokens and re-enter
the waiting queue for a chunked re-prefill of prompt+generated (the
recompute flavor of preemption; parity tests pin that the continuation
is bit-identical).  Admission only ever preempts STRICTLY less important
requests; growth of a running sequence may preempt its own class but
never a more important one, and self-evicts when nothing else yields.

Chaos tie-in: ``chaos_cancel`` consults
runtime/resilience/chaos.serving_cancel_request so fault-injection tests
can drive request-cancellation churn through the same code path users
hit.
"""
import heapq
import itertools
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional

import numpy as np

from deepspeed_tpu_torch.runtime.resilience import chaos


class RequestState(Enum):
    WAITING = "waiting"
    PREFILL = "prefill"
    RUNNING = "running"
    FINISHED = "finished"
    CANCELLED = "cancelled"


@dataclass
class Request:
    """One generation request.  ``generated`` survives eviction: on
    re-admission the prefill covers prompt+generated and decoding
    continues where it stopped."""
    rid: int
    prompt: np.ndarray                 # (S0,) int32
    max_new_tokens: int
    priority: int = 0                  # lower = more important
    eos_token_id: Optional[int] = None
    seed: int = 0
    # -- reliability (serving/reliability.py) -------------
    deadline_s: Optional[float] = None   # relative budget (journaled)
    deadline: Optional[float] = None     # absolute, in the engine's clock
    work_budget: Optional[int] = None    # max scheduled token-writes
    # -- dynamic state --------------------------------------------------
    state: RequestState = RequestState.WAITING
    generated: List[int] = field(default_factory=list)
    prefill_done: int = 0              # pool positions already written
    slot: Optional[int] = None
    shard: int = 0
    submit_seq: int = -1
    evictions: int = 0
    work_done: int = 0                 # token-writes scheduled so far
    fair_chunks: int = 0               # chunks since last fairness pause
    finish_reason: Optional[str] = None

    @property
    def full_tokens(self) -> np.ndarray:
        """Every KNOWN token — what a (re-)prefill must cover."""
        return np.concatenate(
            [self.prompt, np.asarray(self.generated, np.int32)]) \
            if self.generated else self.prompt

    @property
    def remaining_new_tokens(self) -> int:
        return self.max_new_tokens - len(self.generated)

    @property
    def done(self) -> bool:
        if self.remaining_new_tokens <= 0:
            return True
        return (self.eos_token_id is not None and self.generated
                and self.generated[-1] == self.eos_token_id)

    def sort_key(self):
        return (self.priority, self.submit_seq)


class Scheduler:
    def __init__(self, max_slots: int, *, policy: str = "continuous"):
        assert policy in ("continuous", "static"), policy
        self.max_slots = int(max_slots)
        self.policy = policy
        self._seq = itertools.count()
        self._waiting: List = []                  # heap of (key, rid)
        self.requests: Dict[int, Request] = {}    # every live request
        self.running: Dict[int, Request] = {}     # slot -> Request
        self.prefilling: Optional[Request] = None
        # chunked-prefill fairness (long-context traffic): a huge prompt
        # mid-prefill can be PAUSED — it keeps its slot, blocks and
        # prefill_done, and waits here FIFO while shorter prompts take a
        # turn.  Distinct from _requeue, which resets prefill progress.
        self.paused: List[Request] = []
        # static-policy batch gate: a batch's MEMBERSHIP is fixed when it
        # forms — the budget stops freed lanes from being refilled until
        # the whole batch drains (that refill IS continuous batching)
        self._gate_open = True
        self._batch_left = self.max_slots
        self.chaos_step = 0
        # graceful drain (engine.request_drain / SIGTERM): admission
        # stops, in-flight work runs to completion, waiting requests
        # stay journaled for a successor's recover()
        self.draining = False

    # -- queue ----------------------------------------------------------
    def submit(self, req: Request) -> None:
        req.submit_seq = next(self._seq)
        req.state = RequestState.WAITING
        self.requests[req.rid] = req
        heapq.heappush(self._waiting, (req.sort_key(), req.rid))

    def _requeue(self, req: Request) -> None:
        # preempted requests keep their ORIGINAL submit_seq: FCFS age, not
        # eviction time, decides their place back in line
        req.state = RequestState.WAITING
        req.prefill_done = 0
        req.slot = None
        heapq.heappush(self._waiting, (req.sort_key(), req.rid))

    def _pop_waiting(self) -> Optional[Request]:
        while self._waiting:
            _, rid = heapq.heappop(self._waiting)
            req = self.requests.get(rid)
            if req is not None and req.state is RequestState.WAITING:
                return req
        return None

    def peek_waiting(self) -> Optional[Request]:
        while self._waiting:
            _, rid = self._waiting[0]
            req = self.requests.get(rid)
            if req is not None and req.state is RequestState.WAITING:
                return req
            heapq.heappop(self._waiting)
        return None

    def queue_depth(self) -> int:
        return sum(1 for r in self.requests.values()
                   if r.state is RequestState.WAITING)

    def waiting(self) -> List[Request]:
        """Every WAITING request (shed-victim selection + the admission
        gate's queue accounting)."""
        return [r for r in self.requests.values()
                if r.state is RequestState.WAITING]

    def queued_prefill_tokens(self) -> int:
        """Prefill tokens the engine still owes the queue: every waiting
        request's known tokens plus the in-flight prefill's remainder —
        the numerator of the predicted-TTFT admission model."""
        toks = sum(len(r.full_tokens) for r in self.requests.values()
                   if r.state is RequestState.WAITING)
        if self.prefilling is not None:
            toks += len(self.prefilling.full_tokens) \
                - self.prefilling.prefill_done
        for r in self.paused:
            toks += len(r.full_tokens) - r.prefill_done
        return toks

    def has_work(self) -> bool:
        return bool(self.running) or self.prefilling is not None \
            or bool(self.paused) or self.queue_depth() > 0

    def in_flight(self) -> bool:
        """Admitted work only (what a graceful drain must finish)."""
        return bool(self.running) or self.prefilling is not None \
            or bool(self.paused)

    # -- slots ----------------------------------------------------------
    # the engine installs a ranker so admission steers toward the slot
    # whose pool shard has the most free blocks (ties -> lowest slot);
    # with a candidate request the ranker also sees it, so prefix-cache
    # placement can prefer the shard already holding the prompt's KV;
    # without a ranker, first-free wins
    slot_ranker = None
    # the engine installs a probe that consults the pool's prefix tree at
    # admission time: cached prompt blocks are mapped read-only into the
    # new request's page table and its ``prefill_done`` advances past
    # them, so the engine skips the covered prefill chunks entirely
    prefix_probe = None

    def free_slot(self, req: Optional[Request] = None) -> Optional[int]:
        taken = set(self.running)
        if self.prefilling is not None and self.prefilling.slot is not None:
            taken.add(self.prefilling.slot)
        for p in self.paused:      # paused prefills keep their slot
            if p.slot is not None:
                taken.add(p.slot)
        free = [s for s in range(self.max_slots) if s not in taken]
        if not free:
            return None
        if self.slot_ranker is None:
            return free[0]
        return max(free, key=lambda s: (self.slot_ranker(s, req), -s))

    def may_admit(self) -> bool:
        if self.draining:
            return False
        if self.policy == "continuous":
            return True
        return self._gate_open

    def on_drained(self) -> None:
        """Engine signal: no running, no prefilling — a static batch may
        form again."""
        if not self.running and self.prefilling is None:
            self._gate_open = True
            self._batch_left = self.max_slots

    def start_admission(self) -> Optional[Request]:
        """Pop the next admissible request into the PREFILL state (the
        engine assigns shard + drives chunks).  None when no slot, no
        candidate, or the static gate is closed."""
        if self.prefilling is not None or not self.may_admit():
            return None
        slot = self.free_slot(self.peek_waiting())
        if slot is None:
            return None
        req = self._pop_waiting()
        if req is None:
            if self.policy == "static" and (self.running or self.prefilling):
                self._gate_open = False   # batch formed: queue exhausted
            return None
        if self.policy == "static":
            self._batch_left -= 1
            if self._batch_left <= 0:
                self._gate_open = False   # batch formed: slots budgeted
        req.state = RequestState.PREFILL
        req.slot = slot
        self.prefilling = req
        if self.prefix_probe is not None:
            # admission consults the prefix tree: cached prompt blocks
            # are attached read-only and their prefill chunks skipped
            self.prefix_probe(req)
        return req

    def promote(self, req: Request) -> None:
        """Prefill finished: the request joins the decode batch."""
        assert req is self.prefilling
        self.prefilling = None
        req.state = RequestState.RUNNING
        self.running[req.slot] = req

    def adopt_running(self, req: Request, slot: int) -> None:
        """Adopt a migrated-in request DIRECTLY into the decode batch
        (its KV arrived as a paged-block transfer — no prefill here).
        FCFS age restarts in this scheduler's sequence space: the
        request is older than anything submitted after it arrives,
        exactly like a normal admission at this instant."""
        assert slot not in self.running, slot
        assert req.rid not in self.requests, req.rid
        req.submit_seq = next(self._seq)
        req.state = RequestState.RUNNING
        req.slot = slot
        self.requests[req.rid] = req
        self.running[slot] = req

    def drop_prefill(self, req: Request, *, requeue: bool) -> None:
        assert req is self.prefilling
        self.prefilling = None
        if self.policy == "static":
            # the dropped request was the LAST admission: hand its batch
            # budget back (and reopen the gate it may just have closed),
            # or repeated drop/re-admit cycles shrink the batch
            self._batch_left += 1
            self._gate_open = True
        if requeue:
            self._requeue(req)

    # -- chunked-prefill fairness ---------------------------------------
    def pause_prefill(self, req: Request) -> None:
        """Yield the prefill lane mid-prompt: the request keeps its slot,
        pool blocks and ``prefill_done`` (no recompute — unlike
        preemption) and joins the paused FIFO; the lane is free for a
        shorter prompt's turn.  The fairness quantum in the engine
        decides when this fires."""
        assert req is self.prefilling
        self.prefilling = None
        req.fair_chunks = 0
        self.paused.append(req)

    def resume_prefill(self) -> Optional[Request]:
        """Resume the oldest paused prefill (FIFO) when the lane is
        idle.  The engine calls this AFTER trying fresh admissions, so
        paused giants and queued newcomers round-robin the lane."""
        if self.prefilling is not None or not self.paused:
            return None
        req = self.paused.pop(0)
        self.prefilling = req
        return req

    # -- eviction / completion ------------------------------------------
    def victim(self, *, for_req: Request, admission: bool,
               shard: Optional[int] = None) -> Optional[Request]:
        """Who to preempt so ``for_req`` can take blocks.  Admission only
        preempts STRICTLY less important runners; growth may preempt its
        own class (youngest first) but never itself.  ``shard`` filters
        to victims whose blocks actually help (same pool shard)."""
        candidates = [r for r in self.running.values() if r is not for_req]
        if shard is not None:
            candidates = [r for r in candidates if r.shard == shard]
        if admission:
            candidates = [r for r in candidates
                          if r.priority > for_req.priority]
        else:
            candidates = [r for r in candidates
                          if r.priority >= for_req.priority]
        if not candidates:
            return None
        # least important first, then youngest (largest submit_seq)
        return max(candidates,
                   key=lambda r: (r.priority, r.submit_seq))

    def preempt(self, req: Request) -> None:
        """Remove a RUNNING request and requeue it (tokens preserved)."""
        assert req.slot in self.running and self.running[req.slot] is req
        del self.running[req.slot]
        req.evictions += 1
        self._requeue(req)

    def finish(self, req: Request, reason: str = "finished") -> None:
        if req.slot is not None and self.running.get(req.slot) is req:
            del self.running[req.slot]
        if req is self.prefilling:
            self.prefilling = None
        if req in self.paused:
            self.paused.remove(req)
        # every terminal-without-completing reason (cancelled, and the
        # reliability layer's expired/budget/shed/poisoned) lands in the
        # CANCELLED state; only "finished" means the request completed
        req.state = RequestState.FINISHED if reason == "finished" \
            else RequestState.CANCELLED
        req.finish_reason = reason
        # req.slot is deliberately NOT cleared: the engine still needs it
        # to scrub the slot's host arrays (active mask, page-table row)
        self.requests.pop(req.rid, None)

    def cancel(self, rid: int) -> Optional[Request]:
        """Cancel a request in ANY live state; returns it (the engine
        frees its pool blocks) or None if unknown/already finished."""
        req = self.requests.get(rid)
        if req is None:
            return None
        self.finish(req, reason="cancelled")
        return req

    def chaos_cancel(self) -> Optional[int]:
        """Chaos-driven cancellation: when an armed ChaosPlan fires at
        this scheduler step, cancel the YOUNGEST running request
        (deterministic victim) through the normal cancel path."""
        self.chaos_step += 1
        if not chaos.serving_cancel_request(self.chaos_step):
            return None
        if not self.running:
            return None
        victim = max(self.running.values(), key=lambda r: r.submit_seq)
        chaos.record_serving_cancel(victim.rid)
        return victim.rid
