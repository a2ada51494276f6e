"""Fault-injection hooks for resilience testing.

A ``ChaosPlan`` armed via :func:`arm` lets tests kill a checkpoint write
mid-flight (after N leaf files, or at a named commit point), corrupt the
bytes of a just-written file, or poison gradients with NaN for a step
window — proving end-to-end that the atomic commit path and the watchdog
actually recover.  All hooks are no-ops when nothing is armed, so the
production code paths pay one ``is None`` check.

Never arm chaos outside tests.
"""
import os
import threading

from deepspeed_tpu_torch.utils.logging import logger


class ChaosInterrupt(RuntimeError):
    """Simulated preemption: raised from inside a checkpoint write."""


class ChaosPlan:
    """Counters for one armed fault scenario (see :func:`arm`)."""

    def __init__(self, kill_after_files=None, kill_at_point=None,
                 corrupt_after_files=None, corrupt_nbytes=4,
                 nan_grad_steps=0, cancel_request_every=0,
                 preempt_after_steps=0, kill_serving_after_steps=0,
                 slow_serving_step_every=0, slow_serving_step_s=0.05,
                 poison_logits_at_step=0, burst_arrival_every=0,
                 burst_arrival_count=0, kill_replica_after_steps=0,
                 kill_replica=0, slow_replica_step_every=0,
                 slow_replica=0, slow_replica_step_s=0.05,
                 kill_ranks=(), fail_step_transient=0,
                 fail_step_transient_count=1, silence_heartbeat=None,
                 kill_once_at_point=None, flip_bits=(),
                 spike_loss_at_step=0, spike_loss_magnitude=64.0,
                 kill_process_ranks=()):
        self.kill_after_files = kill_after_files
        self.kill_at_point = kill_at_point
        self.kill_once_at_point = kill_once_at_point
        self.kill_ranks = tuple(tuple(p) for p in (kill_ranks or ()))
        self.kill_process_ranks = [tuple(p)
                                   for p in (kill_process_ranks or ())]
        self.fail_step_transient = fail_step_transient
        self.fail_step_transient_count = fail_step_transient_count
        self.silence_heartbeat = tuple(silence_heartbeat) \
            if silence_heartbeat else None
        self.corrupt_after_files = corrupt_after_files
        self.corrupt_nbytes = corrupt_nbytes
        self.nan_grad_steps = nan_grad_steps
        self.cancel_request_every = cancel_request_every
        self.preempt_after_steps = preempt_after_steps
        self.kill_serving_after_steps = kill_serving_after_steps
        self.slow_serving_step_every = slow_serving_step_every
        self.slow_serving_step_s = slow_serving_step_s
        self.poison_logits_at_step = poison_logits_at_step
        self.burst_arrival_every = burst_arrival_every
        self.burst_arrival_count = burst_arrival_count
        self.kill_replica_after_steps = kill_replica_after_steps
        self.kill_replica = kill_replica
        self.slow_replica_step_every = slow_replica_step_every
        self.slow_replica = slow_replica
        self.slow_replica_step_s = slow_replica_step_s
        # silent-corruption injectors: pending single-bit
        # flips as (target, rank, step, leaf, element, bit) tuples, and
        # the one-shot loss-spike window
        self.flip_bits = [tuple(f) for f in (flip_bits or ())]
        self.spike_loss_at_step = spike_loss_at_step
        self.spike_loss_magnitude = spike_loss_magnitude
        self.files_written = 0
        self.fired = []
        self._lock = threading.Lock()


_plan = None


def arm(**kwargs):
    """Arm a fault scenario.

    kill_after_files=N   raise ChaosInterrupt right after the Nth leaf file
                         of a checkpoint write lands (1-based).
    kill_at_point=NAME   raise ChaosInterrupt at a named commit point:
                         'before_manifest' | 'before_rename' | 'before_latest'.
    corrupt_after_files=N  flip bytes in the Nth written file (silent disk
                         corruption; the manifest checksum must catch it).
    nan_grad_steps=K     poison the gradient accumulator with NaN for the
                         next K optimizer steps (drives overflow/NaN streaks).
    cancel_request_every=N  have the serving scheduler cancel its youngest
                         running request every Nth step (request-churn
                         chaos for the continuous-batching engine).
    preempt_after_steps=N  deliver a graceful-preemption signal (the
                         SIGTERM analog) after N more optimizer steps:
                         the engine forces a synchronous emergency save
                         and raises GracefulPreemption.  Combine with
                         kill_at_point to model a hard kill landing
                         MID-preempt-save.
    kill_serving_after_steps=N  raise ChaosInterrupt MID-DECODE at serving
                         step N — after the decode dispatch, before any
                         host bookkeeping or journal commit: the host
                         crash the request journal must recover from.
    slow_serving_step_every=N, slow_serving_step_s=S  sleep S seconds in
                         every Nth serving step (wedged host / slow
                         device sim; the serving stall detector's food).
    poison_logits_at_step=N  inject NaN into the YOUNGEST running lane's
                         embedding at serving step N — its logits go
                         non-finite and the engine must quarantine that
                         request without touching its batch peers.
    burst_arrival_every=N, burst_arrival_count=K  release K extra request
                         arrivals every Nth serving step (thundering-herd
                         traffic; drivers query serving_burst()).
    kill_replica_after_steps=N, kill_replica=R  hard-down one FLEET
                         replica: raise ChaosInterrupt mid-decode on
                         EVERY step >= N of replica R (unlike the
                         one-shot kill_serving latch — a dead host fails
                         every retry, which is what the router's
                         circuit breaker must observe to mark it dead).
    slow_replica_step_every=N, slow_replica=R, slow_replica_step_s=S
                         sleep S seconds in every Nth step of fleet
                         replica R only (one wedged host in an otherwise
                         healthy fleet; feeds that replica's stall
                         detector without touching its peers).
    kill_ranks=((R, N), ...)  hard-down simulated TRAINING host R at
                         supervisor wall step N: it stops heartbeating
                         and stays down forever (a dead host fails every
                         retry — the supervisor's circuit breaker must
                         reach a coordinated dead verdict and restart
                         elastically on the survivors).  Multiple pairs
                         model chained failures (a second rank dying
                         during recovery from the first).
    fail_step_transient=N, fail_step_transient_count=K  raise a
                         TRANSIENT fault in the supervised step from
                         wall step N, for K consecutive attempts
                         (K=1: the first in-place retry succeeds —
                         no rollback; K > max_transient_retries:
                         the retry ladder exhausts and escalates to a
                         coordinated rollback).
    silence_heartbeat=(R, N, W)  simulated host R stops heartbeating for
                         W wall steps starting at step N WITHOUT dying —
                         a network partition / GC pause; shorter than
                         the heartbeat window it is honest downtime,
                         longer and the supervisor correctly declares
                         the unreachable host dead.
    kill_once_at_point=NAME  like kill_at_point but fires exactly once —
                         for killing a RECOVERY mid-flight (e.g.
                         'before_rollback_load' / 'before_restart_load')
                         while letting the supervisor's bounded retry
                         of that recovery then succeed.
    flip_bits=((target, rank, step, leaf, element, bit), ...)  pending
                         silent single-bit flips (usually armed via the
                         flip_bit()/corrupt_opt_state() helpers): flip
                         one bit of one element of one state leaf on ONE
                         dp rank's replica at a step boundary — finite-
                         but-wrong numbers the integrity sentinels and
                         cross-replica vote must catch.
    spike_loss_at_step=N, spike_loss_magnitude=M  one-shot PaLM-style
                         loss spike: the batch feeding step N is scaled
                         by M (anomalous data, symmetric across ranks —
                         rollback-and-skip territory, not quarantine).
    kill_process_ranks=((R, N), ...)  SIGKILL the REAL worker process
                         behind transport peer R at wall step N (the
                         ProcessTransport heartbeat tick consults this
                         and delivers kill(2) for real — nothing
                         simulated about the death or the verdict that
                         follows; the in-process transport's analog is
                         kill_ranks).  Each pair fires once.
    """
    global _plan
    _plan = ChaosPlan(**kwargs)
    return _plan


def disarm():
    global _plan
    _plan = None


def active():
    return _plan


def file_written(path):
    """Called by the atomic writer after each payload lands on disk.

    ``path`` may be a directory (the orbax backend writes a sharded tree);
    corruption then hits the largest file inside it.
    """
    if _plan is None:
        return
    with _plan._lock:
        _plan.files_written += 1
        n = _plan.files_written
    if _plan.corrupt_after_files is not None and n == _plan.corrupt_after_files:
        target = path
        if os.path.isdir(path):
            inner = [os.path.join(root, name)
                     for root, _dirs, names in os.walk(path)
                     for name in names]
            target = max(inner, key=os.path.getsize, default=None)
        if target is not None and os.path.isfile(target):
            corrupt_file(target, nbytes=_plan.corrupt_nbytes)
            _plan.fired.append(("corrupt", target))
        else:
            logger.warning(f"chaos: corrupt target {path} has no file; "
                           f"nothing corrupted")
    if _plan.kill_after_files is not None and n >= _plan.kill_after_files:
        _plan.fired.append(("kill_after_files", path))
        raise ChaosInterrupt(
            f"chaos: killed checkpoint write after {n} files ({path})")


# telemetry observers: called on chaos-relevant moments (commit points
# reached, injected faults firing) so armed tracers can drop instant
# events next to the spans they perturb.  Observers must be cheap,
# exception-free host work; they NEVER influence the chaos plan.
_observers = []


def add_observer(cb):
    """Register ``cb(kind, detail=None)``; returns cb (for removal)."""
    _observers.append(cb)
    return cb


def remove_observer(cb):
    try:
        _observers.remove(cb)
    except ValueError:
        pass


def _notify(kind, detail=None):
    for cb in _observers:
        cb(kind, detail)


def point(name):
    """Called by the atomic writer (and the supervisor's recovery paths)
    at named commit points."""
    _notify(f"point_{name}")
    if _plan is not None and _plan.kill_once_at_point == name:
        _plan.kill_once_at_point = None     # one-shot: the retry survives
        _plan.fired.append(("kill_once_at_point", name))
        raise ChaosInterrupt(f"chaos: one-shot kill at {name!r}")
    if _plan is not None and _plan.kill_at_point == name:
        _plan.fired.append(("kill_at_point", name))
        raise ChaosInterrupt(f"chaos: killed checkpoint commit at {name!r}")


def rank_dead(rank, step_index):
    """True when an armed ``kill_ranks`` plan has simulated host ``rank``
    hard-down at supervisor wall step ``step_index``.  Monotone: once a
    host's kill step passes it is dead on every later query (a downed
    host fails every retry — that is what distinguishes lost capacity
    from a transient fault)."""
    if _plan is None or not _plan.kill_ranks:
        return False
    for r, s in _plan.kill_ranks:
        if r == rank and step_index >= s:
            with _plan._lock:
                if ("kill_rank", (r, s)) not in _plan.fired:
                    _plan.fired.append(("kill_rank", (r, s)))
            _notify("kill_rank", rank)
            return True
    return False


def process_kill_due(rank, step_index):
    """One-shot query: True when an armed ``kill_process_ranks`` plan
    wants transport peer ``rank``'s REAL process SIGKILLed at/after
    wall step ``step_index``.  Consumes the pair — the kill itself is
    permanent (a killed process stays dead without chaos re-firing),
    so unlike ``rank_dead`` this is not re-queried every tick."""
    if _plan is None or not _plan.kill_process_ranks:
        return False
    with _plan._lock:
        for i, (r, s) in enumerate(_plan.kill_process_ranks):
            if r == rank and step_index >= s:
                del _plan.kill_process_ranks[i]
                _plan.fired.append(("kill_process", (r, s)))
                break
        else:
            return False
    _notify("kill_process", rank)
    return True


def heartbeat_silenced(rank, step_index):
    """True while an armed ``silence_heartbeat=(rank, start, window)``
    plan keeps simulated host ``rank`` mute (alive but unreachable)."""
    if _plan is None or _plan.silence_heartbeat is None:
        return False
    r, start, window = _plan.silence_heartbeat
    if rank != r or not (start <= step_index < start + window):
        return False
    with _plan._lock:
        _plan.fired.append(("silence_heartbeat", (rank, step_index)))
    return True


def consume_transient_fault(step_index):
    """One transient supervised-step fault; True while the armed budget
    lasts at/after the armed wall step.  Each True consumes one unit of
    ``fail_step_transient_count``, so retries genuinely re-attempt: a
    count of 1 fails once and the in-place retry succeeds, a count
    above the supervisor's retry ladder escalates to rollback."""
    if _plan is None or not _plan.fail_step_transient:
        return False
    if step_index < _plan.fail_step_transient \
            or _plan.fail_step_transient_count <= 0:
        return False
    with _plan._lock:
        _plan.fail_step_transient_count -= 1
        _plan.fired.append(("fail_step_transient", step_index))
    _notify("fail_step_transient", step_index)
    return True


def serving_cancel_request(step_index):
    """True when an armed plan wants the serving scheduler to cancel a
    running request at this (1-based) scheduler step — the request-churn
    analog of nan_grad_steps, driven through the user-facing cancel path
    (serving/scheduler.py::Scheduler.chaos_cancel).  Pure
    query: the scheduler records via record_serving_cancel only when a
    victim actually exists, so ``fired`` audits real cancellations."""
    if _plan is None or not _plan.cancel_request_every:
        return False
    return step_index % _plan.cancel_request_every == 0


def record_serving_cancel(rid):
    """Audit one ACTUAL chaos-driven request cancellation."""
    _notify("cancel_request", rid)
    if _plan is not None:
        with _plan._lock:
            _plan.fired.append(("cancel_request", rid))


def serving_kill_step(step_index):
    """Kill-mid-decode: raises ChaosInterrupt the first time the serving
    engine reaches an armed step — called AFTER the decode dispatch and
    BEFORE host bookkeeping, so the step's tokens are lost exactly like
    a real host crash (the journal holds state as of the last commit)."""
    if _plan is None or not _plan.kill_serving_after_steps:
        return
    if step_index < _plan.kill_serving_after_steps:
        return
    with _plan._lock:
        if any(kind == "kill_serving" for kind, _ in _plan.fired):
            return
        _plan.fired.append(("kill_serving", step_index))
    raise ChaosInterrupt(
        f"chaos: killed serving host mid-decode at step {step_index}")


def serving_slow_step_s(step_index):
    """Seconds to stall this serving step (0.0 = no fault armed)."""
    if _plan is None or not _plan.slow_serving_step_every:
        return 0.0
    if step_index % _plan.slow_serving_step_every:
        return 0.0
    with _plan._lock:
        _plan.fired.append(("slow_serving_step", step_index))
    return _plan.slow_serving_step_s


def serving_poison_step(step_index):
    """True when an armed plan wants NaN injected into one decode lane
    at this serving step (the engine picks the youngest running request
    as the deterministic victim and must quarantine it)."""
    if _plan is None or not _plan.poison_logits_at_step:
        return False
    return step_index == _plan.poison_logits_at_step


def record_serving_poison(rid):
    """Audit one ACTUAL poison injection (a victim lane existed)."""
    _notify("poison_logits", rid)
    if _plan is not None:
        with _plan._lock:
            _plan.fired.append(("poison_logits", rid))


def serving_burst(step_index):
    """Extra request arrivals to release at this serving step — traffic
    drivers (tools/serve_bench.py, tests) query it so thundering-herd
    bursts run through the same arming/audit machinery as every other
    fault."""
    if _plan is None or not _plan.burst_arrival_every:
        return 0
    if step_index % _plan.burst_arrival_every:
        return 0
    with _plan._lock:
        _plan.fired.append(("burst_arrival", step_index))
    return _plan.burst_arrival_count


def fleet_kill_replica_step(replica_index, step_index):
    """Hard-down replica simulation: raises ChaosInterrupt MID-DECODE
    (after the dispatch, before any host bookkeeping — the same crash
    point as ``serving_kill_step``) on EVERY step >= N of the armed
    replica.  Unlike the single-engine kill's one-shot latch, a downed
    host keeps failing, so the fleet router's bounded retry/backoff
    exhausts its circuit breaker and marks the replica dead.  No-op for
    other replicas and for engines that are not fleet-tagged
    (``replica_index is None``)."""
    if _plan is None or not _plan.kill_replica_after_steps \
            or replica_index is None:
        return
    if replica_index != _plan.kill_replica \
            or step_index < _plan.kill_replica_after_steps:
        return
    with _plan._lock:
        _plan.fired.append(("kill_replica", (replica_index, step_index)))
    _notify("kill_replica", replica_index)
    raise ChaosInterrupt(
        f"chaos: fleet replica {replica_index} killed mid-decode at "
        f"step {step_index}")


def fleet_slow_replica_s(replica_index, step_index):
    """Seconds to stall this step of ONE fleet replica (0.0 = not this
    replica / nothing armed) — the per-replica analog of
    ``serving_slow_step_s`` that lets a fleet test wedge a single host
    while its peers keep serving."""
    if _plan is None or not _plan.slow_replica_step_every \
            or replica_index is None:
        return 0.0
    if replica_index != _plan.slow_replica:
        return 0.0
    if step_index % _plan.slow_replica_step_every:
        return 0.0
    with _plan._lock:
        _plan.fired.append(("slow_replica", (replica_index, step_index)))
    _notify("slow_replica", replica_index)
    return _plan.slow_replica_step_s


def consume_preempt_step():
    """One optimizer step toward an armed graceful preemption; True on
    the step the budget exhausts — the engine must then run its preempt
    checkpoint and raise GracefulPreemption.  Fires once; the engine
    latches its own request flag (a real SIGTERM does not un-deliver
    itself), so repeated polls need no chaos state."""
    if _plan is None or _plan.preempt_after_steps <= 0:
        return False
    with _plan._lock:
        _plan.preempt_after_steps -= 1
        if _plan.preempt_after_steps > 0:
            return False
        _plan.preempt_after_steps = 0
        if not any(kind == "preempt" for kind, _ in _plan.fired):
            _plan.fired.append(("preempt", None))
    return True


def preempt_then_resume(run_fn, resume_fn, preempt_after_steps,
                        kill_at_point=None, **extra_arm):
    """Scenario driver: graceful-preempt a training run, then restart it
    (typically on a SMALLER mesh) — the elastic analog of the
    kill-mid-write chaos tests.

    ``run_fn()`` drives training until the armed preemption interrupts
    it (GracefulPreemption after the forced save; ChaosInterrupt when
    ``kill_at_point`` models a hard kill landing mid-save).  Chaos is
    disarmed, then ``resume_fn()`` builds the restart-world engine and
    resumes.  Returns ``(resume_result, interrupt)`` so the test can
    assert both the landing checkpoint and the interrupt kind.
    """
    from deepspeed_tpu_torch.runtime.resilience.watchdog import \
        GracefulPreemption

    arm(preempt_after_steps=preempt_after_steps,
        kill_at_point=kill_at_point, **extra_arm)
    interrupt = None
    try:
        run_fn()
        raise AssertionError(
            "chaos preempt scenario: run_fn returned without the armed "
            "preemption firing — not enough steps?")
    except (GracefulPreemption, ChaosInterrupt) as e:
        interrupt = e
    finally:
        disarm()
    return resume_fn(), interrupt


def consume_nan_grad_step():
    """One poisoned optimizer step; returns True while the budget lasts."""
    if _plan is None or _plan.nan_grad_steps <= 0:
        return False
    _plan.nan_grad_steps -= 1
    _plan.fired.append(("nan_grads", _plan.nan_grad_steps))
    return True


def flip_bit(rank, step, leaf=0, element=0, bit=30, target="params"):
    """Arm a SINGLE-BIT flip in dp rank ``rank``'s replica of one state
    leaf, applied at the step-``step`` boundary (after that step's
    optimizer update commits) — the silent-data-corruption injector.
    The flipped replica stays finite, so nothing in the
    NaN/overflow machinery fires: only the integrity sentinels (z-score
    on loss/grad-norm/update-ratio) and the cross-replica checksum vote
    can see it.  ``leaf`` indexes ``state.params`` (or ``state.
    opt_state`` with ``target="opt"``, the fp32 master with
    ``target="master"``) in flatten order; ``element`` is
    the flat element, ``bit`` the fp32 word bit (default 30, the top
    exponent bit — clear on any weight with |w| < 1, so the flip
    inflates it by ~2^124: loud but finite).  Composes with an already-armed plan, or
    arms a fresh one."""
    plan = _plan if _plan is not None else arm()
    with plan._lock:
        plan.flip_bits.append((str(target), int(rank), int(step),
                               int(leaf), int(element), int(bit)))
    return plan


def corrupt_opt_state(rank, step, leaf=0, element=0, bit=30):
    """Arm a single-bit flip in one OPTIMIZER-STATE leaf on dp rank
    ``rank`` (applied at the step-``step`` boundary).  Physics note:
    under ZeRO sharding the optimizer shard has no replica — the
    corruption propagates symmetrically through the parameter exchange,
    so it is caught by the sentinels (and rolled back), not attributed
    to a rank by the vote.  That asymmetry is exactly what the e2e
    tests pin."""
    return flip_bit(rank, step, leaf=leaf, element=element, bit=bit,
                    target="opt")


def spike_loss(step, magnitude=64.0):
    """Arm a one-shot PaLM-style loss spike: the batch that feeds
    optimizer step ``step`` has its float features scaled by
    ``magnitude`` (anomalous DATA, not a rank fault) — losses and
    gradients spike finite-but-wrong on EVERY rank, the cross-replica
    vote stays unanimous, and the correct response is rollback plus
    skipping the offending data window."""
    plan = _plan if _plan is not None else arm()
    plan.spike_loss_at_step = int(step)
    plan.spike_loss_magnitude = float(magnitude)
    return plan


def consume_bit_flips(step_index):
    """Pending bit flips due at/before this completed optimizer step, as
    ``(target, rank, leaf, element, bit)`` tuples; each fires once."""
    if _plan is None or not _plan.flip_bits:
        return []
    due = []
    with _plan._lock:
        rest = []
        for target, rank, step, leaf, element, bit in _plan.flip_bits:
            if step_index >= step:
                due.append((target, rank, leaf, element, bit))
                _plan.fired.append(("flip_bit",
                                    (target, rank, step, leaf, element,
                                     bit)))
            else:
                rest.append((target, rank, step, leaf, element, bit))
        _plan.flip_bits = rest
    for f in due:
        _notify("flip_bit", f)
    return due


def maybe_spike_batch(batch, next_step):
    """Scale the batch feeding optimizer step ``next_step`` when a
    ``spike_loss`` plan is armed for it (one-shot).  Host-side, float
    arrays only — integer ids/labels pass through untouched."""
    if _plan is None or not _plan.spike_loss_at_step \
            or next_step != _plan.spike_loss_at_step:
        return batch
    with _plan._lock:
        if any(kind == "spike_loss" for kind, _ in _plan.fired):
            return batch
        _plan.fired.append(("spike_loss", next_step))
    _notify("spike_loss", next_step)
    import numpy as np

    mag = _plan.spike_loss_magnitude

    def scale(x):
        a = np.asarray(x)
        if np.issubdtype(a.dtype, np.floating):
            return a * a.dtype.type(mag)
        return x

    logger.warning(f"chaos: spiked the batch feeding step {next_step} "
                   f"by x{mag:g} (finite anomalous data)")
    if isinstance(batch, dict):
        return {k: scale(v) for k, v in batch.items()}
    return scale(batch)


def corrupt_file(path, offset=0, nbytes=4):
    """Flip ``nbytes`` bytes of ``path`` in place (silent bit rot)."""
    # intentional corruption — the write the manifest checksums must catch
    with open(path, "r+b") as f:  # graftlint: disable=raw-ckpt-write
        f.seek(offset)
        chunk = f.read(nbytes)
        f.seek(offset)
        f.write(bytes(b ^ 0xFF for b in chunk))
    logger.warning(f"chaos: corrupted {nbytes} bytes of {path} at {offset}")


def truncate_file(path, keep_bytes=0):
    """Truncate ``path`` to ``keep_bytes`` (partial write / torn page)."""
    # intentional torn-page injection; size check must catch it
    with open(path, "r+b") as f:  # graftlint: disable=raw-ckpt-write
        f.truncate(keep_bytes)
    logger.warning(f"chaos: truncated {path} to {keep_bytes} bytes")
