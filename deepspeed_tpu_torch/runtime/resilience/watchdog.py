"""Training watchdog: overflow streaks, NaN losses, wall-clock stalls.

The loss scaler recovers from isolated overflows by halving; what it can't
recover from is a *streak* — scale pinned at ``min_scale`` with every step
skipped, or a NaN loss that no scale change fixes, or a step that simply
never finishes (hung collective, wedged host).  The watchdog turns those
into explicit events:

    wd = TrainingWatchdog(max_skipped_steps=20, max_nan_losses=3,
                          stall_timeout=600)
    wd.add_callback(lambda event: "abort")   # or "continue" to back off

Engines call ``observe_step`` after every optimizer step; an event whose
callbacks vote abort makes ``observe_step`` raise :class:`WatchdogAlarm`
*after* the engine has written an emergency checkpoint.  With no callbacks
the configured default action applies.
"""
import time
from typing import Any, NamedTuple

from deepspeed_tpu_torch.utils.logging import logger

EVENT_OVERFLOW_STREAK = "overflow_streak"
EVENT_NAN_LOSS = "nan_loss"
EVENT_STALL = "stall"
EVENT_INTEGRITY = "silent_corruption"

ACTION_ABORT = "abort"
ACTION_CONTINUE = "continue"


class WatchdogEvent(NamedTuple):
    kind: str        # one of the EVENT_* names
    step: int        # global step when detected
    message: str
    details: Any     # dict of streak counters / timings


class WatchdogAlarm(RuntimeError):
    """Raised out of the training loop when an event's verdict is abort."""

    def __init__(self, event: WatchdogEvent):
        super().__init__(event.message)
        self.event = event


class GracefulPreemption(RuntimeError):
    """Raised out of the training loop AFTER a coordinated emergency
    checkpoint committed (or was skipped with a warning) in response to
    a preemption signal — engine.request_preemption(), an installed
    SIGTERM handler, or a chaos ``preempt_after_steps`` plan.  Catching
    it and exiting 0 is the expected shutdown path on preemptible pods;
    the run resumes elastically via load_checkpoint(auto_resume=True)."""

    def __init__(self, message, tag=None, save_dir=None):
        super().__init__(message)
        self.tag = tag
        self.save_dir = save_dir


# per-signal registry for chain_signal_handlers: ONE dispatcher per
# signal fans out to every registered callback, then to whatever
# non-deepspeed handler was installed before the first registration.
# Bound methods are held as WEAKREFS, so an engine rebuilt per elastic
# restart (or drained and dropped) is never pinned process-global by
# its old SIGTERM hook — dead callbacks silently fall out of the chain.
_SIGNAL_CHAINS = {}     # signum -> {"prev": handler, "cbs": [ref],
#                                    "dispatcher": handler}


def chain_signal_handlers(callback, signals=None):
    """Register ``callback`` on each signal WITHOUT dropping what was
    there: one dispatcher per signal invokes every registered callback
    (newest first), then the prior non-deepspeed Python-level handler.
    ``signal.signal`` is last-wins, so a process that hosts both a
    training engine and a serving engine — or any client SIGTERM hook —
    would silently lose every handler but the final one registered;
    chaining makes ``install_preemption_handler`` safe to call from
    multiple engines in one process.  Re-registering the same callback
    is a no-op (no double-fire), bound methods are weakly referenced
    (a dead engine's hook is dropped, not invoked), and non-callable
    prior dispositions (SIG_DFL/SIG_IGN) are never chained.  Returns
    the list of signal numbers installed.  Main thread only (a Python
    signal-handler constraint)."""
    import signal as signal_mod
    import weakref

    try:
        ref = weakref.WeakMethod(callback)
    except TypeError:
        # plain functions/lambdas: hold strongly (their lifetime is the
        # caller's business, and a lambda has no __self__ to outlive)
        def ref(_cb=callback):
            return _cb

    sigs = tuple(signals) if signals else (signal_mod.SIGTERM,)
    for s in sigs:
        ent = _SIGNAL_CHAINS.get(s)
        current = signal_mod.getsignal(s)
        if ent is None or current is not ent["dispatcher"]:
            # first registration, or someone installed their own handler
            # over our dispatcher since: chain THAT as the new tail, and
            # CARRY the already-registered callbacks into the new chain
            # (they would otherwise be lost with the overridden
            # dispatcher).  The old entry is emptied, not shared: if the
            # foreign handler chained our old dispatcher as ITS tail,
            # that dispatcher now fires only its own pre-us prev —
            # every callback still fires exactly once.
            carried = []
            if ent is not None:
                carried, ent["cbs"] = ent["cbs"], []
            ent = {"prev": current, "cbs": carried}

            def _dispatch(signum, frame, _ent=ent):
                for r in list(_ent["cbs"]):
                    cb = r()
                    if cb is not None:
                        cb()
                if callable(_ent["prev"]):
                    _ent["prev"](signum, frame)

            ent["dispatcher"] = _dispatch
            _SIGNAL_CHAINS[s] = ent
            signal_mod.signal(s, _dispatch)
        live = [r() for r in ent["cbs"]]
        ent["cbs"] = [r for r, cb in zip(ent["cbs"], live) if cb is not None]
        if callback not in [cb for cb in live if cb is not None]:
            ent["cbs"].insert(0, ref)       # newest first
    return list(sigs)


class TrainingWatchdog:
    """Streak/stall detector.  Thresholds of 0 disable that detector."""

    def __init__(self, max_skipped_steps=0, max_nan_losses=0,
                 stall_timeout=0.0, default_action=ACTION_ABORT,
                 clock=time.monotonic):
        self.max_skipped_steps = int(max_skipped_steps)
        self.max_nan_losses = int(max_nan_losses)
        self.stall_timeout = float(stall_timeout)
        self.default_action = default_action
        self._clock = clock
        self._callbacks = []
        self.consecutive_skips = 0
        self.consecutive_nans = 0
        # the stall clock arms on the first completed step (or an explicit
        # heartbeat()) — step 1 includes warm-up work (kernel builds,
        # allocator growth), which would otherwise read as a stall on any
        # big model
        self.last_progress_time = None
        self.events = []  # every event ever fired (tests/inspection)

    def add_callback(self, cb):
        """cb(event) -> 'abort' | 'continue' | None (None = default)."""
        self._callbacks.append(cb)
        return cb

    # -- observations ---------------------------------------------------
    def observe_step(self, step, loss=None, overflow=False):
        """Feed one completed optimizer step; fires any triggered events.

        Returns the list of fired events; raises WatchdogAlarm when the
        verdict for any of them is abort.
        """
        now = self._clock()
        fired = []
        if self.stall_timeout > 0 and self.last_progress_time is not None \
                and now - self.last_progress_time > self.stall_timeout:
            fired.append(WatchdogEvent(
                EVENT_STALL, step,
                f"step {step} took {now - self.last_progress_time:.1f}s "
                f"(stall_timeout={self.stall_timeout:g}s)",
                {"elapsed": now - self.last_progress_time}))
        self.last_progress_time = now

        self.consecutive_skips = self.consecutive_skips + 1 if overflow else 0
        if self.max_skipped_steps > 0 and \
                self.consecutive_skips >= self.max_skipped_steps:
            fired.append(WatchdogEvent(
                EVENT_OVERFLOW_STREAK, step,
                f"{self.consecutive_skips} consecutive overflow-skipped "
                f"steps — loss scale cannot recover",
                {"consecutive_skips": self.consecutive_skips}))

        # the finiteness check forces a host transfer of a device loss —
        # only pay for it when the detector can actually fire
        nan = self.max_nan_losses > 0 and loss is not None \
            and not _is_finite(loss)
        self.consecutive_nans = self.consecutive_nans + 1 if nan else 0
        if self.max_nan_losses > 0 and \
                self.consecutive_nans >= self.max_nan_losses:
            fired.append(WatchdogEvent(
                EVENT_NAN_LOSS, step,
                f"{self.consecutive_nans} consecutive non-finite losses",
                {"consecutive_nans": self.consecutive_nans,
                 "loss": None if loss is None else float(loss)}))

        self._dispatch(fired)
        return fired

    def observe_serving_step(self, step):
        """Serving-side analog of :meth:`observe_step`: stall detection
        only (serving has no loss scale or NaN-loss streaks — poisoned
        lanes are quarantined per request by the engine itself), with
        the same dispatch/abort semantics.  The inference engine calls
        it once per serving step, so a wedged decode dispatch or a
        chaos ``slow_serving_step`` trips the same stall machinery the
        training loop uses."""
        now = self._clock()
        fired = []
        if self.stall_timeout > 0 and self.last_progress_time is not None \
                and now - self.last_progress_time > self.stall_timeout:
            fired.append(WatchdogEvent(
                EVENT_STALL, step,
                f"serving step {step} took "
                f"{now - self.last_progress_time:.1f}s "
                f"(stall_timeout={self.stall_timeout:g}s)",
                {"elapsed": now - self.last_progress_time}))
        self.last_progress_time = now
        self._dispatch(fired)
        return fired

    def observe_integrity(self, step, verdict):
        """Feed a confirmed silent-corruption verdict from the integrity
        monitor (runtime/resilience/integrity.py) — the UNSUPERVISED
        escalation path: without a TrainingSupervisor there is no
        rollback ladder, so a corrupt verdict becomes a watchdog event
        with the usual abort/continue dispatch (abort still writes the
        engine's emergency checkpoint first — stamped integrity-suspect
        by the open anomaly window, so auto-resume prefers an older
        clean tag).  Supervised engines never call this: the supervisor
        owns the corrupt rung."""
        event = WatchdogEvent(
            EVENT_INTEGRITY, step,
            f"silent-corruption verdict at step {step} via "
            f"{verdict.get('source')}: "
            + (f"minority rank(s) {verdict.get('culprits')}"
               if verdict.get("culprits") else "no culprit (symmetric)"),
            dict(verdict))
        self._dispatch([event])
        return event

    def check_stall(self, step):
        """Poll for a stall without observing a step (e.g. from a monitor
        loop while train_batch blocks on a hung collective)."""
        now = self._clock()
        if self.last_progress_time is None:  # arm on first poll
            self.last_progress_time = now
            return None
        if self.stall_timeout <= 0 or \
                now - self.last_progress_time <= self.stall_timeout:
            return None
        event = WatchdogEvent(
            EVENT_STALL, step,
            f"no step completed for {now - self.last_progress_time:.1f}s "
            f"(stall_timeout={self.stall_timeout:g}s)",
            {"elapsed": now - self.last_progress_time})
        # re-arm before dispatch: a 'continue' verdict with a tight poll
        # loop must fire once per stall_timeout window, not once per poll
        self.last_progress_time = now
        self._dispatch([event])
        return event

    def heartbeat(self):
        """Mark forward progress without a full step observation."""
        self.last_progress_time = self._clock()

    # -- dispatch -------------------------------------------------------
    def _dispatch(self, fired):
        abort_event = None
        for event in fired:
            self.events.append(event)
            logger.warning(f"watchdog: {event.kind} at step {event.step}: "
                           f"{event.message}")
            # fail-safe: any single abort vote wins, no matter what other
            # callbacks return or in which order they were registered
            verdict = None
            for cb in self._callbacks:
                got = cb(event)
                if got == ACTION_ABORT:
                    verdict = ACTION_ABORT
                elif got == ACTION_CONTINUE and verdict is None:
                    verdict = ACTION_CONTINUE
            if verdict is None:
                verdict = self.default_action
            if verdict == ACTION_ABORT:
                # when a host-local stall and a globally-derived streak
                # (overflow/NaN, reduced identically on every host) abort
                # in the same dispatch, the alarm must carry the global
                # kind: engines skip the collective emergency save for
                # stall verdicts, and hosts disagreeing on the kind would
                # leave some in that save's barrier and some not
                if abort_event is None or (abort_event.kind == EVENT_STALL
                                           and event.kind != EVENT_STALL):
                    abort_event = event
            elif verdict == ACTION_CONTINUE:
                # back off: reset the streak that fired so the event
                # doesn't re-fire every subsequent step
                if event.kind == EVENT_OVERFLOW_STREAK:
                    self.consecutive_skips = 0
                elif event.kind == EVENT_NAN_LOSS:
                    self.consecutive_nans = 0
        if abort_event is not None:
            raise WatchdogAlarm(abort_event)


def _is_finite(x):
    import math

    try:
        return math.isfinite(float(x))
    except (TypeError, ValueError):
        return True
