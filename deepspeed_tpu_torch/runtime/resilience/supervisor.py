"""Self-healing training: the supervisor that owns the loop, in one
process.

Port of deepspeed_tpu/runtime/resilience/supervisor.py at world 1. The
supervisor drives ``engine.train_batch`` over a data stream, commits a
tag every ``checkpoint_every_steps`` and answers failures with a bounded
ladder:

- transient step faults (``TransientStepFault``, chaos
  ``fail_step_transient``) retry in place from the live state, with
  backoff ``retry_backoff_steps`` x (strike - 1); ``max_transient_retries``
  strikes escalate;
- persistent faults (a watchdog alarm: NaN or overflow streaks, stalls;
  an exception escaping a step; exhausted retries) roll back to the last
  committed (published) tag, and the data stream is fast-forwarded to
  the tag's exact sample offset;
- a ``corrupt`` verdict of the integrity sentinels (integrity.py) rolls
  back to the last integrity-clean tag and skips the data window that
  fed the anomaly (``engine.samples_skipped``, kept in every later
  checkpoint);
- a failed commit is counted and does not stop the run;
  ``SupervisorGaveUp`` when there is nothing to roll back to.

After a rollback the losses are bit for bit the uninterrupted run's
from that tag (with a corrupt verdict, that of a run from the tag that
skipped the same window). MTTR and goodput land in
``engine.telemetry_report()["recovery"]``, the ladder's state in
``_last_metrics``.

Peers are :class:`SimHost` state machines on the supervisor's step clock
behind the transport seam (transport.py). A world of more than one host
(dead verdicts, elastic restart, rank quarantine, ``ProcessTransport``
peers) is ROADMAP A16b: it raises NotImplementedError.
"""
import logging
from dataclasses import dataclass

from deepspeed_tpu_torch.runtime.resilience import chaos
from deepspeed_tpu_torch.runtime.resilience.coordination import (
    all_agree, broadcast_tag)
from deepspeed_tpu_torch.runtime.resilience.watchdog import (GracefulPreemption,
                                                       WatchdogAlarm)
from deepspeed_tpu_torch.utils.logging import log_dist, logger

# incident kinds (the failure taxonomy)
KIND_TRANSIENT = "transient"       # step fault, live state intact
KIND_WATCHDOG = "watchdog"         # NaN/overflow streak / stall escalation
KIND_CRASH = "crash"               # exception/interrupt escaping a step
KIND_PEER_STALL = "peer_stall"     # peer silent, within heartbeat window
KIND_CORRUPT = "corrupt"           # silent-corruption verdict:
#                                    finite-but-wrong numbers caught by the
#                                    integrity sentinels / cross-replica
#                                    vote — between transient and dead
KIND_HOST_LOST = "host_lost"       # coordinated dead verdict

# recovery actions (the ladder rungs)
RECOVERY_RETRY = "retry-in-place"
RECOVERY_ROLLBACK = "rollback"
RECOVERY_ROLLBACK_SKIP = "rollback-and-skip"   # + skip the anomalous data
#                                                window (PaLM-style)
RECOVERY_QUARANTINE = "quarantine"             # elastic restart WITHOUT the
#                                                repeat-offender rank
RECOVERY_RESTART = "elastic-restart"


class TransientStepFault(RuntimeError):
    """A step fault that left live state intact (data fetch hiccup,
    flaky interconnect read, chaos ``fail_step_transient``): the bottom
    rung of the ladder — retry in place, no checkpoint load."""


class SupervisorGaveUp(RuntimeError):
    """The bounded ladder is exhausted (or recovery is impossible: no
    committed tag, no valid elastic world, restarts over budget).  The
    run is down for real; a human owns it again."""


@dataclass(frozen=True)
class SupervisorConfig:
    """Detection windows + the retry/backoff ladder, all in STEPS (the
    supervisor runs on a step clock; see the config-block twins in
    runtime/constants.py for the ds_config spelling)."""
    heartbeat_timeout_steps: int = 3
    max_transient_retries: int = 2
    retry_backoff_steps: int = 1
    max_recovery_attempts: int = 3
    max_restarts: int = 4
    checkpoint_every_steps: int = 1

    @staticmethod
    def from_engine(engine):
        """Read the ``resilience.supervisor`` ds_config block off a live
        engine (validated at config parse time)."""
        r = engine._resilience
        return SupervisorConfig(
            heartbeat_timeout_steps=r.supervisor_heartbeat_timeout_steps,
            max_transient_retries=r.supervisor_max_transient_retries,
            retry_backoff_steps=r.supervisor_retry_backoff_steps,
            max_recovery_attempts=r.supervisor_max_recovery_attempts,
            max_restarts=r.supervisor_max_restarts,
            checkpoint_every_steps=r.supervisor_checkpoint_every_steps)


class SimHost:
    """One simulated peer host on the supervisor's step clock.

    Pure heartbeat state machine: each tick it posts its wall step
    unless an armed chaos plan killed it (``kill_ranks`` — permanent)
    or silenced it (``silence_heartbeat`` — alive but unreachable).
    Host 0 is the LOCAL process and always beats (it is the one running
    this code; killing it is not simulable in-process)."""

    def __init__(self, rank, local=False):
        self.rank = rank
        self.local = local
        self.alive = True
        self.last_beat = 0

    def tick(self, wall_step):
        if self.alive and not self.local \
                and chaos.active() is not None \
                and chaos.rank_dead(self.rank, wall_step):
            self.alive = False
        if not self.alive:
            return
        if not self.local and chaos.active() is not None \
                and chaos.heartbeat_silenced(self.rank, wall_step):
            return
        self.last_beat = wall_step


def _refuse_world(what):
    raise NotImplementedError(
        f"{what}: dead verdicts, elastic restart, rank quarantine and "
        f"process transports need a supervised world of several hosts, "
        f"which is not ported yet (ROADMAP A16b); the port supervises one "
        f"process")


class TrainingSupervisor:
    """Owns the train loop; turns rank/host failure into a
    bounded-downtime event instead of a dead run.

    ``engine_factory(world)`` builds an engine for a data-parallel
    world of that size (the config must carry an ``elasticity`` block
    so every world resolves to the SAME global batch).
    ``data_factory(engine)`` returns a fresh deterministic iterator of
    micro-batches in that engine's shape, positioned at sample 0 — the
    supervisor fast-forwards it to the exact committed offset after
    every rollback/restart.  ``save_dir`` holds the committed tags the
    ladder recovers to.
    """

    def __init__(self, engine_factory, data_factory, *, save_dir,
                 world_size=None, config=None, transport=None):
        self.engine_factory = engine_factory
        self.data_factory = data_factory
        self.save_dir = save_dir
        self.wall_step = 0
        self.restarts = 0
        self.rollbacks = 0
        self.commit_failures = 0
        self.transient_retries = 0
        self._strikes = 0
        self._backoff_until = 0
        self.last_committed_tag = None
        self._last_committed_step = -1
        self._last_saved_step = -1
        # numerical integrity: the corrupt rung's bookkeeping
        self.last_clean_tag = None      # last PUBLISHED integrity-clean tag
        self.corrupt_verdicts = 0
        self.quarantines = 0
        self.skipped_samples = 0        # data deliberately skipped, total
        self._offenses = {}             # rank -> corrupt-verdict count
        # async commit cadence: the tag whose
        # seal is in flight — a rollback target only once PUBLISHED
        self._pending_published = None
        self.loss_history = []      # (global_step, loss) committed; device
        #                             values until _materialize_history
        self._history_floats = 0    # prefix already folded to floats
        self.incidents = []         # closed + open incident dicts
        self.verdicts = []          # coordinated dead verdicts reached
        self._open_incident = None
        self._downtime_t0 = 0.0

        if (world_size is not None and int(world_size) > 1) or (
                transport is not None and transport.world > 1):
            _refuse_world(f"a world of "
                          f"{world_size if transport is None else transport.world}")
        engine = engine_factory(world_size)
        if engine.dp_world_size > 1:
            _refuse_world(f"a world of {engine.dp_world_size}")
        if config is None:
            config = SupervisorConfig.from_engine(engine)
        elif isinstance(config, dict):
            config = SupervisorConfig(**config)
        self.config = config
        self.world = int(world_size if world_size is not None
                         else engine.dp_world_size)
        if transport is not None and transport.world != self.world:
            raise ValueError(
                f"transport world {transport.world} != supervisor world "
                f"{self.world} — the heartbeat bus and the engine's dp "
                f"world must agree or the lag classifier misreads peers")
        self.hosts = [SimHost(r, local=(r == 0)) for r in range(self.world)]
        # the transport seam: every heartbeat and verdict goes through
        # it; the default is the in-process clock sharing this
        # supervisor's SimHost list (deterministic, no wall clock)
        if transport is None:
            from deepspeed_tpu_torch.runtime.resilience.transport import (
                InProcessTransport)

            transport = InProcessTransport(hosts=self.hosts)
        self.transport = transport.start()
        self._attach(engine)
        self.data_iter = data_factory(engine)

    # ------------------------------------------------------------------
    # arming / engine attachment
    # ------------------------------------------------------------------
    def _attach(self, engine):
        """Bind a (new) engine: arm the supervised-step hook points on
        it (the engine warns DISARMED naming blockers when it cannot),
        cache the elastic world set, and rewire the ``recovery``
        telemetry lane onto its tracer."""
        self.engine = engine
        self.armed = bool(engine._arm_supervisor(self))
        self._elastic = self._elastic_worlds(engine) if self.armed else None
        self._tracer = getattr(engine, "_tracer", None)
        self._lane_recovery = 0
        if self._tracer is not None:
            self._lane_recovery = self._tracer.lane("recovery")
            for name in ("failure", "retry", "dead_verdict", "rollback",
                         "elastic_restart", "recovered", "commit_failed",
                         "corrupt_verdict", "quarantine"):
                self._tracer.intern(name, args=("wall_step",))
            self._tracer.intern("downtime", args=("wall_steps",))
            self._tracer.intern("data_skipped", args=("samples",))

    @staticmethod
    def _elastic_worlds(engine):
        """(final_batch, sorted valid world sizes) from the engine's
        elasticity config, or None when elasticity is not enabled (the
        engine's ``_arm_supervisor`` already warned that elastic restart
        is disarmed in that case)."""
        from deepspeed_tpu_torch.elasticity import (compute_elastic_config,
                                              elasticity_enabled)

        pd = engine._config._param_dict
        if not elasticity_enabled(pd):
            return None
        from deepspeed_tpu_torch.version import __version__

        final, valid = compute_elastic_config(pd, __version__)
        return int(final), sorted(int(v) for v in valid)

    def _instant(self, name, a0=0):
        if self._tracer is not None:
            self._tracer.instant(name, self._lane_recovery, a0=int(a0))

    # ------------------------------------------------------------------
    # the supervised loop
    # ------------------------------------------------------------------
    def run(self, num_steps, *, max_wall_steps=None):
        """Drive supervised training until ``num_steps`` optimizer steps
        have committed (or the ladder gives up).  Returns the (possibly
        replaced-by-restart) engine."""
        limit = max_wall_steps if max_wall_steps is not None \
            else num_steps * 16 + 64
        while self.engine.global_steps < num_steps:
            if self.wall_step >= limit:
                raise SupervisorGaveUp(
                    f"supervised run spent {self.wall_step} wall steps on "
                    f"{self.engine.global_steps}/{num_steps} committed "
                    f"steps — recovery is not converging")
            self.tick()
        return self.engine

    def tick(self):
        """One supervisor wall step: heartbeats, verdicts, then (when
        the collective is healthy and no backoff is pending) one
        supervised training step."""
        self.wall_step += 1
        if not self.armed:
            # unsupervised passthrough: bit-identical steps, zero extra
            # compiles (the disarmed pin) — no chaos consults, no
            # recovery, no heartbeat bus
            loss = self.engine.train_batch(data_iter=self.data_iter)
            self._note_committed(loss)
            return
        w = self.wall_step
        stale, dead = self._heartbeat_tick(w)
        if dead:
            if self._verdict(dead, w):
                self._elastic_restart(dead)
            else:
                # suspicion without agreement (a transport ack vote can
                # time out on a wedged survivor): the collective step
                # still cannot complete — honest downtime, retry the
                # verdict next tick
                self._open(KIND_PEER_STALL, w)
            return
        if stale:
            # a silent-but-within-window peer: the collective step could
            # not complete — honest downtime, never a half-stepped batch
            self._open(KIND_PEER_STALL, w)
            return
        if w < self._backoff_until:
            return                      # waiting out the retry backoff
        self.supervised_step()

    def supervised_step(self):
        """One training step under the classifier: transient faults feed
        the in-place retry ladder, watchdog alarms and crashes feed the
        coordinated rollback, preemption passes through untouched."""
        w = self.wall_step
        try:
            if chaos.active() is not None \
                    and chaos.consume_transient_fault(w):
                raise TransientStepFault(
                    f"chaos: transient step fault at wall step {w}")
            loss = self.engine.train_batch(data_iter=self.data_iter)
        except TransientStepFault as e:
            self._on_step_fault(e, KIND_TRANSIENT)
            return
        except WatchdogAlarm as e:
            self._on_step_fault(e, KIND_WATCHDOG)
            return
        except GracefulPreemption:
            raise                       # the graceful shutdown path owns it
        except chaos.ChaosInterrupt as e:
            self._on_step_fault(e, KIND_CRASH)
            return
        except Exception as e:  # lint: allow-broad-except — classify and
            # recover is the supervisor's whole job; unknown faults take
            # the persistent (rollback) rung, never a silent swallow
            self._on_step_fault(e, KIND_CRASH)
            return
        self._strikes = 0
        # the corrupt rung decides BEFORE the step commits:
        # a verdict at this boundary discards the step's result (loss
        # never enters the committed trajectory, the cadence commit
        # never runs) — otherwise a corruption landing at a commit
        # boundary could be snapshotted into a tag stamped clean and
        # become the very rollback target the recovery flees to
        if self._integrity_tick():
            return
        self._note_committed(loss)

    # ------------------------------------------------------------------
    # detection
    # ------------------------------------------------------------------
    def _heartbeat_tick(self, w):
        """Drive the transport's heartbeat bus one step-clock tick and
        classify each peer's lag; returns ``(stale_ranks, dead_ranks)``
        — stale peers are silent but within the heartbeat window, dead
        peers are past it.  The default in-process transport shares
        ``self.hosts`` (each tick advances the SimHost machines exactly
        as the pre-seam loop did); a process transport returns the real
        beats its workers answered — same classifier, real silence."""
        timeout = self.config.heartbeat_timeout_steps
        beats = self.transport.heartbeat_tick(w)
        stale, dead = [], []
        for h in self.hosts:
            if h.rank in beats:
                h.last_beat = max(h.last_beat, beats[h.rank])
            lag = w - h.last_beat
            if lag <= 0:
                continue
            if lag > timeout:
                dead.append(h.rank)
            else:
                stale.append(h.rank)
        return stale, dead

    def _verdict(self, dead, w):
        """A coordinated dead verdict (``any_flag``, ``all_agree``, the
        transport's ack round): reached only by a peer's silence, so in a
        world of several hosts (A16b)."""
        _refuse_world(f"rank(s) {sorted(dead)} silent at wall step {w}")

    # ------------------------------------------------------------------
    # the response ladder
    # ------------------------------------------------------------------
    def _on_step_fault(self, exc, kind):
        w = self.wall_step
        self._open(kind, w)
        self._strikes += 1
        logger.warning(f"supervisor: {kind} step fault at wall step {w} "
                       f"(strike {self._strikes}): {exc}")
        if kind == KIND_TRANSIENT \
                and self._strikes <= self.config.max_transient_retries:
            self.transient_retries += 1
            self._backoff_until = w + 1 \
                + self.config.retry_backoff_steps * (self._strikes - 1)
            self._instant("retry", a0=w)
            # a transient fault raised from INSIDE train_batch (a real
            # loader hiccup) may have consumed part of the gas window —
            # reseat the stream at the engine's exact committed sample
            # offset so the retry replays the whole batch: zero samples
            # lost or replayed, whatever the fault consumed
            self._reseat_live()
            return
        self._rollback(reason=kind)

    def _integrity_tick(self):
        """The corrupt rung's decision point, at every healthy step
        boundary BEFORE that step commits: the integrity monitor folds
        sentinel + vote evidence into at most one verdict per incident
        (integrity.IntegrityMonitor.decide — cheap early-outs; device
        work only on the vote/dup cadences), and a verdict picks its
        recovery — quarantine for a repeat-offender rank,
        rollback-and-skip otherwise.  Returns True when a verdict fired
        (the caller then discards the step's commit)."""
        mon = getattr(self.engine, "_integrity", None)
        if mon is None:
            return False
        verdict = mon.decide(self.engine, self.wall_step)
        if verdict is None:
            return False
        self._on_corrupt(mon, verdict)
        return True

    def _on_corrupt(self, mon, verdict):
        w = self.wall_step
        self.corrupt_verdicts += 1
        self._open(KIND_CORRUPT, w)
        inc = self._open_incident
        culprits = list(verdict.get("culprits") or [])
        for r in culprits:
            self._offenses[r] = self._offenses.get(r, 0) + 1
        if inc is not None:
            inc.update({
                "kind": KIND_CORRUPT, "culprits": sorted(culprits),
                "source": verdict.get("source"),
                "tie": bool(verdict.get("tie")),
                "anomaly_step": verdict.get("anomaly_step"),
                "detection_latency_steps": verdict.get("latency_steps"),
                "offense_counts": dict(self._offenses),
            })
        self._instant("corrupt_verdict", a0=w)
        log_dist(
            f"supervisor: CORRUPT verdict at wall step {w} "
            f"(source={verdict.get('source')}, "
            f"culprits={sorted(culprits) or 'none'}, "
            f"tie={bool(verdict.get('tie'))}, detection latency "
            f"{verdict.get('latency_steps')} step(s))",
            ranks=[0], level=logging.WARNING)
        # repeat offenders get quarantined: the rank keeps producing
        # corrupt replicas, so rolling back onto it again is wasted
        # goodput — restart elastically WITHOUT it.  Host 0 is the local
        # process (not quarantinable in the single-process sim), and the
        # rung needs elasticity + restart budget; otherwise fall through
        # to rollback-and-skip (a tie never counts an offense: the vote
        # refused a rank verdict)
        repeat = sorted(
            r for r in culprits
            if r != 0 and self._offenses.get(r, 0)
            >= mon.config.quarantine_after)
        try:
            if repeat and self._elastic is not None \
                    and self.restarts < self.config.max_restarts:
                self.quarantines += 1
                if inc is not None:
                    inc["quarantined"] = repeat
                log_dist(
                    f"supervisor: QUARANTINING repeat-offender rank(s) "
                    f"{repeat} ({self._offenses}) — elastic restart "
                    f"without them", ranks=[0], level=logging.WARNING)
                self._elastic_restart(repeat, reason=KIND_CORRUPT)
            else:
                self._rollback(reason=KIND_CORRUPT, skip_data=True)
        finally:
            # re-arm the monitor whatever the recovery did (even a
            # SupervisorGaveUp must not wedge a later operator-driven
            # resume behind a latched verdict)
            mon.resolve(recovered=True)

    def _drain_pending_commit(self):
        """Async cadence: before any
        verdict-driven recovery, drain the pending seal — a sealed-but-
        unpublished tag either publishes here (becoming the freshest
        rollback target via on_commit_published) or fails here (the
        previous PUBLISHED tag stays the target; counted like any
        commit failure, never fatal)."""
        eng = self.engine
        if not callable(getattr(eng, "pending_commit", None)) \
                or not eng.pending_commit():
            return
        try:
            eng.wait_pending_commit()
        except Exception as e:  # lint: allow-broad-except — a failed
            # seal/publish must not abort the recovery already running;
            # the rollback target stays the last published tag
            self.commit_failures += 1
            self._pending_published = None
            logger.warning(
                f"supervisor: pending async commit failed while draining "
                f"before recovery ({type(e).__name__}: {e}) — rollback "
                f"target stays {self.last_committed_tag!r}")
            self._instant("commit_failed", a0=self.wall_step)

    def _skip_and_reseat(self, pos_before):
        """Rollback-and-skip (PaLM-style): the engine is freshly rolled
        back to a clean tag; advance the DATA stream past everything
        consumed up to the fault, so the anomalous window is never
        trained on again.  The skip is loud (incident ledger + warning
        + ``data_skipped`` instant) and persists in every later
        checkpoint via ``engine.samples_skipped`` — honest goodput
        accounting, not silent sample loss."""
        from deepspeed_tpu_torch.runtime.resilience.reshard import (data_position,
                                                              fast_forward)

        gs = int(self.engine.global_steps)
        self.loss_history = [(g, l) for g, l in self.loss_history
                             if g <= gs]
        self._history_floats = min(self._history_floats,
                                   len(self.loss_history))
        at_tag = int(data_position(self.engine)["samples_consumed"])
        skip = int(pos_before["samples_consumed"]) - at_tag
        if skip > 0:
            self.engine.samples_skipped += skip
            self.skipped_samples += skip
            inc = self._open_incident
            if inc is not None:
                inc["skipped_samples"] = skip
                inc["skip_from_sample"] = at_tag
                inc["skip_to_sample"] = at_tag + skip
            self._instant("data_skipped", a0=skip)
            log_dist(
                f"supervisor: SKIPPING the anomalous data window — "
                f"samples [{at_tag}, {at_tag + skip}) ({skip} samples) "
                f"will never be trained on (PaLM-style rollback-and-"
                f"skip; recorded in the incident ledger and in every "
                f"later checkpoint's data_position)",
                ranks=[0], level=logging.WARNING)
        it = self.data_factory(self.engine)
        self.data_iter = fast_forward(it, data_position(self.engine),
                                      self.engine)

    def _rollback(self, reason, skip_data=False):
        """Coordinated rollback: every rank agrees to enter recovery,
        the tag is re-broadcast (ranks must not roll back to different
        tags), and the load + exact-sample data reseat is retried
        through kill-mid-rollback chaos up to ``max_recovery_attempts``.
        A ``corrupt`` verdict targets the last integrity-CLEAN published
        tag (a suspect tag holds the corruption it is fleeing) and skips
        the anomalous data window; every other reason targets the last
        published tag and replays."""
        self._drain_pending_commit()
        all_agree(True)     # recovery barrier: enter together or not at all
        from deepspeed_tpu_torch.runtime.resilience.reshard import data_position

        pos_before = data_position(self.engine)
        corrupt = reason == KIND_CORRUPT
        tag = broadcast_tag(self.last_clean_tag if corrupt
                            else self.last_committed_tag)
        if tag is None:
            raise SupervisorGaveUp(
                f"persistent {reason} fault with NO "
                f"{'integrity-clean ' if corrupt else ''}committed tag to "
                f"roll back to — "
                + ("every committed tag was stamped inside the anomaly "
                   "window" if corrupt and self.last_committed_tag
                   else "commit cadence (checkpoint_every_steps) never "
                        "fired before the first failure"))
        inc = self._open_incident
        if inc is not None:
            inc["recovery"] = RECOVERY_ROLLBACK_SKIP if skip_data \
                else RECOVERY_ROLLBACK
            inc["tag"] = tag
        last_err = None
        for _attempt in range(self.config.max_recovery_attempts):
            try:
                chaos.point("before_rollback_load")
                _path, client = self.engine.load_checkpoint(
                    self.save_dir, tag=tag, elastic=True)
                if skip_data:
                    self._skip_and_reseat(pos_before)
                else:
                    self._reseat_data(client)
                break
            except chaos.ChaosInterrupt as e:
                # a kill landing mid-rollback: the committed tag on disk
                # is untouched (loads never mutate it) — pay a wall step
                # and retry the same recovery
                last_err = e
                self.wall_step += 1
                continue
        else:
            raise SupervisorGaveUp(
                f"rollback to {tag!r} failed "
                f"{self.config.max_recovery_attempts} times; last error: "
                f"{last_err}")
        self.rollbacks += 1
        self._strikes = 0
        self._backoff_until = 0
        if skip_data:
            self._rebase_commit_tracking(tag)
        self._instant("rollback", a0=self.wall_step)
        log_dist(f"supervisor: rolled back to committed tag {tag!r} "
                 f"({reason}{', data window skipped' if skip_data else ''}"
                 f") at wall step {self.wall_step}", ranks=[0],
                 level=logging.WARNING)

    def _rebase_commit_tracking(self, tag):
        """After a rollback-AND-SKIP the replayed steps train on
        DIFFERENT data (the window moved), so tags committed past the
        landing tag are stale — rebase the cadence so the replay
        re-commits them (the atomic tag-overwrite path makes that safe),
        and never leave a stale suspect tag as the rollback target."""
        gs = int(self.engine.global_steps)
        self.last_committed_tag = tag
        self.last_clean_tag = tag
        self._last_committed_step = gs
        self._last_saved_step = gs
        self._pending_published = None

    def _elastic_restart(self, dead, reason=KIND_HOST_LOST):
        """Lost or quarantined capacity: a restart onto the surviving
        hosts (A16b)."""
        _refuse_world(f"rank(s) {sorted(dead)} "
                      f"{'quarantined' if reason == KIND_CORRUPT else 'lost'}")

    def _reseat_live(self):
        """Fresh deterministic stream fast-forwarded to the LIVE
        engine's committed sample offset (retry-in-place: no checkpoint
        was loaded, the engine's own counters are the truth)."""
        from deepspeed_tpu_torch.runtime.resilience.reshard import (data_position,
                                                              fast_forward)

        it = self.data_factory(self.engine)
        self.data_iter = fast_forward(it, data_position(self.engine),
                                      self.engine)

    def _reseat_data(self, client):
        """Fresh deterministic stream, fast-forwarded to the committed
        sample offset the loaded tag recorded — zero samples lost or
        replayed in the committed trajectory.  Loss history recorded
        past the tag was rolled back with the state, so it is pruned:
        ``loss_history`` is the COMMITTED trajectory."""
        from deepspeed_tpu_torch.runtime.resilience.reshard import fast_forward

        gs = int(self.engine.global_steps)
        self.loss_history = [(g, l) for g, l in self.loss_history if g <= gs]
        self._history_floats = min(self._history_floats,
                                   len(self.loss_history))
        it = self.data_factory(self.engine)
        self.data_iter = fast_forward(it, client.get("data_position"),
                                      self.engine)

    # ------------------------------------------------------------------
    # commit + accounting
    # ------------------------------------------------------------------
    # device-held loss_history tail above this length gets folded to
    # floats (one batched device_get of long-COMPLETED steps, so it
    # never blocks on in-flight compute) — bounds live device buffers
    # for arbitrarily long runs
    _HISTORY_DEVICE_TAIL = 64

    def _note_committed(self, loss):
        gs = int(self.engine.global_steps)
        # the loss stays a DEVICE value: a float() here would block the
        # host on the step's device compute every tick, serializing the
        # steady-state loop (the per-iteration sync the host-sync bar
        # forbids) — committed_losses() materializes lazily, batched
        self.loss_history.append((gs, loss))
        if len(self.loss_history) - self._history_floats \
                >= self._HISTORY_DEVICE_TAIL:
            self._materialize_history()
        inc = self._open_incident
        if inc is not None:
            inc["recovered_step"] = self.wall_step
            inc["mttr_steps"] = self.wall_step - inc["fail_step"]
            inc.setdefault("recovery", RECOVERY_RETRY)
            self._open_incident = None
            self._instant("recovered", a0=self.wall_step)
            if self._tracer is not None:
                self._tracer.complete("downtime", self._lane_recovery,
                                      self._downtime_t0,
                                      a0=inc["mttr_steps"])
        self._maybe_commit(gs)

    def _maybe_commit(self, gs):
        every = self.config.checkpoint_every_steps
        if not self.armed or every <= 0 or gs % every \
                or gs <= self._last_saved_step:
            return
        # commit cadence follows the engine's resilience.async_commit
        # config: a SYNC
        # commit is a rollback target the moment save returns; an ASYNC
        # one only once its foreground publish lands (on_commit_published
        # — the supervisor tracks only PUBLISHED tags, and recoveries
        # drain the pending seal first)
        mon = getattr(self.engine, "_integrity", None)
        clean = bool(mon.clean()) if mon is not None else True
        try:
            self.engine.save_checkpoint(self.save_dir)
        except Exception as e:  # lint: allow-broad-except — a failed
            # commit (disk full, kill mid-write) must not kill the run
            # the supervisor exists to keep alive: the atomic writer
            # guarantees no torn tag became visible, live state is
            # intact, so training continues and the NEXT cadence
            # boundary retries — the cost is a staler rollback target,
            # counted loudly in commit_failures
            self.commit_failures += 1
            logger.warning(
                f"supervisor: checkpoint commit at step {gs} failed "
                f"({type(e).__name__}: {e}) — training continues, "
                f"rollback target stays {self.last_committed_tag!r} "
                f"({self.commit_failures} commit failure(s) so far)")
            self._instant("commit_failed", a0=self.wall_step)
            return
        self._last_saved_step = gs
        tag = f"global_step{gs}"
        if callable(getattr(self.engine, "pending_commit", None)) \
                and self.engine.pending_commit():
            # async seal in flight: NOT a rollback target yet
            self._pending_published = {"tag": tag, "global_steps": gs,
                                       "integrity_clean": clean}
            return
        self._record_published(tag, gs, clean)

    def _record_published(self, tag, gs, clean):
        """A tag became durable-visible (sync save returned, or an async
        publish landed): it is now a rollback target; integrity-clean
        tags additionally become the corrupt rung's target."""
        self.last_committed_tag = tag
        self._last_committed_step = max(self._last_committed_step, int(gs))
        if clean:
            self.last_clean_tag = tag
        self._pending_published = None

    def on_commit_failed(self, exc):
        """Engine hook: an ASYNC commit's seal or publish failed at a
        step boundary.  Same contract as a failed synchronous commit —
        count it, keep the previous PUBLISHED tag as the rollback
        target, never kill (or roll back) the run over an IO failure."""
        self.commit_failures += 1
        pending = self._pending_published
        self._pending_published = None
        logger.warning(
            f"supervisor: async checkpoint commit"
            f"{' of ' + repr(pending['tag']) if pending else ''} failed at "
            f"the step boundary ({type(exc).__name__}: {exc}) — training "
            f"continues, rollback target stays "
            f"{self.last_committed_tag!r} ({self.commit_failures} commit "
            f"failure(s) so far)")
        self._instant("commit_failed", a0=self.wall_step)

    def on_commit_published(self, info):
        """Engine hook: an ASYNC checkpoint commit finished its
        foreground publish (rename + latest).  Only now does the tag
        become a rollback target — and its integrity stamp is the one
        fixed at COMMIT time (a window that opened after the snapshot
        does not taint it, and one that closed since does not clean
        it)."""
        tag = info.get("tag")
        gs = info.get("global_steps")
        if tag is None or gs is None:
            return
        if info.get("save_dir") != self.save_dir:
            # a user-driven save to some OTHER directory (an export, a
            # side snapshot) is not a recovery target: _rollback only
            # ever loads from self.save_dir, so recording this tag
            # would point the ladder at a tag that does not exist there
            return
        if int(gs) >= self._last_committed_step:
            self._record_published(str(tag), int(gs),
                                   bool(info.get("integrity_clean", True)))

    def _open(self, kind, w):
        """Open (or escalate) the current incident; instants + the
        downtime span anchor ride the ``recovery`` telemetry lane."""
        inc = self._open_incident
        if inc is None:
            inc = {"kind": kind, "fail_step": w}
            self._open_incident = inc
            self.incidents.append(inc)
            self._instant("failure", a0=w)
            if self._tracer is not None:
                self._downtime_t0 = self._tracer.begin()
        elif kind != KIND_PEER_STALL and inc["kind"] == KIND_PEER_STALL:
            inc["kind"] = kind      # stall escalated to a harder verdict

    def on_engine_step(self, engine):
        """Engine-side hook (every ``_observe_step_outcome``): surface
        restart-count/backoff ladder state in ``_last_metrics`` so the
        step stream carries recovery posture alongside loss scale."""
        m = engine._last_metrics
        if isinstance(m, dict):
            m = dict(m)
            m["recovery_restarts"] = self.restarts
            m["recovery_rollbacks"] = self.rollbacks
            m["recovery_retries"] = self.transient_retries
            m["recovery_backoff_steps"] = max(
                0, self._backoff_until - self.wall_step)
            engine._last_metrics = m

    def _materialize_history(self):
        """Fold the device-held losses into floats with ONE batched copy
        (of steps long completed, so it does not wait on the card's
        current work); runs every ``_HISTORY_DEVICE_TAIL`` commits and at
        read time."""
        import torch

        held = [i for i, (_, l) in enumerate(self.loss_history)
                if isinstance(l, torch.Tensor)]
        if held:
            vals = torch.stack([self.loss_history[i][1].detach().float()
                                .reshape(()) for i in held]).cpu().tolist()
            for i, v in zip(held, vals):
                self.loss_history[i] = (self.loss_history[i][0], v)
        self.loss_history = [
            (g, v if v is None or isinstance(v, float) else float(v))
            for g, v in self.loss_history]
        self._history_floats = len(self.loss_history)

    def committed_losses(self):
        """The committed ``(global_step, float loss)`` trajectory,
        materialized HERE — never on the per-step hot path
        (``loss_history`` holds device values until folded)."""
        self._materialize_history()
        return list(self.loss_history)

    def report(self):
        """The ``recovery`` section of ``engine.telemetry_report()``:
        incident ledger, MTTR, downtime spans, and
        goodput-samples-per-wall-step (committed samples over EVERY wall
        step, blocked/backoff/recovery ticks included — the honest
        denominator)."""
        mttrs = [i["mttr_steps"] for i in self.incidents
                 if i.get("mttr_steps") is not None]
        gs = int(self.engine.global_steps)
        batch = int(self.engine.train_batch_size())
        wall = max(1, self.wall_step)
        return {
            "armed": self.armed,
            "world": self.world,
            "transport": self.transport.describe(),
            "alive_hosts": sum(1 for h in self.hosts if h.alive),
            "restarts": self.restarts,
            "rollbacks": self.rollbacks,
            "commit_failures": self.commit_failures,
            "transient_retries": self.transient_retries,
            "strikes": self._strikes,
            "backoff_steps_remaining": max(
                0, self._backoff_until - self.wall_step),
            "wall_steps": self.wall_step,
            "committed_steps": gs,
            "committed_samples": gs * batch,
            "goodput_samples_per_wall_step": gs * batch / wall,
            # numerical integrity: skipped data is an honest
            # goodput cost — those samples were consumed from the stream
            # but never trained on, and the ledger says so
            "corrupt_verdicts": self.corrupt_verdicts,
            "quarantines": self.quarantines,
            "skipped_samples": self.skipped_samples,
            "offense_counts": dict(self._offenses),
            "last_clean_tag": self.last_clean_tag,
            "mttr_steps": {
                "mean": sum(mttrs) / len(mttrs) if mttrs else None,
                "max": max(mttrs) if mttrs else None,
                "closed_incidents": len(mttrs),
            },
            "downtime_spans": [
                (i["fail_step"], i.get("recovered_step"))
                for i in self.incidents],
            "downtime_wall_steps": sum(mttrs),
            "incidents": [dict(i) for i in self.incidents],
            "verdicts": [dict(v) for v in self.verdicts],
            "last_committed_tag": self.last_committed_tag,
        }
