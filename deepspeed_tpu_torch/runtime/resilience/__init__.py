"""Resilient training: atomic checkpoints, auto-resume, the watchdog, the
integrity sentinels and the supervisor.

Port of deepspeed_tpu/runtime/resilience/ in one process:

- ``atomic``: write to a temp dir, manifest (per-file size and sha256),
  fsync, atomic rename, ``latest`` last; asynchronous commits
  (``PendingCommit``), tag retention and resume-tag selection.
- ``watchdog``: overflow / NaN-loss streaks and wall-clock stalls, with
  callbacks that abort (after an emergency checkpoint) or back off.
- ``chaos``: fault injection for tests (kills mid-write, corrupted
  bytes, NaN gradients, bit flips, transient step faults).
- ``coordination``: agree / broadcast over ``torch.distributed`` (a
  pass-through in one process).
- ``reshard``: the topology manifest, the exact data position and the
  elastic load plan.
- ``integrity``: the step sentinels and their ``corrupt`` verdict.
- ``supervisor``: the retry / rollback / rollback-and-skip ladder with
  MTTR and goodput.
- ``transport``: the seam the supervisor's peers run behind.
"""
from deepspeed_tpu_torch.runtime.resilience.atomic import (
    MANIFEST_NAME, CheckpointCorrupt, atomic_tag, gc_tags, is_emergency_tag,
    is_preempt_tag, is_suspect_tag, list_tags, load_manifest, read_latest,
    read_topology, resume_candidates, select_resume_tag, verify_tag,
    write_latest, write_manifest)
from deepspeed_tpu_torch.runtime.resilience.integrity import (
    IntegrityConfig, IntegrityMonitor, classify_digests)
from deepspeed_tpu_torch.runtime.resilience.supervisor import (
    SupervisorConfig, SupervisorGaveUp, TrainingSupervisor,
    TransientStepFault)
from deepspeed_tpu_torch.runtime.resilience.watchdog import (
    GracefulPreemption, TrainingWatchdog, WatchdogAlarm, WatchdogEvent,
    chain_signal_handlers)

__all__ = [
    "MANIFEST_NAME", "CheckpointCorrupt", "atomic_tag", "gc_tags",
    "is_emergency_tag", "is_preempt_tag", "is_suspect_tag", "list_tags",
    "load_manifest", "read_latest", "read_topology", "resume_candidates",
    "select_resume_tag", "verify_tag", "write_latest", "write_manifest",
    "GracefulPreemption", "TrainingWatchdog", "WatchdogAlarm",
    "WatchdogEvent", "chain_signal_handlers",
    "SupervisorConfig", "SupervisorGaveUp", "TrainingSupervisor",
    "TransientStepFault",
    "IntegrityConfig", "IntegrityMonitor", "classify_digests",
]
