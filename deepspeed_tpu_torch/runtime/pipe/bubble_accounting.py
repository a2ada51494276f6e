"""Analytic pipeline-bubble accounting: tick simulation of compiled
instruction streams.

Port of deepspeed_tpu/runtime/pipe/bubble_accounting.py, a copy (pure
Python). The schedule compiler (runtime/pipe/schedule.py) emits
per-stage flat instruction streams; this module replays them against a
cost model with the SAME queue semantics the engine uses (in-order
execution per stage, a Recv blocks until the matching Send's payload is
ready), and reports, per physical stage: busy time, idle fraction, and
the peak number of live activation buffers. No device is touched: the
numbers are exact deterministic functions of (schedule, cost model), so
schedule wins are assertable in CPU tests, the same proof idiom as
runtime/comm_accounting.py for collective bytes.

The default cost model matches the engine's passes. A schedule compiled
WITHOUT stash slots pays the zero-bubble remat tax: the fused backward
(b=2) is one forward recompute (1) plus the combined grad math (1); the
split dgrad/wgrad passes each re-run the chunk's forward, so d = w = 1.5
and d + w = b + f: remat ZB-H1 moves MORE total work per micro than the
fused schedules. Its bubble FRACTION still lands lowest (utilization is
high), but compare ``makespan`` for throughput: at pipe=4/gas=8 that
model gives zb-h1 makespan 36.5 vs 1f1b 33. A schedule compiled with
``stash=True`` (bounded activation stashing: the engine runs the forward
once and both split passes consume its saved autograd graph) defaults to
``CostModel.stash()`` (d = w = 1, d + w = b): zb-h1 becomes a genuine
throughput win, makespan 27 vs 33 at the same point, paid for in stash
memory (``peak_live_stash`` per stage). With f == b
(``CostModel.equal_fwd_bwd()``) the plain 1F1B simulation reproduces the
closed form (S-1)/(M+S-1) exactly (0.20 at pipe=2, 0.43 at pipe=4,
gas=4).

A stream that can never satisfy one of its Recvs makes the simulation
wedge; that raises ``DeadlockError`` naming the blocked stages: the
deadlock-freedom check the test suite runs over every schedule x
topology.
"""
from dataclasses import dataclass
from typing import Dict, List, Optional

from deepspeed_tpu_torch.runtime.pipe import schedule as sched_lib


class DeadlockError(RuntimeError):
    """The instruction streams cannot make progress (a Recv whose Send can
    never execute)."""


@dataclass
class CostModel:
    """Abstract per-instruction durations (arbitrary time units).

    fwd/bwd apply to ForwardPass/BackwardPass; dgrad/wgrad to the
    zero-bubble split passes — defaults include each split pass's own
    forward recompute (see module docstring; d = w = f/2 + (b-f)/2 + f/2
    ... i.e. half the grad math plus a full recompute = 1.5 at f=1, b=2).
    p2p is the transfer latency added between a Send and the matching
    Recv's readiness. Loads and host-side bookkeeping are free."""
    fwd: float = 1.0
    bwd: float = 2.0
    dgrad: float = 1.5
    wgrad: float = 1.5
    p2p: float = 0.0

    @classmethod
    def equal_fwd_bwd(cls):
        """f == b == 1 — the model behind the classic (S-1)/(M+S-1)
        ideal-bubble formula; split passes get half the grad math (0.25)
        plus their own recompute (0.5) each, per the same remat rule."""
        return cls(fwd=1.0, bwd=1.0, dgrad=0.75, wgrad=0.75)

    @classmethod
    def stash(cls):
        """d == w == 1 — the activation-STASHING variant (arXiv
        2401.10241's assumption): the forward runs ONCE and saves its vjp
        residuals, so neither split pass recomputes it and
        d + w == b == 2 (no extra total work vs the fused backward).
        This is the default model for schedules compiled with
        ``stash=True`` and the model under which zb-h1 turns from a
        makespan loss (36.5 vs 33 at pipe=4/gas=8) into a win (27)."""
        return cls(fwd=1.0, bwd=2.0, dgrad=1.0, wgrad=1.0)


@dataclass
class _StageSim:
    time: float = 0.0
    busy: float = 0.0
    pc: int = 0
    live: int = 0
    peak_live: int = 0
    stash_live: int = 0
    peak_stash: int = 0


def simulate(compiled, costs: Optional[CostModel] = None) -> dict:
    """Replay a CompiledSchedule; returns the bubble report dict.

    Keys: schedule, micro_batches, stages, virtual_stages, makespan,
    busy (per stage), idle_fraction (per stage), bubble_fraction
    (aggregate: 1 - sum(busy) / (stages * makespan)), peak_live_buffers
    (per stage, activation slots held simultaneously), peak_live_stash
    (per stage, stashed-forward residual sets held simultaneously —
    lifetime ForwardPass -> BackwardWeightPass; all zero unless the
    schedule was compiled with stash slots), total_instructions,
    p2p_transfers (count of send/recv edges crossed per step).

    With no explicit cost model, a stash-compiled schedule defaults to
    ``CostModel.stash()`` (no recompute in either split pass) and every
    other schedule to the remat-honest ``CostModel()`` — the report
    always prices what the engine actually executes.
    """
    stashed = bool(getattr(compiled, "stash", False))
    costs = costs or (CostModel.stash() if stashed else CostModel())
    S = compiled.stages
    C = compiled.num_chunks
    # a chunk is ~1/v of a stage's layers, so per-chunk compute scales
    # down by virtual_stages (total work per stage is schedule-invariant)
    inv_v = 1.0 / compiled.virtual_stages
    streams = compiled.streams
    sims = [_StageSim() for _ in range(S)]
    # per (global chunk, kind) FIFO of payload-ready times
    act_q: Dict[int, List[float]] = {q: [] for q in range(C)}
    grad_q: Dict[int, List[float]] = {q: [] for q in range(C)}
    p2p_transfers = 0

    def cost_of(cmd):
        if isinstance(cmd, sched_lib.ForwardPass):
            return costs.fwd * inv_v
        if isinstance(cmd, sched_lib.BackwardGradPass):
            return costs.dgrad * inv_v
        if isinstance(cmd, sched_lib.BackwardWeightPass):
            return costs.wgrad * inv_v
        if isinstance(cmd, sched_lib.BackwardPass):
            return costs.bwd * inv_v
        return 0.0

    while True:
        progressed, alldone = False, True
        for s, sim in enumerate(sims):
            if sim.pc >= len(streams[s]):
                continue
            alldone = False
            cmd = streams[s][sim.pc]
            g = getattr(cmd, "chunk_id", 0) * S + s
            if isinstance(cmd, sched_lib.RecvActivation):
                if not act_q[g]:
                    continue                       # blocked on the producer
                sim.time = max(sim.time, act_q[g].pop(0))
                sim.live += 1
                sim.peak_live = max(sim.peak_live, sim.live)
            elif isinstance(cmd, sched_lib.RecvGrad):
                if not grad_q[g]:
                    continue
                sim.time = max(sim.time, grad_q[g].pop(0))
            elif isinstance(cmd, sched_lib.SendActivation):
                act_q[g + 1].append(sim.time + costs.p2p)
                p2p_transfers += 1
            elif isinstance(cmd, sched_lib.SendGrad):
                grad_q[g - 1].append(sim.time + costs.p2p)
                p2p_transfers += 1
            elif isinstance(cmd, sched_lib.LoadMicroBatch):
                if g == 0:
                    sim.live += 1
                    sim.peak_live = max(sim.peak_live, sim.live)
            else:
                c = cost_of(cmd)
                sim.time += c
                sim.busy += c
                if stashed and isinstance(cmd, sched_lib.ForwardPass):
                    sim.stash_live += 1
                    sim.peak_stash = max(sim.peak_stash, sim.stash_live)
                if isinstance(cmd, (sched_lib.BackwardPass,
                                    sched_lib.BackwardWeightPass)):
                    sim.live -= 1
                    if stashed and isinstance(cmd,
                                              sched_lib.BackwardWeightPass):
                        sim.stash_live -= 1
            sim.pc += 1
            progressed = True
        if alldone:
            break
        if not progressed:
            blocked = [s for s, sim in enumerate(sims)
                       if sim.pc < len(streams[s])]
            raise DeadlockError(
                f"pipeline schedule '{compiled.name}' deadlocked: stages "
                f"{blocked} blocked at "
                f"{[streams[s][sims[s].pc] for s in blocked]}")

    makespan = max(sim.time for sim in sims) or 1.0
    busy = [sim.busy for sim in sims]
    return {
        "schedule": compiled.name,
        "micro_batches": compiled.micro_batches,
        "stages": S,
        "virtual_stages": compiled.virtual_stages,
        "cost_model": {"fwd": costs.fwd, "bwd": costs.bwd,
                       "dgrad": costs.dgrad, "wgrad": costs.wgrad,
                       "p2p": costs.p2p},
        "makespan": makespan,
        "busy": busy,
        "idle_fraction": [1.0 - b / makespan for b in busy],
        "bubble_fraction": 1.0 - sum(busy) / (S * makespan),
        "peak_live_buffers": [sim.peak_live for sim in sims],
        "peak_live_stash": [sim.peak_stash for sim in sims],
        "stash": stashed,
        "declared_buffers": list(compiled.num_buffers),
        "declared_stash_slots": list(getattr(compiled, "num_stash_slots",
                                             [0] * len(compiled.num_buffers))),
        "total_instructions": sum(len(st) for st in streams),
        "p2p_transfers": p2p_transfers,
    }


def bubble_report(schedule, micro_batches, stages, virtual_stages=1,
                  costs: Optional[CostModel] = None, stash=False) -> dict:
    """Compile + simulate in one call (the tools/tests entry point)."""
    compiled = sched_lib.compile_schedule(
        schedule, micro_batches, stages, virtual_stages, stash=stash)
    return simulate(compiled, costs)


# instruction kinds a telemetry trace can carry back into the simulator
_TRACE_INSTRUCTIONS = {
    cls.__name__: cls for cls in (
        sched_lib.LoadMicroBatch, sched_lib.ForwardPass,
        sched_lib.BackwardPass, sched_lib.BackwardGradPass,
        sched_lib.BackwardWeightPass, sched_lib.SendActivation,
        sched_lib.RecvActivation, sched_lib.SendGrad, sched_lib.RecvGrad)}


def replay_trace(events, compiled, costs: Optional[CostModel] = None,
                 lane_prefix="stage") -> dict:
    """MEASURED bubble report: rebuild per-stage instruction streams from
    a telemetry trace (the PipelineEngine interpreter records one span
    per executed compiled instruction, lane ``stage<N>``, args
    (chunk_id, micro_id)) and replay them through the SAME tick
    simulation :func:`simulate` runs on the compiled plan.

    This is the cross-check the analytic numbers need to be trusted:
    ``simulate(compiled)`` prices what the schedule compiler *planned*;
    ``replay_trace(events, compiled)`` prices what the engine *actually
    executed*, reconstructed from its own trace.  An interpreter that
    reorders, drops or duplicates work diverges here — faithful
    execution reproduces the analytic idle fractions exactly (the tier-1
    tolerance test at pipe=4/gas=8).

    Raises ``ValueError`` on a trace with no pipeline spans — replaying
    an empty stream would report a perfect zero-instruction pipeline.
    """
    S = compiled.stages
    streams = [[] for _ in range(S)]
    n = 0
    for ev in events:
        lane = ev.get("lane", "")
        if not lane.startswith(lane_prefix):
            continue
        try:
            s = int(lane[len(lane_prefix):])
        except ValueError:
            continue
        cls = _TRACE_INSTRUCTIONS.get(ev.get("name"))
        if cls is None or not (0 <= s < S):
            continue
        chunk = ev.get("a0", -1)
        micro = ev.get("a1", -1)
        streams[s].append(cls(buffer_id=0,
                              chunk_id=chunk if chunk >= 0 else 0,
                              micro_id=micro))
        n += 1
    if n == 0:
        raise ValueError(
            "replay_trace: no pipeline instruction spans in the trace "
            f"(lanes '{lane_prefix}<N>'); was telemetry armed for the "
            "train_batch being replayed, or did the trace ring drop "
            "them (raise telemetry.trace_capacity)?")
    traced = sched_lib.CompiledSchedule(
        f"{compiled.name}-trace", compiled.micro_batches, S,
        compiled.virtual_stages, streams, compiled.num_buffers,
        stash=compiled.stash)
    report = simulate(traced, costs)
    report["replayed_instructions"] = n
    return report


def ideal_1f1b_bubble(micro_batches, stages):
    """Closed form (S-1)/(M+S-1) — valid for the equal_fwd_bwd cost model;
    kept as the cross-check anchor for the simulator."""
    return (stages - 1) / (micro_batches + stages - 1)
