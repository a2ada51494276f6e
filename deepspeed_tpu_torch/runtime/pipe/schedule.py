"""Pipeline instruction schedules: declarative streams driving the engine.

Port of deepspeed_tpu/runtime/pipe/schedule.py, a copy (pure Python;
reference deepspeed/runtime/pipe/schedule.py:6-482). The schedule is an
algorithm spec, not an implementation detail: TrainSchedule emits the
1F1B-interleaved stream (even/odd step -> micro-batch mapping, buffer
count = min(stages - stage + 1, micro_batches)), and ``compile_schedule``
plans the 1f1b, interleaved and ZB-H1 streams with explicit buffer slots,
chunk ids and micro ids. The engine (runtime/pipe/engine.py) executes
them host-driven: each instruction is one chunk's forward or backward on
the device, and each Send / Recv crosses the link of runtime/pipe/p2p.py
(a queue inside one process, or a ``torch.distributed`` send between
the processes of neighbouring stages).
"""


class PipeInstruction:
    """Namedtuple-style instruction; kwargs become attributes.
    Reference: schedule.py:336-356."""

    def __init__(self, **kwargs):
        self.name = self.__class__.__name__
        self.kwargs = kwargs
        for k, v in kwargs.items():
            setattr(self, k, v)

    def __repr__(self):
        args = ", ".join(f"{k}={v!r}" for k, v in self.kwargs.items())
        return f"{self.name}({args})"

    def __eq__(self, other):
        return (type(self) is type(other)) and self.kwargs == other.kwargs

    def __hash__(self):
        return hash((self.name, tuple(sorted(self.kwargs.items()))))


class OptimizerStep(PipeInstruction):
    """Step the optimizer and zero gradients; after Reduce*Grads."""


# Compiled-schedule buffer-op instructions additionally carry:
#   chunk_id  — the stage-LOCAL model-chunk index (interleaved virtual
#               stages; 0 when v=1). Global chunk = chunk_id*stages + stage.
#   micro_id  — the micro-batch this op processes (explicit, so the engine
#               never has to recover it from visit-order counters).


class ReduceGrads(PipeInstruction):
    """Data-parallel gradient reduction within the stage."""


class ReduceTiedGrads(PipeInstruction):
    """All-reduce gradients of tied modules over their tie group."""


class BufferOpInstruction(PipeInstruction):
    def __init__(self, buffer_id, **kwargs):
        super().__init__(buffer_id=buffer_id, **kwargs)


class LoadMicroBatch(BufferOpInstruction):
    """Load a micro-batch into buffer_id (first/last stages only)."""


class ForwardPass(BufferOpInstruction):
    """Run forward on buffer_id's activations."""


class BackwardPass(BufferOpInstruction):
    """Run backward with buffer_id's received output grads."""


class SendActivation(BufferOpInstruction):
    """Send buffer_id's activations to the next stage."""


class RecvActivation(BufferOpInstruction):
    """Receive activations from the previous stage into buffer_id."""


class SendGrad(BufferOpInstruction):
    """Send buffer_id's input grads to the previous stage."""


class RecvGrad(BufferOpInstruction):
    """Receive output grads from the next stage into buffer_id."""


class BackwardGradPass(BufferOpInstruction):
    """Zero-bubble dgrad: input grads only (vjp w.r.t. x); the weight
    gradient is deferred to a later BackwardWeightPass. The buffer's
    saved input activation and received output grad stay LIVE."""


class BackwardWeightPass(BufferOpInstruction):
    """Zero-bubble wgrad: the deferred vjp w.r.t. params into the grad
    accumulator; frees the buffer's activation and output grad."""


def _even(x):
    return x % 2 == 0


class PipeSchedule:
    """Generator of per-step instruction lists for one stage; each yielded
    step is barrier-safe. Reference: schedule.py:6-127."""

    def __init__(self, micro_batches, stages, stage_id):
        self.micro_batches = micro_batches
        self.stages = stages
        self.stage_id = stage_id
        self.prev_stage = stage_id - 1
        self.next_stage = stage_id + 1

    def steps(self):
        raise NotImplementedError

    def num_pipe_buffers(self):
        return self.micro_batches

    def _valid_micro_batch(self, mb):
        return 0 <= mb < self.micro_batches

    def _valid_stage(self, stage):
        return 0 <= stage < self.stages

    @property
    def stage(self):
        return self.stage_id

    @property
    def num_stages(self):
        return self.stages

    @property
    def num_micro_batches(self):
        return self.micro_batches

    @property
    def is_first_stage(self):
        return self.stage_id == 0

    @property
    def is_last_stage(self):
        return self.stage_id == self.stages - 1

    def _buffer_idx(self, mb):
        assert self._valid_micro_batch(mb)
        return mb % self.num_pipe_buffers()

    def __iter__(self):
        return iter(self.steps())


class InferenceSchedule(PipeSchedule):
    """Forward-only wavefront; double-buffered. Reference: schedule.py:129-181."""

    def steps(self):
        for step_id in range(self.micro_batches + self.stages - 1):
            mb = step_id - self.stage_id
            cmds = []
            if _even(self.stage_id):
                recv_buf, send_buf = step_id % 2, (step_id + 1) % 2
            else:
                recv_buf, send_buf = (step_id + 1) % 2, step_id % 2

            if (self.is_first_stage or self.is_last_stage) \
                    and self._valid_micro_batch(mb):
                cmds.append(LoadMicroBatch(recv_buf))

            # even stages send-then-recv, odd stages recv-then-send, so
            # paired blocking exchanges can't deadlock
            def _send():
                if self._valid_stage(self.next_stage) \
                        and self._valid_micro_batch(mb - 1):
                    cmds.append(SendActivation(send_buf))

            def _recv():
                if self._valid_stage(self.prev_stage) \
                        and self._valid_micro_batch(mb):
                    cmds.append(RecvActivation(recv_buf))

            if _even(self.stage_id):
                _send(), _recv()
            else:
                _recv(), _send()

            if self._valid_micro_batch(mb):
                cmds.append(ForwardPass(recv_buf))
            yield cmds

    def num_pipe_buffers(self):
        return 2


class TrainSchedule(PipeSchedule):
    """1F1B-interleaved training stream. Reference: schedule.py:183-289.

    Total 2*(micro_batches + stages - 1) ticks; each tick maps to a
    (micro_batch, is_forward) pair via the even/odd parity of tick and stage,
    interleaving one forward with one backward in steady state.
    """

    def steps(self):
        prev_mb = -1
        total = 2 * (self.micro_batches + self.stages - 1)
        for step_id in range(total):
            mb, is_forward = self._step_to_micro_batch(step_id)
            cmds = []

            # activation/grad exchange with the neighbor stages
            if is_forward:
                if self._valid_stage(self.prev_stage):
                    if self._valid_micro_batch(mb):
                        cmds.append(RecvActivation(self._buffer_idx(mb)))
                    if self._valid_micro_batch(prev_mb):
                        cmds.append(SendGrad(self._buffer_idx(prev_mb)))
            else:
                if self._valid_stage(self.next_stage):
                    if self._valid_micro_batch(prev_mb):
                        cmds.append(SendActivation(self._buffer_idx(prev_mb)))
                    if self._valid_micro_batch(mb):
                        cmds.append(RecvGrad(self._buffer_idx(mb)))

            if (self.is_first_stage or self.is_last_stage) \
                    and is_forward and self._valid_micro_batch(mb):
                cmds.append(LoadMicroBatch(self._buffer_idx(mb)))

            if self._valid_micro_batch(mb):
                cmds.append(ForwardPass(self._buffer_idx(mb)) if is_forward
                            else BackwardPass(self._buffer_idx(mb)))

            if step_id == total - 1:
                cmds.append(ReduceTiedGrads())
                cmds.append(ReduceGrads())
                cmds.append(OptimizerStep())

            prev_mb = mb
            yield cmds

    def num_pipe_buffers(self):
        """Distance to the last stage bounds in-flight micro-batches
        (reference schedule.py:243)."""
        return max(2, min(self.stages - self.stage_id + 1, self.micro_batches))

    def _step_to_micro_batch(self, step_id):
        """Even ticks run forwards on even stages / backwards on odd stages,
        and vice versa — the phase shift that interleaves 1F1B."""
        base = step_id // 2
        if _even(step_id) == _even(self.stage_id):
            # forward tick for this stage
            if _even(step_id):
                mb = base - self.stage_id // 2
            else:
                mb = (step_id - 1) // 2 - self.stage_id // 2
            return mb, True
        # backward tick
        if _even(step_id):
            mb = base - self.stages + (self.stage_id + 1) // 2
        else:
            mb = (step_id - 1) // 2 - self.stages + 1 + self.stage_id // 2
        return mb, False


#######################################################################
# Compiled schedules — interleaved virtual stages and zero-bubble ZB-H1
#
# The generator classes above describe per-stage streams in closed form;
# the better schedules below are PLANNED instead: a per-stage ordered list
# of compute ops (F / B / Bd / W per micro per chunk) is derived (Megatron
# interleaving order, arXiv 2104.04473; ZB-H1 wgrad deferral, arXiv
# 2401.10241), then lowered to an instruction stream with explicit buffer
# slots, chunk ids and micro ids. The engine executes compiled streams
# with queue semantics (a Recv blocks until its Send ran); timing/bubble
# claims about them are made by runtime/pipe/bubble_accounting.py, which
# replays any compiled schedule tick-by-tick against a cost model.
#######################################################################

SCHEDULE_1F1B = "1f1b"
SCHEDULE_INTERLEAVED = "interleaved"
SCHEDULE_ZB_H1 = "zb-h1"
KNOWN_SCHEDULES = (SCHEDULE_1F1B, SCHEDULE_INTERLEAVED, SCHEDULE_ZB_H1)


class _SlotAllocator:
    """Lowest-free-index buffer slots for one chunk; high-water = the
    buffer count the engine must allocate."""

    def __init__(self):
        self._free = []
        self._next = 0
        self.high_water = 0

    def alloc(self):
        if self._free:
            return self._free.pop(0)
        slot = self._next
        self._next += 1
        self.high_water = max(self.high_water, self._next)
        return slot

    def release(self, slot):
        assert slot not in self._free, f"double free of buffer slot {slot}"
        self._free.append(slot)
        self._free.sort()


class CompiledSchedule:
    """A planned training schedule, lowered to per-physical-stage flat
    instruction lists with explicit chunk/micro ids and buffer slots.

    streams[s] is executed in order by stage s; cross-stage data moves
    through per-(global chunk, kind) FIFO queues, so the only ordering
    contract is send-before-matching-recv (the engine blocks, the
    bubble simulator proves deadlock freedom).

    ``stash=True`` marks a zero-bubble schedule compiled for activation
    STASHING: each ForwardPass additionally fills a stash slot (the vjp
    residuals of the single forward) that stays live until the micro's
    BackwardWeightPass frees it — dgrad and wgrad consume the stash
    instead of recomputing the forward.  Stash slots reuse the stream's
    explicit buffer_ids (the F->W lifetime IS the buffer lifetime in a
    zb stream), so ``num_stash_slots`` per chunk equals ``num_buffers``
    there and is 0 for schedules compiled without stashing — executors
    and tools must refuse to run stash-mode cost models against a
    schedule whose slots were never emitted."""

    def __init__(self, name, micro_batches, stages, virtual_stages,
                 streams, num_buffers, stash=False):
        self.name = name
        self.micro_batches = micro_batches
        self.stages = stages
        self.virtual_stages = virtual_stages
        self.num_chunks = stages * virtual_stages
        self.streams = streams            # list[stages] of instruction lists
        self.num_buffers = num_buffers    # list[num_chunks] buffer slots
        self.stash = stash
        self.num_stash_slots = list(num_buffers) if stash \
            else [0] * len(num_buffers)

    def global_chunk(self, stage_id, chunk_id):
        return chunk_id * self.stages + stage_id

    def __repr__(self):
        return (f"CompiledSchedule({self.name}, micro={self.micro_batches}, "
                f"stages={self.stages}, v={self.virtual_stages}"
                f"{', stash' if self.stash else ''})")


def _order_1f1b(micro_batches, stages, stage_id, bwd_op="B"):
    """Classic 1F1B compute-op order for one stage: warmup forwards, then
    strict 1-forward-1-backward alternation, then cooldown backwards."""
    warmup = min(micro_batches, stages - stage_id - 1)
    ops = [("F", m, 0) for m in range(warmup)]
    fnext, bnext = warmup, 0
    while bnext < micro_batches:
        if fnext < micro_batches:
            ops.append(("F", fnext, 0))
            fnext += 1
        ops.append((bwd_op, bnext, 0))
        bnext += 1
    return ops


def _order_interleaved(micro_batches, stages, virtual_stages, stage_id):
    """Megatron interleaved-1F1B compute-op order for one stage (reference:
    megatron/core/pipeline_parallel/schedules.py, forward_backward_
    pipelining_with_interleaving). Requires micro_batches % stages == 0."""
    S, v, M = stages, virtual_stages, micro_batches
    assert M % S == 0, "interleaved schedule needs micro_batches % stages == 0"
    total = M * v

    def fchunk(k):
        return (k % (S * v)) // S

    def micro(k):
        return (k // (S * v)) * S + (k % S)

    if M == S:
        warmup = total
    else:
        warmup = min(total, (S - stage_id - 1) * 2 + (v - 1) * S)
    ops = [("F", micro(k), fchunk(k)) for k in range(warmup)]
    for i in range(total - warmup):
        k_f, k_b = warmup + i, i
        ops.append(("F", micro(k_f), fchunk(k_f)))
        ops.append(("B", micro(k_b), v - 1 - fchunk(k_b)))
    for k in range(total - warmup, total):
        ops.append(("B", micro(k), v - 1 - fchunk(k)))
    return ops


def _plan_zb_h1(micro_batches, stages, fwd_cost=1.0, dgrad_cost=1.5,
                wgrad_cost=1.5, max_live=None):
    """ZB-H1 (arXiv 2401.10241 fig. 4) op orders for all stages: the 1F1B
    mainline with backwards split into dgrad (Bd, stays on the critical
    path) and wgrad (W, deferred into bubble slots by a greedy timing
    simulation). ``max_live`` caps in-flight micro-batches per stage (a
    forced W runs before a forward that would exceed it). The default cap
    min(S, M) on EVERY stage keeps the worst-stage activation peak (stage
    0, which sizes uniformly-provisioned devices) identical to 1F1B while
    reaching the paper's H1 bubble; later stages hold up to that many
    in-flight micros instead of 1F1B's S-s."""
    S, M = stages, micro_batches
    mains = [_order_1f1b(M, S, s, bwd_op="Bd") for s in range(S)]
    if max_live is None:
        max_live = [max(2, min(S, M))] * S
    idx = [0] * S
    free_t = [0.0] * S
    pending_w = [[] for _ in range(S)]    # micros with Bd done, W not yet
    live = [0] * S                        # micros with F done, W not yet
    orders = [[] for _ in range(S)]
    f_done, d_done = {}, {}               # (micro, stage) -> finish time

    def dep_time(op, m, s):
        """Cross-stage readiness time, or None if the producer has not been
        simulated yet (decide later)."""
        if op == "F":
            return 0.0 if s == 0 else f_done.get((m, s - 1))
        return 0.0 if s == S - 1 else d_done.get((m, s + 1))

    def run_w(s):
        m = pending_w[s].pop(0)
        orders[s].append(("W", m, 0))
        free_t[s] += wgrad_cost
        live[s] -= 1

    done = lambda: all(i >= len(mains[s]) and not pending_w[s]  # noqa: E731
                       for s, i in enumerate(idx))
    while not done():
        progressed = False
        for s in range(S):
            if idx[s] >= len(mains[s]):
                while pending_w[s]:                 # cooldown: drain wgrads
                    run_w(s)
                    progressed = True
                continue
            op, m, _ = mains[s][idx[s]]
            if op == "F" and live[s] >= max_live[s] and pending_w[s]:
                run_w(s)                            # memory cap: W first
                progressed = True
                continue
            t_dep = dep_time(op, m, s)
            if t_dep is None:
                continue                            # producer not planned yet
            if t_dep > free_t[s] and pending_w[s]:
                run_w(s)                            # bubble slot: fill with W
                progressed = True
                continue
            start = max(free_t[s], t_dep)
            if op == "F":
                free_t[s] = start + fwd_cost
                f_done[(m, s)] = free_t[s]
                live[s] += 1
            else:
                free_t[s] = start + dgrad_cost
                d_done[(m, s)] = free_t[s]
                pending_w[s].append(m)
            orders[s].append((op, m, 0))
            idx[s] += 1
            progressed = True
        assert progressed, "zb-h1 planner wedged (mainline not 1F1B-feasible)"
    return orders


def _emit_streams(orders, stages):
    """Lower per-stage compute-op orders [(op, micro, local_chunk), ...]
    into instruction streams with explicit buffer slots. Returns
    (streams, num_buffers) with num_buffers per GLOBAL chunk."""
    S = stages
    num_chunks = 1 + max(c * S + s for s, ops in enumerate(orders)
                         for _, _, c in ops) if any(orders) else S
    slots = [_SlotAllocator() for _ in range(num_chunks)]
    buf_of = {}                            # (micro, global chunk) -> slot
    streams = [[] for _ in range(S)]

    # Buffer lifetimes interleave across stages in wall-clock order, not
    # per-stage stream order; allocate by replaying all stages' ops in a
    # dependency-consistent global order. Round-robin one op per stage per
    # pass preserves each stage's order and is feasible whenever the
    # schedule itself is (the engine executes with the same discipline).
    idx = [0] * S
    fwd_seen = [set() for _ in range(num_chunks)]
    bwd_seen = [set() for _ in range(num_chunks)]

    def emit(s, op, m, c):
        g = c * S + s
        out = streams[s]
        if op == "F":
            buf = slots[g].alloc()
            buf_of[(m, g)] = buf
            kw = dict(chunk_id=c, micro_id=m)
            if g == 0:
                out.append(LoadMicroBatch(buf, **kw))
            else:
                out.append(RecvActivation(buf, **kw))
            if g == num_chunks - 1 and g != 0:
                out.append(LoadMicroBatch(buf, **kw))   # labels for the loss
            out.append(ForwardPass(buf, **kw))
            if g < num_chunks - 1:
                out.append(SendActivation(buf, **kw))
            fwd_seen[g].add(m)
        else:
            buf = buf_of[(m, g)]
            kw = dict(chunk_id=c, micro_id=m)
            if op in ("B", "Bd"):
                if g < num_chunks - 1:
                    out.append(RecvGrad(buf, **kw))
                out.append(BackwardPass(buf, **kw) if op == "B"
                           else BackwardGradPass(buf, **kw))
                if g > 0:
                    out.append(SendGrad(buf, **kw))
                bwd_seen[g].add(m)
            if op in ("B", "W"):
                if op == "W":
                    out.append(BackwardWeightPass(buf, **kw))
                slots[g].release(buf)
                del buf_of[(m, g)]

    def ready(s):
        op, m, c = orders[s][idx[s]]
        g = c * S + s
        if op == "F":
            return g == 0 or m in fwd_seen[g - 1]
        if op in ("B", "Bd"):
            return g == num_chunks - 1 or m in bwd_seen[g + 1]
        return True                                     # W: stage-local

    while any(i < len(orders[s]) for s, i in enumerate(idx)):
        progressed = False
        for s in range(S):
            if idx[s] >= len(orders[s]) or not ready(s):
                continue
            emit(s, *orders[s][idx[s]])
            idx[s] += 1
            progressed = True
        assert progressed, "schedule op order is not dependency-feasible"
    return streams, [a.high_water for a in slots]


def compile_schedule(name, micro_batches, stages, virtual_stages=1,
                     stash=False):
    """Build the CompiledSchedule for a training batch.

    1f1b        — the classic schedule (identical math/op order to
                  TrainSchedule, lowered to the compiled form);
    interleaved — Megatron virtual stages: each physical stage owns
                  ``virtual_stages`` non-contiguous model chunks, shrinking
                  the pipeline bubble by ~1/v at the cost of (v-1) extra
                  p2p boundary crossings per micro;
    zb-h1       — zero-bubble H1: backwards split into dgrad/wgrad, wgrads
                  deferred into bubble slots.  ``stash=True`` compiles the
                  activation-STASHING variant: the greedy wgrad placement
                  is timed at dgrad = wgrad = 1 (neither split pass pays a
                  forward recompute — both consume the forward's stashed
                  vjp residuals) and every buffer slot doubles as a stash
                  slot (CompiledSchedule.num_stash_slots).

    Callers gate/fall back (with DISARMED warnings) BEFORE calling; this
    function asserts hard on violated preconditions.
    """
    M, S, v = micro_batches, stages, virtual_stages
    assert not stash or name == SCHEDULE_ZB_H1, \
        "activation stashing composes with the zb-h1 schedule only (the " \
        "fused backward of 1f1b/interleaved already recomputes exactly once)"
    if name == SCHEDULE_1F1B:
        assert v == 1, "1f1b has no virtual stages"
        orders = [_order_1f1b(M, S, s) for s in range(S)]
    elif name == SCHEDULE_INTERLEAVED:
        assert v >= 2 and S >= 2
        orders = [_order_interleaved(M, S, v, s) for s in range(S)]
    elif name == SCHEDULE_ZB_H1:
        assert v == 1, "zb-h1 composes with v=1 only"
        assert S >= 2
        if stash:
            orders = _plan_zb_h1(M, S, fwd_cost=1.0, dgrad_cost=1.0,
                                 wgrad_cost=1.0)
        else:
            orders = _plan_zb_h1(M, S)
    else:
        raise KeyError(f"unknown pipeline schedule {name!r}; "
                       f"known: {KNOWN_SCHEDULES}")
    streams, num_buffers = _emit_streams(orders, S)
    while len(num_buffers) < S * v:       # chunks that never got a slot
        num_buffers.append(1)
    return CompiledSchedule(name, M, S, v, streams, num_buffers, stash=stash)


class DataParallelSchedule(PipeSchedule):
    """Plain gradient-accumulation DP expressed as a pipe schedule.
    Reference: schedule.py:292-318."""

    def steps(self):
        for step_id in range(self.micro_batches):
            cmds = [LoadMicroBatch(0), ForwardPass(0), BackwardPass(0)]
            if step_id == self.micro_batches - 1:
                cmds.extend([ReduceGrads(), OptimizerStep()])
            yield cmds

    def num_pipe_buffers(self):
        return 1
