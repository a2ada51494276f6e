"""DeepSpeedEngine: one device per process, data, sequence and tensor
parallel over a process grid, with ZeRO stage 0, 1, 2 or 3.

Port of deepspeed_tpu/runtime/engine.py (the pipeline axis is
runtime/pipe/engine.py's, whose PipelineEngine builds on this one): the
optimizer and LR scheduler from the ds_config
(``_configure_basic_optimizer`` :439, ``_configure_lr_scheduler`` :523),
``forward`` / ``backward`` / ``step`` (:3111, :3217, :3285), the optimizer
step with the fp16 loss scale, global-norm clipping and the overflow skip
(``_take_model_step`` :3415, apply fn :2184-2240), ``train_batch`` (:3489:
gas micro-batches, then one step, returning the mean loss), ``eval_loss``
(:3616), progressive layer drop, ``deepspeed_io`` (:542), the comm volume
report (:2956) and ``save_checkpoint`` / ``load_checkpoint`` (:4312,
:4671) in the JAX engine's own layout.

Precision: the JAX engine's TrainState. Each micro-batch's gradients are
added into an fp32 accumulator (``accum``: views of one flat buffer). At
fp32 the module's parameters are the master weights. With bf16 or fp16 the
engine keeps fp32 master weights (``master``) and the module's parameters
are the compute-dtype copy, refreshed from the master after each optimizer
step: the model computes with the rounded weights, LayerNorm included, and
its compute-dtype gradients (one tied leaf's uses summed in that dtype) go
into the accumulator. Weights are loaded with ``load_module_state_dict``
(the master keeps their fp32 bits); a parameter written into the module
directly becomes the master's value at the next step. fp16 scales the loss
by the dynamic loss scale (runtime/fp16/loss_scaler.py). The step decides
on the device whether the accumulator overflowed (a non-finite element):
one select zeroes it, and the optimizer's in-place update with identity
coefficients skips the step. No host sync; logging reads the flags at
``steps_per_print``. Initial parameters come from the model's
``init_weights`` under the config's ``seed`` (default 42).

Data parallelism (``init_distributed``: NCCL on CUDA, gloo on the CPU):
each process feeds its own micro-batch, and the loss and gradients are the
global batch's, as the JAX engine's over its ``data`` axis: a model with
``set_loss_group`` (models/api.py) computes the whole micro-batch's loss
over the world (Σnll / Σcount of every rank's tokens), and the engine sums
the ranks' gradients; another model's loss is averaged over the ranks. Each
micro step's fp32 gradients are exchanged on the current stream: an
all-reduce, and at stage 2 a reduce-scatter of the leaves ZeRO shards
into the rank's shard of the accumulator (runtime/zero/partition.py: the
JAX engine's per-leaf rule). From stage 1 the master weights and the
optimizer state are the rank's shards; the update runs on them, and one
all-gather brings the compute-dtype parameters back to every rank. The
overflow flag is a MAX and the global norm a SUM over the group, so every
rank takes or skips the same step. In a world of one every leaf is
replicated, and the step is the single-process one bit for bit.

Sequence parallelism (``"mesh": {"data": D, "seq": N}``, a world of D*N
processes; parallel/mesh.py lays the grid in the JAX mesh's order, and
each rank's ``data`` line and ``seq`` line is a process group): each rank
feeds its data rows at full sequence, as at N = 1, so the N ranks of a
seq line feed the same micro-batch. The engine keeps the rank's chunk of
the sequence of ``input_ids`` (and ``token_type_ids``), and the whole row
of the labels and masks, which the model's loss reads (the whole
micro-batch's, the same value on every rank). The model runs
its attention through Ulysses or the ring (``set_sequence_parallel``).
The parameters are replicated over ``seq``, and each rank's backward
holds the terms of its own chunk's tokens: the sum over the seq group
(``sp_grad_ar``) is one all-reduce, in place, of the buffer that already
holds the rank's gradients after the data-parallel exchange (a sum is
the same in either order): the fp32 accumulator at the optimizer step,
or under offload each micro step's buffer before its copy down. So no
buffer is added, and the loss scale, the norm, the overflow flag and
ZeRO's shards are the data axis's alone, as under ``zero_merge_spec``.
Rank 0 writes checkpoints.

Tensor parallelism (``"mesh": {"data": D, "model": M}``, a world of D*M
processes, rank r = d*M + m; the JAX engine's GSPMD layout of the model's
``param_partition_spec``): the engine hands the model its ``model`` line
(``set_tensor_parallel``), and the model keeps its rank's shards and runs
the collectives of parallel/tensor_parallel.py. Every rank of a model
line feeds the same batch rows (its data line's, ``dp_rank``). The
parameters, master, optimizer state and accumulator are this rank's
shards; ZeRO shards them over the data line by the JAX rule (the largest
dim the tensor-parallel spec leaves free). The data-parallel exchange is
each model rank's own; the global norm sums the squares of the split
leaves over the model line and counts a replicated leaf once, the
overflow flag is a MAX over the world, and the loss is the data line's
(``set_loss_group``). Checkpoints hold whole leaves in the JAX layout
(``c_attn`` in [q|k|v] order), gathered over the model line: any
``model`` size, 1 included, and the JAX engine load them. An ``mpu``
whose sizes agree with the mesh is accepted. What tensor parallelism
does not run beside yet raises NotImplementedError naming ROADMAP A7c.

Expert parallelism (a model with MoE layers; the JAX engine's placement of
the expert stacks over ``data`` by ``moe_leaf_spec``, at every ZeRO
stage): at dp > 1 rank r keeps experts [r*E/dp, (r+1)*E/dp) of each stack
(``moe.expert_parallel``), and the tokens reach them by all-to-all inside
the model. The stack's parameter, master, optimizer state and accumulator
are this rank's experts: its gradients go in neither the all-reduce nor
ZeRO's shard rule (the exchange's backward already brings every rank's
tokens' gradient), and the global norm and the overflow flag sum and MAX
their shards over the group. Checkpoints hold the whole stacks, gathered
along E; a load keeps this rank's experts.

ZeRO-Offload (``"cpu_offload": true`` with Adam or AdamW; the JAX engine's
``_ensure_state_offload``, ``_take_model_step_offload``): the fp32 master
weights, the Adam moments and the gradient accumulator live in host
memory, and the device holds only the compute-dtype parameters. After
each backward the gradients (at dp > 1 this rank's part of the exchanged
fp32 ones) are copied into a pinned staging buffer on a side stream, and
the host adds micro step k into its fp32 accumulator while the device
runs micro step k + 1. The step is the host's: a finite check and a
float64 sum of squares of the accumulator, the clip folded into the
gradient scale, the port's C++ Adam (ops/adam/cpu_adam.py) over the
master, and the master rounded to the compute dtype and copied back into
the parameters (at dp > 1 this rank's shard, then one all-gather).

ZeRO stage 3 (JAX ``_arm_stage3``, engine.py:687-854): the compute-dtype
parameters of the leaves ZeRO shards hold only this rank's shard at rest
(views of one segment, ``_ag_send``); the gradients exchange as at stage
2. Armed (the default at dp > 1 without offload, within
``stage3_prefetch_budget``), each micro step gathers every planned leaf
once, in the plan's block order (runtime/zero/stage3.py), as int8 codes
and fp32 scales (``quantized_all_gather``: the forward computes with the
dequantized weights, and their gradients are the straight-through
ones); the gathered weights stay live until the micro step's gradient
exchange and are freed after it. Disarmed (``stage3_scheduled_gathers:
false`` or a blocker, each named in a warning), the implicit path
(runtime/zero/gathers.py): each layer's parameters gathered densely in
the compute dtype as the layer runs and freed after it, and gathered
again at their first use in the backward (a remat recompute's gather),
two gathers per micro step as the JAX report prices them; the autograd
graph keeps no gathered weight. No buffer of the whole model stays on the
device at stage 3: the reduce-scatter's input is made for each exchange.
Through ``forward()`` / ``backward()`` the armed halves are the programs
``s3_fwd`` and ``s3_bwd``.

Quantized collectives (JAX ``_arm_quantized_collectives``,
engine.py:856-942): qgZ (``quantized_gradients``, stage 2, dp > 1, no
offload, seq 1) moves the reduce-scatter of the sharded leaves' gradients
as int8 codes and fp32 scales through all-to-alls, flat or over
``hierarchical_intra_size`` consecutive ranks and then across them
(runtime/custom_collectives.py); qwZ (``quantized_weights``) quantizes
the offload push's shards on the host, so the copy up and the gather move
int8 codes and scales, dequantized on the device; at stage 3 armed, the
scheduled gathers are the int8 weight wire.

1-bit Adam and 0/1 Adam (``OneBitAdam``, ``ZeroOneAdam``; the JAX
engine's wire paths, engine.py:468-516, 2247-2579): at dp > 1 and stage 0
the optimizer owns the gradient exchange. ``train_batch`` keeps each
rank's gradients its own (its micro-batch's loss, no exchange); the step
all-reduces their mean in warmup, then 1-bit Adam sends its momentum
through ``compressed_allreduce`` and 0/1 Adam its round's gradient
through ``quantized_all_reduce`` once per k steps (local rounds post no
collective), each leaf flattened in the JAX tree's layout. The phase is
a host function of the step counters (fp16 skips excluded), so a loaded
tag goes on in the phase of a run that never stopped; the per-rank
residuals are the rows of the JAX state's leading dp dim. At dp 1, or
blocked, the wire is disarmed with its blockers named, and the
optimizer steps on the exchanged mean (0/1 Adam: warmup for ever).

CSR gradients (``sparse_gradients`` and a model's ``sparse_grad_spec``;
JAX engine.py:602-652, 1662-1738, 1856-1965): the flagged (row-sparse)
parameters' gradients move as (row indices, row values) at the
micro-batch's token capacity: an all-gather in place of their all-reduce
under plain data parallelism (stage <= 1), and on ZeRO-Offload's copy
down at dp 1, scatter-added into the host accumulator.

Telemetry (``"telemetry"``, ``"flops_profiler"``, ``"tensorboard"``,
``"wall_clock_breakdown"``; the JAX engine's ``_arm_telemetry``,
engine.py:1023-1145, 1205-1411): host-time spans on lanes ``train``
(``forward_micro``, ``backward_micro``, ``optimizer_step``,
``overflow_skip``), ``ckpt`` (``ckpt_sync_commit``) and ``mem``
(``hbm_in_use``); the JSONL step stream; MFU/HFU from FLOPs counted by a
replay on meta tensors; the memory report, whose measured side is the
CUDA allocator's. Armed with trace, MFU and memory, a step makes no host
sync; with ``metrics_jsonl`` it makes one: the step's scalars stacked and
fetched in one copy. Nothing armed changes what the step computes.

Programs (telemetry/programs.py; the JAX engine's program registry):
``train_batch`` is the program ``fused_train_step`` (the micro loop, the
loss all-reduce and the optimizer step; under offload each micro step is
``micro_offload`` and the fetch and host step lie outside), forward +
backward is ``micro_step``, ``step()`` is ``apply_step`` and
``eval_loss`` is ``eval_loss``, each registered at its first dispatch
with the JAX engine's contract (``program_registry``). The program lint
(telemetry/program_lint.py) observes one dispatch of each.

Resilience (runtime/resilience/; the JAX engine's, engine.py:3660-4070,
4283-4753), in one process: checkpoints stamped with the topology and
the exact data position; asynchronous commits (``async_commit``: the
state copied to pinned host buffers before ``save_checkpoint`` returns,
the payload written, hashed and fsync'd on a thread, the rename
published at a step boundary; at most one in flight); ``auto_resume``
(the newest tag that verifies, healthy before integrity-suspect before
emergency tags); elastic loads; the watchdog (overflow and NaN streaks,
stalls; an emergency tag before its abort); graceful preemption; the
integrity sentinels (loss, gradient norm and the update ratio
||new master - master|| / ||master||, from a copy of the master taken
before the update); the supervisor's hooks (runtime/resilience/
supervisor.py). Armed, the watchdog or the sentinels read the step's
scalars in one batched host copy (the same one as the metrics stream);
disarmed, the step is unchanged. In a world of several processes these
features raise, naming ROADMAP A16b.

Configurations that need parts of the port still to come raise at
construction, naming their ROADMAP item.
"""
import contextlib
import copy
import logging
import math
import os
import pickle
import time
import weakref

import hashlib

import numpy as np
import torch
import torch.distributed as dist

from deepspeed_tpu_torch.moe.sharded_moe import expert_parallel
from deepspeed_tpu_torch.ops.adam.cpu_adam import (DeepSpeedCPUAdam,
                                                  accumulate, sum_of_squares)
from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam
from deepspeed_tpu_torch.ops.adam.sgd import SGD
from deepspeed_tpu_torch.ops.lamb.fused_lamb import FusedLamb
from deepspeed_tpu_torch.ops.onebit.onebit_adam import OnebitAdam
from deepspeed_tpu_torch.ops.onebit.zeroone_adam import ZeroOneAdam
from deepspeed_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                               PIPE_AXIS, SEQ_AXIS,
                                               DataParallelGroup,
                                               ModelParallelGroup,
                                               ProcessGrid,
                                               SequenceParallelGroup,
                                               pipe_processes, resolve_grid)
from deepspeed_tpu_torch.parallel.tensor_parallel import \
    TensorParallelLayout
from deepspeed_tpu_torch.runtime import checkpoint_utils
from deepspeed_tpu_torch.runtime import comm_accounting as ca
from deepspeed_tpu_torch.runtime import memory_accounting
from deepspeed_tpu_torch.runtime.config import (DeepSpeedConfig,
                                                get_mesh_shape)
from deepspeed_tpu_torch.runtime.config_utils import load_config_json
from deepspeed_tpu_torch.runtime.csr_tensor import (CSRTensor,
                                                   allgather_csr,
                                                   nonzero_rows,
                                                   scatter_add_rows)
from deepspeed_tpu_torch.runtime.custom_collectives import (
    quantized_gather_rows, quantized_reduce_scatter_rows, rows_to_leaf)
from deepspeed_tpu_torch.runtime.constants import (
    ADAM_OPTIMIZER, ADAMW_OPTIMIZER, LAMB_OPTIMIZER, ONEBIT_ADAM_OPTIMIZER,
    SGD_OPTIMIZER, TELEMETRY_ENABLED, TELEMETRY_MEMORY,
    TELEMETRY_METRICS_FSYNC, TELEMETRY_METRICS_JSONL, TELEMETRY_MFU,
    TELEMETRY_PEAK_TFLOPS, TELEMETRY_TRACE, TELEMETRY_TRACE_CAPACITY,
    ZEROONE_ADAM_OPTIMIZER)
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader
from deepspeed_tpu_torch.runtime.fp16.loss_scaler import (
    CreateLossScaler, make_loss_scale_state, update_loss_scale)
from deepspeed_tpu_torch.runtime.lr_schedules import SCHEDULER_REGISTRY
from deepspeed_tpu_torch.runtime.progressive_layer_drop import \
    ProgressiveLayerDrop
from deepspeed_tpu_torch.runtime.resilience import atomic, chaos, reshard
from deepspeed_tpu_torch.runtime.resilience.watchdog import (
    EVENT_STALL, GracefulPreemption, TrainingWatchdog, WatchdogAlarm,
    chain_signal_handlers)
from deepspeed_tpu_torch.runtime.quantization import (block_layout,
                                                      dequantize_rows,
                                                      quantize_blockwise_np)
from deepspeed_tpu_torch.runtime.utils import (clip_grad_by_global_norm,
                                               global_norm_from_tree,
                                               has_overflow)
from deepspeed_tpu_torch.runtime.zero import stage3 as s3
from deepspeed_tpu_torch.runtime.zero.gathers import BlockGathers
from deepspeed_tpu_torch.runtime.zero.partition import ZeroPartition
from deepspeed_tpu_torch.telemetry.programs import (NO_OBSERVER,
                                                    ProgramRegistry)
from deepspeed_tpu_torch.utils.distributed import (cards_shared,
                                                   grid_groups,
                                                   init_distributed,
                                                   local_world_size)
from deepspeed_tpu_torch.utils.logging import log_dist, logger
from deepspeed_tpu_torch.utils.timer import (SynchronizedWallClockTimer,
                                             ThroughputTimer)

#: the bytes of a micro step's loss reduction over the group at dp > 1
#: (``group_ratio``: the fp32 sum of the losses and of their counts)
LOSS_REDUCTION_BYTES = 2 * 4

_OPTIMIZERS = (FusedAdam, FusedLamb, SGD)
#: the optimizers that own their gradient wire (1-bit Adam, 0/1 Adam)
_WIRE_OPTIMIZERS = (OnebitAdam, ZeroOneAdam)
_M32 = 0xFFFFFFFF
# wall_clock_breakdown's timers (the JAX engine's names)
FORWARD_MICRO_TIMER = "forward_microstep"
BACKWARD_MICRO_TIMER = "backward_microstep"
STEP_MICRO_TIMER = "step_microstep"


def resolve_device(device=None) -> torch.device:
    """``cuda`` by default; raises when CUDA is asked for (or defaulted to)
    and absent, rather than running on the CPU unasked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: pass device='cpu' to "
                               "run the engine on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} asked for, CUDA is not "
                           f"available")
    return device


def _refuse_unported(raw, cfg, world=1):
    """NotImplementedError for every configuration this port cannot run
    yet, naming its ROADMAP item (A12b the pipeline's residue, A16b
    resilience in a world of several processes; the optimizers' and the
    CSR wires' residue, A13c, at ``_arm_wire`` and ``_arm_csr``);
    nothing is silently ignored."""
    def no(what, item):
        raise NotImplementedError(f"{what} is not ported yet (ROADMAP "
                                  f"{item})")

    if cfg.zero_config.cpu_offload and (
            cfg.pipeline.get("stages", 1) not in (1, None)
            or get_mesh_shape(raw).get("pipe", 1) not in (1, -1)):
        no("ZeRO-Offload with pipeline parallelism", "A12b")
    res = cfg.resilience
    if world > 1:
        for on, what in ((res.watchdog_enabled, "the resilience watchdog"),
                         (res.integrity_enabled, "the integrity monitor "
                          "(its cross-replica vote and duplicate-compute "
                          "check)"),
                         (res.async_commit, "asynchronous checkpoint "
                          "commits"),
                         (res.auto_resume, "auto_resume")):
            if on:
                no(f"{what} in a world of {world} processes", "A16b")


def _check_mpu(mpu, shape):
    """An ``mpu`` (runtime/pipe/topology.py ``PipelineParallelGrid``'s
    interface) is accepted when its sizes are the mesh's, as the JAX engine
    stores it (engine.py:92); the grid's own groups do the work."""
    for axis, getter in ((MODEL_AXIS, "get_model_parallel_world_size"),
                         (DATA_AXIS, "get_data_parallel_world_size")):
        if not hasattr(mpu, getter):
            raise ValueError(f"the mpu has no {getter}() (the interface of "
                             f"runtime/pipe/topology.py PipelineParallelGrid)")
        size = int(getattr(mpu, getter)())
        if size != shape[axis]:
            raise ValueError(f"the mpu's {getter}() is {size}, the mesh's "
                             f"{axis} axis {shape[axis]}: give the mesh the "
                             f"mpu's sizes")


def _refuse_beside_model(raw, cfg, model, optimizer=None):
    """NotImplementedError, naming ROADMAP A7c, for what tensor parallelism
    (mesh ``model`` > 1) does not run beside yet; nothing falls back to
    model 1. The mesh's seq and pipe axes raise in ``resolve_grid``, MoE
    blocks in the model's ``set_tensor_parallel``. ``optimizer``: the
    client's, if any."""
    def no(what):
        raise NotImplementedError(f"{what} beside tensor parallelism (mesh "
                                  f"model > 1) is not ported yet (ROADMAP "
                                  f"A7c)")

    zc = cfg.zero_config
    if not hasattr(model, "set_tensor_parallel"):
        no(f"{type(model).__name__}, which has no set_tensor_parallel(),")
    if zc.stage >= 3:
        no("ZeRO stage 3")
    if zc.quantized_weights or zc.quantized_gradients:
        no("the int8 ZeRO collectives (qwZ, qgZ)")
    if zc.cpu_offload:
        no("ZeRO-Offload (cpu_offload)")
    if cfg.optimizer_name in (ONEBIT_ADAM_OPTIMIZER, ZEROONE_ADAM_OPTIMIZER) \
            or isinstance(optimizer, _WIRE_OPTIMIZERS):
        no("the 1-bit and 0/1 Adam wires")
    if raw.get("sparse_gradients"):
        no("sparse_gradients (CSR)")
    ac = getattr(cfg, "activation_checkpointing_config", None)
    if ac is not None and ac.cpu_checkpointing:
        no("checkpoint_in_cpu (activation_checkpointing.cpu_checkpointing)")


class DeepSpeedEngine:
    # the pipeline engine's (runtime/pipe/engine.py): a PipelineModule over
    # the mesh's pipe axis
    _pipeline = False

    def __init__(self, args=None, model=None, optimizer=None,
                 model_parameters=None, training_data=None, lr_scheduler=None,
                 mpu=None, dist_init_required=None, collate_fn=None,
                 config_params=None, device=None):
        if model is None:
            raise ValueError("deepspeed_tpu_torch.initialize requires a "
                             "model")
        if not (hasattr(model, "loss") and hasattr(model, "init_weights")):
            raise TypeError("the model must be an nn.Module with loss() and "
                            "init_weights() (models/api.py), or a "
                            "PipelineModule through initialize()")
        if dist_init_required or (dist_init_required is None
                                  and not dist.is_initialized()):
            # joins the world the environment names; a no-op without one
            init_distributed(device="cuda" if device is None else device)
        self.device = resolve_device(device)
        self.client_optimizer = optimizer
        self.client_lr_scheduler = lr_scheduler
        self.collate_fn = collate_fn
        self.global_steps = 0
        self.micro_steps = 0

        # --- config -----------------------------------------------------
        config_file = getattr(args, "deepspeed_config", None) if args else None
        if config_file is None and args is not None:
            config_file = getattr(args, "deepscale_config", None)
        raw = config_params if config_params is not None else config_file
        if raw is None:
            raise ValueError("DeepSpeed requires --deepspeed_config or "
                             "config_params")
        raw = load_config_json(raw) if isinstance(raw, str) else raw
        world = dist.get_world_size() if dist.is_initialized() else 1
        self.mesh_shape = resolve_grid(get_mesh_shape(raw), world)
        # the processes of a pipe line: pipe (one per stage) or 1 (this
        # process drives the line), parallel/mesh.py
        self.pipe_procs = pipe_processes(self.mesh_shape, world)
        if self.mesh_shape[PIPE_AXIS] > 1 and not self._pipeline:
            raise NotImplementedError(
                f"mesh pipe={self.mesh_shape[PIPE_AXIS]} with "
                f"{type(model).__name__}, which is not a PipelineModule "
                f"(runtime/pipe/module.py), is not ported yet (ROADMAP A12b: "
                f"the JAX engine replicates such a model over the pipe "
                f"axis)")
        self.dp_world_size = self.mesh_shape[DATA_AXIS]
        self.sp_world_size = self.mesh_shape[SEQ_AXIS]
        self.mp_world_size = self.mesh_shape[MODEL_AXIS]
        if mpu is not None:
            _check_mpu(mpu, self.mesh_shape)
        self.mpu = mpu
        self._process_groups()
        self.dp_rank = 0 if self.dp_group is None else self.dp_group.rank
        self.sp_rank = 0 if self.sp_group is None else self.sp_group.rank
        self.mp_rank = 0 if self.mp_group is None else self.mp_group.rank
        self._config = DeepSpeedConfig(raw, world_size=self.dp_world_size)
        _refuse_unported(raw, self._config, world)
        if self.mp_world_size > 1:
            _refuse_beside_model(raw, self._config, model, optimizer)
        # the dispatched-program registry is ALWAYS on: one dict insert at
        # each program's first dispatch; the lint
        # (telemetry/program_lint.py) arms it to observe one dispatch each
        self._programs = ProgramRegistry("base")
        # the program forward()/backward() make up: None inside
        # train_batch's fused_train_step
        self._micro_name = "micro_step"
        self._micro_obs = NO_OBSERVER

        # --- precision (reference engine.py:136-144) --------------------
        if self.fp16_enabled():
            self.compute_dtype = torch.float16
        elif self.bf16_enabled() or self._config.amp_enabled:
            self.compute_dtype = torch.bfloat16
        else:
            self.compute_dtype = torch.float32
        model_dtype = getattr(getattr(model, "config", None), "dtype", None)
        if model_dtype is not None and model_dtype != self.compute_dtype:
            log_dist(f"model computes in {model_dtype}, the config asks for "
                     f"{self.compute_dtype}: the model's dtype is used",
                     ranks=[0])
        # the dtype of the module's parameters: the one the model computes in
        self.param_dtype = model_dtype or self.compute_dtype
        self.mixed_precision = self.param_dtype != torch.float32

        # --- model, master weights, accumulator -------------------------
        self._seed = int(raw.get("seed", 42))
        self.module = model.to(self.device)
        self.module.init_weights(torch.Generator().manual_seed(self._seed))
        if self.mp_group is not None:
            # this model rank's shards of the whole model just drawn
            self.module.set_tensor_parallel(self.mp_group)
        # the whole micro-batch's loss, over every rank holding its rows
        # (models/api.py): the world, or under tensor parallelism the
        # data line (the model line's ranks compute the same loss)
        self._loss_group = self._world_group if self.mp_group is None \
            else self.dp_group
        self._loss_is_global = self._loss_group is not None \
            and self._loss_group.size > 1 \
            and hasattr(self.module, "set_loss_group")
        if self._loss_is_global:
            self.module.set_loss_group(self._loss_group)
        if self.sp_group is not None:
            if not hasattr(self.module, "set_sequence_parallel"):
                raise NotImplementedError(
                    f"mesh seq={self.sp_world_size}: "
                    f"{type(self.module).__name__} has no sequence-parallel "
                    f"path (set_sequence_parallel)")
            self.module.set_sequence_parallel(self.sp_group)
        # expert parallelism over data: this rank's E/dp experts (the JAX
        # engine refuses a stack that dp does not divide, and so does this)
        experts = expert_parallel(self.module, self.dp_group) \
            if self.dp_world_size > 1 else ()
        named = [(n, p) for n, p in self.module.named_parameters()
                 if p.requires_grad]
        self.param_names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self._tp = TensorParallelLayout(self.module, self.param_names,
                                        self.mp_group)
        # the overflow flag's group (a MAX over every rank that holds a
        # part of the gradients) and the leaves split over the model line
        self._flag_group = self.dp_group if self.mp_group is None \
            else self._world_group
        self._tp_split = self._tp.split() if self.mp_group is not None \
            else None
        self.partition = ZeroPartition(
            self.module, self.param_names, self.params, self.dp_world_size,
            self.dp_rank, self.zero_optimization_stage(), experts)
        self.optimizer = self._configure_basic_optimizer()
        # ZeRO-Offload: Adam/AdamW with cpu_offload steps on the host (LAMB
        # and SGD keep their device step, as in the JAX engine)
        self._offload = getattr(self.optimizer, "needs_host_state", False)
        # the micro steps' gradients leave the exchange as this rank's
        # shards: at stage 2, and under offload from stage 1 (the JAX
        # engine's offload regions follow the ZeRO spec from stage 1)
        stage = self.zero_optimization_stage()
        self._grad_sharded = stage >= 2 or (self._offload and stage >= 1)
        # stage 3: the sharded leaves' parameters hold this rank's shard
        # at rest (none are sharded at dp 1: stage 0 bit for bit)
        self._stage3 = stage >= 3 and bool(self.partition.sharded_idx)
        self._s3_live = False
        self._s3_stash = None
        self._arm_stage3(stage)
        self._arm_quantized_collectives(stage)
        self._arm_wire(stage)
        self._arm_csr(stage)
        if self._offload:
            self._build_offload_state()
        else:
            self._build_state()
        self._mark_params()

        if not self._offload:
            if hasattr(self.optimizer, "set_partition"):
                self.optimizer.set_partition(self.dp_group,
                                             self._split_over_group())
            self.optimizer.init_state(self.master)
        self.lr_scheduler = self._configure_lr_scheduler()
        self._host_scaler = None
        self._host_skipped = 0
        self.scaler = self._make_scaler()
        self._skipped = torch.zeros((), dtype=torch.int32, device=self.device)
        self.progressive_layer_drop = None
        if self._config.pld_enabled:
            self.progressive_layer_drop = ProgressiveLayerDrop(
                theta=self._config.pld_theta, gamma=self._config.pld_gamma)
        self.training_dataloader = None
        if training_data is not None:
            self.training_dataloader = self.deepspeed_io(training_data)
        self.last_step_comm = None

        self._train_mode = True
        self._pending_loss = None
        self._last_micro_loss = None
        self._last_metrics = None
        self._last_grad_norm = None
        self._step_loss = None
        self._comm_metrics = None
        self._comm_key = None

        # --- telemetry (JAX engine.py:195-238) --------------------------
        self._arm_telemetry()
        # after telemetry: the memory gauges ride its registry and lanes
        self._arm_memory_accounting()
        # --- resilience (JAX engine.py:162-206) --------------------------
        self._arm_resilience()
        # timers sync the device: run only under wall_clock_breakdown
        self.timers = SynchronizedWallClockTimer(self.device)
        self.tput_timer = ThroughputTimer(
            batch_size=self.train_micro_batch_size_per_gpu()
            * self.dp_world_size, num_workers=1,
            steps_per_output=self.steps_per_print(), device=self.device)
        self._profiled = False
        self._profile_window = None
        self.summary_writer = None
        if self.tensorboard_enabled() \
                and self.dp_rank == self.sp_rank == self.mp_rank == 0:
            from deepspeed_tpu_torch.utils.tb_writer import SummaryWriter

            # the TensorBoard event-file format, written natively
            self.summary_writer = SummaryWriter(log_dir=os.path.join(
                self.tensorboard_output_path() or ".",
                self.tensorboard_job_name() or "DeepSpeedJobName"))
        n = sum(p.numel() for p in self.params)
        log_dist(f"DeepSpeedEngine: device={self.device} "
                 f"dtype={self.param_dtype} params={n / 1e6:.1f}M "
                 f"dp={self.dp_world_size} mp={self.mp_world_size} "
                 f"zero_stage={self.zero_optimization_stage()} "
                 f"micro_batch={self.train_micro_batch_size_per_gpu()} "
                 f"gas={self.gradient_accumulation_steps()}", ranks=[0])

    # ------------------------------------------------------------------
    # config getters (reference engine.py:212-406)
    # ------------------------------------------------------------------
    def train_batch_size(self):
        return self._config.train_batch_size

    def train_micro_batch_size_per_gpu(self):
        return self._config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self):
        return self._config.gradient_accumulation_steps

    def steps_per_print(self):
        return self._config.steps_per_print

    def fp16_enabled(self):
        return self._config.fp16_enabled

    def bf16_enabled(self):
        return self._config.bf16_enabled

    def gradient_clipping(self):
        return self._config.gradient_clipping

    def zero_optimization(self):
        return self._config.zero_enabled

    def zero_optimization_stage(self):
        return self._config.zero_optimization_stage

    def optimizer_name(self):
        return self._config.optimizer_name

    def optimizer_params(self):
        return self._config.optimizer_params

    def scheduler_name(self):
        return self._config.scheduler_name

    def scheduler_params(self):
        return self._config.scheduler_params

    def dynamic_loss_scale(self):
        return self._config.loss_scale == 0

    def wall_clock_breakdown(self):
        return self._config.wall_clock_breakdown

    def tensorboard_enabled(self):
        return self._config.tensorboard_enabled

    def tensorboard_output_path(self):
        return self._config.tensorboard_output_path

    def tensorboard_job_name(self):
        return self._config.tensorboard_job_name

    def flops_profiler_enabled(self):
        return self._config.flops_profiler_config.enabled

    def flops_profiler_profile_step(self):
        return self._config.flops_profiler_config.profile_step

    def loss_scale(self):
        """The current loss scale (a host read of the device scalar), or
        the configured one without a scaler (reference engine.py:283)."""
        if self._host_scaler is not None:
            return float(self._host_scaler.cur_scale)
        if self.scaler is not None:
            return float(self.scaler.loss_scale)
        return self._config.loss_scale or self._config.initial_dynamic_scale

    def get_global_grad_norm(self):
        return self._last_grad_norm

    @property
    def skipped_steps(self):
        """Overflow-skipped steps (a host read of the device counter; under
        offload the host's skips are added, as in the JAX engine)."""
        return int(self._skipped) + self._host_skipped

    def get_lr(self):
        return [self._current_lr()]

    def get_mom(self):
        if self.lr_scheduler is not None \
                and hasattr(self.lr_scheduler, "get_mom"):
            return self.lr_scheduler.get_mom()
        return [getattr(self.optimizer, "beta1", 0.9)]

    # ------------------------------------------------------------------
    # wiring
    # ------------------------------------------------------------------
    def _configure_basic_optimizer(self):
        """Reference analog: engine.py:439-521."""
        if self.client_optimizer is not None:
            if not isinstance(self.client_optimizer, _OPTIMIZERS):
                raise NotImplementedError(
                    f"client optimizer {type(self.client_optimizer).__name__}"
                    f": the port takes its own FusedAdam, FusedLamb and SGD")
            return self.client_optimizer
        name = self.optimizer_name() or ADAM_OPTIMIZER
        params = dict(self.optimizer_params() or {})
        params.pop("torch_adam", None)
        max_grad_norm = params.pop("max_grad_norm", None)
        if max_grad_norm and not self._config.gradient_clipping:
            self._config.gradient_clipping = max_grad_norm
        if name in (ADAM_OPTIMIZER, ADAMW_OPTIMIZER):
            if self._config.zero_config.cpu_offload:
                # ZeRO-Offload: the host Adam (JAX engine.py:452-459)
                params.setdefault("adamw_mode", name == ADAMW_OPTIMIZER)
                return DeepSpeedCPUAdam(**params)
            params.setdefault("adam_w_mode", name == ADAMW_OPTIMIZER)
            return FusedAdam(**params)
        if name == LAMB_OPTIMIZER:
            return FusedLamb(**params)
        if name == SGD_OPTIMIZER:
            return SGD(**params)
        if name == ONEBIT_ADAM_OPTIMIZER:
            return OnebitAdam(**params)
        if name == ZEROONE_ADAM_OPTIMIZER:
            return ZeroOneAdam(**params)
        raise ValueError(f"Unknown optimizer type {name!r}")

    def _configure_lr_scheduler(self):
        """Reference analog: engine.py:408-421."""
        if self.client_lr_scheduler is not None:
            return self.client_lr_scheduler
        name = self.scheduler_name()
        if name is None:
            return None
        if name not in SCHEDULER_REGISTRY:
            raise ValueError(f"Unknown scheduler {name}")
        return SCHEDULER_REGISTRY[name](**(self.scheduler_params() or {}))

    def _make_scaler(self):
        """The device loss-scale state at fp16 (reference engine.py:1560-1568),
        else None."""
        if not self.fp16_enabled():
            return None
        args = self._config.dynamic_loss_scale_args or {}
        if self._offload:
            # the policy runs on the host (JAX engine.py:1463-1475); the
            # device state holds the scale the loss is multiplied by
            host_args = dict(args)
            host_args.setdefault("init_scale",
                                 self._config.initial_dynamic_scale)
            self._host_scaler = CreateLossScaler(
                static_loss_scale=self._config.loss_scale or 0,
                dynamic_scale_args=host_args)
            return make_loss_scale_state(self._host_scaler.cur_scale,
                                         device=self.device)
        if self._config.loss_scale and self._config.loss_scale > 0:
            return make_loss_scale_state(self._config.loss_scale,
                                         device=self.device)
        return make_loss_scale_state(
            args.get("init_scale", self._config.initial_dynamic_scale),
            delayed_shift=args.get("delayed_shift", 1), device=self.device)

    def _process_groups(self):
        """The grid's groups (none in a single-process run): ``dp_group``,
        this rank's ``data`` line (the world when it is the only axis, at
        any size; None when the line is this rank alone), ``sp_group``,
        its ``seq`` line (None at seq 1), ``pp_group``, its ``pipe`` line
        when each stage is a process of its own (else None), all recording
        into one counter, and ``_world_group``, every rank (the
        checkpoint's tag check and barrier). The world's backend must be
        the device's: NCCL on CUDA (gloo where the node's ranks share a
        card, ``init_distributed``), gloo on the CPU; nothing falls
        back."""
        self.dp_group = self.sp_group = self.pp_group = None
        self.mp_group = None
        self._world_group = None
        self._counter = None
        self._grid = None
        if not dist.is_initialized():
            return
        self._counter = ca.CollectiveCounter()
        self._world_group = DataParallelGroup(None, self._counter)
        want = "nccl" if self.device.type == "cuda" else "gloo"
        if want == "nccl" and self._world_group.backend == "gloo" \
                and cards_shared():
            # ranks that share a card (init_distributed)
            want = "gloo"
        if self._world_group.backend != want:
            raise RuntimeError(f"the process group runs "
                               f"{self._world_group.backend}; a "
                               f"{self.device.type} engine needs {want}")
        if self.sp_world_size == 1 and self.pipe_procs == 1 \
                and self.mp_world_size == 1:
            self.dp_group = self._world_group
            return
        self._grid = ProcessGrid(dict(self.mesh_shape,
                                      **{PIPE_AXIS: self.pipe_procs}),
                                 dist.get_rank())
        groups = grid_groups(self._grid)
        if self.dp_world_size > 1:
            self.dp_group = DataParallelGroup(groups[DATA_AXIS],
                                              self._counter)
        if self.sp_world_size > 1:
            self.sp_group = SequenceParallelGroup(groups[SEQ_AXIS],
                                                  self._counter)
        if self.pipe_procs > 1:
            self.pp_group = DataParallelGroup(groups[PIPE_AXIS],
                                              self._counter)
        if self.mp_world_size > 1:
            self.mp_group = ModelParallelGroup(groups[MODEL_AXIS],
                                               self._counter)

    # ------------------------------------------------------------------
    # ZeRO stage 3 and the quantized collectives: arming (JAX
    # engine.py:687-777, 856-942)
    # ------------------------------------------------------------------
    def _arm_stage3(self, stage):
        """Decide whether stage 3 runs the scheduled int8 gathers (the
        plan of runtime/zero/stage3.py, one quantized gather per planned
        leaf per micro step) or the implicit dense ones, naming every
        blocker in a warning, in the JAX engine's words."""
        zc = self._config.zero_config
        self._s3_sched_armed = False
        self._s3_plan = None
        self._s3_blockers = []
        if stage != 3:
            return
        leaves = self.partition.leaves
        plan = s3.build_gather_plan(
            [leaf.name for leaf in leaves], [leaf.shape for leaf in leaves],
            [leaf.shard_dim for leaf in leaves], self.dp_world_size,
            block_size=zc.quantization_block_size,
            param_dtype=ca.dtype_name(self.param_dtype))
        self._s3_plan = plan
        blockers = []
        if not zc.stage3_scheduled_gathers:
            blockers.append("zero_optimization.stage3_scheduled_gathers="
                            "false")
        if self.dp_world_size <= 1:
            blockers.append("data-parallel degree is 1 (nothing is "
                            "partitioned)")
        if self._offload:
            blockers.append("cpu_offload=true (params materialize through "
                            "the offload push, which has its own qwZ wire)")
        if self.sp_world_size != 1:
            blockers.append(f"seq={self.sp_world_size}")
        if not blockers and plan.n_gathered_leaves == 0:
            blockers.append("no parameter leaf is partitionable over "
                            "'data' (all too small/indivisible)")
        budget = zc.stage3_prefetch_budget
        if not blockers and not plan.within_budget(budget):
            blockers.append(
                f"gather plan needs {plan.gathered_bytes} B of gathered "
                f"weights live fwd->bwd, over stage3_prefetch_budget="
                f"{budget} B — raise the budget or accept the implicit "
                f"path's per-use gathers")
        self._s3_blockers = blockers
        if blockers:
            log_dist(
                "ZeRO stage-3: scheduled quantized gathers DISARMED — "
                f"falling back to the implicit per-use all-gathers "
                f"({'; '.join(blockers)})", ranks=[0],
                level=logging.WARNING)
            return
        self._s3_sched_armed = True
        # the planned leaves, in the plan's block order
        by_name = {leaf.name: leaf for leaf in leaves}
        self._s3_leaves = [by_name[gl.name] for b in plan.blocks
                           for gl in b.leaves]
        log_dist(
            f"ZeRO stage-3: scheduled quantized gathers armed — "
            f"{plan.n_gathered_leaves} leaves in {len(plan.blocks)} "
            f"layer blocks, {plan.wire_bytes_per_gather} B int8+scales "
            f"wire per gather, {plan.gathered_bytes} B gathered peak "
            f"(budget {budget or 'unbounded'})", ranks=[0])

    def stage3_report(self):
        """The gather plan's report (blocks, per-block bytes, the peak
        gathered footprint) with its arming status (JAX
        ``stage3_report``); None below stage 3. ``disarmed_by`` names the
        blockers of a disarmed plan."""
        if self._s3_plan is None:
            return None
        report = self._s3_plan.report()
        report["armed"] = bool(self._s3_sched_armed)
        report["prefetch_budget"] = \
            self._config.zero_config.stage3_prefetch_budget
        report["disarmed_by"] = list(self._s3_blockers)
        return report

    def _arm_quantized_collectives(self, stage):
        """Decide whether qgZ (the int8 gradient reduce-scatter) and qwZ
        (the int8 offload push) run, and resolve the hierarchical intra
        size; every blocker is named in a warning, in the JAX engine's
        words."""
        zc = self._config.zero_config
        dp = self.dp_world_size
        self._qgz_armed = False
        self._qgz_intra = 0
        self._qwz_armed = False
        if zc.quantized_gradients:
            blockers = []
            if dp <= 1:
                blockers.append("data-parallel degree is 1")
            if stage != 2:
                blockers.append(
                    f"zero_optimization.stage={stage} (qgZ quantizes the "
                    f"stage-2 sharded-accumulator reduce-scatter)")
            if self._offload:
                blockers.append("cpu_offload=true (gradients stream D2H, "
                                "no collective to quantize)")
            if self.sp_world_size != 1:
                blockers.append(f"seq={self.sp_world_size}")
            if blockers:
                log_dist(
                    "ZeRO qgZ: quantized_gradients DISARMED — gradients "
                    f"move dense ({', '.join(blockers)}); the quantized "
                    "reduce-scatter requires zero stage 2, no cpu_offload, "
                    "and pipe=seq=1", ranks=[0], level=logging.WARNING)
            else:
                self._qgz_armed = True
        if zc.quantized_weights:
            if self._offload and dp > 1:
                self._qwz_armed = True
            elif self._s3_sched_armed:
                log_dist(
                    "ZeRO qwZ: quantized_weights rides the stage-3 "
                    "scheduled gather plan (int8 blocks + fp32 scales per "
                    "micro-step)", ranks=[0])
            else:
                blocker = "cpu_offload=false (the int8 weight gather rides " \
                          "the offload parameter push or the stage-3 " \
                          "scheduled plan)" \
                    if not self._offload else "data-parallel degree is 1"
                log_dist(
                    f"ZeRO qwZ: quantized_weights DISARMED — parameters "
                    f"move in the compute dtype ({blocker})",
                    ranks=[0], level=logging.WARNING)
        if zc.hierarchical_allreduce and self._qgz_armed:
            k = zc.hierarchical_intra_size
            auto = k <= 0
            if auto:
                # co-located ranks (consecutive on the data axis) form
                # the intra group
                k = math.gcd(dp, local_world_size())
            if 1 < k < dp and dp % k == 0:
                self._qgz_intra = k
                self.dp_group.hierarchy(k)
            elif not auto:
                log_dist(
                    f"ZeRO qgZ: hierarchical_allreduce requested but "
                    f"hierarchical_intra_size={k} cannot form >=2 groups "
                    f"over the data axis ({dp}; needs 1 < k < {dp} with k "
                    f"dividing it); using the flat quantized all_to_all",
                    ranks=[0], level=logging.WARNING)
        elif zc.hierarchical_allreduce:
            why = "quantized_gradients is disarmed (see warning above)" \
                if zc.quantized_gradients else \
                "zero_optimization.quantized_gradients is not enabled"
            log_dist(
                f"ZeRO qgZ: hierarchical_allreduce has no effect — it "
                f"routes the quantized gradient exchange and {why}",
                ranks=[0], level=logging.WARNING)

    def _arm_wire(self, stage):
        """1-bit Adam and 0/1 Adam: decide whether the optimizer's own
        compressed gradient wire runs (JAX engine.py:468-516,
        ``_arm_zeroone`` :944-981, ``_arm_quantized_allreduce``
        :984-1019), naming every blocker in a warning, in the JAX
        engine's words. Armed (dp > 1, stage 0, no offload; 0/1 Adam also
        without sparse_gradients), ``train_batch`` keeps each rank's
        gradients local and the optimizer exchanges them: a dense mean in
        warmup, then the 1-bit wire (``_wire_apply``). Disarmed, the
        optimizer steps on the exchanged mean gradient, its wire the
        local twin (0/1 Adam: warmup, dense Adam without bias correction,
        for ever)."""
        self._wire = None
        self._wire_phase = None
        self._wire_micro = False
        self._onebit_latch = False
        self._zeroone_latch = False
        opt = self.optimizer
        if not isinstance(opt, _WIRE_OPTIMIZERS):
            return
        dp, zc = self.dp_world_size, self._config.zero_config
        zero_one = isinstance(opt, ZeroOneAdam)
        what = "ZeroOneAdam" if zero_one else "OneBitAdam"
        unported = []
        if zc.cpu_offload:
            unported.append("cpu_offload")
        if dp > 1 and stage != 0:
            unported.append(f"ZeRO stage {stage} at dp {dp} (the state "
                            f"sharded over data)")
        if self.sp_world_size != 1:
            unported.append(f"seq={self.sp_world_size}")
        if dp > 1 and self.partition.expert_idx:
            unported.append("MoE expert parallelism")
        if unported:
            raise NotImplementedError(
                f"{what} with {', '.join(unported)} is not ported yet "
                f"(ROADMAP A13c)")
        blockers = []
        if opt.comm_backend_name == "none":
            blockers.append("comm_backend_name='none'")
        if dp <= 1:
            blockers.append("data-parallel degree is 1")
        if zero_one and self._config.sparse_gradients_enabled:
            blockers.append("sparse_gradients CSR exchange owns the "
                            "embedding-grad wire")
        leaf_map = self.partition.leaf_map()
        if blockers:
            if zero_one:
                log_dist(
                    "ZeroOneAdam: wire compression DISARMED — gradients "
                    f"move dense and the variance never freezes "
                    f"({', '.join(blockers)}); the 1-bit collective path "
                    "requires dp>1, zero stage 0, pipe=1, no cpu_offload "
                    "and no sparse_gradients", ranks=[0],
                    level=logging.WARNING)
            else:
                log_dist(
                    "OneBitAdam: wire compression DISARMED — gradients "
                    f"move dense ({', '.join(blockers)}); the compressed "
                    "collective path requires zero stage 0 and pipe=1",
                    ranks=[0], level=logging.WARNING)
            opt.set_wire(None, leaf_map)
            return
        if self.gradient_clipping():
            # JAX engine.py:2439-2449, 2668-2676
            raise ValueError(
                f"gradient_clipping is incompatible with the "
                f"{'0/1' if zero_one else '1-bit'} Adam wire-compression "
                f"path (there is no dense gradient to clip). Disable "
                f"clipping, or set optimizer params "
                f"comm_backend_name='none' to keep the dense path.")
        if zero_one:
            opt.set_wire(self.dp_group, leaf_map,
                         self._arm_quantized_allreduce(dp, opt))
            self._wire = "zeroone"
        else:
            opt.set_wire(self.dp_group, leaf_map)
            self._wire = "onebit"

    def _arm_quantized_allreduce(self, dp, opt):
        """The intra-group size of the armed 0/1 Adam wire (0: flat): the
        optimizer's ``intra_size``, else the config's
        ``hierarchical_intra_size`` under ``hierarchical_allreduce`` (auto:
        the ranks on this node)."""
        zc = self._config.zero_config
        k = int(opt.intra_size or 0)
        if not k and zc.hierarchical_allreduce:
            k = zc.hierarchical_intra_size
            if k <= 0:
                k = math.gcd(dp, local_world_size())
        if 1 < k < dp and dp % k == 0:
            self.dp_group.hierarchy(k)
            return k
        if k > 1:
            log_dist(
                f"quantized_all_reduce: hierarchical intra size {k} cannot "
                f"form >=2 groups over the data axis ({dp}; needs 1 < k < "
                f"{dp} with k dividing it); using the flat wire",
                ranks=[0], level=logging.WARNING)
        return 0

    def _arm_csr(self, stage):
        """sparse_gradients (JAX engine.py:602-625, 639-652): the
        parameters the model flags row-sparse (``sparse_grad_spec()``:
        {parameter name: bool}) move as CSR rows at the capacity of the
        micro-batch's lookup tokens: under plain data parallelism (dp > 1,
        stage <= 1, seq 1, no wire of the optimizer's own) an all-gather
        of (indices, values) in place of their all-reduce; under
        ZeRO-Offload the copy down."""
        self._csr_idx = []
        self._csr_cap = None
        if not (self._config.sparse_gradients_enabled
                and hasattr(self.module, "sparse_grad_spec")):
            return
        flags = self.module.sparse_grad_spec()
        idx = [i for i, n in enumerate(self.param_names) if flags.get(n)]
        dp = self.dp_world_size
        if self._config.zero_config.cpu_offload:
            if dp > 1:
                raise NotImplementedError(
                    "ZeRO-Offload with sparse_gradients at dp > 1 (CSR rows "
                    "of the exchanged gradients on the copy down) is not "
                    "ported yet (ROADMAP A13c)")
            if self._offload:
                self._csr_idx = idx
            return
        if dp > 1 and stage <= 1 and self.sp_world_size == 1 \
                and self._wire is None:
            self._csr_idx = idx

    def _csr_last(self, idx):
        """``idx`` with the CSR parameters moved to its end (the flat
        layouts keep them out of the dense exchange and copy)."""
        csr = set(self._csr_idx)
        return [i for i in idx if i not in csr] + \
            [i for i in idx if i in csr]

    def _leaf_name(self, i):
        return next(leaf.name for leaf in self.partition.leaves
                    if i in leaf.params)

    def _sparse_row_capacity(self, batch):
        """The CSR row capacity of a micro-batch (JAX
        ``_sparse_row_capacity``, engine.py:1662-1684): the model's
        ``sparse_grad_tokens(batch)``, else the integer entries' sizes."""
        if hasattr(self.module, "sparse_grad_tokens"):
            tokens = int(self.module.sparse_grad_tokens(batch))
        else:
            values = batch.values() if isinstance(batch, dict) else [batch]
            tokens = sum(int(np.prod(np.shape(v))) for v in values
                         if _is_integer(v))
        if tokens <= 0:
            raise ValueError(
                "sparse_gradients: cannot size the CSR row capacity — the "
                "batch has no integer leaves and the model does not define "
                "sparse_grad_tokens(batch); truncating rows would silently "
                "corrupt gradients")
        return tokens

    @torch.no_grad()
    def _build_state(self):
        """This rank's master weights, gradient accumulator and exchange
        buffers under the ZeRO partition (``self.partition``)."""
        part, dev, f32 = self.partition, self.device, torch.float32
        sharded = part.sharded
        # master: the shards of the sharded parameters in one segment;
        # fp32 replicated ones are the parameters themselves
        self._master_seg = torch.empty(part.seg_size, dtype=f32, device=dev)
        shards = iter(part.segment_views(self._master_seg))
        self.master = []
        for i, p in enumerate(self.params):
            if sharded[i]:
                m = next(shards)
                m.copy_(part.narrow(p, i))
            else:
                m = p.detach().clone() if self.mixed_precision else p
            self.master.append(m)
        if self.mixed_precision:
            for p in self.params:
                p.data = p.data.to(self.param_dtype)
        self._master_separate = self.mixed_precision or any(sharded)
        self._rep_idx = [i for i, s in enumerate(sharded) if not s]
        # accumulator: full-shaped for the leaves all-reduced each micro
        # step, then (stage 2) this rank's shards of the others, then this
        # rank's experts
        stage2 = self._grad_sharded
        self._ar_idx = self._csr_last(
            [i for i, s in enumerate(sharded)
             if not (stage2 and s) and not part.expert[i]])
        sizes = [self.params[i].numel() for i in self._ar_idx]
        self._n_ar = sum(sizes)
        self._n_dense = self._n_ar - sum(self.params[i].numel()
                                         for i in self._csr_idx)
        seg = part.seg_size if stage2 else 0
        self._flat_accum = torch.zeros(self._n_ar + seg + self._n_experts(),
                                       dtype=f32, device=dev)
        self.accum = [None] * len(self.params)
        for i, a in zip(self._ar_idx, self._flat_accum[:self._n_ar]
                        .split(sizes)):
            self.accum[i] = a.view(self.params[i].shape)
        if stage2:
            for i, a in zip(part.sharded_idx, part.segment_views(
                    self._flat_accum[self._n_ar:self._n_ar + seg])):
                self.accum[i] = a
        for i, a in self._expert_views(self._flat_accum[self._n_ar + seg:]):
            self.accum[i] = a
        # the gradients the update reads: this rank's part of each
        self._step_grads = [a if stage2 else part.local(a, i)
                            for i, a in enumerate(self.accum)]
        split = self._split_over_group()
        self._partitioned = split if any(split) else None
        self._seq_leaves()
        if self.dp_group is None:
            return
        self._exchange_buffers(
            torch.empty(self._n_ar + (part.seg_size if stage2 else 0),
                        dtype=f32, device=dev),
            torch.empty(part.seg_size, dtype=self.param_dtype, device=dev))
        if self._stage3:
            self._ag_send.copy_(self._master_seg)
            self._s3_at_rest()

    def _seq_leaves(self):
        """The leaves that the gradient all-reduce over the seq group
        carries: the accumulator's layout, every leaf whole but, where the
        gradients are sharded, this rank's shard of each sharded leaf."""
        if self.sp_group is None:
            return
        dp = self.dp_world_size
        self._sp_leaves = [
            (leaf.name, leaf.elements // dp
             if self._grad_sharded and leaf.shard_dim is not None
             else leaf.elements)
            for leaf in self.partition.leaves]

    def _sum_over_seq(self, flat):
        """The gradients in ``flat`` summed over the seq group, in place (a
        no-op at seq 1)."""
        if self.sp_group is not None:
            self.sp_group.all_reduce(flat, leaves=self._sp_leaves)

    def _split_over_group(self):
        """Whether each parameter list entry is this rank's part of a leaf
        split over the group: a ZeRO shard or an expert stack's experts
        (their squared norms sum over the group)."""
        part = self.partition
        return [s or e for s, e in zip(part.sharded, part.expert)]

    def _n_experts(self):
        return sum(self.params[i].numel()
                   for i in self.partition.expert_idx)

    def _expert_views(self, flat):
        """[(i, view)] of the expert parameters' regions at the start of
        ``flat``, in parameter order."""
        out, at = [], 0
        for i in self.partition.expert_idx:
            n = self.params[i].numel()
            out.append((i, flat[at:at + n].view(self.params[i].shape)))
            at += n
        return out

    def _exchange_buffers(self, xchg, ag_send):
        """The device buffers of the gradient exchange over the group:
        ``xchg`` (fp32) holds the all-reduced replicated part, then at
        stage 2 this rank's reduce-scattered shards (then, under offload,
        this rank's experts' gradients); ``ag_send`` (the parameters'
        dtype, ``seg_size`` elements) this rank's shards of the updated
        parameters for the all-gather."""
        part, dev, f32 = self.partition, self.device, torch.float32
        sizes = [self.params[i].numel() for i in self._ar_idx]
        self._xchg = xchg
        self._ar_buf = xchg[:self._n_ar]
        self._ar_views = [b.view(self.params[i].shape) for i, b in
                          zip(self._ar_idx, self._ar_buf.split(sizes))]
        csr = {self._leaf_name(i) for i in self._csr_idx}
        self._ar_leaves = [(leaf.name, leaf.elements)
                           for leaf in part.leaves
                           if not (self._grad_sharded
                                   and leaf.shard_dim is not None)
                           and leaf.expert_dim is None
                           and leaf.name not in csr]
        self._sh_leaves = part.leaf_elements(sharded=True)
        n = self.dp_world_size * part.seg_size
        seg = part.seg_size if self._grad_sharded else 0
        self._ep_xchg = self._expert_views(xchg[self._n_ar + seg:]) \
            if self._offload else []
        # stage 3 gathers block by block and reduce-scatters from a
        # buffer made for the exchange: neither whole-model buffer stays
        self._rs_send = torch.empty(n, dtype=f32, device=dev) \
            if self._grad_sharded and not self._stage3 else None
        if self._grad_sharded:
            self._rs_recv = xchg[self._n_ar:self._n_ar + seg]
        self._ag_send = ag_send
        self._ag_recv = None if self._stage3 else \
            torch.empty(n, dtype=self.param_dtype, device=dev)

    @torch.no_grad()
    def _build_offload_state(self):
        """ZeRO-Offload's state (JAX engine ``_ensure_state_offload``,
        engine.py:1420): this rank's fp32 master, Adam moments and
        gradient accumulator in pageable host memory, each one flat buffer
        laid out as the stage-2 accumulator (the replicated parameters
        whole, then this rank's shards of the others; at dp 1, every
        parameter whole); on the device only the compute-dtype parameters
        and one flat buffer of them (the gradients packed for the copy
        down at dp 1, and the push up), and at dp > 1 PR 8's exchange
        buffers. Two pinned staging buffers (pinned on CUDA only; one at
        gas 1, where no micro step follows within the step), allocated
        here once, carry the micro steps' gradients down (the compute
        dtype at dp 1, the exchanged fp32 at dp > 1); the first also
        carries the pushed parameters up."""
        part, dev, f32 = self.partition, self.device, torch.float32
        sharded = part.sharded
        self._master_separate = True
        self._rep_idx = [i for i, s in enumerate(sharded) if not s]
        self._ar_idx = self._csr_last(
            [i for i in self._rep_idx if not part.expert[i]])
        sizes = [self.params[i].numel() for i in self._ar_idx]
        self._n_ar = sum(sizes)
        self._n_dense = self._n_ar - sum(self.params[i].numel()
                                         for i in self._csr_idx)
        self._csr_staging = [None] * (2 if self.gradient_accumulation_steps()
                                      > 1 else 1)
        self.last_fetch_bytes = None
        seg = part.seg_size
        n = self._n_ar + seg + self._n_experts()

        def views(flat):
            # the replicated parameters, this rank's shards, its experts
            out = [None] * len(self.params)
            for i, v in zip(self._ar_idx, flat[:self._n_ar].split(sizes)):
                out[i] = v.view(self.params[i].shape)
            for i, v in zip(part.sharded_idx, part.segment_views(
                    flat[self._n_ar:self._n_ar + seg])):
                out[i] = v
            for i, v in self._expert_views(flat[self._n_ar + seg:]):
                out[i] = v
            return out

        self._host_master = torch.empty(n, dtype=f32)
        self.master = views(self._host_master)
        for i, p in enumerate(self.params):
            self.master[i].copy_(part.local(p, i))
        self._host_accum = torch.zeros(n, dtype=f32)
        self.accum = views(self._host_accum)
        self._host_opt = self.optimizer.init_state([self._host_master])
        self._host_m = views(self._host_opt["m"][0])
        self._host_v = views(self._host_opt["v"][0])
        for p in self.params:
            p.data = p.data.to(self.param_dtype)
        # the host Adam's OpenMP pool, sized on purpose: torch's intra-op
        # pool's size (the host's cores, unless OMP_NUM_THREADS or
        # torch.set_num_threads says otherwise); the two run in turn
        self._host_lib = self.optimizer._lib
        self._host_lib.ds_set_num_threads(torch.get_num_threads())
        cuda = dev.type == "cuda"
        stage_dtype = self.param_dtype if self.dp_group is None else f32
        slots = 2 if self.gradient_accumulation_steps() > 1 else 1
        self._staging = [torch.empty(n, dtype=stage_dtype, pin_memory=cuda)
                         for _ in range(slots)]
        elem = torch.empty((), dtype=self.param_dtype).element_size()
        self._push_host = self._staging[0].view(torch.uint8)[:n * elem] \
            .view(self.param_dtype)
        self._dev_flat = torch.empty(n, dtype=self.param_dtype, device=dev)
        self._dev_views = views(self._dev_flat)
        self._seq_leaves()
        self._d2h_stream = torch.cuda.Stream(dev) if cuda else None
        self._d2h_events = [torch.cuda.Event() for _ in self._staging] \
            if cuda else None
        self._d2h_last = None
        self._h2d_done = torch.cuda.Event() if cuda else None
        self._slot = 0
        self._pending_fetches = []
        self._host_waits = 0
        if self.dp_group is not None:
            self._exchange_buffers(
                torch.empty(n, dtype=f32, device=dev),
                self._dev_flat[self._n_ar:self._n_ar + seg])
        if self._qwz_armed:
            # the pushed shards' int8 codes and fp32 scales: pinned host
            # buffers and their device copies, each leaf's side by side;
            # the other sharded leaves go up in the compute dtype and
            # gather densely from a segment of their own
            self._push_views = views(self._push_host)
            self._qwz_leaves = [leaf for leaf in part.leaves
                                if self._qwz_ok(leaf)]
            qwz = {i for leaf in self._qwz_leaves for i in leaf.params}
            self._qwz_dense = [leaf for leaf in part.leaves
                               if leaf.shard_dim is not None
                               and not self._qwz_ok(leaf)]
            self._qwz_dense_idx = [i for i in part.sharded_idx
                                   if i not in qwz]
            self._qwz_dense_send = torch.empty(
                sum(self.master[i].numel() for i in self._qwz_dense_idx),
                dtype=self.param_dtype, device=dev)
            block = self._config.zero_config.quantization_block_size
            self._qwz_lay = [block_layout(leaf.elements // self.dp_world_size,
                                          block)
                             for leaf in self._qwz_leaves]
            nq = sum(npad for _, _, npad in self._qwz_lay)
            ns = sum(nb for _, nb, _ in self._qwz_lay)
            self._qwz_host = (torch.empty(nq, dtype=torch.int8,
                                          pin_memory=cuda),
                              torch.empty(ns, dtype=f32, pin_memory=cuda))
            self._qwz_dev = tuple(torch.empty_like(t, device=dev)
                                  for t in self._qwz_host)
        if self._stage3:
            torch._foreach_copy_(part.segment_views(self._ag_send),
                                 [part.narrow(self.params[i], i)
                                  for i in part.sharded_idx])
            self._s3_at_rest()

    # ------------------------------------------------------------------
    # ZeRO stage 3: the parameters' gathers and their release
    # ------------------------------------------------------------------
    def _s3_at_rest(self):
        """Stage 3's parameters at rest (this rank's shards, views of
        ``_ag_send``) and the implicit path's per-block gathers over them
        (runtime/zero/gathers.py)."""
        part = self.partition
        self._s3_rest = part.segment_views(self._ag_send)
        self._s3_blocks = BlockGathers(self.module, self.param_names,
                                       self.params, part, self._ag_send,
                                       self._s3_rest, self.dp_group)
        self._s3_release()

    def _s3_release(self):
        """The sharded leaves' parameters back to this rank's shards at
        rest; a gathered copy is freed when nothing else holds it."""
        self._s3_blocks.release()
        for i, v in zip(self.partition.sharded_idx, self._s3_rest):
            self.params[i].data = v
        self._s3_live = False
        self._mark_params()

    @torch.no_grad()
    def _s3_gather(self):
        """The scheduled gathers: the plan's leaves in its block order,
        each through one int8 gather (``quantized_gather_rows``, counted as
        ``qwz_ag`` and ``qwz_scales``) dequantized to the compute dtype,
        live until the micro step's gradient exchange."""
        part, dt = self.partition, self.param_dtype
        leaves = self._s3_leaves
        block = self._config.zero_config.quantization_block_size
        rows = quantized_gather_rows(
            [part.leaf_row(leaf, self.params) for leaf in leaves],
            self.dp_group, [leaf.name for leaf in leaves], dt, block)
        stash = {}
        for leaf, r in zip(leaves, rows):
            full = rows_to_leaf(r, leaf.shape, leaf.shard_dim)
            for i, v in part.leaf_views(leaf, full):
                self.params[i].data = v.contiguous()
                stash[f"stash/{self.param_names[i]}"] = self.params[i].data
        self._s3_stash = stash
        self._s3_live = True

    def _s3_implicit(self):
        """Whether this micro step's weights come through the implicit
        per-block gathers."""
        return self._stage3 and not self._s3_sched_armed

    def _s3_whole_shapes(self):
        """{name: whole shape} of the parameters that hold a shard at rest
        (stage 3), for the FLOP counts' replays; None below stage 3."""
        if not self._stage3:
            return None
        return {self.param_names[i]: self.partition.shapes[i]
                for i in self.partition.sharded_idx}

    def _param_local(self, i):
        """This rank's part of parameter i as the module holds it now
        (at stage 3 the sharded ones are their shards at rest)."""
        p = self.params[i]
        if self._stage3 and self.partition.sharded[i] and not self._s3_live:
            return p
        return self.partition.local(p, i)

    @staticmethod
    def _qwz_ok(leaf):
        """Whether the qwZ push moves ``leaf`` as int8: its offload region
        is a pure ``data`` split, sharded by ZeRO with no dim of its
        tensor-parallel spec (JAX ``_qwz_leaf_meta``); the other sharded
        leaves go up and gather in the compute dtype."""
        return leaf.shard_dim is not None and not leaf.tp_taken

    def deepspeed_io(self, dataset, batch_size=None, pin_memory=False,
                     data_sampler=None, collate_fn=None,
                     num_local_io_workers=None):
        """This process's loader of ``dataset``: micro-batches of its
        disjoint share (reference engine.py:731-772)."""
        return DeepSpeedDataLoader(
            dataset,
            batch_size=batch_size or self.train_micro_batch_size_per_gpu(),
            pin_memory=pin_memory, collate_fn=collate_fn or self.collate_fn,
            num_local_io_workers=num_local_io_workers or 0,
            data_sampler=data_sampler,
            data_parallel_world_size=self.dp_world_size,
            data_parallel_rank=self.dp_rank)

    def _scaler_hparams(self):
        """Reference engine.py:1612-1618."""
        args = self._config.dynamic_loss_scale_args or {}
        return dict(scale_window=args.get("scale_window", 1000),
                    min_scale=args.get("min_scale", 1.0),
                    delayed_shift=args.get("delayed_shift", 1),
                    dynamic=self.dynamic_loss_scale())

    def _current_lr(self):
        sched = self.lr_scheduler
        if sched is not None:
            if getattr(sched, "_last_lr", None):
                return float(sched.get_last_lr()[0])
            return float(sched.lr_at(max(0, sched.last_batch_iteration)))
        return float(self.optimizer.lr)

    def _advance_lr(self):
        if self.lr_scheduler is not None:
            return float(self.lr_scheduler.step())
        return self._current_lr()

    def _to_device(self, batch):
        def put(x):
            t = torch.as_tensor(x)
            return t.to(self.device, non_blocking=True)

        if self.sp_group is not None:
            batch = self._seq_chunk(batch)
        if isinstance(batch, dict):
            return {k: put(v) for k, v in batch.items()}
        return put(batch)

    def _seq_chunk(self, batch):
        """Under sequence parallelism: this rank's chunk of the sequence of
        the entries the model embeds (``_SEQ_SHARDED``); the labels and
        masks stay whole (the loss reads the next position's label across
        the chunk's end)."""
        if not isinstance(batch, dict):
            raise ValueError(f"mesh seq={self.sp_world_size} takes a dict "
                             f"batch (the sequence-sharded entries are "
                             f"{_SEQ_SHARDED})")
        out = dict(batch)
        for key in _SEQ_SHARDED:
            if key in batch:
                out[key] = self.sp_group.chunk(torch.as_tensor(batch[key]), 1)
        return out

    def _micro_generator(self):
        """The dropout randomness of one micro-batch: a generator seeded
        from (seed, step, micro step), as the JAX engine folds its rng."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed((self._seed * 1000003 + self.global_steps * 131071
                         + self.micro_steps) % (2 ** 63))
        return gen

    def _mark_params(self):
        """Note each parameter's version: a later change was made outside
        the engine (``_sync_master``)."""
        self._param_versions = [p._version for p in self.params]

    @torch.no_grad()
    def _sync_master(self):
        """Mixed precision or ZeRO shards: a parameter written into the
        module outside the engine (``module.load_state_dict``) becomes its
        master's value (this rank's part of it), so that the next update
        starts from it."""
        if not self._master_separate:
            return
        changed = [i for i, (p, v) in enumerate(zip(self.params,
                                                    self._param_versions))
                   if p._version != v]
        if changed:
            logger.warning(f"{len(changed)} parameters were written into the "
                           f"module outside the engine: the fp32 master takes "
                           f"their {self.param_dtype} values "
                           f"(load_module_state_dict keeps the fp32 bits)")
            for i in changed:
                self.master[i].copy_(self._param_local(i))
            self._mark_params()

    @torch.no_grad()
    def load_module_state_dict(self, state_dict, strict=True):
        """Load weights into the module and, under mixed precision or ZeRO,
        into the fp32 master (this rank's shards) at the state dict's own
        precision (the module's parameters take the compute-dtype copy).
        Returns what ``module.load_state_dict`` returns."""
        part = self.partition
        if self.mp_group is not None:
            # whole parameters: this model rank's shards of each
            state_dict = dict(state_dict)
            for i, name in enumerate(self.param_names):
                t = state_dict.get(name)
                if t is not None and tuple(t.shape) != part.shapes[i]:
                    state_dict[name] = self._tp.local(torch.as_tensor(t), i)
        if part.expert_idx:
            # the whole expert stacks: this rank's experts of each
            state_dict = dict(state_dict)
            for i in part.expert_idx:
                name = self.param_names[i]
                if name in state_dict:
                    state_dict[name] = part.expert_local(
                        torch.as_tensor(state_dict[name]), i)
        if self._stage3:
            # the sharded parameters take their whole shape for the load,
            # then keep this rank's shard
            for i in part.sharded_idx:
                self.params[i].data = torch.empty(
                    part.shapes[i], dtype=self.param_dtype,
                    device=self.device)
        result = self.module.load_state_dict(state_dict, strict=strict)
        if self._stage3:
            for i, v in zip(part.sharded_idx, self._s3_rest):
                if self.param_names[i] in state_dict:
                    v.copy_(part.narrow(self.params[i], i))
            self._s3_release()
        for i, (name, m) in enumerate(zip(self.param_names, self.master)):
            if name in state_dict and m is not self.params[i]:
                m.copy_(part.local(state_dict[name], i))
        self._mark_params()
        return result

    # ------------------------------------------------------------------
    # public training API (reference semantics)
    # ------------------------------------------------------------------
    def train(self, mode=True):
        self._train_mode = bool(mode)
        self.module.train(self._train_mode)
        return self

    def eval(self):
        return self.train(False)

    def forward(self, batch):
        """The micro-batch loss, with the graph kept for backward(). In
        eval mode, a grad-free forward (eval_loss)."""
        if not self._train_mode:
            return self.eval_loss(batch)
        if self._pending_loss is not None:
            raise RuntimeError("forward() called twice without backward()")
        if self.wall_clock_breakdown():
            self.timers(FORWARD_MICRO_TIMER).start()
        if self.progressive_layer_drop is not None:
            # theta rides the batch (reference engine.py:3144-3149)
            batch = dict(batch)
            batch["pld_theta"] = np.float32(
                self.progressive_layer_drop.get_theta())
        dev_batch = self._to_device(batch)
        if self._csr_idx:
            self._csr_cap = self._sparse_row_capacity(batch)
        self._maybe_profile(dev_batch)
        if self._telemetry is not None:
            self._register_micro_step(dev_batch)
        tr = self._tracer
        _t0 = tr.begin() if tr is not None else 0.0
        if self._memacct is not None:
            self._memacct.begin("micro_step")
        obs = NO_OBSERVER
        gas = self.gradient_accumulation_steps()
        split = self._s3_split()
        if split:
            # scheduled stage 3: the gathers and the forward are the JAX
            # engine's s3_fwd, the backward and the exchange its s3_bwd
            obs = self._dispatch_program("s3_fwd", self._s3_fwd_contract(),
                                         calls_per_step=gas)
        elif self._micro_name is not None:
            # one forward + backward: the JAX engine's micro_step
            # (micro_offload under train_batch with offload)
            obs = self._dispatch_program(
                self._micro_name, self._micro_program_contract(),
                calls_per_step=gas)
        obs.start()
        try:
            if self._s3_sched_armed:
                self._s3_gather()
            # the implicit path gathers each block as it runs and frees
            # it after; the backward gathers it again
            with self._s3_blocks.forward() if self._s3_implicit() \
                    else contextlib.nullcontext():
                loss, _ = self.module.loss(
                    dev_batch, generator=self._micro_generator(),
                    train=True)
        finally:
            obs.stop()
        if split:
            obs.outputs(loss)
            obs.close()
            obs = NO_OBSERVER
        self._micro_obs = obs
        self._pending_loss = loss
        if tr is not None:
            tr.complete("forward_micro", self._lane_train, _t0)
        if self.wall_clock_breakdown():
            self.timers(FORWARD_MICRO_TIMER).stop()
        return loss

    def __call__(self, batch):
        return self.forward(batch)

    def backward(self, loss=None, allreduce_gradients=True):
        """Accumulate the gradients of the last forward's loss (times the
        loss scale at fp16) / gas into the fp32 accumulator (reference
        engine.py:871; micro fn :1634-1659)."""
        if self._pending_loss is None:
            raise RuntimeError("backward() called without a preceding "
                               "forward()")
        if self.wall_clock_breakdown():
            self.timers(BACKWARD_MICRO_TIMER).start()
        tr = self._tracer
        _t0 = tr.begin() if tr is not None else 0.0
        pending = self._pending_loss
        self._pending_loss = None
        self._last_micro_loss = pending.detach()
        obs, self._micro_obs = self._micro_obs, NO_OBSERVER
        if self._s3_split():
            stash = self._s3_stash
            obs = self._dispatch_program(
                "s3_bwd", {"host_transfer_free": True,
                           "forbid_collectives": ("all-gather",),
                           "donates_argnums": (1,)},
                calls_per_step=self.gradient_accumulation_steps(),
                args=(self._program_state, lambda: stash))
        obs.start()
        try:
            self._backward_micro(pending)
        finally:
            obs.stop()
        obs.outputs(pending)
        obs.close()
        if self._offload:
            # this micro step's copy down starts; the previous one's (its
            # copy overlapped this micro step's compute) goes into the
            # host accumulator (JAX engine.py:3260-3271)
            _tg = tr.begin() if tr is not None else 0.0
            slot = self._start_grad_fetch([p.grad for p in self.params])
            for p in self.params:
                p.grad = None
            self._drain_pending_fetches()
            self._pending_fetches.append(slot)
            if tr is not None:
                tr.complete("grad_exchange_d2h", self._lane_train, _tg)
        for p in self.params:
            p.grad = None
        if self._s3_live:
            # the exchange is done: the gathered weights are freed
            self._s3_release()
            self._s3_stash = None
        self.micro_steps += 1
        if self._memacct is not None:
            self._memacct.end("micro_step")
        if self._profile_window is not None:
            self._finish_profile()
        if tr is not None:
            tr.complete("backward_micro", self._lane_train, _t0)
        if self.wall_clock_breakdown():
            self.timers(BACKWARD_MICRO_TIMER).stop()
        return pending if loss is None else loss

    def _backward_micro(self, loss):
        """The device work of backward(): the gradients of ``loss`` (times
        the loss scale at fp16) / gas, and, without offload, into the fp32
        accumulator (over the group at dp > 1)."""
        scaled = loss.float()
        if self.scaler is not None:
            scaled = scaled * self.scaler.loss_scale
        # the global batch's mean: a whole-micro-batch loss is every rank's
        # alike (the exchange sums its ranks' terms), another model's loss
        # is this rank's share of it
        div = self.gradient_accumulation_steps()
        if not (self._loss_is_global or self._wire_micro):
            div *= self.dp_world_size
        # the implicit path's second gathers: each block's at its first
        # use in the backward (a remat recompute's, where there is one)
        with self._s3_blocks.backward() if self._s3_implicit() \
                else contextlib.nullcontext():
            (scaled / div).backward()
        if self._offload:
            return
        # the gradients, in the compute dtype, into the fp32 accumulator
        grads = [p.grad for p in self.params]
        if self.dp_group is not None and not self._wire_micro:
            self._exchange_grads(grads)
        else:
            got = [(a, g) for a, g in zip(self.accum, grads)
                   if g is not None]
            if got:
                torch._foreach_add_([a for a, _ in got], [g for _, g in got])

    @torch.no_grad()
    def _exchange_grads(self, grads):
        """One micro step's gradients (None: zero) over the group, into
        ``_xchg``: one fp32 all-reduce of the replicated part, and at stage
        2 one reduce-scatter of the sharded leaves into this rank's shards;
        without offload then summed into the accumulator. This rank's
        experts' gradients go into their accumulator (under offload into
        ``_xchg``) as they are. All enqueue on the current stream."""
        group = self.dp_group
        ep = self.partition.expert_idx
        if ep:
            # this rank's experts: theirs alone, nothing to exchange
            if self._offload:
                _copy_or_zero([v for _, v in self._ep_xchg],
                              [grads[i] for i in ep])
            else:
                got = [(self.accum[i], grads[i]) for i in ep
                       if grads[i] is not None]
                if got:
                    torch._foreach_add_([a for a, _ in got],
                                        [g for _, g in got])
        nd = self._n_dense
        if nd:
            dense = len(self._ar_idx) - len(self._csr_idx)
            _copy_or_zero(self._ar_views[:dense],
                          [grads[i] for i in self._ar_idx[:dense]])
            group.all_reduce(self._ar_buf[:nd], leaves=self._ar_leaves)
            if not self._offload:
                self._flat_accum[:nd].add_(self._ar_buf[:nd])
        for i in self._csr_idx:
            # the row-sparse gradients: (indices, values) of every rank
            # gathered and summed (JAX engine.py:1686-1738)
            g = grads[i]
            if g is not None:
                csr = CSRTensor.from_dense(
                    g, max_rows=min(self._csr_cap, g.shape[0]))
                self.accum[i].add_(allgather_csr(csr, group,
                                                 self._leaf_name(i)))
        if self._grad_sharded and self.partition.seg_size:
            if self._qgz_armed:
                self._qgz_exchange(grads)
            else:
                send = self._rs_send if self._rs_send is not None else \
                    torch.empty(self.dp_world_size * self.partition.seg_size,
                                dtype=torch.float32, device=self.device)
                self.partition.pack(send, grads)
                group.reduce_scatter(self._rs_recv, send,
                                     leaves=self._sh_leaves)
                del send
            if not self._offload:
                seg = self.partition.seg_size
                self._flat_accum[self._n_ar:self._n_ar + seg].add_(
                    self._rs_recv)

    def _qgz_exchange(self, grads):
        """qgZ (JAX ``_make_quantized_grad_exchange``): the sharded
        leaves' gradients reduce-scattered as int8 codes and fp32 scales
        (``quantized_reduce_scatter_rows``, one bucket of every leaf per
        hop), summed over the group as the dense exchange sums them, into
        this rank's shards in ``_rs_recv``."""
        part, dp = self.partition, self.dp_world_size
        leaves = [leaf for leaf in part.leaves if leaf.shard_dim is not None]
        out = quantized_reduce_scatter_rows(
            [part.leaf_rows(leaf, grads) for leaf in leaves], self.dp_group,
            [leaf.name for leaf in leaves],
            block_size=self._config.zero_config.quantization_block_size,
            intra_size=self._qgz_intra, mean=False)
        views = dict(zip(part.sharded_idx, part.segment_views(self._rs_recv)))
        for leaf, row in zip(leaves, out):
            shape = list(leaf.shape)
            shape[leaf.shard_dim] //= dp
            for i, v in part.leaf_views(
                    leaf, rows_to_leaf(row, shape, leaf.shard_dim)):
                views[i].copy_(v)

    # ------------------------------------------------------------------
    # ZeRO-Offload: the gradient stream and the host step
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _start_grad_fetch(self, grads):
        """Start the copy of one micro step's gradients into a staging
        buffer (JAX ``_start_grad_fetch``, engine.py:1930); returns its
        slot. At dp 1 the compute-dtype gradients are packed into
        ``_dev_flat``; at dp > 1 the exchange leaves this rank's fp32 part
        in ``_xchg``. Either buffer is rewritten only after the previous
        copy out of it (the current stream waits on its event). On CUDA
        the copy runs on a side stream that waits on an event recorded
        after backward, so the next micro step's compute overlaps it."""
        if self._d2h_last is not None:
            torch.cuda.current_stream(self.device).wait_event(self._d2h_last)
        csr = []
        if self.dp_group is None:
            dense = self._ar_idx[:len(self._ar_idx) - len(self._csr_idx)]
            _copy_or_zero([self._dev_views[i] for i in dense],
                          [grads[i] for i in dense])
            src = self._dev_flat
            csr = [self._csr_rows(i, grads[i]) for i in self._csr_idx]
        else:
            self._exchange_grads(grads)
            src = self._xchg
        # at dp 1 in the compute dtype: the buffer the copy down reads
        self._sum_over_seq(src)
        slot = self._slot
        self._slot = (slot + 1) % len(self._staging)
        if slot in self._pending_fetches:
            # one slot (gas 1) still holding a micro step not yet added
            self._drain_pending_fetches()
        staging = self._staging[slot]
        # the CSR parameters lie at the end of the flat layout (dp 1):
        # their rows go down instead of their dense region
        nd = self._n_dense if csr else src.numel()
        host_csr = self._csr_host(slot, csr)
        self.last_fetch_bytes = {
            "dense": nd * src.element_size(),
            "csr": {self._leaf_name(i): sum(t.numel() * t.element_size()
                                            for t in rows)
                    for i, rows in zip(self._csr_idx, csr)},
            "csr_dense": {self._leaf_name(i): self.params[i].numel()
                          * src.element_size() for i in self._csr_idx}}
        if self._d2h_stream is None:
            staging[:nd].copy_(src[:nd])
            for dst, rows in zip(host_csr, csr):
                torch._foreach_copy_(list(dst), list(rows))
            return slot
        ready = torch.cuda.Event()
        ready.record()
        self._d2h_stream.wait_event(ready)
        with torch.cuda.stream(self._d2h_stream):
            staging[:nd].copy_(src[:nd], non_blocking=True)
            for dst, rows in zip(host_csr, csr):
                for d, r in zip(dst, rows):
                    d.copy_(r, non_blocking=True)
                    # made on the current stream, read on this one
                    r.record_stream(self._d2h_stream)
        self._d2h_events[slot].record(self._d2h_stream)
        self._d2h_last = self._d2h_events[slot]
        return slot

    def _csr_rows(self, i, g):
        """(indices, values, dropped) of parameter i's gradient at the
        micro-batch's capacity, on the device: the rows the copy down
        carries, and how many nonzero rows the capacity left out."""
        if g is None:
            g = torch.zeros(self.params[i].shape, dtype=self.param_dtype,
                            device=self.device)
        cap = min(self._csr_cap, g.shape[0])
        csr = CSRTensor.from_dense(g, max_rows=cap)
        dropped = torch.clamp(nonzero_rows(g).sum() - cap, min=0)
        return csr.indices, csr.values, dropped.reshape(1)

    def _csr_host(self, slot, csr):
        """The pinned host buffers of ``slot`` for the CSR rows ``csr``,
        made again only when a capacity changes."""
        if not csr:
            return []
        have = self._csr_staging[slot]
        shapes = [[(tuple(t.shape), t.dtype) for t in rows] for rows in csr]
        if have is None or have[0] != shapes:
            pin = self.device.type == "cuda"
            have = (shapes, [[torch.empty(sh, dtype=dt, pin_memory=pin)
                              for sh, dt in rows] for rows in shapes])
            self._csr_staging[slot] = have
        return have[1]

    def _drain_pending_fetches(self):
        """Add each pending staging buffer into the fp32 host accumulator,
        once its copy has completed (JAX ``_consume_grad_fetch``); a CSR
        parameter's rows are scatter-added into its region."""
        for slot in self._pending_fetches:
            if self._d2h_events is not None:
                self._d2h_events[slot].synchronize()
                self._host_waits += 1
            if not self._csr_idx:
                accumulate(self._host_lib, self._host_accum,
                           self._staging[slot])
                continue
            nd = self._n_dense
            accumulate(self._host_lib, self._host_accum[:nd],
                       self._staging[slot][:nd])
            for i, (idx, vals, dropped) in zip(self._csr_idx,
                                               self._csr_staging[slot][1]):
                if int(dropped):
                    raise RuntimeError(
                        f"sparse_gradients: CSR capacity too small — "
                        f"{int(dropped)} nonzero gradient rows were "
                        f"dropped; fix the model's sparse_grad_tokens"
                        f"(batch) to report the true lookup-token count")
                scatter_add_rows(self.accum[i], idx, vals)
        self._pending_fetches = []

    @torch.no_grad()
    def _take_model_step_offload(self):
        """The host step (JAX ``_take_model_step_offload``,
        engine.py:3298-3395): the finite check of the host accumulator and
        its float64 sum of squares over the regions this rank owns (the
        replicated part on rank 0 only), at dp > 1 summed over the group
        with the overflow flag in one reduction; the clip folded into the
        gradient scale; one host Adam call over this rank's regions (one
        flat buffer); the push; the accumulator zeroed and the loss-scale
        policy run on the host. An overflowed step pushes nothing."""
        _t0 = self._begin_apply()
        lr = self._advance_lr()
        self._sync_master()
        self._drain_pending_fetches()
        self._chaos_poison_accum()
        lib, acc = self._host_lib, self._host_accum
        scale = self._host_scaler.cur_scale \
            if self._host_scaler is not None else 1.0
        sq_rep = sum_of_squares(lib, acc[:self._n_ar])
        sq_own = sum_of_squares(lib, acc[self._n_ar:])
        finite = math.isfinite(sq_rep) and math.isfinite(sq_own)
        total_sq = (sq_own + (sq_rep if self.dp_rank == 0 else 0.0)) \
            if finite else 0.0
        if self.dp_group is not None:
            stats = torch.tensor([total_sq, 0.0 if finite else 1.0],
                                 dtype=torch.float64, device=self.device)
            stats = self.dp_group.all_reduce(stats).cpu()
            total_sq, finite = float(stats[0]), float(stats[1]) == 0.0
        clip = self.gradient_clipping()
        if finite:
            gnorm = math.sqrt(total_sq) / scale
            clip_factor = min(1.0, clip / (gnorm + 1e-6)) if clip else 1.0
            self.optimizer.step([self._host_master], [acc], self._host_opt,
                                lr=lr, grad_scale=scale / clip_factor)
            self._push_params()
        else:
            self._host_skipped += 1
            gnorm = 0.0
        acc.zero_()
        if self._host_scaler is not None:
            self._host_scaler.update_scale(not finite)
            if self._host_scaler.cur_scale != scale:
                # the scale the next forward reads, without a host sync
                self.scaler.loss_scale.fill_(self._host_scaler.cur_scale)
            if not finite:
                log_dist(f"ZeRO-Offload: OVERFLOW, skipping step "
                         f"{self.global_steps + 1}, scale -> "
                         f"{self._host_scaler.cur_scale:g}", ranks=[0])
        self._finish_step(lr, {"overflow": not finite, "grad_norm": gnorm,
                               "loss_scale": scale}, _t0)

    @torch.no_grad()
    def _push_params(self):
        """The updated master into the module's parameters (JAX
        ``_push_local_params``, engine.py:2097): rounded to the compute
        dtype on the host into pinned staging, one non-blocking copy up
        into ``_dev_flat`` on the current stream, then the replicated
        parameters copied out of it and, at dp > 1, this rank's shards
        all-gathered into the sharded ones (``_gather_params``). The host
        rewrites the staging only after the last copy up out of it has
        completed (it has, unless no micro step ran since)."""
        if self._h2d_done is not None:
            self._h2d_done.synchronize()
        self.optimizer.cast_into(self._host_master, self._push_host)
        if self._qwz_armed:
            # the shards go up as int8 codes and fp32 scales, the rest in
            # the compute dtype
            self._qwz_quantize_host()
            a, b = self._n_ar, self._n_ar + self.partition.seg_size
            self._dev_flat[:a].copy_(self._push_host[:a], non_blocking=True)
            self._dev_flat[b:].copy_(self._push_host[b:], non_blocking=True)
            for i in self._qwz_dense_idx:
                self._dev_views[i].copy_(self._push_views[i],
                                         non_blocking=True)
            for dev, host in zip(self._qwz_dev, self._qwz_host):
                dev.copy_(host, non_blocking=True)
        else:
            self._dev_flat.copy_(self._push_host, non_blocking=True)
        if self._h2d_done is not None:
            self._h2d_done.record()
        if self._rep_idx:
            torch._foreach_copy_([self.params[i] for i in self._rep_idx],
                                 [self._dev_views[i] for i in self._rep_idx])
        if self._qwz_armed:
            self._qwz_dequantize()
            self._gather_dense_shards()
        elif self.partition.sharded_idx and not self._stage3:
            self.dp_group.all_gather(self._ag_recv, self._ag_send,
                                     leaves=self._sh_leaves)
            self.partition.unpack(self._ag_recv, self.params)
        self._mark_params()

    @torch.no_grad()
    def _gather_dense_shards(self):
        """Under qwZ, the sharded leaves that stay dense (a tensor-
        parallel dim): their shards all-gathered in the compute dtype
        (``param_ag``) into the parameters; at stage 3 they stay at
        rest."""
        idx, part = self._qwz_dense_idx, self.partition
        if not idx or self._stage3:
            return
        send = self._qwz_dense_send
        torch._foreach_copy_(
            list(send.split([self._dev_views[i].numel() for i in idx])),
            [self._dev_views[i].reshape(-1) for i in idx])
        recv = torch.empty(self.dp_world_size * send.numel(),
                           dtype=send.dtype, device=send.device)
        self.dp_group.all_gather(recv, send, leaves=[
            (leaf.name, leaf.elements) for leaf in self._qwz_dense])
        dst, src = [], []
        for r, seg in enumerate(recv.chunk(self.dp_world_size)):
            at = 0
            for i in idx:
                view = part.narrow(self.params[i], i, r)
                dst.append(view)
                src.append(seg[at:at + view.numel()].view(view.shape))
                at += view.numel()
        torch._foreach_copy_(dst, src)

    @torch.no_grad()
    def _qwz_quantize_host(self):
        """This rank's shard of each qwZ leaf from the host master,
        flattened as the JAX push flattens it and quantized with the host
        twin (JAX ``_push_local_params``), into the pinned buffers."""
        block = self._config.zero_config.quantization_block_size
        q_host, s_host = self._qwz_host
        qa = sa = 0
        for leaf, (_, nb, npad) in zip(self._qwz_leaves, self._qwz_lay):
            q, sc = quantize_blockwise_np(
                self.partition.leaf_row(leaf, self.master), block)
            q_host[qa:qa + npad].copy_(q)
            s_host[sa:sa + nb].copy_(sc)
            qa, sa = qa + npad, sa + nb

    @torch.no_grad()
    def _qwz_dequantize(self):
        """The pushed codes into the parameters: all-gathered over the
        group (one gather of the codes and one of the scales, counted per
        leaf as ``qwz_ag`` / ``qwz_scales``) and dequantized into each
        whole leaf; at stage 3 this rank's own codes dequantized into its
        shards at rest, with no gather."""
        part, dp = self.partition, self.dp_world_size
        q, sc = self._qwz_dev
        leaves = self._qwz_leaves
        if self._stage3:
            w, qg, sg = 1, q.view(1, -1), sc.view(1, -1)
        else:
            w = dp
            qg = torch.empty(w * q.numel(), dtype=q.dtype, device=q.device)
            sg = torch.empty(w * sc.numel(), dtype=sc.dtype,
                             device=sc.device)
            self.dp_group.quantized_all_gather(
                qg, q, "qwz_ag", [(leaf.name, w * npad) for leaf, (_, _, npad)
                                  in zip(leaves, self._qwz_lay)])
            self.dp_group.quantized_all_gather(
                sg, sc, "qwz_scales", [(leaf.name, w * nb) for leaf, (_, nb, _)
                                       in zip(leaves, self._qwz_lay)])
            qg, sg = qg.view(w, -1), sg.view(w, -1)
        rest = dict(zip(part.sharded_idx, self._s3_rest)) \
            if self._stage3 else None
        qa = sa = 0
        for leaf, (_, nb, npad) in zip(leaves, self._qwz_lay):
            rows = dequantize_rows(qg[:, qa:qa + npad].contiguous(),
                                   sg[:, sa:sa + nb].contiguous(),
                                   leaf.elements // dp)
            qa, sa = qa + npad, sa + nb
            shape = list(leaf.shape)
            shape[leaf.shard_dim] = shape[leaf.shard_dim] * w // dp
            for i, v in part.leaf_views(leaf, rows_to_leaf(
                    rows, shape, leaf.shard_dim)):
                (rest[i] if rest is not None else self.params[i]).copy_(v)

    @torch.no_grad()
    def _gather_params(self):
        """The module's parameters from the updated master: a cast copy of
        each replicated one (mixed precision), and one all-gather of this
        rank's shards in the parameters' dtype for the sharded ones."""
        if self.mixed_precision and self._rep_idx:
            torch._foreach_copy_([self.params[i] for i in self._rep_idx],
                                 [self.master[i] for i in self._rep_idx])
        if self.partition.sharded_idx:
            self._ag_send.copy_(self._master_seg)
            if not self._stage3:
                # stage 3 keeps the shards at rest: no gather
                self.dp_group.all_gather(self._ag_recv, self._ag_send,
                                         leaves=self._sh_leaves)
                self.partition.unpack(self._ag_recv, self.params)
        self._mark_params()

    def is_gradient_accumulation_boundary(self):
        return self.micro_steps % self.gradient_accumulation_steps() == 0

    def step(self):
        """Optimizer step at accumulation boundaries (reference
        engine.py:1016)."""
        if self._pending_loss is not None:
            raise RuntimeError("step() called between forward() and "
                               "backward()")
        if self.wall_clock_breakdown():
            self.timers(STEP_MICRO_TIMER).start()
        if self.is_gradient_accumulation_boundary():
            self._take_model_step()
        if self.wall_clock_breakdown():
            self.timers(STEP_MICRO_TIMER).stop()

    def _take_model_step(self):
        """The apply fn of engine.py:2184-2240: overflow = a non-finite
        element of the (scaled) accumulator; unscale, clip by the global
        norm, optimizer step, all skipped on overflow; scaler update; zero
        the accumulator. Every decision stays on the device. Under offload,
        the host step (``_take_model_step_offload``)."""
        if self._offload:
            return self._take_model_step_offload()
        self._finish_step(*self._model_step(*self._apply_program_spec()))

    @torch.no_grad()
    def _model_step(self, program=None, contract=None):
        """The optimizer step up to its bookkeeping: its device work
        (``_apply``, or the optimizer's own wire: ``_wire_apply``)
        dispatched as ``program`` (None: inside the caller's program,
        ``fused_train_step``). Returns ``_finish_step``'s arguments."""
        _t0 = self._begin_apply()
        lr = self._advance_lr()
        self._sync_master()
        self._chaos_poison_accum()
        obs = NO_OBSERVER if program is None else self._dispatch_program(
            program, contract)
        with obs:
            metrics = self._wire_apply(lr) if self._wire is not None \
                else self._apply(lr)
        return lr, metrics, _t0

    @torch.no_grad()
    def _apply(self, lr):
        """The device work of the optimizer step (``_take_model_step``);
        returns the step's metrics."""
        flat = self._flat_accum
        self._sum_over_seq(flat)
        inv_scale = scale = None
        if self.scaler is not None:
            scale = self.scaler.loss_scale
            inv_scale = (1.0 / scale).reshape(1)
        # one fused pass over this rank's accumulator: inf or nan, and every
        # element times 1 / scale (exact: the scale is a power of 2); the
        # flag is a MAX over the group, so every rank skips alike
        overflow = has_overflow([flat], self._flag_group, inv_scale)
        # an overflowed step: a zero gradient (norm 0, clip factor 1), and
        # the optimizer's update with skip=overflow is the identity
        flat.masked_fill_(overflow, 0.0)
        grads = self._step_grads
        gnorm = global_norm_from_tree(grads, self.dp_group,
                                      self._partitioned, self.mp_group,
                                      self._tp_split)
        clip = self.gradient_clipping()
        if clip and clip > 0:
            clip_grad_by_global_norm(grads, clip, gnorm)
        sentinels = self._integrity is not None \
            and self._integrity.sentinels_armed
        if sentinels:
            old_norm = self._master_before_update()
        self.optimizer.update(self.master, grads, lr=lr, skip=overflow,
                              **self._phase_kwargs())
        self._gather_params()
        self._skipped += overflow.to(torch.int32)
        if self.scaler is not None:
            self.scaler = update_loss_scale(self.scaler, overflow,
                                            **self._scaler_hparams())
        flat.zero_()
        metrics = {"overflow": overflow, "grad_norm": gnorm,
                   "loss_scale": 1.0 if scale is None else scale}
        if sentinels:
            metrics["update_ratio"] = self._update_ratio(old_norm)
        return metrics

    @torch.no_grad()
    def _master_before_update(self):
        """The integrity sentinels' copy of this rank's fp32 master before
        the update (one fp32 buffer, kept between steps); returns the
        master's norm, on the device."""
        if self._ratio_prev is None:
            flat = torch.empty(sum(m.numel() for m in self.master),
                               dtype=torch.float32, device=self.device)
            self._ratio_prev = [v.view(m.shape) for v, m in zip(
                flat.split([m.numel() for m in self.master]), self.master)]
        torch._foreach_copy_(self._ratio_prev, self.master)
        return torch.stack(torch._foreach_norm(self._ratio_prev)).square() \
            .sum().sqrt()

    @torch.no_grad()
    def _update_ratio(self, old_norm):
        """||new master - master|| / (||master|| + 1e-12) (JAX
        engine.py:2209-2214), on the device; the copy becomes the
        difference."""
        torch._foreach_sub_(self._ratio_prev, self.master)
        diff = torch.stack(torch._foreach_norm(self._ratio_prev)).square() \
            .sum().sqrt()
        return diff / (old_norm + 1e-12)

    # ------------------------------------------------------------------
    # 1-bit Adam and 0/1 Adam: the phases and the wire step (JAX
    # engine.py:2247-2338, 2461-2579)
    # ------------------------------------------------------------------
    def _onebit_frozen(self):
        """Whether the next step runs 1-bit Adam's frozen phase, keyed on
        optimizer steps (engine steps less the fp16-skipped ones): the
        skipped count is read back only once engine steps alone can reach
        the boundary, and the phase latches."""
        if self._onebit_latch:
            return True
        if self.global_steps + 1 <= self.optimizer.freeze_step:
            return False
        skipped = self.skipped_steps if self.fp16_enabled() else 0
        frozen = self.global_steps - skipped + 1 > self.optimizer.freeze_step
        self._onebit_latch = frozen
        return frozen

    def _zeroone_phase(self):
        """(phase, k_round) of the next 0/1 Adam step: ``zeroone_cadence``
        of the completed optimizer steps (engine steps less the
        fp16-skipped ones), re-derived from the counters, so a resumed
        run takes the phase an unbroken one would."""
        opt = self.optimizer
        if not self._zeroone_latch and \
                self.global_steps + 1 <= opt.var_freeze_step:
            return "warmup", 1
        skipped = self.skipped_steps if self.fp16_enabled() else 0
        phase, k = opt.cadence(self.global_steps - skipped)
        if phase != "warmup":
            self._zeroone_latch = True
        return phase, k

    def _phase_kwargs(self):
        """The phase arguments of a disarmed wire optimizer's update in
        the generic step: 1-bit Adam's freeze (its local twin after it);
        0/1 Adam steps in warmup for ever (JAX ``_arm_zeroone``)."""
        if isinstance(self.optimizer, OnebitAdam):
            return {"frozen": self._onebit_frozen()}
        return {}

    def _next_wire_phase(self):
        """Fix the phase of the next wire step: ("warmup" | "frozen", 1)
        for 1-bit Adam, ``_zeroone_phase()`` for 0/1 Adam; returns the
        program name's suffix."""
        if self._wire == "onebit":
            self._wire_phase = ("frozen" if self._onebit_frozen()
                                else "warmup", 1)
            return self._wire_phase[0]
        self._wire_phase = self._zeroone_phase()
        return "%s_k%d" % self._wire_phase

    def _wire_contract(self, base):
        """``base`` with the wire phase's contract (JAX
        ``_fused_program_spec``): a local round posts no collective; a
        frozen or sync step moves packed u8 / s8 codes, a sync round
        within the report's ``optimizer_wire.sync_round_bytes`` (times
        dp / (dp - 1): gathers are priced at their output)."""
        contract = dict(base)
        phase = self._wire_phase[0]
        if phase == "local":
            contract["collective_free"] = True
        elif phase == "frozen":
            contract["wire_dtype"] = ("u8", "s8")
        elif phase == "sync":
            # a gather or all-to-all is measured at its output, the
            # report's ring bytes times g / (g - 1) for a group of g: the
            # data axis (the JAX contract's slack), or over hierarchical
            # groups the smaller of k and dp / k (ROADMAP C-w17)
            dp, k = self.dp_world_size, self.optimizer.intra_size
            g = min(k, dp // k) if k else dp
            contract.update(
                wire_dtype=("u8", "s8"),
                comm_budget_key="optimizer_wire.sync_round_bytes",
                comm_budget_bytes=lambda: (
                    self.comm_volume_report()["optimizer_wire"]
                    ["sync_round_bytes"] * g / max(1, g - 1) + 1),
                comm_small_op_cutoff=8)
        return contract

    def _fused_program_spec(self):
        """(name, contract) of the program ``train_batch`` runs next:
        ``fused_train_step``, or the wire's phase program
        (``onebit_fused:<phase>``, ``zeroone_fused:<phase>_k<k>``)."""
        base = {"host_transfer_free": True, "donates_argnums": (0,),
                "donation_min_elements": 4}
        if self._wire is None:
            return "fused_train_step", base
        name = f"{self._wire}_fused:{self._next_wire_phase()}"
        return name, self._wire_contract(base)

    def _apply_program_spec(self):
        """(name, contract) of the program ``step()`` runs next:
        ``apply_step``, or ``onebit_apply:<phase>`` /
        ``zeroone_apply:<phase>_k<k>``."""
        base = {"donates_argnums": (0,), "donation_min_elements": 4}
        if self._wire is None:
            return "apply_step", base
        name = f"{self._wire}_apply:{self._next_wire_phase()}"
        return name, self._wire_contract(base)

    @contextlib.contextmanager
    def _local_micro_steps(self):
        """Under the armed wire, ``train_batch``'s micro steps keep each
        rank's gradients its own (the JAX engine's fused wire step runs
        the model under shard_map): the model's loss is the rank's own
        micro-batch's, and nothing is exchanged before the optimizer."""
        if self._wire is None:
            yield
            return
        self._wire_micro = True
        if self._loss_is_global:
            self.module.set_loss_group(None)
        try:
            yield
        finally:
            self._wire_micro = False
            if self._loss_is_global:
                self.module.set_loss_group(self._loss_group)

    @torch.no_grad()
    def _wire_apply(self, lr):
        """The optimizer step of the armed wire (JAX ``_make_onebit_tail``,
        ``_make_zeroone_tail``): the accumulator (this rank's gradients
        under ``train_batch``, the exchanged mean through step()) unscaled;
        a local round adds it into the optimizer's local accumulator with
        no collective, no overflow check and no scaler update; otherwise
        the non-finite check over the group (at a sync the local
        accumulator too), and the update: warmup over the all-reduced
        mean, 1-bit Adam's frozen momentum and 0/1 Adam's sync round over
        the compressed wire. The global norm is not computed (0)."""
        phase, k = self._wire_phase
        opt, flat, group = self.optimizer, self._flat_accum, self.dp_group
        dev = self.device
        scale = None
        found = torch.zeros(1, device=dev)
        ones = torch.ones(1, device=dev)
        if self.scaler is not None:
            scale = self.scaler.loss_scale
        inv = (1.0 / scale).reshape(1) if scale is not None else ones
        # one fused pass: the flag and the unscale (exact: a power of 2)
        torch._amp_foreach_non_finite_check_and_unscale_([flat], found, inv)
        if phase == "local":
            opt.update(self.master, self._step_grads, lr=lr, phase="local",
                       k_round=k)
            overflow = torch.zeros((), dtype=torch.bool, device=dev)
        else:
            if phase == "sync":
                # local rounds never checked: what they accumulated trips
                # the scaler here
                torch._amp_foreach_non_finite_check_and_unscale_(
                    opt.local_accum, found, ones)
            group.all_reduce(found, op=dist.ReduceOp.MAX)
            overflow = found[0] > 0
            flat.masked_fill_(overflow, 0.0)
            if phase == "warmup":
                # the exact mean the warmup step takes
                group.all_reduce(flat, leaves=self._ar_leaves)
                flat.div_(self.dp_world_size)
            kw = {"phase": phase, "k_round": k} if self._wire == "zeroone" \
                else {"frozen": phase == "frozen"}
            opt.update(self.master, self._step_grads, lr=lr, skip=overflow,
                       **kw)
        self._gather_params()
        self._skipped += overflow.to(torch.int32)
        if self.scaler is not None and phase != "local":
            self.scaler = update_loss_scale(self.scaler, overflow,
                                            **self._scaler_hparams())
        flat.zero_()
        return {"overflow": overflow,
                "grad_norm": torch.zeros((), device=dev),
                "loss_scale": 1.0 if scale is None else scale}

    def _begin_apply(self):
        """The optimizer step's span start and memory window."""
        if self._memacct is not None:
            self._memacct.begin("apply_step")
        return self._tracer.begin() if self._tracer is not None else 0.0

    def _finish_step(self, lr, metrics, _t0=0.0):
        """The counters, the step's metrics (with the JAX engine's comm
        annotation, and the mean loss under train_batch) and collectives,
        the telemetry step boundary, the log line."""
        self.global_steps += 1
        if self._memacct is not None:
            self._memacct.end("apply_step")
        tr = self._tracer
        if tr is not None:
            tr.complete("optimizer_step", self._lane_train, _t0,
                        a0=self.global_steps)
        if self.progressive_layer_drop is not None:
            self.progressive_layer_drop.update_state(self.global_steps)
        self._last_grad_norm = metrics["grad_norm"]
        metrics.update(self._annotate_comm())
        if self._step_loss is not None:
            metrics["loss"] = self._step_loss
            self._step_loss = None
        self._last_metrics = metrics
        if self._counter is not None:
            self.last_step_comm = self._counter.take()
        tel, host = self._telemetry, None
        watched = self._watchdog is not None or self._integrity is not None
        if watched and "loss" not in metrics \
                and self._last_micro_loss is not None:
            # step(): the last micro-batch's loss (the JAX engine's
            # _pending_loss)
            metrics["loss"] = self._last_micro_loss
        if watched or (tel is not None and tel.stream is not None):
            # THE one device-to-host copy of the step (module docstring)
            host = self._host_metrics(metrics)
        self._observe_step_outcome(host)
        if self.global_steps % self.steps_per_print() == 0:
            self._report_progress(lr)
            self._write_monitor(lr, host or metrics)
            if self.wall_clock_breakdown():
                self.timers.log([FORWARD_MICRO_TIMER, BACKWARD_MICRO_TIMER,
                                 STEP_MICRO_TIMER], ranks=[0])

    def _annotate_comm(self):
        """The step's communication figures (JAX ``_annotate_comm``,
        engine.py:3071): the analytic report's totals where the report
        models the active gradient path (none for the CSR rows and the
        1-bit Adam wire), with the 0/1 Adam wire's figures; computed again
        when the 0/1 phase changes."""
        key = self._zeroone_phase() if self._wire == "zeroone" else None
        if self._comm_metrics is None or self._comm_key != key:
            self._comm_key = key
            report = self.comm_volume_report()
            self._comm_metrics = {} if not report["grad_path_modeled"] \
                else {k: report[v] for k, v in (
                    ("comm_bytes_per_step", "total_bytes_per_step"),
                    ("param_gather_bytes_per_step",
                     "param_gather_bytes_per_step"),
                    ("param_gather_dense_bytes_per_step",
                     "param_gather_dense_bytes_per_step"),
                    ("param_gather_quantized_bytes_per_step",
                     "param_gather_quantized_bytes_per_step"))}
            ow = report.get("optimizer_wire")
            if ow is not None:
                m = self._comm_metrics
                m["optimizer_wire_bytes_per_step"] = \
                    m["comm_bytes_per_step"] \
                    - report["param_gather_bytes_per_step"]
                m["optimizer_wire_sync_round_bytes"] = ow["sync_round_bytes"]
                m["optimizer_wire_k_round"] = ow["config"]["local_steps_k"]
                m["optimizer_wire_phase"] = ow["phase"]
        return self._comm_metrics

    @torch.no_grad()
    def _host_metrics(self, metrics):
        """``metrics`` with every tensor a host number: the tensors stacked
        on their device and fetched in ONE copy (a bool stays a bool)."""
        keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
        out = dict(metrics)
        if keys:
            host = torch.stack([metrics[k].detach().reshape(())
                                .to(torch.float64) for k in keys]).cpu()
            for k, x in zip(keys, host.tolist()):
                out[k] = bool(x) if metrics[k].dtype == torch.bool else x
        return out

    def _write_monitor(self, lr, metrics):
        """TensorBoard scalars at ``steps_per_print`` (JAX
        ``_write_monitor``), read on the host here only."""
        if self.summary_writer is None:
            return
        for tag, v in (("lr", lr), ("loss_scale", metrics["loss_scale"]),
                       ("grad_norm", metrics["grad_norm"])):
            self.summary_writer.add_scalar(f"Train/Samples/{tag}", float(v),
                                           self.global_steps)
        self.summary_writer.flush()

    def _report_progress(self, lr):
        """The step's flags, read on the host only here (reference
        engine.py:4088)."""
        m = self._last_metrics
        log_dist(f"step={self.global_steps} skipped={self.skipped_steps} "
                 f"lr={lr:.3e} scale={float(m['loss_scale']):g} "
                 f"grad_norm={float(m['grad_norm']):.4f}", ranks=[0])

    def train_batch(self, data_iter=None, batch=None):
        """gas micro-batches (forward + backward each), then one optimizer
        step; returns the mean micro-batch loss over the global batch.
        ``batch`` (this process's share) carries a leading (gas, ...) axis
        on every entry, as in the JAX engine."""
        gas = self.gradient_accumulation_steps()
        if batch is None:
            if data_iter is None:
                raise ValueError("train_batch needs data_iter or batch")
            micros = [next(data_iter) for _ in range(gas)]
        else:
            micros = [_micro_at(batch, i) for i in range(gas)]
        if chaos.active() is not None:
            # an armed spike_loss plan scales this batch's float features
            micros = [chaos.maybe_spike_batch(m, self.global_steps + 1)
                      for m in micros]
        was_training = self._train_mode
        self._train_mode = True
        try:
            loss = self._train_batch(micros)
        except BaseException:
            # a fault inside the step: back to the step's start (the
            # supervisor retries it or rolls back)
            self._discard_staged_micro()
            raise
        finally:
            self._train_mode = was_training
        return loss

    def _train_batch(self, micros):
        if self.wall_clock_breakdown():
            self.tput_timer.start()
        if self._offload:
            # each micro step's device work is one program, as the JAX
            # engine's micro_offload jit; the fetch and the host step lie
            # outside it
            self._micro_name = "micro_offload"
            try:
                loss = self._micro_loop(micros)
            finally:
                self._micro_name = "micro_step"
            self._take_model_step()
        else:
            # the micro loop, the loss all-reduce and the optimizer step:
            # one program, the JAX engine's fused_train_step
            obs = self._dispatch_program(*self._fused_program_spec())
            self._micro_name = None
            obs.start()
            try:
                with self._local_micro_steps():
                    loss = self._micro_loop(micros)
                step = self._model_step()
            finally:
                obs.stop()
                self._micro_name = "micro_step"
            obs.outputs(loss)
            obs.close()
            self._finish_step(*step)
        if self.wall_clock_breakdown():
            self.tput_timer.stop()
        return loss

    def _micro_loop(self, micros):
        """forward + backward of each micro-batch; the global batch's mean
        loss, which the optimizer step's metrics carry."""
        losses = []
        for micro in micros:
            losses.append(self.forward(micro).detach())
            self.backward()
        loss = torch.stack(losses).float().mean()
        if self._wire_micro:
            # the mean of the ranks' losses, but a local round's: this
            # rank's alone, no collective
            if self._wire_phase[0] != "local":
                loss = self.dp_group.all_reduce(loss) / self.dp_world_size
        elif self.dp_group is not None and not self._loss_is_global:
            # the global batch's mean loss
            loss = self.dp_group.all_reduce(loss) / self.dp_world_size
        self._step_loss = loss
        return loss

    @torch.no_grad()
    def eval_loss(self, batch):
        dev_batch = self._to_device(batch)
        # stage 3: the implicit per-block gathers, not counted with the
        # step's collectives (unless a scheduled gather is live)
        gather = self._stage3 and not self._s3_live
        with self._dispatch_program(
                "eval_loss", {"host_transfer_free": True}) as obs, \
                self._s3_blocks.forward(counted=False) if gather \
                else contextlib.nullcontext():
            loss, _ = self.module.loss(dev_batch,
                                       generator=self._micro_generator(),
                                       train=False)
            obs.outputs(loss)
        return loss

    # ------------------------------------------------------------------
    # the dispatched-program registry (telemetry/programs.py; JAX
    # engine.py:1155-1170, 2729-2818)
    # ------------------------------------------------------------------
    @property
    def program_registry(self):
        """The engine's dispatched-program registry (always armed): every
        program the engine has dispatched, with its declarative contract.
        Read by ``python -m deepspeed_tpu_torch.telemetry.program_lint``."""
        return self._programs

    def _program_state(self):
        """The state the step programs update in place, by name: the JAX
        engine's TrainState, the programs' donated argument, field by
        field (``params/<name>``, ``opt_state/...``, ``master/<name>``,
        ``accum/<name>``, ``scaler/<field>``, ``skipped_steps``). Its step
        counters and rng key are host values here. Under offload the
        device holds the parameters only."""
        state = {f"params/{n}": p
                 for n, p in zip(self.param_names, self.params)}
        if not self._offload:
            state["opt_state/step"] = self.optimizer.step
            for k, lst in enumerate(self.optimizer.state_lists()):
                state.update({f"opt_state/{k}/{n}": t
                              for n, t in zip(self.param_names, lst)})
            if hasattr(self.optimizer, "leaf_state_lists"):
                names = self.optimizer.leaf_map.names
                for k, lst in enumerate(self.optimizer.leaf_state_lists()):
                    state.update({f"opt_state/leaf{k}/{n}": t
                                  for n, t in zip(names, lst)})
            if self._master_separate:
                state.update({f"master/{n}": m
                              for n, m in zip(self.param_names,
                                              self.master)})
            state.update({f"accum/{n}": a
                          for n, a in zip(self.param_names, self.accum)})
        if self.scaler is not None:
            state.update({f"scaler/{f}": t for f, t in
                          zip(self.scaler._fields, self.scaler)})
        state["skipped_steps"] = self._skipped
        return state

    def _dispatch_program(self, name, contract, calls_per_step=1.0,
                          args=None):
        """Register program ``name`` at its first dispatch and return its
        observer (a no-op unless the lint observes this engine).
        ``args``: the program's arguments (default: the state)."""
        return self._programs.dispatch(
            name, args or (self._program_state,), contract, calls_per_step)

    def _s3_split(self):
        """Whether forward() and backward() are the scheduled stage-3
        programs ``s3_fwd`` and ``s3_bwd`` (outside train_batch)."""
        return self._s3_sched_armed and self._micro_name == "micro_step"

    def _s3_fwd_contract(self):
        """The staged forward gathers each planned leaf exactly once, on
        the s8 wire (the fp32 gathers are the per-block scales)."""
        n = self._s3_plan.n_gathered_leaves
        return {"host_transfer_free": True, "wire_dtype": "s8",
                "wire_min_elements": 64,
                "expect_op_counts": [("all-gather", "s8", n)] if n else None}

    def _micro_program_contract(self):
        """The micro step's contract: device work on the donated state;
        under qgZ its gradient exchange rides the s8 wire within the
        analytic per-micro budget (JAX ``_micro_program_contract``)."""
        contract = {"host_transfer_free": True, "donates_argnums": (0,)}
        if self._qgz_armed:
            # beside the report's exchange, the whole micro-batch loss's
            # one all-reduce of (sum nll, count) over the group, which the
            # report does not price (ROADMAP C-w16)
            loss = LOSS_REDUCTION_BYTES if self._loss_is_global else 0
            contract.update(
                wire_dtype="s8",
                comm_budget_key="grad_exchange_bytes_per_step",
                comm_budget_bytes=lambda: (
                    self.comm_volume_report()["grad_exchange_bytes_per_step"]
                    / max(1, self.gradient_accumulation_steps()) + loss))
        return contract

    # ------------------------------------------------------------------
    # telemetry (deepspeed_tpu_torch/telemetry/; JAX engine.py:1023-1145,
    # 1205-1411, 2898-2920)
    # ------------------------------------------------------------------
    def _arm_telemetry(self):
        """Build the telemetry session (span tracer + metrics registry/
        stream + MFU accounting) when the ``telemetry`` config block asks
        for it. Disarmed engines hold ``self._tracer = None``: every
        instrumentation site is one attribute check and the step is
        unchanged. A stream asked for with the master switch off would
        observe nothing, so that DISARMED state warns. The metrics
        stream is rank 0's; every rank traces and counts."""
        tc = self._config.telemetry
        self._telemetry = None
        self._tracer = None
        self._chaos_observer = None
        self._lane_train = self._lane_ckpt = 0
        self._mfu_n_params = self._mfu_tokens_per_step = None
        if not tc[TELEMETRY_ENABLED]:
            if tc[TELEMETRY_METRICS_JSONL]:
                log_dist("telemetry: DISARMED — telemetry.metrics_jsonl is "
                         "set but telemetry.enabled=false, so no trace, step "
                         "stream or MFU accounting will be produced; set "
                         "telemetry.enabled=true to arm it", ranks=[0],
                         level=logging.WARNING)
            return
        from deepspeed_tpu_torch.telemetry import Telemetry

        self._telemetry = Telemetry(
            trace=tc[TELEMETRY_TRACE],
            trace_capacity=tc[TELEMETRY_TRACE_CAPACITY],
            metrics_jsonl=tc[TELEMETRY_METRICS_JSONL]
            if self.dp_rank == self.sp_rank == self.mp_rank == 0 else None,
            metrics_fsync=tc[TELEMETRY_METRICS_FSYNC],
            mfu=tc[TELEMETRY_MFU],
            peak_tflops_per_device=tc[TELEMETRY_PEAK_TFLOPS])
        tr = self._tracer = self._telemetry.tracer
        if tr is not None:
            self._lane_train = tr.lane("train")
            self._lane_ckpt = tr.lane("ckpt")
            tr.intern("optimizer_step", args=("global_step",))
            tr.intern("overflow_skip", args=("global_step",))
            tr.intern("preempt", args=("global_step",))
            # the chaos observers are process-global: a weakref
            # trampoline keeps an abandoned engine collectable
            ref = weakref.ref(self)

            def _chaos_obs(kind, detail=None):
                eng = ref()
                if eng is not None:
                    eng._telemetry_chaos_cb(kind, detail)

            self._chaos_observer = chaos.add_observer(_chaos_obs)
        log_dist(f"telemetry armed: trace={tc[TELEMETRY_TRACE]} (capacity "
                 f"{tc[TELEMETRY_TRACE_CAPACITY]}), metrics_jsonl="
                 f"{tc[TELEMETRY_METRICS_JSONL] or 'off'}, "
                 f"mfu={tc[TELEMETRY_MFU]}", ranks=[0])

    def _telemetry_watchdog_cb(self, event):
        """Observe-only watchdog callback: one instant per event (returns
        None, so the verdict stays the configured one's)."""
        tr = self._tracer
        if tr is not None:
            tr.instant(f"watchdog_{event.kind}", self._lane_train,
                       a0=int(event.step))
        return None

    def _telemetry_chaos_cb(self, kind, detail=None):
        tr = self._tracer
        if tr is not None:
            tr.instant(f"chaos_{kind}", self._lane_train)

    def close_telemetry(self):
        """Release the chaos observer and close the metrics stream's file
        handle. Idempotent; also runs at GC. The session stays
        readable."""
        obs = getattr(self, "_chaos_observer", None)
        if obs is not None:
            self._chaos_observer = None
            chaos.remove_observer(obs)
        tel = getattr(self, "_telemetry", None)
        if tel is not None:
            tel.close()

    def __del__(self):
        try:
            self.close_telemetry()
        except Exception:  # interpreter teardown can fail imports mid-GC;
            # never raise from __del__
            pass

    @property
    def telemetry(self):
        """The armed Telemetry session, or None."""
        return self._telemetry

    def export_trace(self, path, complete_events=True):
        """Write the retained trace as Chrome-trace-event JSON (loadable in
        chrome://tracing / Perfetto); None when tracing is disarmed. Spans
        are host time (telemetry/trace.py)."""
        tr = self._tracer
        if tr is None:
            return None
        return tr.export_chrome_trace(path, complete_events=complete_events)

    def _register_micro_step(self, dev_batch):
        """First dispatch: the 6ND inputs, and the micro step's capture by
        shape with the MFU ledger (its FLOPs are counted at report time)
        and with the memory ledger (its transient, every micro step)."""
        if self._mfu_tokens_per_step is not None:
            return
        self._note_mfu_workload(dev_batch)
        gas = self.gradient_accumulation_steps()
        from deepspeed_tpu_torch.telemetry import mfu

        mfu.register_loss_step(self._telemetry.mfu, "micro_step",
                               self.module, dev_batch, calls_per_step=gas,
                               param_shapes=self._s3_whole_shapes())
        if self._memacct is not None:
            batch_bytes = memory_accounting.tree_device_bytes(dev_batch)
            self._memacct.register("micro_step", calls_per_step=gas,
                                   argument_bytes=batch_bytes)
            self._memacct.register("apply_step")

    def _note_mfu_workload(self, batch):
        """Record the 6ND inputs once: the parameter count and the tokens of
        one optimizer step (the largest integer leaf of a micro-batch times
        gas, over every rank of the data-parallel group)."""
        part = self.partition
        self._mfu_n_params = sum(
            math.prod(self._tp.full_shape(i, part.full_shape(i)))
            for i in range(len(self.params)))
        tokens = 0
        leaves = batch.values() if isinstance(batch, dict) else [batch]
        for leaf in leaves:
            if isinstance(leaf, torch.Tensor) and not leaf.is_floating_point():
                tokens = max(tokens, leaf.numel())
        self._mfu_tokens_per_step = tokens * self.gradient_accumulation_steps() \
            * self.dp_world_size

    def _mfu_report(self):
        from deepspeed_tpu_torch.telemetry import mfu

        tel = self._telemetry
        model_flops = None
        if self._mfu_n_params and self._mfu_tokens_per_step:
            model_flops = mfu.model_flops_per_step(self._mfu_n_params,
                                                   self._mfu_tokens_per_step)
        rep = tel.mfu.report(
            step_time_s=tel.step_time_s(),
            n_devices=self.dp_world_size * self.sp_world_size
            * self.mp_world_size,
            model_flops=model_flops, device_kind=mfu.device_kind(self.device))
        rep["n_params"] = self._mfu_n_params
        rep["tokens_per_step"] = self._mfu_tokens_per_step
        return rep

    def telemetry_report(self):
        """ONE observability report (JAX ``telemetry_report``): the legacy
        builders (``_last_metrics``, ``comm_volume_report()``) behind one
        dict without replacing them, the memory report, and, when armed,
        the metrics-registry snapshot, the trace summary and the MFU/HFU
        ledger (``mfu``; its first call counts the registered programs'
        FLOPs). Reading ``last_metrics`` here fetches its tensors."""
        last = self._last_metrics
        report = {
            "engine": type(self).__name__,
            "global_steps": self.global_steps,
            "telemetry_armed": self._telemetry is not None,
            "last_metrics": self._host_metrics(last)
            if isinstance(last, dict) else last,
            "comm": self.comm_volume_report(),
            "memory": self.memory_report(),
        }
        if self._supervisor is not None:
            # the incident ledger, MTTR, downtime, goodput
            report["recovery"] = self._supervisor.report()
        if self._integrity is not None:
            # anomalies, verdicts, detection latency, the sentinels
            report["integrity"] = self._integrity.report()
        tel = self._telemetry
        if tel is None:
            return report
        report["metrics"] = tel.registry.snapshot()
        if tel.tracer is not None:
            report["trace"] = tel.tracer.summary()
        if tel.mfu is not None:
            report["mfu"] = self._mfu_report()
        return report

    # -- memory accounting (runtime/memory_accounting.py) ---------------
    def _arm_memory_accounting(self):
        """Arm the measured side of the memory accounting when telemetry is
        on and ``telemetry.memory`` asks for it: each micro step and
        optimizer step is a window over the CUDA allocator's peak, the step
        boundary notes the bytes in use and the ``mem`` gauges, and the
        analytic persistent bytes are held against those within
        ``UNDERESTIMATE_TOLERANCE``. A disarmed engine never touches the
        allocator's peak counter."""
        tc = self._config.telemetry
        self._memacct = None
        self._lane_mem = 0
        if not tc[TELEMETRY_ENABLED]:
            return
        if not tc[TELEMETRY_MEMORY]:
            log_dist("memory accounting: DISARMED — telemetry.memory=false; "
                     "memory_report() will carry the analytic component "
                     "model only, with no measured windows and no per-step "
                     "memory gauges", ranks=[0], level=logging.WARNING)
            return
        self._memacct = memory_accounting.MemoryAccounting(self.device)
        self._memacct.expect(
            "train_state", "persistent train state: parameters, fp32 "
            "accumulator, master, optimizer state, loss scaler",
            lambda: self._analytic_memory_components()["persistent_bytes"],
            field="in_use_bytes")
        if self._tracer is not None:
            self._lane_mem = self._tracer.lane("mem")
            self._tracer.intern("hbm_in_use", args=("bytes", "peak"))

    def memory_report(self):
        """The memory leg of the accounting (JAX ``memory_report``): the
        analytic per-component state bytes (this rank's tensors), the
        measured windows with their cross-checks when armed, and the
        allocator's in-use/peak bytes and headroom (None on the CPU)."""
        return memory_accounting.memory_report(
            analytic=self._analytic_memory_components(),
            accounting=self._memacct, devices=self.device,
            extra={"engine": type(self).__name__})

    def _memory_step_gauges(self):
        """Per-step ``mem`` gauges: the allocator's bytes in use and its
        peak (host-side counters, no sync; nothing on the CPU)."""
        acct = self._memacct
        if acct is None or not acct.cuda:
            return
        in_use = torch.cuda.memory_allocated(self.device)
        peak = acct.device_peak_bytes()
        acct.note("train_state", in_use_bytes=in_use)
        reg = self._telemetry.registry
        reg.gauge("mem_bytes_in_use").set(in_use)
        reg.gauge("mem_peak_bytes_in_use").set(peak)
        if self._tracer is not None:
            self._tracer.instant("hbm_in_use", self._lane_mem, a0=in_use,
                                 a1=peak)

    # -- the flops profiler (JAX engine.py:2898-2920) -------------------
    def _maybe_profile(self, dev_batch):
        """At ``profile_step``'s first micro step: count the micro step's
        FLOPs (a replay on meta tensors: no launch) and open a timing
        window around the real one (CUDA events, read once at its end);
        ``_finish_profile`` prints the profile."""
        cfg = self._config.flops_profiler_config
        if not cfg.enabled or self._profiled \
                or self.global_steps + 1 < cfg.profile_step \
                or self.micro_steps % self.gradient_accumulation_steps():
            return
        self._profiled = True
        from deepspeed_tpu_torch.profiling.flops_profiler import \
            FlopsProfiler

        prof = FlopsProfiler(engine=self)
        prof.profile_params([torch.empty(self.partition.shapes[i],
                                         device="meta")
                             for i in range(len(self.params))])
        prof.profile_comm(self.comm_volume_report())
        prof.profile_step(self.module, dev_batch, self._s3_whole_shapes())
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            start = time.perf_counter()
        self._profile_window = (prof, start)

    def _finish_profile(self):
        prof, start = self._profile_window
        self._profile_window = None
        if self.device.type == "cuda":
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            prof._duration = start.elapsed_time(end) / 1e3
        else:
            prof._duration = time.perf_counter() - start
        cfg = self._config.flops_profiler_config
        self.flops_profile = prof
        prof.print_model_profile(profile_step=cfg.profile_step,
                                 module_depth=cfg.module_depth,
                                 top_modules=cfg.top_modules,
                                 detailed=cfg.detailed)

    # ------------------------------------------------------------------
    # checkpoints (reference engine.py:4144-4216, 4312, 4671, 4941-5049):
    # the JAX engine's npz layout, so that either engine loads the other's
    # ------------------------------------------------------------------
    def _state_layout(self):
        """[(field, kind, tensors, sharded)] of the JAX TrainState's fields
        in its flatten order (engine.py:60-70): step, micro_step, params,
        opt_state (its step, then each parameter-shaped list), master
        (mixed precision only), accum, scaler (fp16 only), skipped_steps,
        rng. ``kind`` "tree" marks a parameter-shaped list in this module's
        order, which maps through the reference's parameter tree; "rows"
        a list of flat tensors, one per JAX leaf, whose fourth entry is
        their shapes (each this rank's row of a leaf with a leading
        ``(dp,)`` dim where the optimizer's wire is armed); ``sharded``, a
        list that holds this rank's shards of the sharded parameters (ZeRO: the optimizer state and master, and at stage 2
        the accumulator). Under offload the TrainState holds no optimizer
        state, master or accumulator (they are the host's, in
        ``offload_states.npz``)."""
        def scalar(v):
            return torch.tensor(v, dtype=torch.int32)

        zero = bool(self.partition.sharded_idx)
        gas = self.gradient_accumulation_steps()
        layout = [("step", "leaf", [scalar(self.global_steps)], False),
                  ("micro_step", "leaf", [scalar(self.micro_steps % gas)],
                   False),
                  ("params", "tree", self.params, self._stage3)]
        if not self._offload:
            layout.append(("opt", "leaf", [self.optimizer.step], False))
            layout += [("opt", "tree", lst, zero)
                       for lst in self.optimizer.state_lists()]
            if hasattr(self.optimizer, "leaf_state_lists"):
                # 1-bit / 0/1 Adam's per-leaf state: each rank's row of the
                # JAX engine's leading (dp,) dim where the wire is armed
                layout += [("opt", "rows", lst, shapes) for lst, shapes in
                           zip(self.optimizer.leaf_state_lists(),
                               self.optimizer.leaf_state_shapes())]
            if self.mixed_precision:
                layout.append(("master", "tree", self.master, zero))
            layout.append(("accum", "tree", self.accum,
                           zero and self._grad_sharded))
        if self.scaler is not None:
            layout.append(("scaler", "leaf", list(self.scaler), False))
        # the rng leaf: jax.random.PRNGKey(seed), never read back (a torch
        # generator cannot continue a jax key)
        seed = np.array([self._seed >> 32, self._seed & _M32], np.uint32)
        layout += [("skipped_steps", "leaf", [self._skipped], False),
                   ("rng", "leaf", [seed], False)]
        return layout

    @torch.no_grad()
    def _gather_full(self, tensors):
        """Full-shaped copies of a parameter-shaped list that holds this
        rank's shards: one all-gather (every rank takes part)."""
        part = self.partition
        seg = torch.empty(part.seg_size, dtype=torch.float32,
                          device=self.device)
        torch._foreach_copy_(part.segment_views(seg),
                             [tensors[i] for i in part.sharded_idx])
        out = torch.empty(self.dp_world_size * part.seg_size,
                          dtype=torch.float32, device=self.device)
        self.dp_group.all_gather(out, seg, leaves=())
        full = [torch.empty(part.shapes[i], dtype=t.dtype, device=t.device)
                if part.sharded[i] else t for i, t in enumerate(tensors)]
        part.unpack(out, full)
        return full

    @torch.no_grad()
    def _gather_experts(self, tensors):
        """A parameter-shaped list with each expert stack whole: this
        rank's experts all-gathered along E (every rank takes part)."""
        out = list(tensors)
        for i in self.partition.expert_idx:
            t = tensors[i].contiguous()
            full = torch.empty(self.partition.full_shape(i), dtype=t.dtype,
                               device=t.device)
            self.dp_group.all_gather(full, t, leaves=())
            out[i] = full
        return out

    @torch.no_grad()
    def _tp_whole(self, tensors):
        """A parameter-shaped list with each leaf split over the model line
        whole, in the JAX layout's column order: one all-gather per split
        parameter (every rank of the line takes part; not counted)."""
        if self.mp_group is None:
            return tensors
        return [self._tp.gather(t, i) for i, t in enumerate(tensors)]

    def _host_full(self, tensors):
        """Full-shaped host copies of a host parameter-shaped list that
        holds this rank's regions (the offload state): gathered over the
        group through the device (JAX ``_replicate_host_leaves``); every
        rank takes part."""
        part = self.partition
        if not (part.sharded_idx or part.expert_idx):
            return tensors
        dev = [t.to(self.device) for t in tensors]
        if part.sharded_idx:
            dev = self._gather_full(dev)
        return [t.cpu() for t in self._gather_experts(dev)]

    def _offload_leaves(self):
        """``offload_states.npz``'s leaves (JAX engine.py:4161-4175): the
        master, then m, then v, each full-shaped in the reference tree's
        order."""
        leaves = []
        for lst in (self.master, self._host_m, self._host_v):
            leaves += self._tree_leaves(self._host_full(lst))
        return leaves

    def _tree_leaves(self, tensors):
        """A parameter-shaped list -> the reference tree's leaves."""
        index = {n: i for i, n in enumerate(self.param_names)}
        out = []
        for names, transposed in self._leaf_specs():
            group = names if isinstance(names, tuple) else (names,)
            ts = [tensors[index[n]] for n in group]
            ts = [t.t() if transposed else t for t in ts]
            out.append(torch.stack(ts) if isinstance(names, tuple)
                       else ts[0])
        return out

    def _leaf_specs(self):
        """The model's parameters in the JAX package's tree order (its
        ``reference_leaf_specs``), the layout of every "tree" field."""
        if not hasattr(self.module, "reference_leaf_specs"):
            raise NotImplementedError(
                f"no JAX checkpoint layout for {type(self.module).__name__}: "
                f"the model has no reference_leaf_specs()")
        return self.module.reference_leaf_specs()

    def _state_leaves(self):
        """The TrainState's leaves, full-shaped (sharded lists gathered)."""
        leaves = []
        for _, kind, tensors, sharded in self._state_layout():
            if kind == "rows":
                leaves += self._rows_leaves(tensors, sharded)
                continue
            if sharded:
                tensors = self._gather_full(tensors)
            if kind == "tree":
                leaves += self._tree_leaves(self._tp_whole(
                    self._gather_experts(tensors)))
            else:
                leaves += list(tensors)
        return leaves

    def _rows_leaves(self, flats, shapes):
        """Per-leaf flat state as the JAX leaves: each reshaped to its
        shape, or, with the wire armed, every rank's row gathered into a
        leading (dp,) dim (every rank takes part)."""
        if self._wire is None:
            return [t.reshape(sh) for t, sh in zip(flats, shapes)]
        out = []
        for t, sh in zip(flats, shapes):
            full = torch.empty(self.dp_world_size * t.numel(),
                               dtype=t.dtype, device=t.device)
            self.dp_group.all_gather(full, t.contiguous(), leaves=())
            out.append(full.view((self.dp_world_size,) + tuple(sh)))
        return out

    def _checkpoint_tag_validation(self, tag):
        """The tag must be the same on every rank (reference
        engine.py:1472-1487; JAX engine.py:4105-4125): its hash gathered
        over the group, min against max."""
        mode = self._config.checkpoint_tag_validation_mode
        if mode == "IGNORE" or self._world_group is None:
            return
        digest = int.from_bytes(
            hashlib.sha256(str(tag).encode()).digest()[:4], "big")
        hashes = self._world_group.all_gather_ints([digest])
        lo, hi = int(hashes.min()), int(hashes.max())
        if lo != hi:
            msg = (f"checkpoint tag {tag!r} is not consistent across "
                   f"processes (hash min {lo} != max {hi})")
            if mode == "FAIL":
                raise AssertionError(msg)
            logger.warning(msg)

    # ------------------------------------------------------------------
    # accounting (JAX engine.py:1323-1365, 2928-3059)
    # ------------------------------------------------------------------
    def _comm_leaf_specs(self):
        """A LeafSpec of every JAX leaf: its name, shape and the dimension
        the accumulator's layout shards over ``data`` (ZeRO's at stage 2;
        an expert stack's E at every stage, as the JAX engine's
        accumulator places it). Under tensor parallelism the shape is the
        whole leaf's, as the JAX engine reads its global shapes (ROADMAP
        C-w19: its report prices each data-axis exchange at the whole
        leaf and has no entry for the model axis)."""
        mp = self.mp_world_size
        return [ca.LeafSpec(leaf.name,
                            tuple(s * mp if d in leaf.tp_taken else s
                                  for d, s in enumerate(leaf.shape)),
                            leaf.expert_dim if leaf.expert_dim is not None
                            else leaf.shard_dim if self._grad_sharded
                            else None)
                for leaf in self.partition.leaves]

    def comm_volume_report(self):
        """The analytic per-step communication volume of this config, as
        the JAX engine computes it (``comm_volume_report``): the fp32
        gradient exchange of every micro step (a reduce-scatter of each
        leaf the accumulator shards, an all-reduce of the others) and the
        compute-dtype all-gather of the sharded leaves after each step,
        with ring bytes (w-1)/w. Under offload the leaves shard as the
        offload regions do (the ZeRO spec from stage 1), and the push's
        all-gather is priced at any stage (JAX engine.py:2935-3017)."""
        dp = self.dp_world_size
        stage = self.zero_optimization_stage()
        gas = self.gradient_accumulation_steps()
        compute = ca.dtype_name(self.param_dtype)
        leaves = self._comm_leaf_specs()
        s3 = stage == 3 and dp > 1
        # stage 3: scheduled, one quantized gather per micro; implicit,
        # the forward's and the backward's dense gathers
        gathers = (gas if self._s3_sched_armed else 2 * gas) if s3 else 1
        report = ca.volume_report(
            leaves, dp, gas=gas,
            quantized_gradients=self._qgz_armed,
            quantized_weights=self._qwz_armed or self._s3_sched_armed,
            quantized_weights_mask=[self._qwz_ok(leaf)
                                    for leaf in self.partition.leaves]
            if self._qwz_armed else None,
            block_size=self._config.zero_config.quantization_block_size,
            intra_size=self._qgz_intra, param_dtype=compute,
            gather_params=dp > 1 and (self._offload or stage in (1, 2, 3)),
            param_gathers_per_step=gathers,
            implicit_param_gathers_per_step=2 * gas if s3 else None)
        report["config"].update({"zero_stage": stage,
                                 "compute_dtype": compute})
        # the report models the dense and quantized ZeRO exchanges; the
        # CSR rows and the 1-bit Adam wire it does not price (JAX
        # engine.py:3024-3032; ROADMAP C-w17)
        report["grad_path_modeled"] = not (
            bool(self._csr_idx) or self._wire == "onebit")
        if self._wire == "zeroone":
            # the 0/1 Adam wire, phase by phase (JAX engine.py:3033-3054):
            # the dense mean in warmup, the packed sync round amortized
            # over its k steps after
            phase, k_round = self._zeroone_phase()
            opt = self.optimizer
            ow = ca.zeroone_volume_report(
                leaves, dp, bits=opt.bits,
                block_size=(opt.quantization_block_size
                            or ca.DEFAULT_BLOCK_SIZE),
                intra_size=opt.intra_size, local_steps_k=k_round, gas=gas)
            ow["phase"] = phase
            report["optimizer_wire"] = ow
            report["grad_path_modeled"] = True
            grad_bytes = ow["warmup_grad_exchange_bytes_per_step"] \
                if phase == "warmup" \
                else ow["amortized_grad_exchange_bytes_per_step"]
            report["grad_exchange_bytes_per_step"] = grad_bytes
            report["total_bytes_per_step"] = \
                grad_bytes + report["param_gather_bytes_per_step"]
            base = report["baseline"]["fp32_grad_exchange_bytes_per_step"]
            report["grad_reduction_vs_fp32"] = \
                base / grad_bytes if grad_bytes else None
        return report

    def _analytic_memory_components(self):
        """This rank's bytes of the train state by component (JAX
        engine.py:1323-1365), from the tensors it holds: the compute
        parameters (whole on every rank), the fp32 accumulator, the master
        and the optimizer state (this rank's shards of the sharded leaves
        from stage 1, of the accumulator at stage 2), the loss scaler. A
        master that is the parameters themselves counts under params.

        Under offload (the ``cpu_offload`` branch of the JAX package's
        memory_accounting.py:297-355) the device holds the parameters, the
        flat compute-dtype buffer and the exchange buffers (staging) and,
        while backward's output waits to be packed, one gradient tree
        (transient); the master, the moments and the accumulator are
        host bytes, beside the pinned staging."""
        if self._offload:
            return self._offload_memory_components()
        own = {id(p) for p in self.params}
        opt = [self.optimizer.step] + [
            t for lst in self.optimizer.state_lists() for t in lst] + [
            t for lst in getattr(self.optimizer, "leaf_state_lists",
                                 list)() for t in lst]
        components = {
            "params_bytes": memory_accounting.tensor_bytes(self.params),
            "grad_accum_bytes":
                memory_accounting.tensor_bytes([self._flat_accum]),
            "master_bytes": memory_accounting.tensor_bytes(
                [m for m in self.master if id(m) not in own]),
            "optimizer_state_bytes": memory_accounting.tensor_bytes(opt),
            "scaler_bytes":
                memory_accounting.tensor_bytes(list(self.scaler or ())),
        }
        transient = {
            # scheduled stage 3: the gathered weights live from the
            # forward to the gradient exchange (the prefetch budget's
            # number)
            "gathered_stage3_bytes": self._s3_plan.gathered_bytes
            if self._s3_sched_armed else 0,
            "quantization_scratch_bytes":
                memory_accounting.quantization_scratch_bytes(
                    self._comm_leaf_specs(), self.dp_world_size,
                    self._config.zero_config.quantization_block_size)
                if self._qgz_armed else 0}
        persistent = sum(components.values())
        transient_total = sum(transient.values())
        return {"components": components, "transient": transient,
                "persistent_bytes": persistent,
                "transient_bytes": transient_total,
                "peak_bytes": persistent + transient_total}

    def _offload_memory_components(self):
        tb = memory_accounting.tensor_bytes
        staging = [self._dev_flat]
        if self._stage3:
            # the shards' region of the flat buffer is the parameters
            a, b = self._n_ar, self._n_ar + self.partition.seg_size
            staging = [self._dev_flat[:a], self._dev_flat[b:]]
        if self.dp_group is not None:
            staging += [t for t in (self._xchg, self._ag_recv,
                                    self._rs_send) if t is not None]
        components = {"params_bytes": tb(self.params),
                      "grad_accum_bytes": 0, "master_bytes": 0,
                      "optimizer_state_bytes": 0,
                      "scaler_bytes": tb(list(self.scaler or ())),
                      "offload_staging_bytes": tb(staging)}
        transient = {"grad_tree_bytes": tb(self.params) if not self._stage3
                     else sum(math.prod(self.partition.full_shape(i))
                              for i in range(len(self.params)))
                     * self.params[0].element_size()}
        host = {"master_bytes": tb([self._host_master]),
                "optimizer_state_bytes":
                    tb(self._host_opt["m"] + self._host_opt["v"]),
                "grad_accum_bytes": tb([self._host_accum]),
                "pinned_staging_bytes": tb(self._staging)}
        persistent = sum(components.values())
        transient_total = sum(transient.values())
        return {"components": components, "persistent_bytes": persistent,
                "transient": transient, "transient_bytes": transient_total,
                "peak_bytes": persistent + transient_total,
                "device_bytes": persistent + transient_total,
                "host": host, "host_bytes": sum(host.values())}

    # ------------------------------------------------------------------
    # resilience (JAX engine.py:162-206, 3660-4070): the watchdog, the
    # integrity sentinels, the supervisor's hooks, preemption
    # ------------------------------------------------------------------
    def _arm_resilience(self):
        """The resilience state of a fresh engine: the watchdog and the
        integrity monitor when the config asks for them (both read the
        step's one host fetch), the async-commit slot, the preemption
        flag; the supervisor arms itself (``_arm_supervisor``)."""
        res = self._resilience = self._config.resilience
        self._consecutive_skips = 0
        self._last_ckpt_dir = None
        self.samples_skipped = 0
        # at most ONE async commit in flight: the thread owns write, hash
        # and fsync, this thread the rename (_finalize_pending_commit)
        self._pending_commit = None
        self._pending_commit_info = None
        self._ckpt_foreground_ms = 0.0
        self._ckpt_metrics = None
        self._snap_buf = None          # the async snapshot's host buffer
        self._ratio_prev = None        # the sentinels' master copy
        self._preempt_requested = False
        self._preempt_poll_enabled = False
        self._supervisor = None
        self._watchdog = None
        if res.watchdog_enabled:
            self._watchdog = TrainingWatchdog(
                max_skipped_steps=res.watchdog_max_skipped_steps,
                max_nan_losses=res.watchdog_max_nan_losses,
                stall_timeout=res.watchdog_stall_timeout,
                default_action=res.watchdog_action)
            if self._tracer is not None:
                self._watchdog.add_callback(self._telemetry_watchdog_cb)
        self._arm_integrity()

    @property
    def watchdog(self):
        """The TrainingWatchdog (None unless resilience.watchdog.enabled);
        callbacks go in with ``engine.watchdog.add_callback(cb)``."""
        return self._watchdog

    def consecutive_skipped_steps(self):
        """The current run of overflow-skipped steps, tracked where the
        step's flags reach the host (armed watchdog or sentinels, the
        metrics stream, offload, the pipeline)."""
        return self._consecutive_skips

    def _observe_step_outcome(self, host):
        """The step boundary's resilience and telemetry bookkeeping (JAX
        ``_observe_step_outcome``): publish a sealed async commit, land
        armed chaos bit flips, feed the sentinels and (unsupervised) take
        their verdict, the skip streak, the supervisor's hook, the
        telemetry step, the watchdog (an emergency checkpoint before its
        alarm propagates), the preemption poll. ``host`` is the step's
        metrics fetched to the host, or None."""
        if self._pending_commit is not None:
            if self._supervisor is not None:
                # a failed commit must not become a step fault the ladder
                # answers with a rollback: no torn tag became visible
                try:
                    self._finalize_pending_commit(wait=False)
                except Exception as e:  # noqa: BLE001 - counted, see above
                    self._supervisor.on_commit_failed(e)
            else:
                self._finalize_pending_commit(wait=False)
        if chaos.active() is not None:
            # after the step's fetch: detection starts at the next step
            from deepspeed_tpu_torch.runtime.resilience import integrity

            integrity.apply_chaos_faults(self)
        metrics = self._last_metrics
        overflow = None
        if host is not None:
            overflow = bool(host["overflow"])
        elif isinstance(metrics.get("overflow"), bool):
            overflow = metrics["overflow"]
        mon = self._integrity
        if mon is not None and mon.sentinels_armed:
            ratio = host.get("update_ratio")
            mon.observe_step(
                self.global_steps, loss=host.get("loss"),
                grad_norm=None if overflow else float(host["grad_norm"]),
                update_ratio=None if ratio is None or overflow
                else float(ratio), overflow=overflow)
        if mon is not None and self._supervisor is None:
            # unsupervised, a corrupt verdict is a watchdog event (abort:
            # an emergency tag, stamped suspect by the open window)
            verdict = mon.decide(self, self.global_steps)
            if verdict is not None:
                if self._watchdog is not None:
                    try:
                        self._watchdog.observe_integrity(self.global_steps,
                                                         verdict)
                    except WatchdogAlarm as alarm:
                        self._emergency_checkpoint(alarm.event)
                        raise
                else:
                    logger.warning(
                        f"integrity: corrupt verdict at step "
                        f"{self.global_steps} with no supervisor and no "
                        f"watchdog armed — nothing will recover this run; "
                        f"verdict: {verdict}")
        if overflow is not None:
            self._consecutive_skips = \
                self._consecutive_skips + 1 if overflow else 0
            self._last_metrics = metrics = dict(
                metrics, consecutive_skips=self._consecutive_skips)
        if self._ckpt_metrics is not None \
                and "ckpt_commit_ms_foreground" not in metrics:
            self._last_metrics = metrics = dict(metrics, **dict(
                self._ckpt_metrics,
                ckpt_commit_pending=int(self._pending_commit is not None)))
        if self._supervisor is not None:
            self._supervisor.on_engine_step(self)
        tel, tr = self._telemetry, self._tracer
        if tel is not None:
            if tr is not None and overflow:
                # an overflow the host knows of: the scaler halves on this
                # skip
                tr.instant("overflow_skip", self._lane_train,
                           a0=self.global_steps)
            self._memory_step_gauges()
            tel.on_step(self.global_steps, host)
        if self._watchdog is not None:
            try:
                self._watchdog.observe_step(
                    self.global_steps, loss=host.get("loss"),
                    overflow=bool(overflow))
            except WatchdogAlarm as alarm:
                self._emergency_checkpoint(alarm.event)
                raise
        self._maybe_preempt()

    def _arm_integrity(self):
        """Arm the integrity sentinels when ``resilience.integrity.enabled``
        asks, or warn DISARMED naming the blocker (JAX
        ``_arm_integrity``). The cross-replica vote needs replicas: at dp
        1 (every port engine that arms, A16b holds the rest) it is
        DISARMED with the JAX engine's warning. Disarmed engines hold
        ``self._integrity = None`` and step as before."""
        self._integrity = None
        res = self._resilience
        if not res.integrity_enabled:
            return
        from deepspeed_tpu_torch.runtime.resilience.integrity import (
            IntegrityConfig, IntegrityMonitor)

        if self._wire is not None:
            log_dist(
                "numerical-integrity defense DISARMED — 1-bit Adam wire "
                "compression (the shard_map'd update tail has no per-leaf "
                "norm outputs; error-feedback state is deliberately "
                "rank-local, which the vote would misread as corruption); "
                "silent corruption in this configuration is only caught by "
                "the NaN/overflow watchdog", ranks=[0], level=logging.WARNING)
            return
        cfg = IntegrityConfig.from_resilience(res)
        blockers = []
        if self.dp_world_size <= 1:
            blockers.append(
                "dp=1 (a single replica has nobody to disagree with)")
        if self._pipeline:
            blockers.append(
                "PipelineEngine (per-stage params have no cross-stage "
                "'data' replica to vote over; sentinels ride the host "
                "loss/grad-norm the pipe interpreter already fetches)")
        if self._offload:
            blockers.append(
                "cpu_offload=true (the optimizer steps on HOST master "
                "shards and re-pushes device params every step — a "
                "device vote would checksum state the next push "
                "overwrites; sentinels ride the host grad-norm/loss "
                "the streaming path already computes)")
        log_dist(
            f"integrity cross-replica vote DISARMED — "
            f"{'; '.join(blockers)}; sentinels-only (anomalies "
            f"roll back without a culprit rank)",
            ranks=[0], level=logging.WARNING)
        self._integrity = IntegrityMonitor(cfg, self.dp_world_size,
                                           tracer=self._tracer)
        log_dist(f"numerical-integrity defense armed: sentinels "
                 f"(z>{cfg.z_threshold:g} over a {cfg.window}-step window), "
                 f"cross-replica vote=off, duplicate-compute check=off",
                 ranks=[0])

    def _arm_supervisor(self, supervisor):
        """Arm the supervised-step hooks for a TrainingSupervisor, or warn
        DISARMED naming every blocker (a committed-tag directory and the
        atomic commit are what the ladder needs); returns whether armed.
        Host-side only: the step is unchanged."""
        self._supervisor = None
        blockers = []
        if not getattr(supervisor, "save_dir", None):
            blockers.append(
                "no save_dir — rollback and elastic restart need a "
                "committed-tag directory")
        if not self._resilience.atomic_checkpoints:
            blockers.append(
                "resilience.atomic_checkpoints is disabled — a torn tag "
                "could become the rollback target")
        if blockers:
            log_dist(
                f"self-healing supervision DISARMED — "
                f"{'; '.join(blockers)}; steps run unsupervised (no "
                f"retry, rollback or elastic restart)",
                ranks=[0], level=logging.WARNING)
            return False
        from deepspeed_tpu_torch.elasticity import elasticity_enabled

        if not elasticity_enabled(self._config._param_dict):
            log_dist(
                "supervisor elastic restart DISARMED — no elasticity "
                "config, so a lost host cannot reshard onto the "
                "survivors (compute_elastic_config has no valid world "
                "set) and lost capacity aborts the run; transient retry "
                "and coordinated rollback stay armed",
                ranks=[0], level=logging.WARNING)
        self._supervisor = supervisor
        log_dist("self-healing supervision armed: heartbeat detection + "
                 "retry/rollback/elastic-restart ladder", ranks=[0])
        return True

    def request_preemption(self):
        """Ask for a graceful shutdown: at the next step boundary the engine
        commits a synchronous ``preempt_step<N>`` tag and raises
        GracefulPreemption. Signal-handler safe: it only sets a flag."""
        self._preempt_requested = True
        self._preempt_poll_enabled = True

    def install_preemption_handler(self, signals=None):
        """Route SIGTERM into :meth:`request_preemption`, chaining any
        handler installed before (main thread only)."""
        import signal as signal_mod

        sigs = chain_signal_handlers(self.request_preemption, signals)
        self._preempt_poll_enabled = True
        log_dist(f"preemption handler installed for "
                 f"{[signal_mod.Signals(s).name for s in sigs]}", ranks=[0])

    def _maybe_preempt(self):
        """The step boundary's preemption poll: the request flag OR an
        armed chaos ``preempt_after_steps``, agreed over the world (any
        rank's request stops every rank), then save and raise."""
        want = self._preempt_requested
        if chaos.active() is not None and chaos.consume_preempt_step():
            want = True
        if self._world_group is not None:
            if not (self._preempt_poll_enabled or chaos.active() is not None):
                return
            from deepspeed_tpu_torch.runtime.resilience.coordination import \
                any_flag

            want = any_flag(want)
        if not want:
            return
        self._preempt_requested = True
        if self._tracer is not None:
            self._tracer.instant("preempt", self._lane_train,
                                 a0=self.global_steps)
        tag, save_dir = self._preempt_checkpoint()
        raise GracefulPreemption(
            f"graceful preemption at step {self.global_steps}"
            + (f": committed checkpoint tag {tag!r} under {save_dir}"
               if tag else " (no checkpoint directory known; state NOT "
                          "saved)"),
            tag=tag, save_dir=save_dir)

    def _preempt_checkpoint(self):
        """The synchronous pre-shutdown save, into the run's own checkpoint
        directory first (its state is healthy and moves ``latest``), with
        the exact data position. Returns ``(tag, save_dir)``."""
        save_dir = self._last_ckpt_dir \
            or self._resilience.watchdog_emergency_dir
        if not save_dir:
            logger.warning(
                "graceful preemption: no prior save_checkpoint dir and no "
                "resilience.watchdog.emergency_checkpoint_dir configured; "
                "shutting down WITHOUT a checkpoint")
            return None, None
        tag = f"preempt_step{self.global_steps}"
        self.save_checkpoint(
            save_dir, tag=tag,
            client_state={"data_position": reshard.data_position(self)},
            manifest_meta={"preempt": True}, async_commit=False)
        log_dist(f"graceful preemption: committed {tag!r} under "
                 f"{save_dir}", ranks=[0])
        return tag, save_dir

    def _emergency_checkpoint(self, event=None):
        """The last checkpoint before a watchdog abort: synchronous,
        ``emergency: true``, ``latest`` left alone (the aborting state may
        be the problem), with the data position; best effort."""
        if self._tracer is not None:
            self._tracer.instant("emergency_checkpoint", self._lane_ckpt,
                                 a0=self.global_steps)
        if event is not None and event.kind == EVENT_STALL \
                and self._world_group is not None:
            # a stall is host-local: a collective save would hang peers
            logger.warning(
                "watchdog abort (stall): skipping emergency checkpoint on a "
                "multi-process run — stall verdicts are host-local and the "
                "collective save would hang peers")
            return
        save_dir = self._resilience.watchdog_emergency_dir \
            or self._last_ckpt_dir
        if not save_dir:
            logger.warning(
                "watchdog abort: skipping emergency checkpoint (no prior "
                "save_checkpoint dir and no resilience.watchdog."
                "emergency_checkpoint_dir configured)")
            return
        try:
            self.save_checkpoint(save_dir,
                                 tag=f"emergency_step{self.global_steps}",
                                 save_latest=False,
                                 client_state={"data_position":
                                               reshard.data_position(self)},
                                 manifest_meta={"emergency": True},
                                 async_commit=False)
        except Exception as e:  # noqa: BLE001 - the alarm must propagate
            logger.error(f"emergency checkpoint failed: "
                         f"{type(e).__name__}: {e}")

    @torch.no_grad()
    def _chaos_poison_accum(self):
        """Test hook: NaN into the gradient accumulator when a chaos
        ``nan_grad_steps`` plan is armed (a no-op otherwise)."""
        if chaos.active() is None or not chaos.consume_nan_grad_step():
            return
        if self._offload:
            self._host_accum.fill_(float("nan"))
        else:
            self._flat_accum.fill_(float("nan"))

    @torch.no_grad()
    def _discard_staged_micro(self):
        """Drop a step's staged work (a forward without its backward, the
        accumulated gradients of its micro-batches): the engine is back at
        the last step boundary."""
        self._pending_loss = None
        self._step_loss = None
        self._micro_obs = NO_OBSERVER
        for p in self.params:
            p.grad = None
        if self._s3_live:
            self._s3_release()
            self._s3_stash = None
        gas = self.gradient_accumulation_steps()
        if self.micro_steps % gas:
            self.micro_steps -= self.micro_steps % gas
            if self._offload:
                self._drain_pending_fetches()
                self._host_accum.zero_()
            else:
                self._flat_accum.zero_()

    # ------------------------------------------------------------------
    # checkpoints (JAX engine.py:4144-4216, 4283-4753, 4941-5049): the JAX
    # engine's npz layout, so that either engine loads the other's tags;
    # synchronous or asynchronous commits; auto-resume; elastic loads
    # ------------------------------------------------------------------
    def _ckpt_writer(self):
        """Whether this rank writes the payload (data, seq, model rank 0;
        JAX engine.py:4365)."""
        return self.dp_rank == 0 and self.sp_rank == 0 and self.mp_rank == 0

    def _ckpt_backend(self, backend):
        """The payload backend of a save: npz; orbax, the JAX package's
        checkpoint library, is not read or written by this port."""
        if backend == "orbax":
            raise NotImplementedError(
                "orbax checkpoints are not supported by this port: orbax is "
                "the JAX package's checkpoint library (sharded jax.Array "
                "state); save with backend='npz', which both packages read")
        if backend not in (None, "auto", "npz"):
            raise ValueError(f"unknown checkpoint backend {backend!r} "
                             f"(this engine writes 'npz')")
        return "npz"

    def _ckpt_host_snapshot(self, client_state, backend, copy_host=False):
        """What the payload writer needs, resident in host memory: the
        TrainState's leaves (gathered over the group: every rank takes
        part) copied into the pinned host buffer before this returns (so
        that the next step's in-place update cannot reach what an async
        commit's thread writes), the offload state (cloned for an async
        commit: ``copy_host``) and the metadata."""
        leaves = self._state_leaves()
        offload = self._offload_leaves() if self._offload else None
        meta = {
            "global_steps": self.global_steps,
            "micro_steps": self.micro_steps,
            "skipped_steps": self.skipped_steps,
            "dp_world_size": self.dp_world_size,
            "backend": backend,
            "lr_scheduler": self.lr_scheduler.state_dict()
            if self.lr_scheduler is not None else None,
            "client_state": client_state,
            "num_leaves": len(leaves),
            reshard.TOPOLOGY_KEY: reshard.topology_manifest(self),
            reshard.DATA_POSITION_KEY: reshard.data_position(self),
        }
        if self._host_scaler is not None:
            # the host policy's counters (the JAX engine keeps only the
            # scale), so that a resumed fp16 run goes on as it would have
            h = self._host_scaler
            meta["host_scaler"] = {
                k: getattr(h, k) for k in ("cur_iter", "last_overflow_iter",
                                           "cur_hysteresis")
                if hasattr(h, k)}
        writer = self._ckpt_writer()
        if writer:
            leaves = self._host_copies(leaves)
        if copy_host and offload is not None:
            # the host Adam steps these buffers in place
            offload = [t.clone() for t in offload]
        return {"flat": leaves if writer else None,
                "off_leaves": offload if writer else None,
                "opt_step": self._host_opt["step"] if self._offload
                else None, "meta": meta, "writer": writer}

    @torch.no_grad()
    def _host_copies(self, leaves):
        """Host copies of the state's leaves, the device ones in one pinned
        buffer kept across saves (one commit is in flight at most, and
        its copies are finished when this returns; pinned memory takes
        the device-to-host copy at the link's rate, with no page
        faults)."""
        dev = [t for t in leaves if isinstance(t, torch.Tensor)
               and t.device.type == "cuda"]
        align = 64
        total = sum(-(-t.numel() * t.element_size() // align) * align
                    for t in dev)
        if dev and (self._snap_buf is None or self._snap_buf.numel() < total):
            self._snap_buf = None
            self._snap_buf = torch.empty(total, dtype=torch.uint8,
                                         pin_memory=True)
        out, at = [], 0
        for t in leaves:
            if not isinstance(t, torch.Tensor):
                out.append(np.array(t, copy=True))
            elif t.device.type != "cuda":
                out.append(t.detach().clone())
            else:
                n = t.numel() * t.element_size()
                dst = self._snap_buf[at:at + n].view(t.dtype).view(t.shape)
                # a transposed leaf is put in C order on the device
                dst.copy_(t.contiguous(), non_blocking=True)
                out.append(dst)
                at += -(-n // align) * align
        if dev:
            # the copies land before the next step can update the state
            torch.cuda.current_stream(self.device).synchronize()
        return out

    def _write_snapshot_files(self, path, snap):
        """The payload files of one snapshot into ``path`` (filesystem work
        only: safe on the commit thread); each file is a chaos point."""
        if snap["flat"] is not None:
            fname = os.path.join(path, "model_states.npz")
            atomic.savez_hashed(
                fname, **checkpoint_utils.leaves_to_npz_dict(snap["flat"]))
            chaos.file_written(fname)
        if snap["off_leaves"] is not None:
            fname = os.path.join(path, "offload_states.npz")
            atomic.savez_hashed(
                fname, **checkpoint_utils.leaves_to_npz_dict(
                    snap["off_leaves"]),
                opt_step=np.int64(snap["opt_step"]))
            chaos.file_written(fname)
        if snap["writer"]:
            fname = os.path.join(path, "metadata.pkl")
            with open(fname, "wb") as f:
                pickle.dump(snap["meta"], f)
            chaos.file_written(fname)

    def _checkpoint_manifest_meta(self, tag):
        """The tag manifest's step, world, topology and data position (read
        without unpickling the payload); with the sentinels armed, the
        ``integrity_clean`` stamp (auto-resume and the supervisor pass
        over a suspect tag)."""
        meta = {
            "tag": str(tag),
            "global_steps": self.global_steps,
            "micro_steps": self.micro_steps,
            "world": {"dp": self.dp_world_size, "mp": self.mp_world_size,
                      "sp": self.sp_world_size},
            reshard.TOPOLOGY_KEY: reshard.topology_manifest(self),
            reshard.DATA_POSITION_KEY: reshard.data_position(self),
        }
        if self._integrity is not None:
            meta["integrity_clean"] = bool(self._integrity.clean())
        return meta

    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        save_latest=True, backend=None, manifest_meta=None,
                        async_commit=None):
        """Write ``save_dir/<tag>`` (default ``global_step<N>``) in the JAX
        engine's npz layout: ``model_states.npz`` (the TrainState's leaves,
        full arrays at any dp), ``metadata.pkl`` and the manifest,
        committed atomically, then the ``latest`` pointer. Every rank
        takes part; rank 0 writes. ``manifest_meta``: extra manifest keys.

        ``async_commit`` (None: ``resilience.async_commit``): the state is
        copied to host memory here, and the write, the hash and the fsync
        run on a thread; the tag becomes visible at the first step
        boundary after the seal (or in ``wait_pending_commit()``). One
        commit is in flight at most: a save first finishes the one
        before. Returns True."""
        t0 = time.perf_counter()
        self._finalize_pending_commit(wait=True)
        backend = self._ckpt_backend(backend)
        if self._pending_loss is not None:
            raise RuntimeError("save_checkpoint between forward() and "
                               "backward(): commit the micro-batch first")
        tag = f"global_step{self.global_steps}" if tag is None else tag
        self._checkpoint_tag_validation(tag)
        res = self._resilience
        self._last_ckpt_dir = save_dir
        want_async = res.async_commit if async_commit is None \
            else bool(async_commit)
        if want_async:
            want_async = self._arm_async_commit()
        meta = self._checkpoint_manifest_meta(tag)
        meta.update(manifest_meta or {})
        meta["backend"] = backend
        snap = self._ckpt_host_snapshot(client_state or {}, backend,
                                        copy_host=want_async)
        if want_async:
            commit = atomic.atomic_tag(save_dir, tag, meta=meta,
                                       update_latest=save_latest,
                                       fsync=res.fsync)
            self._pending_commit = atomic.PendingCommit(
                commit, lambda path: self._write_snapshot_files(path, snap),
                heartbeat=self._ckpt_commit_heartbeat()).start()
            self._pending_commit_info = {
                "save_dir": save_dir, "tag": str(tag), "backend": backend,
                # the supervisor's rollback target is a PUBLISHED tag, with
                # the integrity stamp of its commit
                "global_steps": int(meta["global_steps"]),
                "integrity_clean": bool(meta.get("integrity_clean", True)),
            }
            self._ckpt_foreground_ms = (time.perf_counter() - t0) * 1e3
            self._publish_ckpt_metrics()
            if self._tracer is not None:
                self._tracer.complete("ckpt_async_submit", self._lane_ckpt,
                                      t0, a0=self.global_steps)
            log_dist(f"Async checkpoint commit in flight for tag {tag!r} "
                     f"(snapshot took {self._ckpt_foreground_ms:.1f} ms "
                     f"foreground; write+hash+fsync on the commit thread)",
                     ranks=[0])
            return True
        writer = snap["writer"]
        if writer and res.atomic_checkpoints:
            with atomic.atomic_tag(save_dir, tag, meta=meta,
                                   update_latest=save_latest,
                                   fsync=res.fsync) as tmp:
                self._write_snapshot_files(tmp, snap)
        elif writer:
            # the in-place layout (resilience.atomic_checkpoints false)
            path = os.path.join(save_dir, str(tag))
            os.makedirs(path, exist_ok=True)
            self._write_snapshot_files(path, snap)
            if save_latest:
                atomic.write_latest(save_dir, tag, fsync=False)
        if writer and res.keep_checkpoint_tags > 0:
            atomic.gc_tags(save_dir, res.keep_checkpoint_tags,
                           protect={str(tag)})
        if self._world_group is not None:
            # no rank goes on (or loads the tag) before rank 0 committed it
            self._world_group.barrier()
        log_dist(f"Saved checkpoint {os.path.join(save_dir, str(tag))}",
                 ranks=[0])
        if self._watchdog is not None:
            # a long fsync'd save is progress, not a stalled step
            self._watchdog.heartbeat()
        self._ckpt_foreground_ms = (time.perf_counter() - t0) * 1e3
        self._publish_ckpt_metrics()
        if self._tracer is not None:
            self._tracer.complete("ckpt_sync_commit", self._lane_ckpt, t0,
                                  a0=self.global_steps)
        return True

    def _ckpt_commit_heartbeat(self):
        """The commit thread's heartbeat: the watchdog's (a slow disk is
        progress) and, traced, one instant per file on lane ``ckpt``."""
        wd_beat = self._watchdog.heartbeat if self._watchdog is not None \
            else None
        tr = self._tracer
        if wd_beat is None and tr is None:
            return None
        lane = self._lane_ckpt

        def beat():
            if wd_beat is not None:
                wd_beat()
            if tr is not None:
                tr.instant("ckpt_commit_beat", lane)

        return beat

    def _arm_async_commit(self):
        """Whether an async commit can carry this save: in a world of
        several processes it raises (A16b); without the atomic layout it
        warns DISARMED and commits synchronously."""
        if self._world_group is not None:
            raise NotImplementedError(
                f"asynchronous checkpoint commits in a world of "
                f"{self._world_group.size} processes are not ported yet "
                f"(ROADMAP A16b)")
        if not self._resilience.atomic_checkpoints:
            log_dist(
                "DeepSpeedEngine: async checkpoint commit DISARMED — "
                "resilience.atomic_checkpoints=false (the legacy in-place "
                "layout has no seal/publish split to defer); committing "
                "synchronously", ranks=[0], level=logging.WARNING)
            return False
        return True

    def _publish_ckpt_metrics(self):
        """The commit path's state in ``_last_metrics``: the training
        thread's ms of the last save (snapshot + rename for an async one,
        all of it for a synchronous one) and whether a commit is in
        flight."""
        self._ckpt_metrics = {
            "ckpt_commit_ms_foreground": round(self._ckpt_foreground_ms, 3),
            "ckpt_commit_pending": int(self._pending_commit is not None),
        }
        if isinstance(self._last_metrics, dict):
            self._last_metrics = dict(self._last_metrics,
                                      **self._ckpt_metrics)

    def _finalize_pending_commit(self, wait=True):
        """The training thread's part of an async commit: the rename and
        the ``latest`` pointer, then retention. ``wait=False`` (the step
        boundary's call) leaves an unfinished seal in flight. Returns
        True when a commit was published; raises a failed one's error
        (the previous checkpoint intact)."""
        pending = self._pending_commit
        if pending is None:
            return False
        if not wait and not pending.ready():
            return False
        info = self._pending_commit_info
        t0 = time.perf_counter()
        try:
            pending.finalize()
        finally:
            self._pending_commit = None
            self._pending_commit_info = None
            self._ckpt_foreground_ms += (time.perf_counter() - t0) * 1e3
            self._publish_ckpt_metrics()
            if self._tracer is not None:
                self._tracer.complete("ckpt_publish", self._lane_ckpt, t0)
        # a kill here finds the tag durable and visible
        chaos.point("before_gc")
        res = self._resilience
        if res.keep_checkpoint_tags > 0:
            atomic.gc_tags(info["save_dir"], res.keep_checkpoint_tags,
                           protect={info["tag"]})
        if self._watchdog is not None:
            self._watchdog.heartbeat()
        if self._supervisor is not None:
            # only a published tag is a rollback target
            self._supervisor.on_commit_published(dict(info))
        log_dist(f"Committed async checkpoint "
                 f"{os.path.join(info['save_dir'], info['tag'])} "
                 f"(backend={info['backend']}, atomic)", ranks=[0])
        return True

    def wait_pending_commit(self):
        """Block until an in-flight async commit is published (rename,
        ``latest``, retention); True if there was one. Raises a failed
        write's error."""
        return self._finalize_pending_commit(wait=True)

    def pending_commit(self):
        """True while an async commit is in flight."""
        return self._pending_commit is not None

    def load_checkpoint(self, load_dir, tag=None, load_module_strict=True,
                        load_optimizer_states=True,
                        load_lr_scheduler_states=True, auto_resume=None,
                        elastic=None):
        """Restore ``load_dir/<tag>`` (``latest`` when tag is None),
        written by this engine or the JAX one at any dp: the full arrays,
        this rank keeping its own shards. The manifest is verified first.
        Returns (path, client_state), or (None, {}) when nothing loads.

        ``auto_resume`` (None: ``resilience.auto_resume``, with tag None):
        the newest tag that verifies and loads, healthy tags before
        integrity-suspect ones before emergency ones; a named tag is never
        second-guessed. ``elastic=True`` (always with auto-resume, unless
        False): the saved topology is planned against this engine's, the
        dropped schedule features warned DISARMED, and the client state
        gains the plan (``elastic_reshard``) and the ``data_position``.
        In a world of several processes both raise (A16b)."""
        # an in-flight commit lands (or fails) before its tag can be a
        # candidate, and before a restore changes what it snapshot
        self._finalize_pending_commit(wait=True)
        res = self._resilience
        self._last_ckpt_dir = self._last_ckpt_dir or load_dir
        if tag is not None:
            auto_resume = False
        elif auto_resume is None:
            auto_resume = res.auto_resume
        if (auto_resume or elastic) and self._world_group is not None:
            raise NotImplementedError(
                f"{'auto_resume' if auto_resume else 'elastic'} checkpoint "
                f"loads in a world of {self._world_group.size} processes "
                f"are "
                f"not ported yet (ROADMAP A16b)")
        if auto_resume:
            return self._auto_resume_load(load_dir, load_module_strict,
                                          load_optimizer_states,
                                          load_lr_scheduler_states,
                                          elastic=elastic is not False)
        if tag is None:
            tag = atomic.read_latest(load_dir)
            if tag is None:
                logger.warning(f"No 'latest' file at {load_dir}; nothing "
                               f"loaded")
                return None, {}
        if res.verify_on_load:
            ok, reason = atomic.verify_tag(os.path.join(load_dir, str(tag)))
            if not ok:
                raise atomic.CheckpointCorrupt(
                    f"checkpoint tag {tag!r} under {load_dir} failed "
                    f"verification: {reason}. Pass auto_resume=True to fall "
                    f"back to the newest intact checkpoint.")
        return self._load_checkpoint_tag(load_dir, tag, load_module_strict,
                                         load_optimizer_states,
                                         load_lr_scheduler_states,
                                         elastic=bool(elastic))

    def _auto_resume_load(self, load_dir, load_module_strict,
                          load_optimizer_states, load_lr_scheduler_states,
                          elastic=True):
        """The newest-first scan (``atomic.resume_candidates``) past tags
        that fail verification or the load; (None, {}) when none loads.
        A load checks every leaf before it writes any, so a failed one
        leaves the state as it was."""
        res = self._resilience
        last_err = None
        for cand in atomic.resume_candidates(load_dir):
            ok, reason = atomic.verify_tag(os.path.join(load_dir, cand),
                                           check_checksums=res.verify_on_load)
            if not ok:
                logger.warning(f"auto-resume: skipping tag {cand!r} "
                               f"({reason})")
                continue
            snap = self._ckpt_state_snapshot()
            try:
                return self._load_checkpoint_tag(
                    load_dir, cand, load_module_strict,
                    load_optimizer_states, load_lr_scheduler_states,
                    elastic=elastic)
            except Exception as e:  # noqa: BLE001 - any failure: next tag
                self._ckpt_state_restore(snap)
                last_err = e
                logger.warning(f"auto-resume: tag {cand!r} failed to load "
                               f"({type(e).__name__}: {e}); falling back "
                               f"to an older checkpoint")
        logger.warning(f"auto-resume: no {'loadable ' if last_err else ''}"
                       f"checkpoint under {load_dir}; starting fresh")
        return None, {}

    def _ckpt_state_snapshot(self):
        """The host-side counters a load sets (the device state is checked
        before it is written)."""
        return {"global_steps": self.global_steps,
                "micro_steps": self.micro_steps,
                "samples_skipped": self.samples_skipped,
                "host_skipped": self._host_skipped,
                "lr_sched": copy.deepcopy(self.lr_scheduler.state_dict())
                if self.lr_scheduler is not None else None}

    def _ckpt_state_restore(self, snap):
        self.global_steps = snap["global_steps"]
        self.micro_steps = snap["micro_steps"]
        self.samples_skipped = snap["samples_skipped"]
        self._host_skipped = snap["host_skipped"]
        if snap["lr_sched"] is not None:
            self.lr_scheduler.load_state_dict(snap["lr_sched"])

    def _load_checkpoint_tag(self, load_dir, tag, load_module_strict=True,
                             load_optimizer_states=True,
                             load_lr_scheduler_states=True, elastic=False):
        """Restore one tag (already verified): every leaf is matched and its
        shape checked before any is written."""
        path = os.path.join(load_dir, str(tag))
        with open(os.path.join(path, "metadata.pkl"), "rb") as f:
            meta = pickle.load(f)
        if meta.get("backend") == "orbax":
            raise NotImplementedError(
                f"checkpoint {path} was written with the orbax backend, "
                f"which this port does not read: orbax is the JAX package's "
                f"checkpoint library (sharded jax.Array state); re-save it "
                f"from the JAX engine with backend='npz'")
        has_offload = os.path.exists(os.path.join(path,
                                                  "offload_states.npz"))
        if has_offload != self._offload:
            raise ValueError(
                f"checkpoint at {path} was written "
                f"{'with' if has_offload else 'without'} ZeRO-Offload "
                f"(offload_states.npz), this engine runs "
                f"{'with' if self._offload else 'without'} it")
        with checkpoint_utils.load_npz(
                os.path.join(path, "model_states.npz")) as data:
            flat = checkpoint_utils.npz_dict_to_leaves(data)
        copies, scaler = self._restore_plan(flat, path, load_module_strict,
                                            load_optimizer_states)
        finish_offload = self._restore_offload(
            path, meta, load_module_strict, load_optimizer_states,
            copies) if self._offload else None
        self._discard_staged_micro()
        self._apply_restore(copies, scaler)
        if finish_offload is not None:
            finish_offload()
        self.global_steps = meta["global_steps"]
        self.micro_steps = meta["micro_steps"]
        # the stream offset past any window a rollback-and-skip passed over
        self.samples_skipped = int(
            (meta.get(reshard.DATA_POSITION_KEY) or {})
            .get("samples_skipped", 0))
        # the 1-bit / 0/1 Adam phases re-derive from the restored counters
        self._onebit_latch = False
        self._zeroone_latch = False
        if load_lr_scheduler_states and self.lr_scheduler is not None \
                and meta.get("lr_scheduler") is not None:
            self.lr_scheduler.load_state_dict(meta["lr_scheduler"])
        if self.progressive_layer_drop is not None:
            self.progressive_layer_drop.update_state(self.global_steps)
        log_dist(f"Loaded checkpoint {path} (saved at dp="
                 f"{meta.get('dp_world_size')}, now dp={self.dp_world_size})",
                 ranks=[0])
        if self._watchdog is not None:
            # a restore mid-run is progress, not a stalled step
            self._watchdog.heartbeat()
        return path, self._elastic_client_state(meta, elastic)

    def _elastic_client_state(self, meta, elastic):
        """The load's client state, with the elastic plan and the data
        position when the load was elastic; a plain load of a tag written
        at another dp logs a line pointing at elastic=True."""
        client = dict(meta.get("client_state") or {})
        if elastic:
            client["elastic_reshard"] = reshard.elastic_load_report(meta,
                                                                    self)
            client.setdefault(reshard.DATA_POSITION_KEY,
                              meta.get(reshard.DATA_POSITION_KEY))
        else:
            saved = meta.get(reshard.TOPOLOGY_KEY) or {}
            if saved.get("dp") not in (None, self.dp_world_size):
                log_dist(
                    f"checkpoint was written at dp={saved.get('dp')}, now "
                    f"dp={self.dp_world_size}; pass elastic=True to "
                    f"load_checkpoint for the verified reshard plan + "
                    f"data-position resume", ranks=[0])
        return client

    def _restore_plan(self, flat, path, strict, load_optimizer_states):
        """(copies, scaler): the checkpoint's leaves matched field by field
        of the layout with this engine's tensors as (destination, source)
        pairs, every shape checked; raises when the layouts differ. The
        counters come from the metadata and the rng leaf is not read."""
        layout = self._state_layout()
        specs = self._leaf_specs()
        n_want = sum(len(specs) if kind == "tree" else len(t)
                     for _, kind, t, _ in layout)
        if len(flat) != n_want:
            raise ValueError(
                f"checkpoint at {path} holds {len(flat)} state leaves, this "
                f"engine's layout has {n_want}: saved under another "
                f"precision, optimizer or model")
        copies, scaler = [], None
        at = 0
        for field, kind, tensors, sharded in layout:
            n = len(specs) if kind == "tree" else len(tensors)
            got, at = flat[at:at + n], at + n
            if field in ("step", "micro_step", "rng") \
                    or (field == "opt" and not load_optimizer_states):
                continue
            if field == "scaler":
                scaler = type(self.scaler)(*[g.to(self.device) for g in got])
            elif kind == "leaf":
                for dst, src in zip(tensors, got):
                    if tuple(dst.shape) != tuple(src.shape):
                        raise ValueError(
                            f"checkpoint at {path}: a {field} leaf has "
                            f"shape {tuple(src.shape)}, this engine's is "
                            f"{tuple(dst.shape)}")
                    copies.append((dst, src))
            elif kind == "rows":
                self._copy_rows(got, tensors, sharded, path, copies)
            else:
                self._copy_tree(got, tensors, sharded, strict, copies)
        return copies, scaler

    @torch.no_grad()
    def _apply_restore(self, copies, scaler):
        """Write a checked restore plan into the state."""
        for dst, src in copies:
            if dst.device.type != "cpu" and not src.is_contiguous():
                # a transposed leaf goes up as stored and is transposed on
                # the device
                staged = torch.empty_strided(src.size(), src.stride(),
                                             dtype=src.dtype,
                                             device=dst.device)
                staged.copy_(src)
                src = staged
            dst.copy_(src)
        if scaler is not None:
            self.scaler = scaler
        if not (self._offload or self.mixed_precision):
            # fp32: the master shards are the restored parameters' slices
            for i in self.partition.sharded_idx:
                self.master[i].copy_(self._param_local(i))
        self._mark_params()

    def _copy_rows(self, got, flats, shapes, path, copies):
        """A per-leaf state's checkpoint leaves into the flat tensors: this
        rank's row where the wire is armed (the tag must have been written
        at this dp with the wire armed), the leaf itself where not."""
        armed = self._wire is not None
        for src, dst, sh in zip(got, flats, shapes):
            want = ((self.dp_world_size,) if armed else ()) + tuple(sh)
            if tuple(src.shape) != want:
                raise ValueError(
                    f"checkpoint at {path}: an optimizer residual leaf has "
                    f"shape {tuple(src.shape)}, this engine's is {want} "
                    f"(written at another dp or with the wire "
                    f"{'disarmed' if armed else 'armed'})")
            copies.append((dst, (src[self.dp_rank] if armed else src)
                           .reshape(-1)))

    def _copy_tree(self, got, tensors, sharded, strict, copies):
        """The reference tree's leaves ``got`` (full arrays) matched with
        the parameter-shaped list ``tensors`` (this rank's part of each
        where ``sharded``, and this rank's experts of each expert
        stack)."""
        index = {n: i for i, n in enumerate(self.param_names)}
        part = self.partition
        for (names, transposed), src in zip(self._leaf_specs(), got):
            group = names if isinstance(names, tuple) else (names,)
            parts = src.unbind(0) if isinstance(names, tuple) else [src]
            for name, full in zip(group, parts):
                i = index[name]
                full = full.t() if transposed else full
                want = self._tp.full_shape(i, part.full_shape(i))
                if tuple(full.shape) != want:
                    if strict:
                        raise ValueError(
                            f"checkpoint leaf for {name} has shape "
                            f"{tuple(full.shape)}, the model's is {want}")
                    logger.warning(f"load_checkpoint: {name} skipped "
                                   f"(shape {tuple(full.shape)})")
                    continue
                full = part.expert_local(self._tp.local(full, i), i)
                copies.append((tensors[i],
                               part.local(full, i) if sharded else full))

    def _restore_offload(self, path, meta, strict, load_optimizer_states,
                         copies):
        """The host state from ``offload_states.npz`` (JAX
        engine.py:4996-5014): master, m and v (this rank's regions of the
        full arrays) into ``copies``; returns what sets the host Adam's
        step, the host's skipped steps (the metadata's count less the
        device's) and the scale once they are written."""
        with checkpoint_utils.load_npz(
                os.path.join(path, "offload_states.npz")) as data:
            leaves = checkpoint_utils.npz_dict_to_leaves(data)
            opt_step = int(data["opt_step"])
        n = len(self._leaf_specs())
        if len(leaves) != 3 * n:
            raise ValueError(f"offload_states.npz at {path} holds "
                             f"{len(leaves)} leaves, this engine's layout "
                             f"has {3 * n} (master, m, v)")
        lists = [self.master]
        if load_optimizer_states:
            lists += [self._host_m, self._host_v]
        for k, lst in enumerate(lists):
            self._copy_tree(leaves[k * n:(k + 1) * n], lst, True, strict,
                            copies)

        def finish():
            if load_optimizer_states:
                self._host_opt["step"] = opt_step
            self._host_skipped = max(0, int(meta.get("skipped_steps", 0))
                                     - int(self._skipped))
            if self._host_scaler is not None:
                self._host_scaler.cur_scale = float(self.scaler.loss_scale)
                for k, v in (meta.get("host_scaler") or {}).items():
                    setattr(self._host_scaler, k, v)

        return finish


# the batch entries that shard over ``seq`` (the JAX engine shards every
# entry's dim 1; the labels and masks stay whole here, module docstring)
_SEQ_SHARDED = ("input_ids", "token_type_ids")


def _is_integer(x):
    """Whether a batch entry (a tensor or an array) holds integers."""
    if isinstance(x, torch.Tensor):
        return not (x.is_floating_point() or x.is_complex()
                    or x.dtype == torch.bool)
    return np.issubdtype(np.asarray(x).dtype, np.integer)


def _copy_or_zero(dst, src):
    """``dst[j] = src[j]`` for each pair, zero where ``src[j]`` is None (a
    parameter the loss did not reach), in one multi-tensor copy."""
    pairs = []
    for d, g in zip(dst, src):
        if g is None:
            d.zero_()
        else:
            pairs.append((d, g))
    if pairs:
        torch._foreach_copy_([d for d, _ in pairs], [g for _, g in pairs])


def _micro_at(batch, i):
    if isinstance(batch, dict):
        return {k: v[i] for k, v in batch.items()}
    return batch[i]
