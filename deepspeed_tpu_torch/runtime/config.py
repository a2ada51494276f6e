"""DeepSpeedConfig: ds_config JSON -> typed config object.

Key-for-key parity with the reference config system (reference:
deepspeed/runtime/config.py:515-783), including the 6-case batch-size
triangulation (:675) and elasticity integration (:538-592). The bf16 and
mesh sections are extensions of the reference's keys.
"""
import json
import os

import torch.distributed as dist

from deepspeed_tpu_torch.elasticity import (compute_elastic_config, elasticity_enabled,
                                      ensure_immutable_elastic_config)
from deepspeed_tpu_torch.elasticity.config import (ElasticityConfigError,
                                             ElasticityIncompatibleWorldSize)
from deepspeed_tpu_torch.elasticity.constants import (IGNORE_NON_ELASTIC_BATCH_INFO,
                                                IGNORE_NON_ELASTIC_BATCH_INFO_DEFAULT)
from deepspeed_tpu_torch.profiling.config import DeepSpeedFlopsProfilerConfig
from deepspeed_tpu_torch.runtime.activation_checkpointing.config import \
    DeepSpeedActivationCheckpointingConfig
from deepspeed_tpu_torch.runtime.config_utils import (dict_raise_error_on_duplicate_keys,
                                                get_scalar_param)
from deepspeed_tpu_torch.runtime.constants import *  # noqa: F401,F403
from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig
from deepspeed_tpu_torch.runtime.zero.constants import (ZERO_OPTIMIZATION,
                                                  ZERO_OPTIMIZATION_DISABLED)
from deepspeed_tpu_torch.utils.logging import logger
from deepspeed_tpu_torch.version import __version__

TENSOR_CORE_ALIGN_SIZE = 8
# the pipeline schedules a config may name (runtime/pipe/schedule.py; a
# PipelineModule through initialize() runs them in the PipelineEngine)
KNOWN_SCHEDULES = ("1f1b", "interleaved", "zb-h1")
# optimizer-name constants come from runtime/constants.py via the star import


class DeepSpeedConfigError(Exception):
    pass


def get_fp16_enabled(param_dict):
    if FP16 in param_dict:
        return get_scalar_param(param_dict[FP16], FP16_ENABLED, FP16_ENABLED_DEFAULT)
    return False


def get_bf16_enabled(param_dict):
    if BF16 in param_dict:
        return get_scalar_param(param_dict[BF16], BF16_ENABLED, BF16_ENABLED_DEFAULT)
    return False


def get_amp_enabled(param_dict):
    if AMP in param_dict:
        return get_scalar_param(param_dict[AMP], AMP_ENABLED, AMP_ENABLED_DEFAULT)
    return False


def get_amp_params(param_dict):
    if AMP in param_dict:
        d = dict(param_dict[AMP])
        d.pop(AMP_ENABLED, None)
        return d
    return False


def get_loss_scale(param_dict):
    if get_fp16_enabled(param_dict):
        return get_scalar_param(param_dict[FP16], FP16_LOSS_SCALE, FP16_LOSS_SCALE_DEFAULT)
    return FP16_LOSS_SCALE_DEFAULT


def get_initial_dynamic_scale(param_dict):
    if get_fp16_enabled(param_dict):
        power = get_scalar_param(param_dict[FP16], FP16_INITIAL_SCALE_POWER,
                                 FP16_INITIAL_SCALE_POWER_DEFAULT)
    else:
        power = FP16_INITIAL_SCALE_POWER_DEFAULT
    return 2 ** power


def get_dynamic_loss_scale_args(param_dict):
    loss_scale_args = None
    if get_fp16_enabled(param_dict):
        fp16_dict = param_dict[FP16]
        dynamic_props = [FP16_INITIAL_SCALE_POWER, FP16_LOSS_SCALE_WINDOW,
                         FP16_MIN_LOSS_SCALE, FP16_HYSTERESIS]
        if any(prop in fp16_dict for prop in dynamic_props):
            init_scale = get_scalar_param(fp16_dict, FP16_INITIAL_SCALE_POWER,
                                          FP16_INITIAL_SCALE_POWER_DEFAULT)
            scale_window = get_scalar_param(fp16_dict, FP16_LOSS_SCALE_WINDOW,
                                            FP16_LOSS_SCALE_WINDOW_DEFAULT)
            delayed_shift = get_scalar_param(fp16_dict, FP16_HYSTERESIS,
                                             FP16_HYSTERESIS_DEFAULT)
            min_loss_scale = get_scalar_param(fp16_dict, FP16_MIN_LOSS_SCALE,
                                              FP16_MIN_LOSS_SCALE_DEFAULT)
            loss_scale_args = {
                "init_scale": 2 ** init_scale,
                "scale_window": scale_window,
                "delayed_shift": delayed_shift,
                "min_scale": min_loss_scale,
            }
    return loss_scale_args


def get_gradient_accumulation_steps(param_dict):
    return get_scalar_param(param_dict, GRADIENT_ACCUMULATION_STEPS,
                            GRADIENT_ACCUMULATION_STEPS_DEFAULT)


def get_sparse_gradients_enabled(param_dict):
    return get_scalar_param(param_dict, SPARSE_GRADIENTS, SPARSE_GRADIENTS_DEFAULT)


def get_zero_optimization(param_dict):
    return get_scalar_param(param_dict, ZERO_OPTIMIZATION, ZERO_OPTIMIZATION_DISABLED)


def get_allow_untested_optimizer(param_dict):
    return get_scalar_param(param_dict, ZERO_ALLOW_UNTESTED_OPTIMIZER,
                            ZERO_ALLOW_UNTESTED_OPTIMIZER_DEFAULT)


def get_gradient_clipping(param_dict):
    return get_scalar_param(param_dict, GRADIENT_CLIPPING, GRADIENT_CLIPPING_DEFAULT)


def get_checkpoint_params(param_dict):
    return param_dict.get(CHECKPOINT, {})


def get_checkpoint_tag_validation_mode(checkpoint_params):
    """Reference config.py:483-491: 'ignore' | 'warn' | 'fail'."""
    mode = checkpoint_params.get(CHECKPOINT_TAG_VALIDATION,
                                 CHECKPOINT_TAG_VALIDATION_DEFAULT)
    if isinstance(mode, str) and mode.upper() in CHECKPOINT_TAG_VALIDATION_MODES:
        return mode.upper()
    raise ValueError(
        f"Checkpoint config contains invalid tag_validation value "
        f"{mode!r}, expecting one of {CHECKPOINT_TAG_VALIDATION_MODES}")


def get_sparse_attention(param_dict):
    if SPARSE_ATTENTION in param_dict:
        sparsity = param_dict[SPARSE_ATTENTION]
        mode = get_scalar_param(sparsity, SPARSE_ATTENTION_MODE, SPARSE_ATTENTION_MODE_DEFAULT)
        sparsity = dict(sparsity)
        sparsity[SPARSE_ATTENTION_MODE] = mode
        return sparsity
    return None


def get_optimizer_name(param_dict):
    if OPTIMIZER in param_dict and TYPE in param_dict[OPTIMIZER]:
        return param_dict[OPTIMIZER][TYPE]
    return OPTIMIZER_TYPE_DEFAULT


def get_optimizer_params(param_dict):
    if get_optimizer_name(param_dict) is not None and \
            OPTIMIZER_PARAMS in param_dict[OPTIMIZER]:
        return param_dict[OPTIMIZER][OPTIMIZER_PARAMS]
    return None


def get_optimizer_gradient_clipping(param_dict):
    optimizer_params = get_optimizer_params(param_dict)
    if optimizer_params is not None and MAX_GRAD_NORM in optimizer_params:
        return optimizer_params[MAX_GRAD_NORM]
    return None


def get_optimizer_legacy_fusion(param_dict):
    if OPTIMIZER in param_dict and LEGACY_FUSION in param_dict[OPTIMIZER]:
        return param_dict[OPTIMIZER][LEGACY_FUSION]
    return LEGACY_FUSION_DEFAULT


def get_scheduler_name(param_dict):
    if SCHEDULER in param_dict and TYPE in param_dict[SCHEDULER]:
        return param_dict[SCHEDULER][TYPE]
    return SCHEDULER_TYPE_DEFAULT


def get_scheduler_params(param_dict):
    if get_scheduler_name(param_dict) is not None and \
            SCHEDULER_PARAMS in param_dict[SCHEDULER]:
        return param_dict[SCHEDULER][SCHEDULER_PARAMS]
    return None


def get_train_batch_size(param_dict):
    return get_scalar_param(param_dict, TRAIN_BATCH_SIZE, TRAIN_BATCH_SIZE_DEFAULT)


def get_train_micro_batch_size_per_gpu(param_dict):
    return get_scalar_param(param_dict, TRAIN_MICRO_BATCH_SIZE_PER_GPU,
                            TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT)


def get_wall_clock_breakdown(param_dict):
    return get_scalar_param(param_dict, WALL_CLOCK_BREAKDOWN, WALL_CLOCK_BREAKDOWN_DEFAULT)


def get_memory_breakdown(param_dict):
    return get_scalar_param(param_dict, MEMORY_BREAKDOWN, MEMORY_BREAKDOWN_DEFAULT)


def get_tensorboard_enabled(param_dict):
    if TENSORBOARD in param_dict:
        return get_scalar_param(param_dict[TENSORBOARD], TENSORBOARD_ENABLED,
                                TENSORBOARD_ENABLED_DEFAULT)
    return False


def get_tensorboard_output_path(param_dict):
    if get_tensorboard_enabled(param_dict):
        return get_scalar_param(param_dict[TENSORBOARD], TENSORBOARD_OUTPUT_PATH,
                                TENSORBOARD_OUTPUT_PATH_DEFAULT)
    return TENSORBOARD_OUTPUT_PATH_DEFAULT


def get_tensorboard_job_name(param_dict):
    if get_tensorboard_enabled(param_dict):
        return get_scalar_param(param_dict[TENSORBOARD], TENSORBOARD_JOB_NAME,
                                TENSORBOARD_JOB_NAME_DEFAULT)
    return TENSORBOARD_JOB_NAME_DEFAULT


def get_steps_per_print(param_dict):
    return get_scalar_param(param_dict, STEPS_PER_PRINT, STEPS_PER_PRINT_DEFAULT)


def get_disable_allgather(param_dict):
    return get_scalar_param(param_dict, DISABLE_ALLGATHER, DISABLE_ALLGATHER_DEFAULT)


def get_dump_state(param_dict):
    return get_scalar_param(param_dict, DUMP_STATE, DUMP_STATE_DEFAULT)


def get_gradient_predivide_factor(param_dict):
    return get_scalar_param(param_dict, GRADIENT_PREDIVIDE_FACTOR,
                            GRADIENT_PREDIVIDE_FACTOR_DEFAULT)


def get_prescale_gradients(param_dict):
    return get_scalar_param(param_dict, PRESCALE_GRADIENTS, PRESCALE_GRADIENTS_DEFAULT)


def get_allreduce_always_fp32(param_dict):
    return get_scalar_param(param_dict, ALLREDUCE_ALWAYS_FP32, ALLREDUCE_ALWAYS_FP32_DEFAULT)


def get_progressive_layer_drop(param_dict):
    d = param_dict.get(PROGRESSIVE_LAYER_DROP, {})
    enabled = get_scalar_param(d, PLD_ENABLED, PLD_ENABLED_DEFAULT)
    theta = get_scalar_param(d, PLD_THETA, PLD_THETA_DEFAULT)
    gamma = get_scalar_param(d, PLD_GAMMA, PLD_GAMMA_DEFAULT)
    return enabled, theta, gamma


def get_mesh_shape(param_dict):
    """Explicit mesh axis sizes {"data": -1, "model": 1, "pipe": 1}.

    -1 for the data axis means "whatever is left over" after model/pipe.
    """
    d = param_dict.get(MESH, {})
    shape = {
        MESH_PIPE_AXIS: d.get(MESH_PIPE_AXIS, 1),
        MESH_DATA_AXIS: d.get(MESH_DATA_AXIS, -1),
        MESH_SEQ_AXIS: d.get(MESH_SEQ_AXIS, 1),
        MESH_MODEL_AXIS: d.get(MESH_MODEL_AXIS, 1),
    }
    if d.get(MESH_ALLOW_PARTIAL, False):
        shape[MESH_ALLOW_PARTIAL] = True
    return shape


class DeepSpeedResilienceConfig:
    """"resilience" ds_config section: atomic checkpoints + watchdog.

    Everything defaults safe-and-on for the commit path (atomic, fsync,
    verify) and off for the opt-in behaviors (auto-resume, watchdog,
    retention GC).
    """

    def __init__(self, param_dict):
        d = param_dict.get(RESILIENCE, {})
        wd = d.get(RESILIENCE_WATCHDOG, {})
        self.atomic_checkpoints = bool(d.get(RESILIENCE_ATOMIC,
                                             RESILIENCE_ATOMIC_DEFAULT))
        self.fsync = bool(d.get(RESILIENCE_FSYNC, RESILIENCE_FSYNC_DEFAULT))
        self.keep_checkpoint_tags = int(d.get(RESILIENCE_KEEP_TAGS,
                                              RESILIENCE_KEEP_TAGS_DEFAULT))
        self.verify_on_load = bool(d.get(RESILIENCE_VERIFY_ON_LOAD,
                                         RESILIENCE_VERIFY_ON_LOAD_DEFAULT))
        self.auto_resume = bool(d.get(RESILIENCE_AUTO_RESUME,
                                      RESILIENCE_AUTO_RESUME_DEFAULT))
        self.async_commit = bool(d.get(RESILIENCE_ASYNC_COMMIT,
                                       RESILIENCE_ASYNC_COMMIT_DEFAULT))
        self.watchdog_enabled = bool(wd.get(WATCHDOG_ENABLED,
                                            WATCHDOG_ENABLED_DEFAULT))
        self.watchdog_max_skipped_steps = int(
            wd.get(WATCHDOG_MAX_SKIPPED, WATCHDOG_MAX_SKIPPED_DEFAULT))
        self.watchdog_max_nan_losses = int(
            wd.get(WATCHDOG_MAX_NAN, WATCHDOG_MAX_NAN_DEFAULT))
        self.watchdog_stall_timeout = float(
            wd.get(WATCHDOG_STALL_TIMEOUT, WATCHDOG_STALL_TIMEOUT_DEFAULT))
        self.watchdog_action = wd.get(WATCHDOG_ACTION,
                                      WATCHDOG_ACTION_DEFAULT)
        if self.watchdog_action not in ("abort", "continue"):
            raise ValueError(
                f'resilience.watchdog.{WATCHDOG_ACTION} must be "abort" or '
                f'"continue", got {self.watchdog_action!r}')
        self.watchdog_emergency_dir = wd.get(WATCHDOG_EMERGENCY_DIR,
                                             WATCHDOG_EMERGENCY_DIR_DEFAULT)
        sup = d.get(RESILIENCE_SUPERVISOR, {})
        self.supervisor_heartbeat_timeout_steps = int(
            sup.get(SUPERVISOR_HEARTBEAT_TIMEOUT,
                    SUPERVISOR_HEARTBEAT_TIMEOUT_DEFAULT))
        self.supervisor_max_transient_retries = int(
            sup.get(SUPERVISOR_MAX_TRANSIENT_RETRIES,
                    SUPERVISOR_MAX_TRANSIENT_RETRIES_DEFAULT))
        self.supervisor_retry_backoff_steps = int(
            sup.get(SUPERVISOR_RETRY_BACKOFF,
                    SUPERVISOR_RETRY_BACKOFF_DEFAULT))
        self.supervisor_max_recovery_attempts = int(
            sup.get(SUPERVISOR_MAX_RECOVERY_ATTEMPTS,
                    SUPERVISOR_MAX_RECOVERY_ATTEMPTS_DEFAULT))
        self.supervisor_max_restarts = int(
            sup.get(SUPERVISOR_MAX_RESTARTS, SUPERVISOR_MAX_RESTARTS_DEFAULT))
        self.supervisor_checkpoint_every_steps = int(
            sup.get(SUPERVISOR_CHECKPOINT_EVERY,
                    SUPERVISOR_CHECKPOINT_EVERY_DEFAULT))
        if self.supervisor_heartbeat_timeout_steps < 1:
            raise ValueError(
                f"resilience.supervisor.{SUPERVISOR_HEARTBEAT_TIMEOUT} must "
                f"be >= 1 step (a zero window would declare every peer dead "
                f"on its first in-flight step), got "
                f"{self.supervisor_heartbeat_timeout_steps}")
        for label, val in (
                (SUPERVISOR_MAX_TRANSIENT_RETRIES,
                 self.supervisor_max_transient_retries),
                (SUPERVISOR_RETRY_BACKOFF,
                 self.supervisor_retry_backoff_steps),
                (SUPERVISOR_CHECKPOINT_EVERY,
                 self.supervisor_checkpoint_every_steps)):
            if val < 0:
                raise ValueError(
                    f"resilience.supervisor.{label} must be >= 0, got {val}")
        for label, val in (
                (SUPERVISOR_MAX_RECOVERY_ATTEMPTS,
                 self.supervisor_max_recovery_attempts),
                (SUPERVISOR_MAX_RESTARTS, self.supervisor_max_restarts)):
            if val < 1:
                raise ValueError(
                    f"resilience.supervisor.{label} must be >= 1 (the "
                    f"supervisor needs at least one recovery attempt to "
                    f"recover at all), got {val}")
        integ = d.get(RESILIENCE_INTEGRITY, {})
        self.integrity_enabled = bool(integ.get(INTEGRITY_ENABLED,
                                                INTEGRITY_ENABLED_DEFAULT))
        self.integrity_window = int(integ.get(INTEGRITY_WINDOW,
                                              INTEGRITY_WINDOW_DEFAULT))
        self.integrity_z_threshold = float(
            integ.get(INTEGRITY_Z_THRESHOLD, INTEGRITY_Z_THRESHOLD_DEFAULT))
        self.integrity_min_history = int(
            integ.get(INTEGRITY_MIN_HISTORY, INTEGRITY_MIN_HISTORY_DEFAULT))
        self.integrity_confirm_steps = int(
            integ.get(INTEGRITY_CONFIRM_STEPS,
                      INTEGRITY_CONFIRM_STEPS_DEFAULT))
        self.integrity_clear_steps = int(
            integ.get(INTEGRITY_CLEAR_STEPS, INTEGRITY_CLEAR_STEPS_DEFAULT))
        self.integrity_vote_every_steps = int(
            integ.get(INTEGRITY_VOTE_EVERY, INTEGRITY_VOTE_EVERY_DEFAULT))
        self.integrity_dup_check_every_steps = int(
            integ.get(INTEGRITY_DUP_CHECK_EVERY,
                      INTEGRITY_DUP_CHECK_EVERY_DEFAULT))
        self.integrity_quarantine_after = int(
            integ.get(INTEGRITY_QUARANTINE_AFTER,
                      INTEGRITY_QUARANTINE_AFTER_DEFAULT))
        if self.integrity_window < 2:
            raise ValueError(
                f"resilience.integrity.{INTEGRITY_WINDOW} must be >= 2 "
                f"steps (a shorter window has no variance to score "
                f"against), got {self.integrity_window}")
        if self.integrity_z_threshold <= 0:
            raise ValueError(
                f"resilience.integrity.{INTEGRITY_Z_THRESHOLD} must be "
                f"> 0 (0 would flag every step as corrupt), got "
                f"{self.integrity_z_threshold}")
        for label, val, lo in (
                (INTEGRITY_MIN_HISTORY, self.integrity_min_history, 1),
                (INTEGRITY_CONFIRM_STEPS, self.integrity_confirm_steps, 1),
                (INTEGRITY_CLEAR_STEPS, self.integrity_clear_steps, 1),
                (INTEGRITY_QUARANTINE_AFTER,
                 self.integrity_quarantine_after, 1),
                (INTEGRITY_VOTE_EVERY,
                 self.integrity_vote_every_steps, 0),
                (INTEGRITY_DUP_CHECK_EVERY,
                 self.integrity_dup_check_every_steps, 0)):
            if val < lo:
                raise ValueError(
                    f"resilience.integrity.{label} must be >= {lo}, "
                    f"got {val}")


def get_resilience_config(param_dict):
    return DeepSpeedResilienceConfig(param_dict)


def get_pipeline_config(param_dict):
    d = param_dict.get(PIPELINE, {})
    schedule = str(d.get(PIPELINE_SCHEDULE, PIPELINE_SCHEDULE_DEFAULT)).lower()
    if schedule not in KNOWN_SCHEDULES:
        raise ValueError(
            f"pipeline.{PIPELINE_SCHEDULE} must be one of "
            f"{list(KNOWN_SCHEDULES)}, got {schedule!r}")
    virtual_stages = int(d.get(PIPELINE_VIRTUAL_STAGES,
                               PIPELINE_VIRTUAL_STAGES_DEFAULT))
    if virtual_stages < 1:
        raise ValueError(
            f"pipeline.{PIPELINE_VIRTUAL_STAGES} must be >= 1, "
            f"got {virtual_stages}")
    stashing = d.get(PIPELINE_STASH, PIPELINE_STASH_DEFAULT)
    if isinstance(stashing, str):
        stashing = stashing.lower()
    if stashing not in (True, False, "auto"):
        raise ValueError(
            f'pipeline.{PIPELINE_STASH} must be true, false or "auto", '
            f"got {stashing!r}")
    stash_budget = int(d.get(PIPELINE_STASH_BUDGET,
                             PIPELINE_STASH_BUDGET_DEFAULT))
    if stash_budget < 0:
        raise ValueError(
            f"pipeline.{PIPELINE_STASH_BUDGET} must be >= 0 bytes "
            f"(0 = unbounded), got {stash_budget}")
    return {
        PIPELINE_STAGES: d.get(PIPELINE_STAGES, PIPELINE_STAGES_DEFAULT),
        PIPELINE_PARTITION: d.get(PIPELINE_PARTITION, PIPELINE_PARTITION_DEFAULT),
        PIPELINE_SEED_LAYERS: d.get(PIPELINE_SEED_LAYERS, PIPELINE_SEED_LAYERS_DEFAULT),
        PIPELINE_ACTIVATION_CHECKPOINT_INTERVAL: d.get(
            PIPELINE_ACTIVATION_CHECKPOINT_INTERVAL,
            PIPELINE_ACTIVATION_CHECKPOINT_INTERVAL_DEFAULT),
        PIPELINE_SCHEDULE: schedule,
        PIPELINE_VIRTUAL_STAGES: virtual_stages,
        PIPELINE_STASH: stashing,
        PIPELINE_STASH_BUDGET: stash_budget,
    }


def get_telemetry_config(param_dict):
    """"telemetry" ds_config section: tracing + metrics stream + MFU.

    Everything defaults OFF (the master ``enabled`` switch) — telemetry
    is opt-in observability, and disarmed must cost exactly nothing on
    the step path."""
    d = param_dict.get(TELEMETRY, {})
    capacity = int(d.get(TELEMETRY_TRACE_CAPACITY,
                         TELEMETRY_TRACE_CAPACITY_DEFAULT))
    if capacity < 256:
        raise ValueError(
            f"telemetry.{TELEMETRY_TRACE_CAPACITY} must be >= 256 events "
            f"(got {capacity}); a smaller ring drops spans mid-step and "
            f"the trace replay refuses to run on a holey stream")
    peak = float(d.get(TELEMETRY_PEAK_TFLOPS,
                       TELEMETRY_PEAK_TFLOPS_DEFAULT))
    if peak < 0:
        raise ValueError(
            f"telemetry.{TELEMETRY_PEAK_TFLOPS} must be >= 0 TFLOPS "
            f"(0 = auto-detect from the device kind), got {peak}")
    return {
        TELEMETRY_ENABLED: bool(d.get(TELEMETRY_ENABLED,
                                      TELEMETRY_ENABLED_DEFAULT)),
        TELEMETRY_TRACE: bool(d.get(TELEMETRY_TRACE,
                                    TELEMETRY_TRACE_DEFAULT)),
        TELEMETRY_TRACE_CAPACITY: capacity,
        TELEMETRY_METRICS_JSONL: d.get(TELEMETRY_METRICS_JSONL,
                                       TELEMETRY_METRICS_JSONL_DEFAULT),
        TELEMETRY_METRICS_FSYNC: bool(d.get(TELEMETRY_METRICS_FSYNC,
                                            TELEMETRY_METRICS_FSYNC_DEFAULT)),
        TELEMETRY_MFU: bool(d.get(TELEMETRY_MFU, TELEMETRY_MFU_DEFAULT)),
        TELEMETRY_MEMORY: bool(d.get(TELEMETRY_MEMORY,
                                     TELEMETRY_MEMORY_DEFAULT)),
        TELEMETRY_PEAK_TFLOPS: peak,
    }


class DeepSpeedConfig:
    def __init__(self, json_file_or_dict, mpu=None, param_dict=None, world_size=None):
        if param_dict is None:
            if isinstance(json_file_or_dict, dict):
                self._param_dict = json_file_or_dict
            else:
                with open(json_file_or_dict, "r") as f:
                    self._param_dict = json.load(
                        f, object_pairs_hook=dict_raise_error_on_duplicate_keys)
        else:
            self._param_dict = param_dict

        if world_size is not None:
            self.world_size = world_size
        elif mpu is None and dist.is_available() and dist.is_initialized():
            # the process group's world, when one is initialised
            self.world_size = dist.get_world_size()
        elif mpu is None:
            self.world_size = int(os.environ.get("WORLD_SIZE", "1"))
        else:
            self.world_size = mpu.get_data_parallel_world_size()

        self.elasticity_enabled = elasticity_enabled(self._param_dict)
        if self.elasticity_enabled:
            final_batch_size, valid_gpus, micro_batch_size = compute_elastic_config(
                ds_config=self._param_dict,
                target_deepspeed_version=__version__,
                world_size=self.world_size)
            elastic_dict = self._param_dict["elasticity"]
            ensure_immutable_elastic_config(elastic_dict)
            ignore_non_elastic = elastic_dict.get(IGNORE_NON_ELASTIC_BATCH_INFO,
                                                  IGNORE_NON_ELASTIC_BATCH_INFO_DEFAULT)
            if not ignore_non_elastic:
                batch_params = [TRAIN_BATCH_SIZE, TRAIN_MICRO_BATCH_SIZE_PER_GPU,
                                GRADIENT_ACCUMULATION_STEPS]
                if any(p in self._param_dict for p in batch_params):
                    raise ElasticityConfigError(
                        "One or more batch-related parameters were found in your "
                        f"ds_config ({batch_params}). These parameters *cannot* be "
                        "used with elasticity; they are computed from the elastic "
                        f"config. Set {IGNORE_NON_ELASTIC_BATCH_INFO}:true to "
                        "suppress this error")
            gas = final_batch_size // (micro_batch_size * self.world_size)
            self._param_dict[TRAIN_BATCH_SIZE] = final_batch_size
            self._param_dict[TRAIN_MICRO_BATCH_SIZE_PER_GPU] = micro_batch_size
            self._param_dict[GRADIENT_ACCUMULATION_STEPS] = gas
            logger.info(
                f"Elasticity: final batch size {final_batch_size}, "
                f"micro batch {micro_batch_size}, gas {gas}, valid world sizes {valid_gpus}")

        self._initialize_params(self._param_dict)
        self._configure_train_batch_size()
        self._do_sanity_check()

    def _initialize_params(self, param_dict):
        self.train_batch_size = get_train_batch_size(param_dict)
        self.train_micro_batch_size_per_gpu = get_train_micro_batch_size_per_gpu(param_dict)
        self.gradient_accumulation_steps = get_gradient_accumulation_steps(param_dict)
        self.steps_per_print = get_steps_per_print(param_dict)
        self.dump_state = get_dump_state(param_dict)

        self.disable_allgather = get_disable_allgather(param_dict)
        self.allreduce_always_fp32 = get_allreduce_always_fp32(param_dict)
        self.prescale_gradients = get_prescale_gradients(param_dict)
        self.gradient_predivide_factor = get_gradient_predivide_factor(param_dict)
        self.sparse_gradients_enabled = get_sparse_gradients_enabled(param_dict)

        self.zero_config = DeepSpeedZeroConfig(param_dict)
        self.zero_optimization_stage = self.zero_config.stage
        self.zero_enabled = self.zero_optimization_stage > 0

        self.activation_checkpointing_config = \
            DeepSpeedActivationCheckpointingConfig(param_dict)
        self.flops_profiler_config = DeepSpeedFlopsProfilerConfig(param_dict)

        self.fp16_enabled = get_fp16_enabled(param_dict)
        self.bf16_enabled = get_bf16_enabled(param_dict)
        self.amp_enabled = get_amp_enabled(param_dict)
        self.amp_params = get_amp_params(param_dict)
        self.loss_scale = get_loss_scale(param_dict)
        self.initial_dynamic_scale = get_initial_dynamic_scale(param_dict)
        self.dynamic_loss_scale_args = get_dynamic_loss_scale_args(param_dict)

        self.optimizer_name = get_optimizer_name(param_dict)
        if self.optimizer_name is not None and \
                self.optimizer_name.lower() in DEEPSPEED_OPTIMIZERS:
            self.optimizer_name = self.optimizer_name.lower()
        self.optimizer_params = get_optimizer_params(param_dict)
        self.optimizer_legacy_fusion = get_optimizer_legacy_fusion(param_dict)

        self.zero_allow_untested_optimizer = get_allow_untested_optimizer(param_dict)

        self.scheduler_name = get_scheduler_name(param_dict)
        self.scheduler_params = get_scheduler_params(param_dict)

        self.wall_clock_breakdown = get_wall_clock_breakdown(param_dict)
        self.memory_breakdown = get_memory_breakdown(param_dict)
        self.tensorboard_enabled = get_tensorboard_enabled(param_dict)
        self.tensorboard_output_path = get_tensorboard_output_path(param_dict)
        self.tensorboard_job_name = get_tensorboard_job_name(param_dict)

        self.gradient_clipping = get_gradient_clipping(param_dict)
        self.sparse_attention = get_sparse_attention(param_dict)
        self.checkpoint_tag_validation_mode = \
            get_checkpoint_tag_validation_mode(get_checkpoint_params(param_dict))

        self.pld_enabled, self.pld_theta, self.pld_gamma = \
            get_progressive_layer_drop(param_dict)

        self.mesh_shape = get_mesh_shape(param_dict)
        self.pipeline = get_pipeline_config(param_dict)
        self.resilience = get_resilience_config(param_dict)
        self.telemetry = get_telemetry_config(param_dict)

    def _batch_assertion(self):
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps
        assert train_batch > 0, f"Train batch size: {train_batch} has to be greater than 0"
        assert micro_batch > 0, f"Micro batch size per gpu: {micro_batch} has to be greater than 0"
        assert grad_acc > 0, f"Gradient accumulation steps: {grad_acc} has to be greater than 0"
        assert train_batch == micro_batch * grad_acc * self.world_size, (
            f"Check batch related parameters. train_batch_size is not equal "
            f"to micro_batch_per_gpu * gradient_acc_step * world_size "
            f"{train_batch} != {micro_batch} * {grad_acc} * {self.world_size}")

    def _set_batch_related_parameters(self):
        """The 6-case triangulation (reference: config.py:675)."""
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps

        # all three provided
        if train_batch is not None and micro_batch is not None and grad_acc is not None:
            return
        # global + micro -> derive gas
        elif train_batch is not None and micro_batch is not None:
            grad_acc = train_batch // micro_batch
            grad_acc //= self.world_size
            self.gradient_accumulation_steps = grad_acc
        # global + gas -> derive micro
        elif train_batch is not None and grad_acc is not None:
            micro_batch = train_batch // self.world_size
            micro_batch //= grad_acc
            self.train_micro_batch_size_per_gpu = micro_batch
        # micro + gas -> derive global
        elif micro_batch is not None and grad_acc is not None:
            self.train_batch_size = micro_batch * grad_acc * self.world_size
        # global only
        elif train_batch is not None:
            self.gradient_accumulation_steps = 1
            self.train_micro_batch_size_per_gpu = train_batch // self.world_size
        # micro only
        elif micro_batch is not None:
            self.train_batch_size = micro_batch * self.world_size
            self.gradient_accumulation_steps = 1
        else:
            raise DeepSpeedConfigError(
                "Either train_batch_size or train_micro_batch_size_per_gpu needs "
                "to be provided")

    def _configure_train_batch_size(self):
        self._set_batch_related_parameters()
        self._batch_assertion()

    def _do_sanity_check(self):
        self._do_error_check()
        self._do_warning_check()

    def _do_error_check(self):
        assert self.train_micro_batch_size_per_gpu, \
            f"DeepSpeedConfig: {TRAIN_MICRO_BATCH_SIZE_PER_GPU} is not defined"
        assert self.gradient_accumulation_steps, \
            f"DeepSpeedConfig: {GRADIENT_ACCUMULATION_STEPS} is not defined"
        if self.zero_enabled:
            from deepspeed_tpu_torch.runtime.zero.constants import \
                MAX_STAGE_ZERO_OPTIMIZATION

            assert self.zero_optimization_stage <= MAX_STAGE_ZERO_OPTIMIZATION, \
                (f"DeepSpeedConfig: Max supported ZeRO stage is "
                 f"{MAX_STAGE_ZERO_OPTIMIZATION} (3 = param sharding, an "
                 f"extension beyond the reference snapshot's cap of 2)")

    def _do_warning_check(self):
        fp16_enabled = self.fp16_enabled or self.zero_enabled
        vocabulary_size = self._param_dict.get("vocabulary_size", None)
        if vocabulary_size and vocabulary_size % TENSOR_CORE_ALIGN_SIZE != 0:
            logger.warning(
                f"DeepSpeedConfig: vocabulary size {vocabulary_size} is not aligned "
                f"to {TENSOR_CORE_ALIGN_SIZE}; may be suboptimal for tensor-core tiling")
        if self.optimizer_params is not None and \
                MAX_GRAD_NORM in self.optimizer_params and \
                self.optimizer_params[MAX_GRAD_NORM] > 0:
            if fp16_enabled:
                logger.warning(
                    f"DeepSpeedConfig: In FP16 mode, DeepSpeed will pass "
                    f"{MAX_GRAD_NORM}:{self.optimizer_params[MAX_GRAD_NORM]} to the "
                    f"fp16 wrapper; set gradient_clipping instead")

    def print(self, name):
        logger.info(f"{name}:")
        for key, value in sorted(self.__dict__.items()):
            if key != "_param_dict":
                logger.info(f"  {key} {value}")
        logger.info(f"  json = {json.dumps(self._param_dict, sort_keys=True, indent=2)}")
