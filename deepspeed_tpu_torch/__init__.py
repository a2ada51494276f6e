"""deepspeed_tpu_torch: the DeepSpeed training API on PyTorch and CUDA.

The PyTorch/CUDA port of the ``deepspeed_tpu`` package: same config
surface, same ``initialize()`` entry point, with the attention kernels
written by hand for NVIDIA Hopper (sm_90a). Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""
from deepspeed_tpu_torch.utils.distributed import init_distributed
from deepspeed_tpu_torch.version import __reference_version__, __version__

__git_hash__ = None
__git_branch__ = None


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, mpu=None,
               dist_init_required=None, collate_fn=None, config_params=None,
               device=None):
    """Build the engine (reference deepspeed/__init__.py:50-139).

    Returns (engine, optimizer, training_dataloader, lr_scheduler). A
    ``PipelineModule`` takes the ``PipelineEngine`` (runtime/pipe), as
    the JAX package's ``initialize`` dispatches it. ``device`` defaults
    to ``cuda`` and raises when CUDA is absent; pass ``device="cpu"`` to
    run on the CPU.
    """
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
    from deepspeed_tpu_torch.runtime.pipe.engine import PipelineEngine
    from deepspeed_tpu_torch.runtime.pipe.module import PipelineModule

    cls = PipelineEngine if isinstance(model, PipelineModule) \
        else DeepSpeedEngine
    engine = cls(args=args, model=model, optimizer=optimizer,
                 model_parameters=model_parameters,
                 training_data=training_data, lr_scheduler=lr_scheduler,
                 mpu=mpu, dist_init_required=dist_init_required,
                 collate_fn=collate_fn, config_params=config_params,
                 device=device)
    return (engine, engine.optimizer, engine.training_dataloader,
            engine.lr_scheduler)


def add_config_arguments(parser):
    """Add --deepspeed / --deepspeed_config argparse flags
    (reference deepspeed/__init__.py:142-190)."""
    group = parser.add_argument_group("DeepSpeed", "DeepSpeed configurations")
    group.add_argument("--deepspeed", default=False, action="store_true",
                       help="Enable DeepSpeed (helper flag for user code; "
                            "DeepSpeed=True if flag is present)")
    group.add_argument("--deepspeed_config", default=None, type=str,
                       help="DeepSpeed json configuration file.")
    group.add_argument("--deepscale", default=False, action="store_true",
                       help="Deprecated enable DeepSpeed (helper flag)")
    group.add_argument("--deepscale_config", default=None, type=str,
                       help="Deprecated DeepSpeed json configuration file.")
    group.add_argument("--deepspeed_mpi", default=False, action="store_true",
                       help="Run via MPI; discover rank/world from the MPI "
                            "environment.")
    return parser


def __getattr__(name):
    if name == "DeepSpeedEngine":
        from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
        return DeepSpeedEngine
    if name == "PipelineEngine":
        from deepspeed_tpu_torch.runtime.pipe.engine import PipelineEngine
        return PipelineEngine
    if name == "PipelineModule":
        from deepspeed_tpu_torch.runtime.pipe.module import PipelineModule
        return PipelineModule
    if name == "DeepSpeedConfig":
        from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
        return DeepSpeedConfig
    raise AttributeError(
        f"module 'deepspeed_tpu_torch' has no attribute {name!r}")
