"""Activation checkpointing: recompute instead of save, on torch.

Port of deepspeed_tpu/runtime/activation_checkpointing/checkpointing.py
(reference behavior: deepspeed/runtime/activation_checkpointing/
checkpointing.py:58-832, CheckpointFunction, the model-parallel RNG tracker,
configure() / is_configured()).

``checkpoint(fn, *args)`` is torch.utils.checkpoint without re-entry: the
forward keeps only the arguments, the backward re-runs ``fn`` with the
default generators' states restored, so its dropout draws the same masks.
The flags map as in the JAX package:
- partition_activations: save nothing but the boundary, which is what
  torch's checkpoint keeps anyway (one device: nothing to partition);
- contiguous_checkpointing: accepted for config parity (the caching
  allocator owns buffer layout), and needs ``num_checkpoints``;
- checkpoint_in_cpu: the JAX package's policy
  (``offload_dot_products_with_no_batch_dims("device", "pinned_host")``):
  the outputs of the matmuls that have no batch dims (``aten.mm`` /
  ``aten.addmm``, what a dense layer on a (B, S, D) input folds to; not
  ``bmm`` and not the attention kernels') are saved in host memory,
  pinned on the card, and everything else is recomputed in the backward.
  The saved outputs are cached by the checkpoint frame itself, not passed
  through autograd's saved-tensor hooks (``save_on_cpu`` would not see
  them), so the offload sits where the policy stores them: a dispatch
  mode copies each matmul output out (``non_blocking`` into pinned
  memory, on the current stream) as the forward computes it, and the
  recompute's mode serves each matmul from that copy (``non_blocking``
  back) instead of running it. No host sync either way. The JAX package
  warns and falls back to full recompute where its jax lacks that policy
  (ROADMAP C-w11); the gradients are the same either way.
The RNG tracker keeps named ``torch.Generator`` streams (the reference's
CudaRNGStatesTracker, :148-263); ``fork(name)`` hands out a new generator
seeded from the named stream and advances it, as the JAX package's
``fork`` splits a key.
"""
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint as _torch_checkpoint

from deepspeed_tpu_torch.utils.logging import logger

# module state (the reference keeps the same globals, :40-56)
_CONFIG = {
    "partition_activations": False,
    "contiguous_checkpointing": False,
    "checkpoint_in_cpu": False,
    "synchronize": False,
    "profile": False,
}
_CONFIGURED = False
_MPU = None
_NUM_LAYERS = None


def configure(mpu_=None, deepspeed_config=None, partition_activations=None,
              contiguous_checkpointing=None, checkpoint_in_cpu=None,
              synchronize=None, profile=None, num_checkpoints=None):
    """Reference analog: checkpointing.py:747-827. Takes explicit flags or a
    DeepSpeedConfig (or a dict / path of one) with an
    activation_checkpointing section."""
    global _CONFIGURED, _MPU, _NUM_LAYERS
    _CONFIGURED = True
    _MPU = mpu_
    if deepspeed_config is not None:
        from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

        cfg = deepspeed_config
        if isinstance(cfg, (str, dict)):
            cfg = DeepSpeedConfig(cfg, world_size=1)
        ac = getattr(cfg, "activation_checkpointing_config", None)
        if ac is not None:
            _CONFIG["partition_activations"] = ac.partition_activations
            _CONFIG["contiguous_checkpointing"] = \
                ac.contiguous_memory_optimization
            _CONFIG["checkpoint_in_cpu"] = ac.cpu_checkpointing
            _CONFIG["synchronize"] = ac.synchronize_checkpoint_boundary
            _CONFIG["profile"] = ac.profile
            _NUM_LAYERS = ac.number_checkpoints
    for key, val in [("partition_activations", partition_activations),
                     ("contiguous_checkpointing", contiguous_checkpointing),
                     ("checkpoint_in_cpu", checkpoint_in_cpu),
                     ("synchronize", synchronize), ("profile", profile)]:
        if val is not None:
            _CONFIG[key] = val
    if num_checkpoints is not None:
        _NUM_LAYERS = num_checkpoints
    if _CONFIG["contiguous_checkpointing"]:
        logger.info("contiguous_checkpointing: the caching allocator owns "
                    "buffer layout; flag accepted for parity")
        if _NUM_LAYERS is None:
            raise ValueError("contiguous_checkpointing requires "
                             "num_checkpoints (reference "
                             "checkpointing.py:816-818)")


def is_configured():
    return _CONFIGURED


def reset():
    """Reference analog: :691-703 (clears the config state)."""
    global _CONFIGURED, _NUM_LAYERS
    _CONFIGURED = False
    _NUM_LAYERS = None
    for key in _CONFIG:
        _CONFIG[key] = False


def partition_activations_in_checkpoint(flag):
    """Reference analog: :678-683."""
    _CONFIG["partition_activations"] = flag


def set_num_layers(nlayers):
    global _NUM_LAYERS
    _NUM_LAYERS = nlayers


# the matmuls with no batch dims: a dense layer's product on a folded
# (B * S, D) input
_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


class HostActivations:
    """What checkpoint_in_cpu moved through host memory: tensors and bytes
    saved by the forwards (and of those bytes, the ones in pinned memory),
    matmuls served to the recomputes, and the other ops the recomputes
    ran."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.saved = 0
        self.saved_bytes = 0
        self.pinned_bytes = 0
        self.served = 0
        self.recomputed = 0


HOST_ACTIVATIONS = HostActivations()


class _SaveToHost(TorchDispatchMode):
    """The forward's mode: each matmul's output is copied into host memory
    (pinned on the card) and the copy queued for the recompute."""

    def __init__(self, storage):
        super().__init__()
        self.storage = storage

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _MATMULS:
            host = torch.empty(out.shape, dtype=out.dtype,
                               pin_memory=out.is_cuda)
            host.copy_(out, non_blocking=out.is_cuda)
            self.storage.append((host, out.device))
            nbytes = host.numel() * host.element_size()
            HOST_ACTIVATIONS.saved += 1
            HOST_ACTIVATIONS.saved_bytes += nbytes
            if out.is_cuda and host.is_pinned():
                HOST_ACTIVATIONS.pinned_bytes += nbytes
        return out


class _LoadFromHost(TorchDispatchMode):
    """The recompute's mode: each matmul is served from its host copy, in
    the forward's order; every other op runs again."""

    def __init__(self, storage):
        super().__init__()
        self.storage = storage

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in _MATMULS:
            host, device = self.storage.pop(0)
            HOST_ACTIVATIONS.served += 1
            return host.to(device, non_blocking=True) \
                if device.type == "cuda" else host
        if func is not torch.ops.aten.detach.default:   # autograd's own
            HOST_ACTIVATIONS.recomputed += 1
        return func(*args, **(kwargs or {}))


def _host_offload_contexts():
    """The (forward, recompute) context pair of one checkpointed call
    under checkpoint_in_cpu."""
    storage = []
    return _SaveToHost(storage), _LoadFromHost(storage)


def _policy():
    """The ``context_fn`` that torch.utils.checkpoint takes for the
    configured flags, None for its default. checkpoint_in_cpu saves the
    matmul outputs in host memory; every other flag means the default:
    only the boundary is saved and the rest recomputed (the JAX package's
    nothing_saveable and its default coincide here)."""
    if _CONFIG["checkpoint_in_cpu"]:
        return _host_offload_contexts
    return None


def checkpoint(function, *args):
    """Checkpoint a function call: outputs computed normally, the
    activations inside recomputed in the backward with the default
    generators replayed (reference CheckpointFunction, :362-663).
    Non-tensor arguments pass through as they are."""
    kw = {}
    context_fn = _policy()
    if context_fn is not None:
        kw["context_fn"] = context_fn
    return _torch_checkpoint(function, *args, use_reentrant=False,
                             preserve_rng_state=True, **kw)


# ---------------------------------------------------------------------------
# model-parallel RNG (reference CudaRNGStatesTracker :148-263)
# ---------------------------------------------------------------------------
_MODEL_PARALLEL_RNG_TRACKER_NAME = "model-parallel-rng"


class RNGStatesTracker:
    """Named RNG streams over torch generators (reference :148-214)."""

    def __init__(self):
        self.states = {}

    def reset(self):
        self.states = {}

    def get_states(self):
        """{name: generator state}, to restore with set_states."""
        return {name: gen.get_state() for name, gen in self.states.items()}

    def set_states(self, states):
        for name, state in states.items():
            self.states[name].set_state(state)

    def add(self, name, seed, device="cpu"):
        if name in self.states:
            raise Exception(f"rng state {name} already exists")
        self.states[name] = torch.Generator(device=device).manual_seed(seed)

    def fork(self, name=_MODEL_PARALLEL_RNG_TRACKER_NAME):
        """A new generator seeded from the named stream, which advances."""
        if name not in self.states:
            raise Exception(f"rng state {name} is not added")
        gen = self.states[name]
        seed = int(torch.randint(0, 2 ** 62, (), generator=gen,
                                 device=gen.device))
        return torch.Generator(device=gen.device).manual_seed(seed)


_RNG_TRACKER = RNGStatesTracker()


def get_rng_tracker():
    return _RNG_TRACKER


# torch-API alias (reference get_cuda_rng_tracker)
get_cuda_rng_tracker = get_rng_tracker


def model_parallel_rng(generator, group=None):
    """The dropout generator of this model-parallel shard (JAX
    ``model_parallel_rng``: the key folded with 2718 + the ``model``
    coordinate, the reference tracker's seed + 2718 + rank): a new
    generator on ``generator``'s device, seeded from its initial seed and
    ``group``'s rank (the engine's ``ModelParallelGroup``), so each shard
    draws its own masks; ``generator`` itself (not advanced) outside
    tensor parallelism. The port's GPT-2 and BERT do not use it: every
    model rank draws the replicated activations' masks alike and the
    attention's through the kernels' head-offset hash, as one process
    does."""
    if group is None or group.size == 1:
        return generator
    seed = (generator.initial_seed() * 1000003 + 2718 + group.rank) \
        % (2 ** 63)
    return torch.Generator(device=generator.device).manual_seed(seed)


def model_parallel_seed(seed, model_parallel_rank=0, device="cpu"):
    """Seed the default and model-parallel streams (reference
    model_parallel_cuda_manual_seed :224-263: the model-parallel stream's
    seed is seed + 2718 + rank)."""
    _RNG_TRACKER.reset()
    _RNG_TRACKER.add("default", seed, device=device)
    _RNG_TRACKER.add(_MODEL_PARALLEL_RNG_TRACKER_NAME,
                     seed + 2718 + model_parallel_rank, device=device)


model_parallel_cuda_manual_seed = model_parallel_seed
