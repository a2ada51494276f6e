"""Coordination primitives of the checkpoint and recovery paths.

Port of deepspeed_tpu/runtime/resilience/coordination.py over
``torch.distributed``'s default group (the engine's world) in place of
``jax.experimental.multihost_utils``. One discipline for every
multi-process phase: a rank that fails still reaches the next
collective, so errors are kept locally, the success flags are gathered
(the gather is itself a barrier), and every rank agrees on the outcome
before any proceeds or raises. With no process group, or a world of one,
every function passes its value through without a collective, as the
JAX functions do in one process.
"""
import numpy as np
import torch
import torch.distributed as dist

# the fixed buffer a tag name is broadcast in (collectives need one shape
# everywhere); tags are directory names, so NAME_MAX caps them at 255
# bytes, and longer ones are skipped by the caller, never truncated
TAG_BCAST_BYTES = 512


def _world():
    """The world's size, 1 without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _device():
    """The device a collective's tensor lives on: the rank's card under
    NCCL, the host under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _gather(values, dtype):
    """[world, len(values)] of every rank's ``values`` (one all-gather)."""
    t = torch.as_tensor(np.asarray(values), dtype=dtype, device=_device())
    out = [torch.empty_like(t) for _ in range(_world())]
    dist.all_gather(out, t)
    return torch.stack(out).cpu().numpy()


def all_agree(ok):
    """``(agreed, n_failed)``: agreed iff every rank reported success."""
    if _world() == 1:
        return bool(ok), 0 if ok else 1
    flags = _gather([int(bool(ok))], torch.int32)
    return bool(int(flags.min())), int(flags.size - flags.sum())


def any_flag(flag):
    """True when any rank set ``flag`` (a preemption landing on one rank
    first still stops every rank together)."""
    if _world() == 1:
        return bool(flag)
    return bool(int(_gather([int(bool(flag))], torch.int32).max()))


def min_int(value):
    """The smallest of every rank's ``value`` (the world an elastic
    restart agrees on)."""
    if _world() == 1:
        return int(value)
    return int(_gather([int(value)], torch.int64).min())


def gather_ints(arr):
    """``[world, *arr.shape]`` of every rank's integer array;
    ``arr[None]`` in one process."""
    arr = np.ascontiguousarray(np.asarray(arr, dtype=np.int64))
    if _world() == 1:
        return arr[None]
    flat = _gather(arr.reshape(-1), torch.int64)
    return flat.reshape((-1,) + arr.shape)


def broadcast_tag(name):
    """Rank 0's tag name (or None, the 'no more candidates' mark) on
    every rank."""
    if _world() == 1:
        return name or None
    buf = np.zeros(TAG_BCAST_BYTES, np.uint8)
    raw = str(name or "").encode()
    buf[:len(raw)] = np.frombuffer(raw, np.uint8)
    t = torch.as_tensor(buf, device=_device())
    dist.broadcast(t, src=0)
    return t.cpu().numpy().tobytes().rstrip(b"\0").decode() or None
