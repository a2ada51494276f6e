"""Joining the process group: the rendezvous of a data-parallel world.

Port of deepspeed_tpu/utils/distributed.py:18-125 (reference:
deepspeed/utils/distributed.py:12-108): the env-var rendezvous
(``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE`` /
``LOCAL_RANK``, as torchrun sets them) and MPI discovery. Here the world is
a ``torch.distributed`` process group with one process per device: NCCL
when the engine runs on CUDA (each process on ``cuda:LOCAL_RANK``), gloo
on the CPU. There is no fallback: on CUDA the backend is NCCL or the call
raises, and a world larger than the node's cards raises.

``grid_groups`` then lays the mesh's process grid (parallel/mesh.py
``ProcessGrid``) over the world: one process group per ``pipe``, ``data``
and ``seq`` line, in the world's backend; ``pipe_edge_groups`` and
``tie_groups`` the groups of a pipe line's links and tied layers.
"""
import os
from datetime import timedelta

import torch
import torch.distributed as dist

from deepspeed_tpu_torch.utils.logging import logger

_LOCAL_HOSTS = ("localhost", "127.0.0.1", "::1")


def init_distributed(dist_backend=None, auto_mpi_discovery=True,
                     distributed_port=29500, verbose=True, timeout=None,
                     device=None):
    """Join the world named by the environment; a no-op when the process
    group exists already or no world is named (a single-process run).

    ``device`` is the engine's device (default ``cuda``): CUDA takes NCCL
    and sets the current card to ``LOCAL_RANK``; ``cpu`` takes gloo.
    ``dist_backend``, when given, must be that backend, but for gloo over
    CUDA tensors where the node's ranks outnumber its cards (NCCL refuses
    two ranks on one device; each rank then takes card ``LOCAL_RANK``
    modulo the cards). ``timeout`` in seconds bounds the rendezvous and
    every collective."""
    if dist.is_initialized():
        return
    env = ("MASTER_ADDR", "RANK", "WORLD_SIZE")
    if not all(v in os.environ for v in env):
        if auto_mpi_discovery and in_mpi_environment():
            mpi_discovery(distributed_port, verbose)
        else:
            if verbose:
                logger.info("init_distributed: no MASTER_ADDR/RANK/"
                            "WORLD_SIZE; single-process run")
            return
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    addr = os.environ["MASTER_ADDR"]
    port = int(os.environ.get("MASTER_PORT", distributed_port))
    backend = _backend(dist_backend, device, world, local_rank, addr)
    if verbose:
        logger.info(f"init_distributed: backend={backend} rank={rank}/"
                    f"{world} local_rank={local_rank} at {addr}:{port}")
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = timedelta(seconds=timeout)
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            world_size=world, rank=rank, **kwargs)


def _backend(dist_backend, device, world, local_rank, addr):
    """The backend for ``device``, with its device checks; raises where
    the world cannot run as asked."""
    device = torch.device("cuda" if device is None else device)
    want = "nccl" if device.type == "cuda" else "gloo"
    if dist_backend == "gloo" and want == "nccl" \
            and torch.cuda.is_available() \
            and (_local_world(world, addr) or 1) \
            > torch.cuda.device_count():
        # ranks that share a card: gloo carries the CUDA tensors
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
        return "gloo"
    if dist_backend is not None and dist_backend != want:
        raise ValueError(f"dist_backend {dist_backend!r} on a {device.type} "
                         f"engine: the port runs {want} there (gloo on "
                         f"CUDA only where the node's ranks share its "
                         f"cards)")
    if want == "gloo":
        return want
    if not torch.cuda.is_available():
        raise RuntimeError("init_distributed on CUDA: CUDA is not available "
                           "(pass device='cpu' for a gloo world on the CPU)")
    cards = torch.cuda.device_count()
    local_world = _local_world(world, addr)
    if (local_world is not None and local_world > cards) \
            or local_rank >= cards:
        raise RuntimeError(
            f"a world of {local_world or world} processes on one node with "
            f"{cards} CUDA device(s): NCCL needs one device per process "
            f"(LOCAL_RANK {local_rank})")
    torch.cuda.set_device(local_rank)
    return want


def _local_world(world, addr):
    """The ranks on this node: ``LOCAL_WORLD_SIZE``, else the world when
    its rendezvous address is this host, else None (unknown)."""
    local_world = os.environ.get("LOCAL_WORLD_SIZE")
    return int(local_world) if local_world is not None \
        else (world if addr in _LOCAL_HOSTS else None)


def cards_shared() -> bool:
    """Whether this node's ranks outnumber its CUDA cards (a gloo world
    over CUDA tensors, ``init_distributed``)."""
    return torch.cuda.is_available() \
        and local_world_size() > torch.cuda.device_count()


def in_mpi_environment() -> bool:
    return any(v in os.environ for v in
               ["OMPI_COMM_WORLD_RANK", "PMI_RANK", "SLURM_PROCID"])


def mpi_discovery(distributed_port=29500, verbose=True):
    """(rank, world, master_addr) from the MPI/SLURM environment, written
    into the env-var contract (reference distributed.py:54-96). Without
    ``MASTER_ADDR`` rank 0's address is broadcast through mpi4py; raises
    when mpi4py is absent rather than guessing an address."""
    if "OMPI_COMM_WORLD_RANK" in os.environ:
        rank = int(os.environ["OMPI_COMM_WORLD_RANK"])
        world = int(os.environ["OMPI_COMM_WORLD_SIZE"])
        local = os.environ.get("OMPI_COMM_WORLD_LOCAL_RANK")
    elif "PMI_RANK" in os.environ:
        rank = int(os.environ["PMI_RANK"])
        world = int(os.environ["PMI_SIZE"])
        local = os.environ.get("MPI_LOCALRANKID")
    else:
        rank = int(os.environ["SLURM_PROCID"])
        world = int(os.environ["SLURM_NTASKS"])
        local = os.environ.get("SLURM_LOCALID")
    addr = os.environ.get("MASTER_ADDR")
    if addr is None:
        try:
            from mpi4py import MPI
        except ImportError as e:
            raise RuntimeError(
                "MPI discovery without MASTER_ADDR needs mpi4py to "
                "broadcast rank 0's address; set MASTER_ADDR or install "
                "mpi4py") from e
        import socket

        addr = MPI.COMM_WORLD.bcast(
            socket.gethostbyname(socket.gethostname()), root=0)
    os.environ.setdefault("RANK", str(rank))
    os.environ.setdefault("WORLD_SIZE", str(world))
    os.environ.setdefault("LOCAL_RANK", str(local if local is not None
                                            else rank))
    os.environ.setdefault("MASTER_ADDR", addr)
    os.environ.setdefault("MASTER_PORT", str(distributed_port))
    if verbose:
        logger.info(f"MPI discovery: rank={rank}/{world} master={addr}")
    return rank, world, addr


def grid_groups(grid):
    """{axis: this rank's group along it} for the grid's ``pipe``,
    ``data``, ``seq`` and ``model`` axes above size 1: None (the default
    group) where the line is the whole world, else a ``dist.new_group`` of
    the line. Every rank creates every line's group, in the same order,
    as ``new_group`` requires."""
    from deepspeed_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                                   PIPE_AXIS, SEQ_AXIS)

    out = {}
    for axis in (PIPE_AXIS, DATA_AXIS, SEQ_AXIS, MODEL_AXIS):
        size = grid.shape[axis]
        if size == 1:
            continue
        if size == grid.world:
            out[axis] = None
            continue
        for line in grid.lines(axis):
            group = dist.new_group(line)
            if grid.rank in line:
                out[axis] = group
    return out


def pipe_edge_groups(grid, num_chunks):
    """{(edge, kind): group} of this rank's pipe line: one two-rank group
    per chunk boundary (edge q joins global chunks q and q + 1, chunk q
    on stage q mod pipe) and per direction (``kind`` "act" forward,
    "grad" backward), as runtime/pipe/p2p.py ``DistLink`` needs. Every
    rank creates every line's groups, in the same order."""
    from deepspeed_tpu_torch.parallel.mesh import PIPE_AXIS

    P = grid.shape[PIPE_AXIS]
    out = {}
    for line in grid.lines(PIPE_AXIS):
        for edge in range(num_chunks - 1):
            pair = sorted((line[edge % P], line[(edge + 1) % P]))
            for kind in ("act", "grad"):
                group = dist.new_group(pair)
                if grid.rank in line:
                    out[(edge, kind)] = group
    return out


def tie_groups(grid, stage_sets):
    """{tie key: group} of this rank's pipe line: for each tie whose
    chunks lie on several stages (``stage_sets`` {key: sorted stages}),
    the group of those stages' ranks, where the tied gradients are summed.
    None for a tie this rank's stage does not hold. Every rank creates
    every line's groups, in the same order."""
    from deepspeed_tpu_torch.parallel.mesh import PIPE_AXIS

    out = {}
    for key in sorted(stage_sets):
        stages = stage_sets[key]
        out[key] = None
        for line in grid.lines(PIPE_AXIS):
            members = [line[s] for s in stages]
            group = dist.new_group(members)
            if grid.rank in members:
                out[key] = group
    return out


def hierarchical_groups(ranks, k, rank):
    """(intra, inter) process groups of ``rank`` over the line ``ranks``
    (global ranks in line order) cut into groups of k consecutive ranks:
    its intra group, and the group of the ranks that hold its place in
    theirs (hierarchical qgZ's two hops). Every rank of the world creates
    every group, in the same order, as ``new_group`` requires."""
    w = len(ranks)
    m = w // k
    intra = inter = None
    for o in range(m):
        members = ranks[o * k:(o + 1) * k]
        group = dist.new_group(members)
        if rank in members:
            intra = group
    for i in range(k):
        members = [ranks[o * k + i] for o in range(m)]
        group = dist.new_group(members)
        if rank in members:
            inter = group
    return intra, inter


def local_world_size() -> int:
    """The ranks of the world on this node: ``LOCAL_WORLD_SIZE`` (as
    torchrun sets it), else the whole world when its rendezvous address
    is this host, else 1."""
    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_WORLD_SIZE"])
    if os.environ.get("MASTER_ADDR", "localhost") in _LOCAL_HOSTS:
        return get_world_size()
    return 1


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1
