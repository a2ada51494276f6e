"""Contract checks over one observed dispatch of a program.

Port of tools/graftlint/hlo_contracts.py. The JAX helpers read a
contract off a jit's compiled HLO text; the port has no HLO, so the
program lint (telemetry/program_lint.py) observes one real dispatch of
each registered program and reads the contract off that record. Each
check below is a pure function over an :class:`Observation`, so every
rule can be tested on records built by hand, as the JAX checks are
functions over HLO text.

What a dispatch is observed with (:class:`Observer`):

- a ``TorchDispatchMode`` that sees every aten op of the dispatch, on
  the CPU and on the card alike (the backward's too: autograd carries
  the mode into its threads). Host reads are ``aten._local_scalar_dense``
  (``.item()``, ``float(t)``, ``bool(t)``), a device-to-host copy that is
  blocking or whose destination is not pinned, and the ops whose output
  shape depends on the data (``nonzero``, ``masked_select``, ``unique``,
  indexing by a bool mask);
- on the card, ``torch.cuda.set_sync_debug_mode("error")`` around the
  same dispatch, a second witness: an op that synchronizes the host with
  the device is recorded (and run again with the mode off, so that the
  dispatch completes);
- the collectives in the order they were posted, read off the
  dispatcher's ``c10d`` ops: every collective of the dispatch, whether
  ``DataParallelGroup`` (parallel/mesh.py) counts it or a raw
  ``torch.distributed`` call posts it, as the JAX HLO holds every
  collective of the program. A gather or scatter's size is its output's
  (the first tensor of ``_allgather_base_`` and ``_reduce_scatter_base_``);
  its bytes are its elements', but an all-to-all's, which are what this
  rank sends to the others, (w-1)/w of its buffer over a group of w
  (runtime/comm_accounting.py's ring model);
- the ``data_ptr()`` of every tensor of the program's state arguments
  before the dispatch and after it (read again from the live views), and
  the outputs' dtypes and whether each lives in that state's storage.

Nothing here runs unless the lint armed the registry; the observed
dispatch runs the same operations as an unobserved one.
"""
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from deepspeed_tpu_torch.runtime.comm_accounting import (DTYPE_BYTES,
                                                         all_to_all_bytes,
                                                         dtype_name)
from deepspeed_tpu_torch.telemetry.programs import named_tensors

# torch dtype names -> the HLO names the JAX package's program contracts
# speak (``wire_dtype``, ``expect_op_counts``)
HLO_DTYPE = {"float64": "f64", "float32": "f32", "float16": "f16",
             "bfloat16": "bf16", "int64": "s64", "int32": "s32",
             "int16": "s16", "int8": "s8", "uint8": "u8", "bool": "pred"}
_HLO_BYTES = {hlo: DTYPE_BYTES[name] for name, hlo in HLO_DTYPE.items()}

_aten = torch.ops.aten
# ops whose output shape depends on the values of their input: the host
# must read the device to size the result
_DATA_DEPENDENT = {
    _aten.nonzero.default, _aten.masked_select.default,
    _aten._unique2.default, _aten.unique_dim.default,
    _aten.unique_consecutive.default, _aten.equal.default,
}
_BOOL_INDEXED = {_aten.index.Tensor, _aten.index_put.default,
                 _aten.index_put_.default}
_SYNC_ERROR = "synchronizing CUDA operation"
# c10d op names -> the HLO collective names of the contracts
_C10D_OPS = (("allreduce", "all-reduce"), ("allgather", "all-gather"),
             ("reduce_scatter", "reduce-scatter"), ("alltoall", "all-to-all"),
             ("broadcast", "broadcast"), ("send", "collective-permute"),
             ("recv", "collective-permute"))


class CollectiveOp(NamedTuple):
    op: str
    dtype: str
    elements: int
    bytes: int


class Observation(NamedTuple):
    """What one observed dispatch did. ``donated``: {name: (data_ptr
    before, data_ptr after or None if the tensor is gone, elements)} of
    every tensor of the program's state arguments; ``aliased``: the
    indices of the outputs whose storage is one of those tensors'."""
    host_reads: Tuple[str, ...] = ()
    collectives: Tuple[CollectiveOp, ...] = ()
    donated: Dict[str, tuple] = {}
    output_dtypes: Tuple[str, ...] = ()
    aliased: frozenset = frozenset()


def collective(op, dtype, elements, group_size=None):
    """A ``CollectiveOp`` from an HLO dtype name and an element count (a
    gather's or scatter's output), priced at the elements' bytes; an
    all-to-all over a group of known size ``group_size`` at what this
    rank sends, the (w-1)/w of its buffer bound for the other ranks (the
    JAX HLO's all-to-all has one operand per peer, and the JAX lint reads
    one of them)."""
    es = _HLO_BYTES.get(dtype, 4)
    n = int(elements)
    if op == "all-to-all" and group_size:
        return CollectiveOp(op=op, dtype=dtype, elements=n,
                            bytes=all_to_all_bytes(n, es, group_size))
    return CollectiveOp(op=op, dtype=dtype, elements=n, bytes=n * es)


def _group_size(args):
    """The size of the process group among a c10d op's arguments, or
    None."""
    from torch.distributed.distributed_c10d import ProcessGroup

    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return ProcessGroup.unbox(a).size()
            except Exception:   # not a process group
                continue
    return None


# ---------------------------------------------------------------------------
# the checks: pure functions over an Observation
# ---------------------------------------------------------------------------

def collective_ops(obs: Observation) -> List[CollectiveOp]:
    """Every collective of the dispatch, in posting order."""
    return list(obs.collectives)


def host_transfer_ops(obs: Observation) -> List[str]:
    """What the dispatch read back to the host."""
    return list(obs.host_reads)


def moved_donations(obs: Observation, names, min_elements=0) -> List[str]:
    """The declared-donated tensors that were not updated in place: their
    storage moved, or the live state no longer has them (a name never
    seen is missing too). Tensors under ``min_elements`` are exempt."""
    out = []
    for name in sorted(set(names)):
        before, after, n = obs.donated.get(name, (None, None, None))
        if n is not None and n < min_elements:
            continue
        if before is None or after != before:
            out.append(name)
    return out


def aliased_outputs(obs: Observation) -> set:
    return set(obs.aliased)


def entry_output_dtypes(obs: Observation) -> Optional[List[str]]:
    return list(obs.output_dtypes)


# ---------------------------------------------------------------------------
# observing one dispatch
# ---------------------------------------------------------------------------

def _host_read(func, args, kwargs) -> Optional[str]:
    """Why ``func`` on these arguments reads the device back to the host,
    or None."""
    if func is _aten._local_scalar_dense.default:
        return f"{func} (a tensor's value read on the host: .item())"
    if func in _DATA_DEPENDENT:
        return f"{func} (its output shape depends on the data)"
    if func in _BOOL_INDEXED and any(
            isinstance(i, torch.Tensor) and i.dtype == torch.bool
            for i in (args[1] if len(args) > 1 else ()) or ()):
        return f"{func} (indexed by a bool mask: its shape depends on " \
               f"the data)"
    if func is _aten._to_copy.default:
        src, dev = args[0], kwargs.get("device")
        if src.is_cuda and dev is not None \
                and torch.device(dev).type == "cpu" \
                and not kwargs.get("non_blocking", False):
            return f"{func} (a blocking device-to-host copy)"
    if func in (_aten.copy_.default, _aten.copy.default):
        dst, src = args[0], args[1]
        if isinstance(src, torch.Tensor) and src.is_cuda \
                and dst.device.type == "cpu":
            blocking = not (args[2] if len(args) > 2
                            else kwargs.get("non_blocking", False))
            if blocking or not dst.is_pinned():
                return f"{func} (a device-to-host copy, " + \
                    ("blocking)" if blocking else "into pageable memory)")
    return None


def _c10d_collective(func, args) -> Optional[CollectiveOp]:
    name = func.name()
    if not name.startswith("c10d::"):
        return None
    op = next((hlo for key, hlo in _C10D_OPS if key in name), None)
    if op is None:
        return None
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    for a in args:
        if isinstance(a, (list, tuple)):
            tensors += [t for t in a if isinstance(t, torch.Tensor)]
    if not tensors:
        return collective(op, "f32", 0)
    t = tensors[0]
    return collective(op, HLO_DTYPE.get(dtype_name(t.dtype), "f32"),
                      t.numel(), _group_size(args))


class _ObserveMode(TorchDispatchMode):
    """Records the host reads and the ``c10d`` collectives of every op;
    on the card, a synchronizing op caught by the sync debug mode is
    recorded and run again with the mode off."""

    def __init__(self, reads, c10d):
        super().__init__()
        self.reads, self.c10d = reads, c10d

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        why = _host_read(func, args, kwargs)
        if why is not None:
            self.reads.append(why)
        coll = _c10d_collective(func, args)
        if coll is not None:
            self.c10d.append(coll)
        if why is not None and _sync_debug_mode() != 0:
            with _sync_debug(0):
                return func(*args, **kwargs)
        try:
            return func(*args, **kwargs)
        except RuntimeError as e:
            if _SYNC_ERROR not in str(e):
                raise
            self.reads.append(f"{func} (set_sync_debug_mode: "
                              f"{str(e).splitlines()[0]})")
            with _sync_debug(0):
                return func(*args, **kwargs)


def _sync_debug_mode():
    return torch.cuda.get_sync_debug_mode() if torch.cuda.is_available() \
        else 0


class _sync_debug:
    def __init__(self, mode):
        self.mode = mode

    def __enter__(self):
        self.prev = _sync_debug_mode()
        if torch.cuda.is_available():
            torch.cuda.set_sync_debug_mode(self.mode)

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.set_sync_debug_mode(self.prev)
        return False


def _ptrs(args) -> Dict[str, tuple]:
    """{name: (data_ptr, elements)} of the dispatch's state arguments,
    read from the live views now."""
    out = {}
    for argnum, arg in enumerate(args):
        for name, t in named_tensors(arg, argnum).items():
            out[name] = (t.data_ptr(), t.numel())
    return out


class Observer:
    """Observes one dispatch of ``entry`` (a ``ProgramEntry``) given
    ``args`` (the dispatch's arguments, as ``register_program`` takes
    them): as a context manager around it, or ``start()``/``stop()``
    around each part of a program that spans two calls and ``close()``
    after the last part. ``close()`` stores the :class:`Observation` in
    ``entry.observation``."""

    def __init__(self, entry, args=()):
        self.entry = entry
        self.args = tuple(args)
        self._before = None
        self._reads, self._c10d = [], []
        self._dtypes, self._aliased = [], set()
        self._open = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.stop()
        if exc_type is None:
            self.close()
        return False

    def start(self):
        if self._before is None:
            self._before = _ptrs(self.args)
        mode = _ObserveMode(self._reads, self._c10d)
        debug = _sync_debug("error")
        debug.__enter__()
        mode.__enter__()
        self._open = (mode, debug)

    def stop(self):
        mode, debug = self._open
        self._open = None
        mode.__exit__(None, None, None)
        debug.__exit__(None, None, None)

    def outputs(self, *tensors):
        """Note the dispatch's outputs: their dtypes, and which live in
        the storage of the state it was given."""
        before = {ptr for ptr, _ in (self._before or {}).values()}
        storages = set()
        for argnum, arg in enumerate(self.args):
            for t in named_tensors(arg, argnum).values():
                if t.data_ptr() in before:
                    storages.add(t.untyped_storage().data_ptr())
        for t in tensors:
            if t is None:
                continue
            i = len(self._dtypes)
            self._dtypes.append(HLO_DTYPE.get(dtype_name(t.dtype),
                                              dtype_name(t.dtype)))
            if t.untyped_storage().data_ptr() in storages:
                self._aliased.add(i)

    def close(self):
        after = _ptrs(self.args)
        donated = {name: (ptr, after.get(name, (None,))[0], n)
                   for name, (ptr, n) in self._before.items()}
        self.entry.observation = Observation(
            host_reads=tuple(self._reads), collectives=tuple(self._c10d),
            donated=donated, output_dtypes=tuple(self._dtypes),
            aliased=frozenset(self._aliased))
