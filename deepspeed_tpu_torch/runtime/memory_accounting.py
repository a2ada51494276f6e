"""Analytic + measured device-memory accounting.

Port of deepspeed_tpu/runtime/memory_accounting.py. ``comm_accounting``
prices bytes on the wire; this module prices the resource that gates
what fits — device memory.  Two sides, cross-checked:

- **Analytic**: a pure shape/dtype per-component byte model (params /
  gradient accumulators / optimizer state / masters per ZeRO stage, the
  serving KV block pool, quantization scratch), and the engines' own
  components priced from the tensors they hold (``tensor_bytes``).  No
  device is touched, so the numbers are deterministic on any host.
- **Measured**: the CUDA caching allocator's counters
  (``torch.cuda.memory_stats``: ``allocated_bytes.all.current`` and
  ``.peak``; ``torch.cuda.mem_get_info`` for the limit) — host-side
  counters, read without a device sync.  Where the JAX package reads a
  compiled program's ``memory_analysis()``, the counterpart here is the
  measured TRANSIENT of a registered program: the allocator's peak over
  the program's window less the bytes in use at its start.  A window
  needs ``torch.cuda.reset_peak_memory_stats``; the counter is global,
  so :class:`MemoryAccounting` first folds the peak so far into its own
  running maximum, and its device peak (``device_peak_bytes``) is what
  ``max_memory_allocated`` would read had its windows not reset it (a
  reset made by someone else after the first window is not seen).  An
  engine that is not armed never touches the counter.
  On the CPU nothing is measured: the readers return None and the
  measured entries say ``modeled: False``.

Consumers: ``engine.memory_report()`` on both engines, the ``memory``
section of ``telemetry_report()``, the per-step ``mem`` gauges, and
``kv_cache.PagedKVPool.stats()`` (``kv_pool_bytes``).
"""
import threading
from typing import Optional, Sequence

import torch

from deepspeed_tpu_torch.runtime.comm_accounting import LeafSpec  # noqa: F401
from deepspeed_tpu_torch.runtime.quantization import (DEFAULT_BLOCK_SIZE,
                                                      block_layout)
from deepspeed_tpu_torch.utils.logging import logger

# the default analytic-vs-measured tolerance: an analytic estimate more
# than 15% under the measured number is a sizing hazard (budgets derived
# from it under-provision) and is warned about loudly
UNDERESTIMATE_TOLERANCE = 0.15


def _itemsize(dtype) -> int:
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return torch.empty((), dtype=dtype).element_size()


def _dtype_name(dtype) -> str:
    return dtype if isinstance(dtype, str) else str(dtype).split(".")[-1]


# ---------------------------------------------------------------------------
# measured side: the CUDA allocator's counters (None off CUDA)
# ---------------------------------------------------------------------------

def normalize_memory_stats(device_or_stats):
    """The allocator's counters of a device → ``{"bytes_in_use",
    "peak_bytes_in_use", "bytes_limit"}``, or None.

    Accepts a CUDA device (``torch.cuda.memory_stats`` and
    ``torch.cuda.mem_get_info`` are read), a ``memory_stats`` dict, or
    None.  Returns None for a CPU device or an empty dict — "no
    watermark" is a reportable fact, not an exception."""
    stats, limit = device_or_stats, None
    if isinstance(stats, (str, torch.device)):
        device = torch.device(stats)
        if device.type != "cuda":
            return None
        stats = torch.cuda.memory_stats(device)
        limit = torch.cuda.mem_get_info(device)[1]
    if not isinstance(stats, dict) or not stats:
        return None
    cur = stats.get("allocated_bytes.all.current")
    peak = stats.get("allocated_bytes.all.peak")
    return {"bytes_in_use": None if cur is None else int(cur),
            "peak_bytes_in_use": None if peak is None else int(peak),
            "bytes_limit": None if limit is None else int(limit)}


def device_memory_report(devices=None, peak_bytes=None):
    """Per-device snapshot: the allocator's in-use and peak bytes and the
    card's limit and headroom where there is an allocator, honest Nones
    where there is not (the CPU).  ``devices``: one device or a list
    (None: every visible CUDA device); ``peak_bytes`` overrides the
    counter's peak (an armed :class:`MemoryAccounting`'s running maximum,
    for a single device).  Cold-path builder — call it from reports."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())] \
            if torch.cuda.is_available() else [torch.device("cpu")]
    elif isinstance(devices, (str, torch.device)):
        devices = [devices]
    out = []
    for d in devices:
        d = torch.device(d)
        stats = normalize_memory_stats(d) or {}
        cuda = d.type == "cuda"
        entry = {
            "id": (d.index if d.index is not None
                   else torch.cuda.current_device()) if cuda else d.index,
            "kind": torch.cuda.get_device_name(d) if cuda else d.type,
            "platform": "gpu" if cuda else d.type,
            "bytes_in_use": stats.get("bytes_in_use"),
            "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
            "bytes_limit": stats.get("bytes_limit"),
        }
        if peak_bytes is not None and cuda:
            entry["peak_bytes_in_use"] = int(peak_bytes)
        if entry["bytes_limit"] and entry["bytes_in_use"] is not None:
            entry["headroom_bytes"] = \
                entry["bytes_limit"] - entry["bytes_in_use"]
        else:
            entry["headroom_bytes"] = None
        out.append(entry)
    return out


# ---------------------------------------------------------------------------
# analytic per-component model (pure shape math — no devices)
# ---------------------------------------------------------------------------

def bytes_of(shape: Sequence[int], dtype) -> int:
    """Bytes of one dense array of ``shape`` in ``dtype`` (a torch dtype
    or its name)."""
    n = 1
    for d in shape:
        n *= int(d)
    return n * _itemsize(dtype)


def leaf_device_bytes(leaf) -> int:
    """Bytes of one tensor as this process holds it: its own elements
    (a ZeRO shard is a tensor of the shard's shape, a view counts its
    own elements, not its base's)."""
    return leaf.numel() * leaf.element_size()


def tree_device_bytes(tree) -> int:
    """Bytes of every tensor in a (nested dict/list/tuple) tree; 0 for
    None/empty subtrees."""
    if tree is None:
        return 0
    if isinstance(tree, torch.Tensor):
        return leaf_device_bytes(tree)
    if isinstance(tree, dict):
        return sum(tree_device_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_device_bytes(v) for v in tree)
    return 0


def tensor_bytes(tensors) -> int:
    """Bytes of ``tensors`` (views of one buffer each by their own
    elements): the analytic components of the training engine's state
    (``DeepSpeedEngine._analytic_memory_components``)."""
    return sum(leaf_device_bytes(t) for t in tensors)


def _partitioned(leaf: LeafSpec, dp: int) -> bool:
    return (dp > 1 and leaf.shard_dim is not None
            and leaf.shape[leaf.shard_dim] % dp == 0)


def _leaves_bytes(leaves: Sequence[LeafSpec], dp: int, elem_bytes: int,
                  sharded: bool) -> int:
    """Per-device bytes of a param-shaped component: partitioned leaves
    divide by dp when the component is ZeRO-``sharded``; indivisible
    leaves stay whole either way."""
    total = 0
    for leaf in leaves:
        n = leaf.elements
        if sharded and _partitioned(leaf, dp):
            n //= dp
        total += n * elem_bytes
    return total


def quantization_scratch_bytes(leaves: Sequence[LeafSpec], dp: int,
                               block_size: int = DEFAULT_BLOCK_SIZE) -> int:
    """Transient scratch of one quantized collective in flight: the int8
    payload + fp32 per-block scales of the LARGEST leaf (collectives
    serialize on the wire, so one quantize buffer is live at a time).
    0 when nothing is partitioned."""
    worst = 0
    for leaf in leaves:
        if not _partitioned(leaf, dp):
            continue
        _, nb, npad = block_layout(leaf.elements, block_size)
        worst = max(worst, npad * 1 + nb * 4)
    return worst


def kv_pool_bytes(n_layer: int, num_blocks: int, n_head: int,
                  block_size: int, head_dim: int, *,
                  kv_dtype="bfloat16", quantized: bool = False,
                  shards: int = 1, shared_blocks: int = 0,
                  shared_refs: int = 1) -> int:
    """Per-shard device bytes of the serving paged KV pool: k + v of
    ``(L, num_blocks/shards, H, block_size, D)`` (int8 when quantized,
    else ``kv_dtype``, a torch dtype or its name) plus the two fp32
    per-(token, head)-row scale tensors int8 storage carries — byte-exact
    against the allocated tensors.  THE builder both
    ``PagedKVPool.stats()`` and the serving ``memory_report()`` price
    the pool through.

    Under prefix sharing, ``num_blocks`` may be the LOGICAL block demand
    of the workload: ``shared_blocks`` distinct blocks each mapped
    read-only by ``shared_refs`` requests are stored ONCE, so the
    physical pool shrinks by ``shared_blocks * (shared_refs - 1)``.  The
    defaults (no sharing) price exactly the allocated tensors."""
    assert shared_blocks >= 0 and shared_refs >= 1, \
        (shared_blocks, shared_refs)
    physical = num_blocks - shared_blocks * (shared_refs - 1)
    assert physical > 0, (num_blocks, shared_blocks, shared_refs)
    assert physical % shards == 0, (physical, shards)
    bps = physical // shards
    store = 1 if quantized else _itemsize(kv_dtype)
    kv = 2 * n_layer * bps * n_head * block_size * head_dim * store
    scales = 2 * n_layer * bps * n_head * block_size * 4 if quantized else 0
    return kv + scales


def sparse_kv_blocks_per_seq(n_positions: int, block_size: int, *,
                             num_sliding_window_blocks: int,
                             num_global_blocks: int = 1) -> int:
    """RESIDENT pool blocks one sequence of ``n_positions`` tokens holds
    under a sliding-window + global-anchor sparse page policy
    (serving/sparse_context.py) with window-expired reclamation: the
    ``num_global_blocks`` anchors stay pinned and only the trailing
    ``num_sliding_window_blocks`` window stays mapped.  Short sequences
    that never outgrow the window are priced at their dense
    footprint."""
    assert num_sliding_window_blocks >= 1 and num_global_blocks >= 0
    dense = -(-int(n_positions) // int(block_size))
    return min(dense, num_global_blocks + num_sliding_window_blocks)


def train_memory_report(leaves: Sequence[LeafSpec], dp: int, *,
                        zero_stage: int = 0,
                        compute_dtype="float32",
                        mixed_precision: Optional[bool] = None,
                        optimizer_slots: int = 2,
                        cpu_offload: bool = False,
                        quantized_gradients: bool = False,
                        block_size: int = DEFAULT_BLOCK_SIZE,
                        gathered_stage3_bytes: int = 0,
                        stash_bytes: int = 0,
                        extra_transient_bytes: int = 0) -> dict:
    """Analytic per-device bytes of one training configuration — pure
    shape math, the memory twin of ``comm_accounting.volume_report``.

    Components (bytes per device):

    - ``params``: compute dtype; ZeRO-sharded at rest under stage 3.
    - ``grad_accum``: fp32 accumulators; sharded under stage >= 2; ZERO
      under cpu_offload (grads stream to the host per micro).
    - ``master``: fp32 master copies under mixed precision (defaults to
      ``compute_dtype != float32``); sharded under stage >= 1; on the
      host under cpu_offload.
    - ``optimizer_state``: ``optimizer_slots`` fp32 param-shaped slots
      (Adam m+v = 2); sharded under stage >= 1; host under offload.
    - transients: ``gathered_stage3``, ``stash``, ``quantization_scratch``
      (the qgZ quantize buffer), plus any ``extra_transient_bytes`` the
      caller prices.

    ``peak_bytes = persistent + transient``.
    """
    compute_b = _itemsize(compute_dtype)
    if mixed_precision is None:
        mixed_precision = compute_b < 4
    components = {
        "params_bytes": _leaves_bytes(leaves, dp, compute_b,
                                      sharded=zero_stage >= 3),
        "grad_accum_bytes": 0 if cpu_offload else _leaves_bytes(
            leaves, dp, 4, sharded=zero_stage >= 2),
        "master_bytes": 0 if (cpu_offload or not mixed_precision)
        else _leaves_bytes(leaves, dp, 4, sharded=zero_stage >= 1),
        "optimizer_state_bytes": 0 if cpu_offload else
        optimizer_slots * _leaves_bytes(leaves, dp, 4,
                                        sharded=zero_stage >= 1),
    }
    transient = {
        "gathered_stage3_bytes": int(gathered_stage3_bytes),
        "stash_bytes": int(stash_bytes),
        "quantization_scratch_bytes": quantization_scratch_bytes(
            leaves, dp, block_size) if quantized_gradients else 0,
        "extra_transient_bytes": int(extra_transient_bytes),
    }
    persistent = sum(components.values())
    transient_total = sum(transient.values())
    return {
        "config": {
            "dp": dp, "zero_stage": zero_stage,
            "compute_dtype": _dtype_name(compute_dtype),
            "mixed_precision": bool(mixed_precision),
            "optimizer_slots": optimizer_slots,
            "cpu_offload": bool(cpu_offload),
        },
        "components": components,
        "transient": transient,
        "persistent_bytes": persistent,
        "transient_bytes": transient_total,
        "peak_bytes": persistent + transient_total,
    }


def train_state_bytes(numel: int, compute_dtype, *, optimizer_slots=2,
                      cpu_offload: bool = False) -> dict:
    """Analytic persistent bytes of one training process at dp 1 for
    ``numel`` parameters (``train_memory_report`` at dp 1 without
    transients, with the host side spelled out): on the device the
    compute-dtype parameters, the fp32 gradient accumulator, the fp32
    master under mixed precision and ``optimizer_slots`` fp32 slots
    (Adam's m and v); under ``cpu_offload`` the last three are host bytes
    instead, the master at any precision (the host Adam steps a copy of
    its own)."""
    compute = _itemsize(compute_dtype)
    fp32 = 4 * numel
    state = {"grad_accum_bytes": fp32,
             "master_bytes": fp32 if compute < 4 or cpu_offload else 0,
             "optimizer_state_bytes": optimizer_slots * fp32}
    device = dict({"params_bytes": compute * numel},
                  **({k: 0 for k in state} if cpu_offload else state))
    host = state if cpu_offload else {k: 0 for k in state}
    return {"components": device,
            "persistent_bytes": sum(device.values()),
            "host": host, "host_bytes": sum(host.values())}


# ---------------------------------------------------------------------------
# measured side: per-program windows over the allocator's peak
# ---------------------------------------------------------------------------

class MemoryAccounting:
    """Per-program measured-memory registry + cross-check ledger over the
    CUDA allocator of ``device`` (see the module docstring).

    ``begin(name)`` / ``end(name)`` bracket one run of a registered
    program: its transient is the allocator's peak over the window less
    the bytes in use at its start (the largest over the runs is kept).
    ``note(name, **fields)`` records other measured fields (the bytes in
    use at a step boundary).  Reads are host-side counters, never a
    device sync; off CUDA every call is a no-op and the entries read
    ``modeled: False``."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._progs = {}     # name -> (calls/step, argument bytes)
        self._measured = {}  # name -> measured fields
        self._open = {}      # name -> bytes in use at the window's start
        self._peak_seen = 0  # the allocator's peak before each reset
        self._expect = {}    # name -> expectation dict
        self._checked = {}   # name -> cross-check verdict
        self._lock = threading.Lock()

    def register(self, name, calls_per_step=1.0, argument_bytes=None):
        with self._lock:
            if name not in self._progs:
                self._progs[name] = (float(calls_per_step), argument_bytes)

    # -- windows --------------------------------------------------------
    def begin(self, name):
        """Open ``name``'s window: the peak so far is folded into the
        running maximum, then the allocator's peak is reset."""
        if not self.cuda:
            return
        dev = self.device
        self._peak_seen = max(self._peak_seen,
                              torch.cuda.max_memory_allocated(dev))
        torch.cuda.reset_peak_memory_stats(dev)
        self._open[name] = torch.cuda.memory_allocated(dev)

    def end(self, name):
        """Close ``name``'s window (a no-op when none is open)."""
        start = self._open.pop(name, None)
        if start is None:
            return
        peak = torch.cuda.max_memory_allocated(self.device)
        e = self._measured.setdefault(name, {"transient_bytes": 0,
                                             "peak_bytes": 0, "windows": 0})
        e["transient_bytes"] = max(e["transient_bytes"], peak - start)
        e["peak_bytes"] = max(e["peak_bytes"], peak)
        e["start_bytes"] = start
        e["windows"] += 1

    def note(self, name, **fields):
        """Record measured ``fields`` of ``name`` (registering it)."""
        self.register(name)
        self._measured.setdefault(name, {}).update(fields)

    def device_peak_bytes(self):
        """What ``max_memory_allocated`` would read had no window reset
        it (None off CUDA)."""
        if not self.cuda:
            return None
        return max(self._peak_seen,
                   torch.cuda.max_memory_allocated(self.device))

    # -- reports --------------------------------------------------------
    def measured_memory(self):
        """{name: measured fields + calls_per_step + analytic argument
        bytes + ``modeled``} for every registered program."""
        with self._lock:
            progs = dict(self._progs)
        out = {}
        for name, (calls, arg_bytes) in progs.items():
            entry = dict(self._measured.get(name, {}))
            entry["calls_per_step"] = calls
            entry["analytic_argument_bytes"] = arg_bytes
            entry["modeled"] = self.cuda and bool(self._measured.get(name))
            out[name] = entry
        return out

    def expect(self, name, label, analytic_bytes,
               field="transient_bytes", tolerance=UNDERESTIMATE_TOLERANCE):
        """Record an analytic claim about one program or state:
        ``analytic_bytes`` (or a zero-arg callable resolved at
        cross-check time) against its measured ``field``; the cross-check
        warns loudly on a > ``tolerance`` underestimate."""
        self._expect[name] = {"label": label, "analytic": analytic_bytes,
                              "field": field, "tolerance": float(tolerance)}
        self._checked.pop(name, None)

    def cross_check(self, warn=True):
        """Resolve every armed expectation against the measured side.

        Returns ``{name: {"label", "field", "analytic_bytes",
        "measured_bytes", "ratio", "underestimated"}}``.  A measured value
        more than ``tolerance`` over the analytic claim means the model
        under-provisions — warned per name (once)."""
        measured = self.measured_memory()
        for name, exp in self._expect.items():
            if name in self._checked:
                continue
            entry = measured.get(name)
            if entry is None or entry.get(exp["field"]) is None:
                continue        # not run yet / not measured: retry later
            analytic = exp["analytic"]
            if callable(analytic):
                try:
                    analytic = analytic()
                except Exception as e:  # one claim's failure must not
                    # kill the whole memory report
                    self._checked[name] = {
                        "label": exp["label"], "field": exp["field"],
                        "analytic_bytes": None,
                        "measured_bytes": entry[exp["field"]],
                        "ratio": None, "underestimated": False,
                        "error": f"{type(e).__name__}: {e}"}
                    continue
            got = entry[exp["field"]]
            ratio = got / analytic if analytic else None
            under = bool(analytic) and got > analytic * (1 + exp["tolerance"])
            self._checked[name] = {
                "label": exp["label"], "field": exp["field"],
                "analytic_bytes": int(analytic) if analytic else analytic,
                "measured_bytes": got, "ratio": ratio,
                "underestimated": under,
            }
            if under and warn:
                logger.warning(
                    "memory accounting: the analytic model UNDERESTIMATES "
                    "%s (%s): measured %s = %d B vs analytic %d B (> %.0f%% "
                    "over); treat budgets sized from this estimate as "
                    "DISARMED until the model is re-derived",
                    name, exp["label"], exp["field"], got, int(analytic),
                    100 * exp["tolerance"])
        return dict(self._checked)


# ---------------------------------------------------------------------------
# report builder (cold path)
# ---------------------------------------------------------------------------

def memory_report(*, analytic=None, accounting=None, devices=None,
                  extra=None):
    """Assemble the unified memory report every engine surface uses:

    - ``analytic``: the caller's component model (engine state bytes or
      :func:`train_memory_report` output);
    - ``measured``: per-program transients and noted fields +
      expectation cross-checks, when a :class:`MemoryAccounting` is
      armed;
    - ``devices``: the allocator's in-use/peak bytes + headroom (the
      peak is the armed accounting's running maximum).
    """
    peak = accounting.device_peak_bytes() if accounting is not None \
        else None
    report = {
        "armed": accounting is not None,
        "analytic": analytic,
        "devices": device_memory_report(devices, peak_bytes=peak),
    }
    if accounting is not None:
        report["measured"] = accounting.measured_memory()
        report["cross_check"] = accounting.cross_check()
    if extra:
        report.update(extra)
    return report
