"""Analytic communication volume of the data-parallel step, and a counter
of the collectives the engine issues.

Port of the dense subset of deepspeed_tpu/runtime/comm_accounting.py
(:39-100 dtypes, ``Collective``, ring bytes, ``LeafSpec``; :111-184
``grad_exchange_collectives``; :360-496 ``param_gather_collectives`` and
``volume_report``; :674-684 ``zero_shard_dim``): the bytes each rank sends
per collective and per optimizer step, from shapes, dtypes and the world
size alone. The quantized wires (qgZ, qwZ, 0/1 Adam) are ROADMAP A13.

``CollectiveCounter`` is the measured side: the engine's process-group
wrapper (parallel/mesh.py) records every collective it issues, leaf by
leaf, in the same ``Collective`` records, so that a step's count can be
held against the report.
"""
from dataclasses import asdict, dataclass
from typing import List, Optional, Sequence, Tuple

DTYPE_BYTES = {
    "float64": 8, "float32": 4, "float16": 2, "bfloat16": 2,
    "int64": 8, "int32": 4, "int16": 2, "int8": 1, "uint8": 1, "bool": 1,
}


def dtype_bytes(dtype) -> int:
    """Bytes of one element of ``dtype`` (a torch dtype or its name)."""
    name = str(dtype).replace("torch.", "")
    if name not in DTYPE_BYTES:
        raise KeyError(f"unknown dtype {name!r} for comm accounting")
    return DTYPE_BYTES[name]


def dtype_name(dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``: the report's dtype names."""
    return str(dtype).replace("torch.", "")


@dataclass
class Collective:
    """One logical collective: ``bytes_per_device`` is the wire traffic each
    participating device SENDS per invocation; ``count_per_step`` scales it
    to one optimizer step (e.g. gradient-accumulation micro-steps)."""
    name: str            # e.g. "grad_rs:h_0/attn/c_attn/kernel"
    op: str              # all-reduce | reduce-scatter | all-gather |
    #                      all-to-all | collective-permute | broadcast
    dtype: str
    elements: int        # logical elements moved (pre-ring-factor)
    axis_size: int
    bytes_per_device: int
    count_per_step: int = 1
    link: str = "flat"

    @property
    def bytes_per_step(self) -> int:
        return self.bytes_per_device * self.count_per_step


def _ring(w: int) -> float:
    return (w - 1) / w if w > 1 else 0.0


def allreduce_bytes(n: int, elem_bytes: int, w: int) -> int:
    return int(round(2 * _ring(w) * n * elem_bytes))


def reduce_scatter_bytes(n: int, elem_bytes: int, w: int) -> int:
    return int(round(_ring(w) * n * elem_bytes))


def all_gather_bytes(n: int, elem_bytes: int, w: int) -> int:
    return int(round(_ring(w) * n * elem_bytes))


def all_to_all_bytes(n: int, elem_bytes: int, w: int) -> int:
    """An even all-to-all of n elements per device sends all but its own
    chunk."""
    return int(round(_ring(w) * n * elem_bytes))


def collective_permute_bytes(n: int, elem_bytes: int, w: int) -> int:
    """One hop of a ring: every device sends its n elements to the
    next."""
    return n * elem_bytes if w > 1 else 0


def broadcast_bytes(n: int, elem_bytes: int, w: int) -> int:
    """A pipelined ring broadcast: every device but the last forwards the
    n elements, (w - 1) / w of them per device on average."""
    return int(round(_ring(w) * n * elem_bytes))


_RING_BYTES = {"all-reduce": allreduce_bytes,
               "reduce-scatter": reduce_scatter_bytes,
               "all-gather": all_gather_bytes,
               "all-to-all": all_to_all_bytes,
               "collective-permute": collective_permute_bytes,
               "broadcast": broadcast_bytes}


@dataclass
class LeafSpec:
    """Shape/sharding facts the accounting needs about one gradient/param
    leaf.  ``shard_dim`` is the dimension the ZeRO spec shards over 'data'
    (None = leaf stays replicated and its gradient all-reduces densely)."""
    name: str
    shape: Tuple[int, ...]
    shard_dim: Optional[int]

    @property
    def elements(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n


def _refuse_quantized(quantized):
    if quantized:
        raise NotImplementedError("quantized ZeRO collectives (qgZ/qwZ) are "
                                  "not ported yet (ROADMAP A13)")


def grad_exchange_collectives(
        leaves: Sequence[LeafSpec], dp: int, *, quantized: bool = False,
        count_per_step: int = 1) -> List[Collective]:
    """Per-leaf collectives of one gradient exchange (one micro-step):
    shardable leaves reduce-scatter in fp32 (the accumulator's dtype);
    unshardable leaves all-reduce."""
    _refuse_quantized(quantized)
    grad_dtype = "float32"
    es = DTYPE_BYTES[grad_dtype]
    out: List[Collective] = []
    for leaf in leaves:
        n = leaf.elements
        if leaf.shard_dim is None or dp <= 1:
            out.append(Collective(
                name=f"grad_ar:{leaf.name}", op="all-reduce",
                dtype=grad_dtype, elements=n, axis_size=dp,
                bytes_per_device=allreduce_bytes(n, es, dp),
                count_per_step=count_per_step))
        else:
            out.append(Collective(
                name=f"grad_rs:{leaf.name}", op="reduce-scatter",
                dtype=grad_dtype, elements=n, axis_size=dp,
                bytes_per_device=reduce_scatter_bytes(n, es, dp),
                count_per_step=count_per_step))
    return out


def param_gather_collectives(
        leaves: Sequence[LeafSpec], dp: int, *, quantized: bool = False,
        param_dtype: str = "bfloat16",
        count_per_step: int = 1) -> List[Collective]:
    """Collectives of the per-step parameter materialization: one
    all-gather in the compute dtype per shardable leaf, back to the
    replicated compute layout."""
    _refuse_quantized(quantized)
    es = DTYPE_BYTES[param_dtype]
    out: List[Collective] = []
    for leaf in leaves:
        if leaf.shard_dim is None or dp <= 1:
            continue                     # replicated leaf: nothing to gather
        n = leaf.elements
        out.append(Collective(
            name=f"param_ag:{leaf.name}", op="all-gather",
            dtype=param_dtype, elements=n, axis_size=dp,
            bytes_per_device=all_gather_bytes(n, es, dp),
            count_per_step=count_per_step))
    return out


def _as_dicts(collectives):
    return [asdict(c) | {"bytes_per_step": c.bytes_per_step}
            for c in collectives]


def volume_report(leaves: Sequence[LeafSpec], dp: int, *, gas: int = 1,
                  quantized_gradients: bool = False,
                  quantized_weights: bool = False,
                  param_dtype: str = "bfloat16",
                  gather_params: bool = True) -> dict:
    """Full per-step report for one configuration (one parameter gather
    per step, stages 1 and 2), with the dense-fp32 baseline alongside
    (the same numbers on the dense wire)."""
    _refuse_quantized(quantized_gradients or quantized_weights)
    grads = grad_exchange_collectives(leaves, dp, count_per_step=gas)
    params = param_gather_collectives(
        leaves, dp, param_dtype=param_dtype) if gather_params else []
    grad_bytes = sum(c.bytes_per_step for c in grads)
    param_bytes = sum(c.bytes_per_step for c in params)
    return {
        "config": {
            "dp": dp, "gas": gas,
            "quantized_gradients": False, "quantized_weights": False,
            "param_dtype": param_dtype,
            "param_gathers_per_step": 1,
        },
        "collectives": _as_dicts(grads + params),
        "grad_exchange_bytes_per_step": grad_bytes,
        "param_gather_bytes_per_step": param_bytes,
        "param_gather_quantized_bytes_per_step": 0,
        "param_gather_dense_bytes_per_step": param_bytes,
        "total_bytes_per_step": grad_bytes + param_bytes,
        "inter_bytes_per_step": 0,
        "baseline": {
            "fp32_grad_exchange_bytes_per_step": grad_bytes,
            "fp32_reduce_scatter_bytes_per_step": sum(
                c.bytes_per_step for c in grads
                if c.op == "reduce-scatter"),
            "dense_param_gather_bytes_per_step": param_bytes,
        },
        "grad_reduction_vs_fp32": 1.0 if grad_bytes else None,
    }


def zero_shard_dim(shape: Sequence[int], dp: int,
                   taken: Sequence[int] = ()) -> Optional[int]:
    """The dimension mesh.zero_merge_spec would shard over 'data': the
    largest dim (not in ``taken``) divisible by dp; None if nothing fits."""
    best_dim, best = None, 0
    for d, s in enumerate(shape):
        if d in taken:
            continue
        if dp > 1 and s % dp == 0 and s > best:
            best_dim, best = d, s
    return best_dim


class CollectiveCounter:
    """The collectives a process group issued, leaf by leaf, as
    ``Collective`` records summed per name since the last ``take()``;
    ``calls`` counts the calls made (a bucket carrying many leaves is one
    call), ``scalars`` the small flag, norm and loss reductions, which
    the volume report does not price."""

    def __init__(self):
        self._open = {}
        self.calls = {}
        self.scalars = 0

    def record(self, op, prefix, dtype, leaves, axis_size):
        """One call of ``op`` carrying ``leaves`` [(name, elements)]."""
        self.calls[op] = self.calls.get(op, 0) + 1
        es = dtype_bytes(dtype)
        for name, n in leaves:
            key = f"{prefix}:{name}"
            c = self._open.get(key)
            if c is None:
                self._open[key] = Collective(
                    name=key, op=op, dtype=dtype_name(dtype), elements=n,
                    axis_size=axis_size,
                    bytes_per_device=_RING_BYTES[op](n, es, axis_size))
            else:
                c.count_per_step += 1

    def record_scalar(self):
        self.scalars += 1

    def take(self) -> dict:
        """What was issued since the last take, and reset: ``collectives``
        in the report's record format, ``calls`` and ``scalars``."""
        out = {"collectives": _as_dicts(self._open.values()),
               "calls": dict(self.calls), "scalars": self.scalars}
        out["bytes_per_step"] = sum(c["bytes_per_step"]
                                    for c in out["collectives"])
        self._open, self.calls, self.scalars = {}, {}, 0
        return out
