"""Analytic communication volume of the data-parallel step, and a counter
of the collectives the engine issues.

Port of deepspeed_tpu/runtime/comm_accounting.py (:39-100 dtypes,
``Collective``, ring bytes, ``LeafSpec``; :102-184 ``_qgz_wire`` and
``grad_exchange_collectives``, dense and qgZ, flat and hierarchical;
:360-496 ``param_gather_collectives`` (dense and qwZ) and
``volume_report``; :674-684 ``zero_shard_dim``): the bytes each rank sends
per collective and per optimizer step, from shapes, dtypes and the world
size alone. The quantized payloads follow ``quantization.block_layout``,
so the accounting is byte-exact against what the quantizers put on the
wire. The 0/1 Adam wire (``zeroone_*``) is ROADMAP A13b.

``CollectiveCounter`` is the measured side: the engine's process-group
wrapper (parallel/mesh.py) records every collective it issues, leaf by
leaf, in the same ``Collective`` records, so that a step's count can be
held against the report.
"""
from dataclasses import asdict, dataclass
from typing import List, Optional, Sequence, Tuple

from deepspeed_tpu_torch.runtime.quantization import (DEFAULT_BLOCK_SIZE,
                                                      block_layout)

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


def _qgz_wire(n_rows: int, row_len: int, block_size: int, w: int):
    """(int8_bytes, scale_bytes) one rank sends for an all_to_all of
    ``n_rows`` independently-quantized rows of ``row_len`` elements over a
    group of size ``w`` — mirrors quantization.quantize_rows exactly."""
    _, nb, npad = block_layout(row_len, block_size)
    return (all_to_all_bytes(n_rows * npad, 1, w),
            all_to_all_bytes(n_rows * nb, 4, w))


def grad_exchange_collectives(
        leaves: Sequence[LeafSpec], dp: int, *,
        quantized: bool = False,
        block_size: int = DEFAULT_BLOCK_SIZE,
        intra_size: int = 0,
        grad_dtype: str = "float32",
        count_per_step: int = 1) -> List[Collective]:
    """Per-leaf collectives of one gradient exchange (one micro-step).

    Dense (the stage-2 baseline): shardable leaves reduce-scatter in
    ``grad_dtype`` (the fp32 accumulator dtype); unshardable leaves
    all-reduce.  Quantized (qgZ): shardable leaves move int8 + fp32 scales
    through one flat all_to_all, or two hierarchical hops when
    1 < intra_size < dp divides dp (the inter hop carries 1/intra_size of
    the data, re-quantized).
    """
    es = DTYPE_BYTES[grad_dtype]
    out: List[Collective] = []
    k = int(intra_size or 0)
    hier = quantized and 1 < k < dp and dp % k == 0
    for leaf in leaves:
        n = leaf.elements
        if leaf.shard_dim is None or dp <= 1:
            out.append(Collective(
                name=f"grad_ar:{leaf.name}", op="all-reduce",
                dtype=grad_dtype, elements=n, axis_size=dp,
                bytes_per_device=allreduce_bytes(n, es, dp),
                count_per_step=count_per_step))
            continue
        if not quantized:
            out.append(Collective(
                name=f"grad_rs:{leaf.name}", op="reduce-scatter",
                dtype=grad_dtype, elements=n, axis_size=dp,
                bytes_per_device=reduce_scatter_bytes(n, es, dp),
                count_per_step=count_per_step))
            continue
        if not hier:
            nloc = n // dp
            qb, sb = _qgz_wire(dp, nloc, block_size, dp)
            out.append(Collective(
                name=f"qgz_a2a:{leaf.name}", op="all-to-all", dtype="int8",
                elements=n, axis_size=dp, bytes_per_device=qb,
                count_per_step=count_per_step))
            out.append(Collective(
                name=f"qgz_scales:{leaf.name}", op="all-to-all",
                dtype="float32", elements=n, axis_size=dp,
                bytes_per_device=sb, count_per_step=count_per_step))
            continue
        m = dp // k
        nloc = n // dp
        # hop 1 (intra): k rows of m*nloc elements over groups of k
        qb1, sb1 = _qgz_wire(k, m * nloc, block_size, k)
        # hop 2 (inter): m rows of nloc elements over groups of m
        qb2, sb2 = _qgz_wire(m, nloc, block_size, m)
        out += [
            Collective(name=f"qgz_a2a_intra:{leaf.name}", op="all-to-all",
                       dtype="int8", elements=n, axis_size=k,
                       bytes_per_device=qb1, count_per_step=count_per_step,
                       link="intra"),
            Collective(name=f"qgz_scales_intra:{leaf.name}", op="all-to-all",
                       dtype="float32", elements=n, axis_size=k,
                       bytes_per_device=sb1, count_per_step=count_per_step,
                       link="intra"),
            Collective(name=f"qgz_a2a_inter:{leaf.name}", op="all-to-all",
                       dtype="int8", elements=n // k, axis_size=m,
                       bytes_per_device=qb2, count_per_step=count_per_step,
                       link="inter"),
            Collective(name=f"qgz_scales_inter:{leaf.name}", op="all-to-all",
                       dtype="float32", elements=n // k, axis_size=m,
                       bytes_per_device=sb2, count_per_step=count_per_step,
                       link="inter"),
        ]
    return out


def param_gather_collectives(
        leaves: Sequence[LeafSpec], dp: int, *,
        quantized: bool = False,
        block_size: int = DEFAULT_BLOCK_SIZE,
        param_dtype: str = "bfloat16",
        count_per_step: int = 1) -> List[Collective]:
    """Collectives of the per-step parameter materialization: the all-gather
    of (ZeRO-sharded) weights back to the replicated compute layout.
    Dense: one all-gather in the compute dtype per shardable leaf.
    Quantized (qwZ / scheduled stage-3): all-gather int8 blocks + fp32
    scales instead.  ``count_per_step`` scales to one optimizer step: the
    stage-1/2 post-step materialization gathers once, the scheduled
    stage-3 path gathers once per MICRO-step (gas), and the implicit
    stage-3 path under a remat'd backward fetches every weight TWICE per
    micro (forward + backward recompute) — 2*gas."""
    es = DTYPE_BYTES[param_dtype]
    out: List[Collective] = []
    for leaf in leaves:
        if leaf.shard_dim is None or dp <= 1:
            continue                     # replicated leaf: nothing to gather
        n = leaf.elements
        if not quantized:
            out.append(Collective(
                name=f"param_ag:{leaf.name}", op="all-gather",
                dtype=param_dtype, elements=n, axis_size=dp,
                bytes_per_device=all_gather_bytes(n, es, dp),
                count_per_step=count_per_step))
            continue
        _, nb, npad = block_layout(n // dp, block_size)
        out += [
            Collective(name=f"qwz_ag:{leaf.name}", op="all-gather",
                       dtype="int8", elements=dp * npad, axis_size=dp,
                       bytes_per_device=all_gather_bytes(dp * npad, 1, dp),
                       count_per_step=count_per_step),
            Collective(name=f"qwz_scales:{leaf.name}", op="all-gather",
                       dtype="float32", elements=dp * nb, axis_size=dp,
                       bytes_per_device=all_gather_bytes(dp * nb, 4, dp),
                       count_per_step=count_per_step),
        ]
    return out


def volume_report(leaves: Sequence[LeafSpec], dp: int, *,
                  gas: int = 1,
                  quantized_gradients: bool = False,
                  quantized_weights: bool = False,
                  quantized_weights_mask: Optional[Sequence[bool]] = None,
                  block_size: int = DEFAULT_BLOCK_SIZE,
                  intra_size: int = 0,
                  param_dtype: str = "bfloat16",
                  gather_params: bool = True,
                  param_gathers_per_step: int = 1,
                  implicit_param_gathers_per_step: Optional[int] = None
                  ) -> dict:
    """Full per-step report for one configuration, with the dense-fp32
    baseline alongside so byte reductions are assertable directly.

    ``quantized_weights_mask``: per-leaf qwZ eligibility (the engine's
    offload push keeps TP-mixed/non-divisible leaves dense); None means
    ``quantized_weights`` applies to every shardable leaf.

    ``param_gathers_per_step``: how often the ACTIVE config materializes
    its partitioned weights per optimizer step (1 for the stage-1/2
    post-step gather, gas for the scheduled stage-3 per-micro gather,
    2*gas for implicit stage-3 under a remat'd backward — the forward
    gather plus the recompute refetch).  ``implicit_param_gathers_per_
    step``: when set, the baseline additionally prices the implicit
    XLA-scheduled stage-3 path (dense gathers at that count) as
    ``implicit_param_gather_bytes_per_step`` — the honest yardstick the
    scheduled path's acceptance bound is judged against."""
    grads = grad_exchange_collectives(
        leaves, dp, quantized=quantized_gradients, block_size=block_size,
        intra_size=intra_size, count_per_step=gas)
    if not gather_params:
        params = []
    elif quantized_weights and quantized_weights_mask is not None:
        dense_leaves = [l for l, q in zip(leaves, quantized_weights_mask)
                        if not q]
        q_leaves = [l for l, q in zip(leaves, quantized_weights_mask) if q]
        params = param_gather_collectives(
            dense_leaves, dp, quantized=False, param_dtype=param_dtype,
            count_per_step=param_gathers_per_step)
        params += param_gather_collectives(
            q_leaves, dp, quantized=True, block_size=block_size,
            param_dtype=param_dtype, count_per_step=param_gathers_per_step)
    else:
        params = param_gather_collectives(
            leaves, dp, quantized=quantized_weights,
            block_size=block_size, param_dtype=param_dtype,
            count_per_step=param_gathers_per_step)
    base = grad_exchange_collectives(leaves, dp, quantized=False,
                                     count_per_step=gas)
    base_rs = sum(c.bytes_per_step for c in base if c.op == "reduce-scatter")
    base_params = param_gather_collectives(
        leaves, dp, quantized=False, param_dtype=param_dtype) \
        if gather_params else []
    grad_bytes = sum(c.bytes_per_step for c in grads)
    param_bytes = sum(c.bytes_per_step for c in params)
    param_q_bytes = sum(c.bytes_per_step for c in params
                        if c.name.startswith(("qwz_ag", "qwz_scales")))
    report = {
        "config": {
            "dp": dp, "gas": gas,
            "quantized_gradients": bool(quantized_gradients),
            "quantized_weights": bool(quantized_weights),
            "quantization_block_size": int(block_size),
            "hierarchical_intra_size": int(intra_size or 0),
            "param_dtype": param_dtype,
            "param_gathers_per_step": int(param_gathers_per_step),
        },
        "collectives": _as_dicts(grads + params),
        "grad_exchange_bytes_per_step": grad_bytes,
        "param_gather_bytes_per_step": param_bytes,
        "param_gather_quantized_bytes_per_step": param_q_bytes,
        "param_gather_dense_bytes_per_step": param_bytes - param_q_bytes,
        "total_bytes_per_step": grad_bytes + param_bytes,
        "inter_bytes_per_step": sum(c.bytes_per_step
                                    for c in grads + params
                                    if c.link == "inter"),
        "baseline": {
            "fp32_grad_exchange_bytes_per_step":
                sum(c.bytes_per_step for c in base),
            "fp32_reduce_scatter_bytes_per_step": base_rs,
            "dense_param_gather_bytes_per_step":
                sum(c.bytes_per_step for c in base_params),
        },
    }
    if implicit_param_gathers_per_step is not None:
        report["baseline"]["implicit_param_gather_bytes_per_step"] = \
            sum(c.bytes_per_step for c in base_params) \
            * int(implicit_param_gathers_per_step)
    baseline_total = report["baseline"]["fp32_grad_exchange_bytes_per_step"]
    report["grad_reduction_vs_fp32"] = (
        baseline_total / grad_bytes if grad_bytes else None)
    return report


def _as_dicts(collectives):
    return [asdict(c) | {"bytes_per_step": c.bytes_per_step}
            for c in collectives]


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

    def record(self, op, prefix, dtype, leaves, axis_size, link="flat"):
        """One call of ``op`` carrying ``leaves``: [(name, elements)], or
        [(name, elements, wire_elements)] where the payload differs from
        the logical elements the report names (a quantized leaf's padded
        codes or its scales)."""
        self.calls[op] = self.calls.get(op, 0) + 1
        es = dtype_bytes(dtype)
        for name, n, *wire in leaves:
            key = f"{prefix}:{name}"
            c = self._open.get(key)
            if c is None:
                self._open[key] = Collective(
                    name=key, op=op, dtype=dtype_name(dtype), elements=n,
                    axis_size=axis_size, link=link,
                    bytes_per_device=_RING_BYTES[op](
                        wire[0] if wire else n, es, axis_size))
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
