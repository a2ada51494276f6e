"""Topology-elastic checkpoints: the topology manifest, the data position
and the elastic load plan.

Port of deepspeed_tpu/runtime/resilience/reshard.py. The npz payloads
are topology-independent (whole leaves for the base engine, layer-keyed
files for the pipeline engine), so any layout can read them; this module
makes that explicit:

- every checkpoint carries a **topology manifest** (mesh sizes, the
  zero / dp / pipe / virtual-stage degrees, the pipeline chunk grid and
  schedule, the global batch) and a **data position** (the exact global
  sample offset, skipped windows included), in ``manifest.json`` and in
  ``metadata.pkl``;
- ``load_checkpoint(..., elastic=True)`` plans the load from the saved
  manifest against the live engine (``plan_elastic_load``): which axes
  reshard, which pipeline layers change owner (``chunk_remap``), which
  schedule features the new layout drops (interleaved or ZB-H1 to 1f1b:
  a DISARMED warning naming them);
- the data position lets a resumed run go on at the exact sample
  (``micro_batches_to_skip``, ``fast_forward``).

The port loads elastically where the target runs in one process (dp 1,
or the pipeline engine's single-controller layout); a target of several
processes is ROADMAP A16b.
"""
import logging

from deepspeed_tpu_torch.utils.logging import log_dist, logger

# manifest.json / metadata.pkl keys (shared with atomic.read_topology)
TOPOLOGY_KEY = "topology"
DATA_POSITION_KEY = "data_position"

# the features a richer schedule has over a plainer one (the downgrade
# axis of an elastic load); keys are runtime/pipe/schedule.py's names
_SCHEDULE_FEATURES = {
    "1f1b": (),
    "interleaved": ("virtual-stage interleaving",),
    "zb-h1": ("zero-bubble wgrad deferral",),
}


class ElasticReshardError(RuntimeError):
    """An elastic load the current layout cannot satisfy."""


# ---------------------------------------------------------------------------
# manifest construction (save side)
# ---------------------------------------------------------------------------
def partition_specs(engine):
    """The ZeRO layout of the engine's sharded state (the optimizer state
    and master from stage 1), one entry per JAX leaf: ``{leaf path:
    "PartitionSpec(...)"}`` with 'data' on the dimension ZeRO splits.
    None for an engine without a partition."""
    part = getattr(engine, "partition", None)
    if part is None:
        return None
    sharded = int(engine.zero_optimization_stage()) >= 1 \
        and engine.dp_world_size > 1
    out = {}
    for leaf in part.leaves:
        dim = leaf.shard_dim if sharded else None
        if leaf.expert_dim is not None and engine.dp_world_size > 1:
            dim = leaf.expert_dim
        axes = ["'data'" if d == dim else "None"
                for d in range(len(leaf.shape))] if dim is not None else []
        out[str(leaf.name)] = f"PartitionSpec({', '.join(axes)})"
    return out


def topology_manifest(engine):
    """The writing layout's identity card, stored with every checkpoint:
    mesh sizes, parallel degrees, the zero layout, the pipeline chunk
    grid and schedule, and the global batch a resize must keep."""
    topo = {
        "engine": type(engine).__name__,
        "mesh": {str(a): int(s) for a, s in engine.mesh_shape.items()},
        "dp": int(engine.dp_world_size),
        "mp": int(engine.mp_world_size),
        "sp": int(engine.sp_world_size),
        "zero_stage": int(engine.zero_optimization_stage()),
        "global_batch": {
            "train_batch_size": int(engine.train_batch_size()),
            "micro_batch_per_gpu":
                int(engine.train_micro_batch_size_per_gpu()),
            "gradient_accumulation_steps":
                int(engine.gradient_accumulation_steps()),
        },
    }
    if hasattr(engine, "num_stages"):  # PipelineEngine
        from deepspeed_tpu_torch.runtime.constants import \
            PIPELINE_STASH_BUDGET

        topo["mesh"]["pipe"] = int(engine.num_stages)
        module = engine.module_pipe
        pipe = {
            "num_stages": int(engine.num_stages),
            "virtual_stages": int(engine.virtual_stages),
            "num_chunks": int(engine.num_chunks),
            "schedule": engine.pipe_schedule,
            "requested_schedule": engine.requested_schedule,
            "stash_armed": bool(engine._stash_armed),
            "stash_budget": int(engine._pipe_cfg[PIPELINE_STASH_BUDGET]),
            "partition": [int(b) for b in
                          module.partition_layers(engine.num_chunks)],
        }
        pipe["chunk_owner_stage"] = [
            int(engine.grid.chunk_owner_stage(q))
            for q in range(engine.num_chunks)]
        topo["pipe"] = pipe
    else:
        specs = partition_specs(engine)
        if specs is not None:
            topo["partition_specs"] = specs
    opt = getattr(engine, "optimizer", None)
    if getattr(engine, "_wire", None) is not None:
        # 1-bit / 0/1 Adam's per-rank state (error feedback, the local
        # accumulator) has a leading (dp,) dim a dp change cannot remap
        comp = {"optimizer": type(opt).__name__, "axis_name": "data",
                "axis_size": int(engine.dp_world_size)}
        for k in ("freeze_step", "var_freeze_step", "local_steps",
                  "local_step_scaler", "local_step_clipper", "bits"):
            if hasattr(opt, k):
                comp[k] = int(getattr(opt, k))
        topo["compression"] = comp
    return topo


def data_position(engine):
    """The exact position in the global sample stream, in samples (so a
    resumed run with another micro-batch / dp split lands on the same
    sample): the trained samples plus every sample a rollback-and-skip
    passed over (``samples_skipped``)."""
    mb = int(engine.train_micro_batch_size_per_gpu())
    dp = int(engine.dp_world_size)
    micro_steps = int(engine.micro_steps)
    skipped = int(getattr(engine, "samples_skipped", 0))
    return {
        "global_steps": int(engine.global_steps),
        "micro_steps": micro_steps,
        "micro_batch_per_gpu": mb,
        "dp_world_size": dp,
        "samples_skipped": skipped,
        "samples_consumed": micro_steps * mb * dp + skipped,
    }


# ---------------------------------------------------------------------------
# data-order resume (load side)
# ---------------------------------------------------------------------------
def micro_batches_to_skip(position, engine):
    """How many micro-batches of the current engine's shape cover the saved
    sample offset; raises when the offset is not on a micro-batch
    boundary (rounding would replay or skip samples)."""
    if position is None:
        return 0
    consumed = int(position.get("samples_consumed", 0))
    per_batch = int(engine.train_micro_batch_size_per_gpu()) \
        * int(engine.dp_world_size)
    if consumed % per_batch:
        raise ElasticReshardError(
            f"checkpoint consumed {consumed} samples, which is not a "
            f"multiple of the current micro_batch*dp = {per_batch} — the "
            f"data stream cannot resume on a batch boundary. Use an "
            f"elastic config (compute_elastic_config) so the global batch "
            f"divides evenly at every world size")
    return consumed // per_batch


def fast_forward(data_iter, position, engine):
    """Advance ``data_iter`` (micro-batches of the current shape) past the
    samples the checkpoint consumed; returns it at the next unseen
    sample."""
    n = micro_batches_to_skip(position, engine)
    for i in range(n):
        try:
            next(data_iter)
        except StopIteration:
            raise ElasticReshardError(
                f"data stream exhausted after {i} of {n} skip "
                f"micro-batches — the loader is shorter than the "
                f"checkpoint's {position['samples_consumed']}-sample "
                f"offset; resume with the run's full (repeating) data "
                f"stream") from None
    if n:
        log_dist(f"elastic resume: fast-forwarded data stream by {n} "
                 f"micro-batches ({position['samples_consumed']} samples)",
                 ranks=[0])
    return data_iter


# ---------------------------------------------------------------------------
# pipeline chunk remapping
# ---------------------------------------------------------------------------
def chunk_layer_ranges(partition):
    """[(lo, hi)) of model layers per chunk from a partition boundary list
    (``partition_layers``, length num_chunks + 1)."""
    return [(int(partition[i]), int(partition[i + 1]))
            for i in range(len(partition) - 1)]


def chunk_remap(saved_pipe, grid, current_partition):
    """Per-layer remap from the saved chunk grid onto the current one:
    ``[{layer, saved_chunk, saved_stage, chunk, stage}]``. Raises when
    the two grids do not cover the same model."""
    saved_ranges = chunk_layer_ranges(saved_pipe["partition"])
    cur_ranges = chunk_layer_ranges(current_partition)
    n_saved = saved_ranges[-1][1] if saved_ranges else 0
    n_cur = cur_ranges[-1][1] if cur_ranges else 0
    if n_saved != n_cur:
        raise ElasticReshardError(
            f"checkpoint partitions {n_saved} model layers but the current "
            f"module has {n_cur} — elastic resharding remaps the same "
            f"model across meshes, it cannot change the model")
    saved_stages = int(saved_pipe["num_stages"])

    def owner(ranges, layer):
        for q, (lo, hi) in enumerate(ranges):
            if lo <= layer < hi:
                return q
        raise ElasticReshardError(
            f"layer {layer} not covered by chunk partition {ranges}")

    remap = []
    for layer in range(n_cur):
        q_saved = owner(saved_ranges, layer)
        q_cur = owner(cur_ranges, layer)
        remap.append({
            "layer": layer,
            "saved_chunk": q_saved,
            "saved_stage": q_saved % saved_stages,
            "chunk": q_cur,
            "stage": int(grid.chunk_owner_stage(q_cur)),
        })
    return remap


# ---------------------------------------------------------------------------
# elastic plan and report
# ---------------------------------------------------------------------------
def schedule_features(schedule, stash_armed=False):
    """The features a (schedule, stash) pair provides."""
    feats = list(_SCHEDULE_FEATURES.get(schedule, ()))
    if stash_armed:
        feats.append("bounded activation stashing")
    return feats


def plan_elastic_load(saved_topo, engine):
    """Diff the saved topology manifest against the live engine: a plain
    dict with ``changed`` ({axis: (saved, current)}), ``resharded``
    (actions), ``dropped`` / ``gained`` (schedule features),
    ``layers_moved`` and ``notes``."""
    plan = {"changed": {}, "resharded": [], "dropped": [], "gained": [],
            "layers_moved": 0, "notes": []}
    if saved_topo is None:
        plan["notes"].append(
            "checkpoint carries no topology manifest (pre-elastic "
            "layout); resharding based on the live engine only")
        return plan

    for axis in ("dp", "mp", "sp", "zero_stage"):
        saved = saved_topo.get(axis)
        cur = {"dp": engine.dp_world_size, "mp": engine.mp_world_size,
               "sp": engine.sp_world_size,
               "zero_stage": engine.zero_optimization_stage()}[axis]
        if saved is not None and int(saved) != int(cur):
            plan["changed"][axis] = (int(saved), int(cur))
    if "dp" in plan["changed"] or "zero_stage" in plan["changed"]:
        s_dp = saved_topo.get("dp")
        if int(saved_topo.get("zero_stage") or 0) > 0 \
                or engine.zero_optimization_stage() > 0:
            plan["resharded"].append(
                f"optimizer-state leaves re-partitioned along the zero "
                f"axis (dp {s_dp} -> {engine.dp_world_size}, zero stage "
                f"{saved_topo.get('zero_stage')} -> "
                f"{engine.zero_optimization_stage()})")
        else:
            plan["resharded"].append(
                f"data-parallel degree changed (dp {s_dp} -> "
                f"{engine.dp_world_size}); replicated state re-placed on "
                f"the new mesh")

    saved_comp = saved_topo.get("compression")
    if saved_comp is not None and "dp" in plan["changed"]:
        plan["resharded"].append(
            f"per-device {saved_comp.get('optimizer')} compression state "
            f"(error-feedback residuals, local accumulator) written at "
            f"axis_size={saved_comp.get('axis_size')} reset to zero on "
            f"the new data axis; freeze/local-step phase re-derived from "
            f"the restored step counters")

    saved_pipe = saved_topo.get("pipe")
    if isinstance(saved_pipe, dict) and hasattr(engine, "num_stages"):
        cur_grid = (engine.num_stages, engine.virtual_stages)
        saved_grid = (int(saved_pipe["num_stages"]),
                      int(saved_pipe["virtual_stages"]))
        if saved_grid[0] != cur_grid[0]:
            plan["changed"]["pipe"] = (saved_grid[0], cur_grid[0])
        if saved_grid[1] != cur_grid[1]:
            plan["changed"]["virtual_stages"] = (saved_grid[1],
                                                 cur_grid[1])
        remap = chunk_remap(
            saved_pipe, engine.grid,
            engine.module_pipe.partition_layers(engine.num_chunks))
        moved = sum(1 for r in remap if r["saved_stage"] != r["stage"])
        plan["layers_moved"] = moved
        if moved:
            plan["resharded"].append(
                f"{moved}/{len(remap)} pipeline layers remapped to new "
                f"owner stages through chunk_owner_stage "
                f"({saved_grid[0]}x{saved_grid[1]} -> "
                f"{cur_grid[0]}x{cur_grid[1]} chunk grid)")
        saved_feats = set(schedule_features(
            saved_pipe.get("schedule"), saved_pipe.get("stash_armed")))
        cur_feats = set(schedule_features(
            engine.pipe_schedule, engine._stash_armed))
        plan["dropped"] = sorted(saved_feats - cur_feats)
        plan["gained"] = sorted(cur_feats - saved_feats)
        if plan["dropped"] or plan["gained"]:
            plan["notes"].append(
                f"schedule {saved_pipe.get('schedule')}"
                f"{' + stash' if saved_pipe.get('stash_armed') else ''}"
                f" -> {engine.pipe_schedule}"
                f"{' + stash' if engine._stash_armed else ''}")
    elif saved_pipe is not None:
        plan["notes"].append(
            "checkpoint was written by a PipelineEngine; loading on the "
            "base engine ignores its chunk grid (layer files are "
            "stage-independent)")

    saved_gb = (saved_topo.get("global_batch") or {}).get("train_batch_size")
    if saved_gb is not None:
        if int(saved_gb) == int(engine.train_batch_size()):
            if plan["changed"]:
                plan["notes"].append(
                    f"global batch preserved at {saved_gb} "
                    f"(micro/gas re-derived for the new world)")
        else:
            plan["notes"].append(
                f"GLOBAL BATCH CHANGED: {saved_gb} -> "
                f"{engine.train_batch_size()} — the loss trajectory will "
                f"diverge from the original run; use an elasticity config "
                f"so compute_elastic_config preserves it across resizes")
    return plan


def log_plan(plan):
    """Log a reshard plan: actions as info, dropped schedule features as a
    DISARMED warning naming them."""
    for line in plan["resharded"]:
        log_dist(f"elastic resume: {line}", ranks=[0])
    if plan["dropped"]:
        log_dist(
            f"elastic resume: schedule features DISARMED by the new "
            f"topology — dropped: {', '.join(plan['dropped'])}"
            + (f" ({'; '.join(plan['notes'])})" if plan["notes"] else ""),
            ranks=[0], level=logging.WARNING)
    if plan["gained"]:
        log_dist(f"elastic resume: schedule features gained: "
                 f"{', '.join(plan['gained'])}", ranks=[0])
    for note in plan["notes"]:
        if "GLOBAL BATCH CHANGED" in note:
            log_dist(f"elastic resume: {note}", ranks=[0],
                     level=logging.WARNING)
        elif not plan["dropped"]:
            log_dist(f"elastic resume: {note}", ranks=[0])


def elastic_batch_check(engine):
    """``compute_elastic_config`` at the current world against the
    engine's batch shape: ``(final_batch, micro, gas)``, or None without
    an elasticity config."""
    from deepspeed_tpu_torch.elasticity import (compute_elastic_config,
                                                elasticity_enabled)
    from deepspeed_tpu_torch.version import __version__

    pd = engine._config._param_dict
    if not elasticity_enabled(pd):
        return None
    final, _valid, micro = compute_elastic_config(
        pd, __version__, world_size=int(engine.dp_world_size))
    gas = final // (micro * int(engine.dp_world_size))
    if (final, micro, gas) != (engine.train_batch_size(),
                               engine.train_micro_batch_size_per_gpu(),
                               engine.gradient_accumulation_steps()):
        raise ElasticReshardError(
            f"elastic config resolves to (batch={final}, micro={micro}, "
            f"gas={gas}) at world size {engine.dp_world_size} but the "
            f"engine is configured with "
            f"(batch={engine.train_batch_size()}, "
            f"micro={engine.train_micro_batch_size_per_gpu()}, "
            f"gas={engine.gradient_accumulation_steps()}) — the elastic "
            f"config is immutable once scheduled "
            f"(ensure_immutable_elastic_config)")
    return final, micro, gas


def elastic_load_report(meta, engine):
    """The load side of ``load_checkpoint(..., elastic=True)`` in both
    engines: plan the reshard from the checkpoint's metadata, log it,
    check the elastic batch config, and return the report that joins
    the returned client_state."""
    plan = plan_elastic_load(meta.get(TOPOLOGY_KEY), engine)
    log_plan(plan)
    resolved = elastic_batch_check(engine)
    if resolved is not None:
        plan["elastic_config"] = {
            "train_batch_size": int(resolved[0]),
            "micro_batch_per_gpu": int(resolved[1]),
            "gradient_accumulation_steps": int(resolved[2]),
        }
    position = meta.get(DATA_POSITION_KEY)
    if position is not None:
        plan[DATA_POSITION_KEY] = dict(position)
        try:
            plan["micro_batches_to_skip"] = micro_batches_to_skip(position,
                                                                  engine)
        except ElasticReshardError as e:
            # the state restore stands; only the exact-sample resume does
            # not (a property of the new batch shape)
            plan["data_position_error"] = str(e)
            logger.warning(f"elastic resume: {e}")
    return plan
