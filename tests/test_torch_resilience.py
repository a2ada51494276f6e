"""Resilience of the PyTorch port in one process (ROADMAP A16) against the
JAX package.

- **Tags**: on copies of one directory (clean, emergency, preempt,
  suspect, torn and corrupted tags) the port's ``list_tags``,
  ``resume_candidates``, ``select_resume_tag``, ``gc_tags``,
  ``read_topology`` and tag predicates answer as the JAX package's.
- **One chaos script** through the JAX engine and the port (a tiny fp32
  GPT-2 from the same weights, the watchdog and the integrity sentinels
  armed): an async commit after step 3, NaN gradients at steps 4-5 (the
  watchdog's overflow streak), a flipped exponent bit in Adam's step
  count after step 7 (the sentinels' anomaly, the unsupervised corrupt
  verdict, the watchdog's abort and its emergency tag). The watchdog
  events, the verdict steps and the emergency manifests are the JAX
  engine's; the losses and the sentinels' statistics agree within the
  engine parity tolerance (rtol 1e-4: the same fp32 arithmetic in
  another summation order). The port's async tag loads into the JAX
  engine, which trains on to the port's next loss; a chaos kill inside an
  async write leaves ``latest`` as it was.
- **Topology and data position**: ``topology_manifest``, ``data_position``
  and ``fast_forward`` as the JAX package's; an elastic load at dp 1 of a
  tag the JAX engine wrote at ``{"data": 2}``; a pipe-2 interleaved tag of
  the single-controller layout elastically loaded at pipe 1 (the JAX
  package's plan of the same move, the dropped schedule DISARMED).
- **Async commits**: the committed bytes are a synchronous save's.
- **Preemption**: the preempt tag moves ``latest`` and resumes as an
  uninterrupted run.
- **A16b**: what a world of several processes needs raises, naming it.
"""
import logging
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2Model as JGPT2Model
from deepspeed_tpu.runtime.resilience import atomic as jatomic
from deepspeed_tpu.runtime.resilience import chaos as jchaos
from deepspeed_tpu.runtime.resilience import reshard as jreshard
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from deepspeed_tpu_torch.runtime.resilience import atomic, chaos, reshard
from deepspeed_tpu_torch.utils.logging import logger as ds_logger

TINY = dict(vocab_size=128, n_positions=16, n_embd=32, n_layer=2, n_head=2)
RTOL = 1e-4
DS = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
      "gradient_accumulation_steps": 2,
      "optimizer": {"type": "Adam", "params": {"lr": 3e-3}},
      "gradient_clipping": 1.0, "steps_per_print": 10 ** 9}
# the sentinels: 3 steps of history, a verdict after 2 anomalous steps
INTEGRITY = {"enabled": True, "min_history": 3, "confirm_steps": 2}


@pytest.fixture(autouse=True)
def _always_disarm():
    yield
    chaos.disarm()
    jchaos.disarm()


def _batch(seed):
    ids = np.random.default_rng(seed).integers(0, TINY["vocab_size"],
                                               (2, 2, TINY["n_positions"]))
    return {"input_ids": ids, "labels": ids.copy()}


def _jax_engine(cfg, data=1):
    from deepspeed_tpu.runtime.engine import _first_micro

    eng = deepspeed_tpu.initialize(
        model=JGPT2Model(JGPT2Config(dtype=jnp.float32, **TINY)),
        config_params=dict(cfg, mesh={"data": data, "allow_partial": True}))[0]
    eng._ensure_state(_first_micro(_batch(0)))
    return eng


def _port_engine(cfg, init=None):
    eng = deepspeed_tpu_torch.initialize(
        model=GPT2Model(GPT2Config(dtype=torch.float32, **TINY)),
        config_params=cfg, device="cpu")[0]
    if init is not None:
        eng.load_module_state_dict(init)
    return eng


# ---------------------------------------------------------------------------
# tag selection on copies of one directory
# ---------------------------------------------------------------------------
def _tag(save_dir, name, step, mtime, **meta):
    with atomic.atomic_tag(save_dir, name, meta=dict(global_steps=step,
                                                     **meta),
                           update_latest=False) as tmp:
        with open(os.path.join(tmp, "model_states.npz"), "wb") as f:
            f.write(os.urandom(64))
    os.utime(os.path.join(save_dir, name), (mtime, mtime))


def _tag_dir(root):
    d = os.path.join(root, "tags")
    _tag(d, "global_step2", 2, 1000, topology={"dp": 2})
    _tag(d, "global_step4", 4, 1001)
    _tag(d, "preempt_step5", 5, 1002, preempt=True)
    _tag(d, "global_step6", 6, 1003, integrity_clean=False)
    _tag(d, "emergency_step7", 7, 1004, emergency=True)
    _tag(d, "global_step8", 8, 1005)
    _tag(d, "global_step9", 9, 1006)
    # a newer tag with one corrupted payload byte, one truncated, a torn
    # write, a foreign directory, a stale latest pointer
    chaos.corrupt_file(os.path.join(d, "global_step9", "model_states.npz"),
                       offset=7, nbytes=1)
    _tag(d, "global_step10", 10, 1007)
    chaos.truncate_file(os.path.join(d, "global_step10",
                                     "model_states.npz"), 5)
    os.makedirs(os.path.join(d, ".tmp-global_step11"))
    os.makedirs(os.path.join(d, "logs"))
    atomic.write_latest(d, "global_step4")
    return d


def test_tag_selection_matches_the_reference(tmp_path):
    d = _tag_dir(str(tmp_path))
    assert atomic.list_tags(d) == jatomic.list_tags(d)
    assert atomic.resume_candidates(d) == jatomic.resume_candidates(d)
    assert atomic.resume_candidates(d)[-2:] == ["global_step6",
                                                "emergency_step7"]
    assert atomic.select_resume_tag(d) == jatomic.select_resume_tag(d) \
        == "global_step8"
    for tag in atomic.list_tags(d):
        for pred in ("is_emergency_tag", "is_preempt_tag", "is_suspect_tag"):
            assert getattr(atomic, pred)(d, tag) == \
                getattr(jatomic, pred)(d, tag), (pred, tag)
        assert atomic.read_topology(os.path.join(d, tag)) == \
            jatomic.read_topology(os.path.join(d, tag))
    assert atomic.read_topology(os.path.join(d, "global_step2")) == {"dp": 2}
    for keep in (0, 2):
        a, b = str(tmp_path / f"port{keep}"), str(tmp_path / f"jax{keep}")
        shutil.copytree(d, a)
        shutil.copytree(d, b)
        assert sorted(atomic.gc_tags(a, keep, protect={"global_step2"})) \
            == sorted(jatomic.gc_tags(b, keep, protect={"global_step2"}))
        assert sorted(os.listdir(a)) == sorted(os.listdir(b))


# ---------------------------------------------------------------------------
# the chaos script
# ---------------------------------------------------------------------------
def _continue_overflow(event):
    return "continue" if event.kind == "overflow_streak" else None


def _run_script(eng, ch, save_dir):
    """11 steps at most: an async commit after step 3, NaN gradients at
    steps 4-5, Adam's step count multiplied by 2**16 (bit 27 of its fp32
    word) after step 7; stops at the watchdog's alarm."""
    eng.watchdog.add_callback(_continue_overflow)
    losses, alarm = [], None
    for step in range(1, 12):
        if step == 4:
            ch.arm(nan_grad_steps=2)
            ch.corrupt_opt_state(rank=0, step=7, leaf=0, element=0, bit=27)
        try:
            losses.append(float(eng.train_batch(batch=_batch(step))))
        except Exception as e:   # noqa: BLE001 - each package's alarm
            alarm = e
            break
        if step == 3:
            eng.save_checkpoint(save_dir, async_commit=True)
    ch.disarm()
    return {"losses": losses, "alarm": type(alarm).__name__,
            "events": [(e.kind, e.step) for e in eng.watchdog.events],
            "integrity": eng._integrity.report()}


def test_chaos_script_matches_the_reference(tmp_path):
    """The script through both engines (one test: the JAX engine compiles
    once): the watchdog's events and alarm, the emergency tags and their
    manifests, the sentinels' statistics and verdict, the topology, data
    position and fast_forward; then the port's async tag of step 3 loads
    into the JAX engine, which trains on to the port's step-4 loss, and a
    chaos kill inside a port async write leaves ``latest`` as it was."""
    dirs = {k: str(tmp_path / k) for k in ("jax", "port")}

    def cfg(k):
        return dict(DS, resilience={
            "watchdog": {"enabled": True, "max_skipped_steps": 2,
                         "emergency_checkpoint_dir": dirs[k]},
            "integrity": INTEGRITY})

    jeng = _jax_engine(cfg("jax"))
    init = params_from_jax(jax.device_get(jeng.state.params),
                           GPT2Config(dtype=torch.float32, **TINY))
    peng = _port_engine(cfg("port"), init)
    out = {"jax": _run_script(jeng, jchaos, dirs["jax"]),
           "port": _run_script(peng, chaos, dirs["port"])}

    # the watchdog and the emergency tags
    assert out["port"]["events"] == out["jax"]["events"] == [
        ("overflow_streak", 5), ("silent_corruption", 9)]
    assert out["port"]["alarm"] == out["jax"]["alarm"] == "WatchdogAlarm"
    np.testing.assert_allclose(out["port"]["losses"], out["jax"]["losses"],
                               rtol=RTOL)
    for d in dirs.values():
        # the emergency tag leaves latest at the async tag of step 3
        assert atomic.read_latest(d) == "global_step3"
        assert atomic.select_resume_tag(d) == "global_step3"
        assert atomic.resume_candidates(d) == ["global_step3",
                                               "emergency_step9"]
    mp, mj = (atomic.load_manifest(os.path.join(dirs[k], "emergency_step9"))
              for k in ("port", "jax"))
    # (the backend differs: the JAX engine's default is orbax)
    for key in ("tag", "global_steps", "micro_steps", "world", "emergency",
                "integrity_clean", "data_position"):
        assert mp[key] == mj[key], key
    assert mp["emergency"] is True and mp["integrity_clean"] is False
    tp, tj = (dict(m["topology"]) for m in (mp, mj))
    tp.pop("partition_specs")
    tj.pop("partition_specs")
    assert tp == tj

    # the sentinels and the verdict
    rp, rj = out["port"]["integrity"], out["jax"]["integrity"]
    for key in ("anomalies", "false_positives", "overflow_skips_excluded",
                "open_anomaly_step", "verdicts", "detection_latency_steps",
                "vote_armed", "dup_check_armed", "sentinels_armed", "dp"):
        assert rp[key] == rj[key], key
    assert [(v["step"], v["anomaly_step"], v["source"]) for v in
            rp["verdicts"]] == [(9, 8, "sentinel")]
    for name, sp in rp["sentinels"].items():
        sj = rj["sentinels"][name]
        assert sp["count"] == sj["count"] == 5, name
        np.testing.assert_allclose(sp["mean"], sj["mean"], rtol=RTOL)
        # the EMA variance of values known to rtol 1e-4: within 1e-4 of
        # the squared mean
        assert abs(sp["var"] - sj["var"]) <= RTOL * sj["mean"] ** 2, name

    # the topology, the data position, fast_forward
    tp, tj = reshard.topology_manifest(peng), jreshard.topology_manifest(jeng)
    assert set(tp.pop("partition_specs")) == set(
        peng.module.reference_leaf_paths())
    tj.pop("partition_specs")
    assert tp == tj
    assert reshard.data_position(peng) == jreshard.data_position(jeng)
    pos = {"samples_consumed": 12}

    def stream():
        return iter(range(100))

    assert next(reshard.fast_forward(stream(), pos, peng)) == \
        next(jreshard.fast_forward(stream(), pos, jeng)) == 6
    with pytest.raises(reshard.ElasticReshardError):
        reshard.fast_forward(stream(), {"samples_consumed": 5}, peng)
    with pytest.raises(jreshard.ElasticReshardError):
        jreshard.fast_forward(stream(), {"samples_consumed": 5}, jeng)

    # the port's async tag trains on in the JAX engine
    path, _ = jeng.load_checkpoint(dirs["port"], tag="global_step3")
    assert path is not None and jeng.global_steps == 3
    # step 4's loss (its forward ran before the NaN poisoned the update)
    loss = float(jeng.train_batch(batch=_batch(4)))
    np.testing.assert_allclose(loss, out["port"]["losses"][3], rtol=RTOL)

    # a chaos kill inside an async write
    d = dirs["port"]
    before = atomic.list_tags(d)
    chaos.arm(kill_after_files=1)
    peng.save_checkpoint(d, tag="killed", async_commit=True)
    with pytest.raises(chaos.ChaosInterrupt):
        peng.wait_pending_commit()
    assert not peng.pending_commit()
    assert atomic.read_latest(d) == "global_step3"
    assert atomic.list_tags(d) == before
    assert not os.path.exists(os.path.join(d, ".tmp-killed"))


# ---------------------------------------------------------------------------
# elastic loads onto one process
# ---------------------------------------------------------------------------
def test_elastic_load_at_dp_1_of_a_jax_tag_written_at_data_2(tmp_path):
    """The JAX engine trains one step at {"data": 2} (global batch 4) and
    saves; the port at dp 1 loads it elastically: every state leaf equal,
    the plan's dp change (2 -> 1) and the data position the JAX
    package's, and one more step of each at the same global batch within
    rtol 1e-4."""
    cfg = dict(DS, train_micro_batch_size_per_gpu=1)
    jeng = _jax_engine(cfg, data=2)
    jeng.train_batch(batch=_batch(1))
    jeng.save_checkpoint(str(tmp_path), backend="npz")
    peng = _port_engine(DS)
    _path, client = peng.load_checkpoint(str(tmp_path), elastic=True)
    plan = client["elastic_reshard"]
    meta = {"topology": atomic.read_topology(
        os.path.join(str(tmp_path), "global_step1"))}
    want = jreshard.plan_elastic_load(meta["topology"], peng)
    assert plan["changed"] == {"dp": (2, 1)} == \
        {k: tuple(v) for k, v in want["changed"].items()}
    assert plan["resharded"] == want["resharded"]
    assert client["data_position"]["samples_consumed"] == 4
    assert plan["micro_batches_to_skip"] == 2
    st = jax.tree_util.tree_leaves(jax.device_get(jeng.state))
    for i, (x, y) in enumerate(zip(peng._state_leaves()[:-1], st[:-1])):
        np.testing.assert_array_equal(x.detach().numpy(), np.asarray(y),
                                      err_msg=str(i))
    b = _batch(2)
    jloss = float(jeng.train_batch(batch=b))
    loss = float(peng.train_batch(batch=b))
    np.testing.assert_allclose(loss, jloss, rtol=RTOL)


def test_pipe_2_tag_loads_elastically_at_pipe_1(tmp_path, caplog):
    """An interleaved pipe-2 tag (2 virtual stages, single controller)
    loads at pipe 1: the plan is the JAX package's plan of the same move,
    the interleaving DISARMED in a warning, every master leaf equal, and
    the next step within rtol 1e-4 of pipe 2's."""
    from deepspeed_tpu_torch.models.gpt2_pipe import gpt2_pipeline_module

    def pipe_engine(pipe, schedule, v):
        mod = gpt2_pipeline_module(GPT2Config(dtype=torch.float32,
                                              **dict(TINY, n_layer=5)))
        cfg = dict(DS, mesh={"pipe": pipe},
                   pipeline={"schedule": schedule, "virtual_stages": v})
        return deepspeed_tpu_torch.initialize(model=mod, config_params=cfg,
                                              device="cpu")[0]

    a = pipe_engine(2, "interleaved", 2)
    a.train_batch(batch=_batch(1))
    a.save_checkpoint(str(tmp_path))
    b = pipe_engine(1, "1f1b", 1)
    ds_logger.propagate = True
    try:
        with caplog.at_level(logging.WARNING):
            _path, client = b.load_checkpoint(str(tmp_path), elastic=True)
    finally:
        ds_logger.propagate = False
    plan = client["elastic_reshard"]
    assert "schedule features DISARMED" in caplog.text
    assert plan["dropped"] == ["virtual-stage interleaving"]
    assert plan["changed"] == {"pipe": (2, 1), "virtual_stages": (2, 1)}

    class View:
        """The port engine under the JAX PipelineEngine's attribute
        names that the plan reads."""
        def __init__(self, eng):
            self.__dict__.update(
                {k: getattr(eng, k) for k in (
                    "dp_world_size", "mp_world_size", "sp_world_size",
                    "num_stages", "virtual_stages", "num_chunks", "grid",
                    "pipe_schedule", "_stash_armed")})
            self.module = eng.module_pipe
            self.zero_optimization_stage = eng.zero_optimization_stage
            self.train_batch_size = eng.train_batch_size

    saved = atomic.read_topology(os.path.join(str(tmp_path), "global_step1"))
    want = jreshard.plan_elastic_load(saved, View(b))
    for key in ("dropped", "gained", "layers_moved", "resharded", "notes"):
        assert plan[key] == want[key], key
    assert {k: tuple(v) for k, v in want["changed"].items()} == \
        plan["changed"]
    for q in range(a.num_chunks):
        for name, t in a.chunk_master(q).items():
            assert torch.equal(t, b.chunk_master(0)[name]), name
    np.testing.assert_allclose(float(b.train_batch(batch=_batch(2))),
                               float(a.train_batch(batch=_batch(2))),
                               rtol=RTOL)


# ---------------------------------------------------------------------------
# async commits and the refusals of A16b
# ---------------------------------------------------------------------------
def test_async_commit_writes_a_synchronous_saves_bytes(tmp_path):
    """The same state committed asynchronously and synchronously: the
    manifests' sha256 of every payload file are equal (the npz members
    carry fixed timestamps), and the async tag loads bit for bit."""
    eng = _port_engine(dict(DS, resilience={"async_commit": True}))
    eng.train_batch(batch=_batch(1))
    eng.save_checkpoint(str(tmp_path / "sync"), async_commit=False)
    eng.save_checkpoint(str(tmp_path / "async"))
    assert eng.pending_commit()
    # the step after the snapshot cannot reach what the thread writes (its
    # boundary publishes the commit if the seal has landed)
    eng.train_batch(batch=_batch(2))
    eng.wait_pending_commit()
    assert not eng.pending_commit()
    ms, ma = (atomic.load_manifest(str(tmp_path / k / "global_step1"))
              for k in ("sync", "async"))
    assert ms["files"] == ma["files"]
    assert eng._last_metrics["ckpt_commit_pending"] == 0
    other = _port_engine(DS)
    other.load_checkpoint(str(tmp_path / "async"))
    ref = _port_engine(DS)
    ref.load_checkpoint(str(tmp_path / "sync"))
    for x, y in zip(other._state_leaves(), ref._state_leaves()):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


def test_graceful_preemption_commits_a_preempt_tag(tmp_path):
    """request_preemption(): at the next step boundary a synchronous
    ``preempt_step<N>`` tag (manifest ``preempt``, the data position in
    its client state) moves ``latest`` and GracefulPreemption names it;
    the tag resumes as an uninterrupted run."""
    from deepspeed_tpu_torch.runtime.resilience.watchdog import \
        GracefulPreemption

    eng = _port_engine(DS)
    eng.train_batch(batch=_batch(1))
    eng.save_checkpoint(str(tmp_path))
    eng.request_preemption()
    with pytest.raises(GracefulPreemption) as ei:
        eng.train_batch(batch=_batch(2))
    assert ei.value.tag == "preempt_step2"
    assert atomic.read_latest(str(tmp_path)) == "preempt_step2"
    assert atomic.is_preempt_tag(str(tmp_path), "preempt_step2")
    other = _port_engine(DS)
    _path, client = other.load_checkpoint(str(tmp_path), auto_resume=True)
    assert other.global_steps == 2
    assert client["data_position"]["samples_consumed"] == 8
    ref = _port_engine(DS)
    for seed in (1, 2):
        ref.train_batch(batch=_batch(seed))
    assert torch.equal(other.train_batch(batch=_batch(3)),
                       ref.train_batch(batch=_batch(3)))


def test_a_world_of_several_processes_names_a16b():
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    from deepspeed_tpu_torch.runtime.engine import _refuse_unported
    from deepspeed_tpu_torch.runtime.resilience.integrity import (
        IntegrityConfig, IntegrityMonitor)
    from deepspeed_tpu_torch.runtime.resilience.supervisor import \
        TrainingSupervisor

    for res in ({"watchdog": {"enabled": True}},
                {"integrity": {"enabled": True}}, {"async_commit": True},
                {"auto_resume": True}):
        raw = dict(DS, resilience=res)
        cfg = DeepSpeedConfig(raw, world_size=1)
        _refuse_unported(raw, cfg, world=1)
        with pytest.raises(NotImplementedError, match="A16b"):
            _refuse_unported(raw, cfg, world=2)
    with pytest.raises(NotImplementedError, match="A16b"):
        IntegrityMonitor(IntegrityConfig(), 2, vote_armed=True)
    with pytest.raises(NotImplementedError, match="A16b"):
        TrainingSupervisor(lambda w: None, lambda e: iter(()),
                           save_dir="x", world_size=2)
