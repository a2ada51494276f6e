"""The port's TrainingSupervisor at world 1 (ROADMAP A16) against the JAX
package's.

One supervised chaos script runs through the JAX supervisor and the
port's, a tiny fp32 GPT-2 from the same weights, a commit every 2 steps:
a transient step fault at wall step 2 (retried in place), NaN gradients
at steps 5-6 (the watchdog's overflow streak: its emergency tag, then a
rollback to the last committed tag), a flipped exponent bit in Adam's
step count after step 7 (the sentinels' corrupt verdict at step 8: a
rollback to the last integrity-clean tag and a skip of the data window
that fed it). The incident ledgers (kind, recovery, tag, wall steps,
MTTR, skipped samples) and the recovery report's counters are the JAX
supervisor's; the committed losses agree within the engine parity
tolerance (rtol 1e-4). In the port the recovered losses are bit for bit
its own: steps 1-6 those of an uninterrupted run, steps 7-10 those of a
run resumed from the clean tag that skips the same window. Beside it:
the pipeline engine's supervised transient retry, a failed commit that
does not stop the run, SupervisorGaveUp with nothing to roll back to.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2Model as JGPT2Model
from deepspeed_tpu.runtime.resilience import chaos as jchaos
from deepspeed_tpu.runtime.resilience import supervisor as jsup
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from deepspeed_tpu_torch.runtime.resilience import atomic, chaos, reshard
from deepspeed_tpu_torch.runtime.resilience import supervisor as sup

TINY = dict(vocab_size=128, n_positions=16, n_embd=32, n_layer=2, n_head=2)
RTOL = 1e-4
DS = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
      "gradient_accumulation_steps": 2,
      "optimizer": {"type": "Adam", "params": {"lr": 3e-3}},
      "gradient_clipping": 1.0, "steps_per_print": 10 ** 9,
      "resilience": {"watchdog": {"enabled": True, "max_skipped_steps": 2},
                     "integrity": {"enabled": True, "window": 4,
                                   "min_history": 3, "confirm_steps": 1}}}
SUP = {"checkpoint_every_steps": 2, "max_transient_retries": 2}


@pytest.fixture(autouse=True)
def _always_disarm():
    yield
    chaos.disarm()
    jchaos.disarm()


def _stream(engine):
    """The deterministic micro-batch stream from sample 0: micro-batch i
    from seed i."""
    rows = engine.train_micro_batch_size_per_gpu() * engine.dp_world_size
    i = 0
    while True:
        ids = np.random.default_rng(1000 + i).integers(
            0, TINY["vocab_size"], (rows, TINY["n_positions"]))
        yield {"input_ids": ids, "labels": ids.copy()}
        i += 1


def _port_engine(init, cfg=DS):
    eng = deepspeed_tpu_torch.initialize(
        model=GPT2Model(GPT2Config(dtype=torch.float32, **TINY)),
        config_params=cfg, device="cpu")[0]
    eng.load_module_state_dict(init)
    return eng


def _script(s, ch):
    """The chaos script over supervisor ``s`` and its package's chaos."""
    ch.arm(fail_step_transient=2)
    s.run(4)
    ch.arm(nan_grad_steps=2)
    s.run(6)
    ch.arm()
    ch.corrupt_opt_state(rank=0, step=7, leaf=0, element=0, bit=27)
    s.run(10)
    ch.disarm()
    return s.report(), s.committed_losses()


_INCIDENT_KEYS = ("kind", "fail_step", "recovered_step", "mttr_steps",
                  "recovery", "tag", "skipped_samples", "skip_from_sample",
                  "skip_to_sample", "culprits", "source",
                  "detection_latency_steps")
_REPORT_KEYS = ("armed", "world", "alive_hosts", "restarts", "rollbacks",
                "commit_failures", "transient_retries", "wall_steps",
                "committed_steps", "committed_samples",
                "goodput_samples_per_wall_step", "corrupt_verdicts",
                "quarantines", "skipped_samples", "last_clean_tag",
                "mttr_steps", "downtime_spans", "downtime_wall_steps",
                "last_committed_tag")


def test_supervisor_ladder_matches_the_reference(tmp_path):
    """(One test: the JAX engine compiles once.)"""
    init = {}

    def jax_factory(world):
        eng = deepspeed_tpu.initialize(
            model=JGPT2Model(JGPT2Config(dtype=jnp.float32, **TINY)),
            config_params=dict(DS, mesh={"data": 1,
                                         "allow_partial": True}))[0]
        eng._ensure_state(next(_stream(eng)))
        init["params"] = params_from_jax(
            jax.device_get(eng.state.params),
            GPT2Config(dtype=torch.float32, **TINY))
        return eng

    js = jsup.TrainingSupervisor(jax_factory, _stream,
                                 save_dir=str(tmp_path / "jax"),
                                 world_size=1, config=SUP)
    jrep, jlosses = _script(js, jchaos)
    ps = sup.TrainingSupervisor(lambda w: _port_engine(init["params"]),
                                _stream, save_dir=str(tmp_path / "port"),
                                world_size=1, config=SUP)
    prep, plosses = _script(ps, chaos)

    kinds = [(i["kind"], i.get("recovery")) for i in prep["incidents"]]
    assert kinds == [("transient", "retry-in-place"),
                     ("watchdog", "rollback"),
                     ("corrupt", "rollback-and-skip")]
    assert len(prep["incidents"]) == len(jrep["incidents"])
    for ip, ij in zip(prep["incidents"], jrep["incidents"]):
        for key in _INCIDENT_KEYS:
            assert ip.get(key) == ij.get(key), (key, ip, ij)
    for key in _REPORT_KEYS:
        assert prep[key] == jrep[key], key
    assert prep["incidents"][1]["tag"] == "global_step4"
    assert prep["incidents"][2]["tag"] == "global_step6"
    assert prep["skipped_samples"] == 8
    assert [g for g, _ in plosses] == list(range(1, 11))
    np.testing.assert_allclose([v for _, v in plosses],
                               [v for _, v in jlosses], rtol=RTOL)
    m = ps.engine._last_metrics
    assert (m["recovery_retries"], m["recovery_rollbacks"]) == (1, 2)
    rec = ps.engine.telemetry_report()["recovery"]
    assert rec["rollbacks"] == 2 and rec["mttr_steps"]["closed_incidents"] \
        == 3
    # the emergency tag of the watchdog's abort, kept beside the tags
    d = str(tmp_path / "port")
    assert atomic.is_emergency_tag(d, "emergency_step6")
    assert ps.engine.samples_skipped == 8

    # bit for bit, steps 1-6: an uninterrupted run
    clean = _port_engine(init["params"], dict(DS, resilience={}))
    it = _stream(clean)
    for g in range(1, 7):
        assert float(clean.train_batch(data_iter=it)) == dict(plosses)[g], g
    # steps 7-10: a run resumed from the clean tag that skips the window
    ref = _port_engine(init["params"], dict(DS, resilience={}))
    ref.load_checkpoint(d, tag="global_step6")
    pos = reshard.data_position(ref)
    pos["samples_consumed"] += prep["skipped_samples"]
    it = reshard.fast_forward(_stream(ref), pos, ref)
    for g in range(7, 11):
        assert float(ref.train_batch(data_iter=it)) == dict(plosses)[g], g


def test_pipeline_engine_supervised_transient_retry(tmp_path):
    from deepspeed_tpu_torch.models.gpt2_pipe import gpt2_pipeline_module

    def factory(world):
        mod = gpt2_pipeline_module(GPT2Config(dtype=torch.float32, **TINY))
        cfg = dict(DS, mesh={"pipe": 2}, resilience={})
        return deepspeed_tpu_torch.initialize(model=mod, config_params=cfg,
                                              device="cpu")[0]

    s = sup.TrainingSupervisor(factory, _stream,
                               save_dir=str(tmp_path / "run"), world_size=1,
                               config={"checkpoint_every_steps": 2})
    assert s.armed
    chaos.arm(fail_step_transient=2, fail_step_transient_count=1)
    s.run(3)
    chaos.disarm()
    rep = s.report()
    assert rep["transient_retries"] == 1 and rep["rollbacks"] == 0
    assert [g for g, _ in s.loss_history] == [1, 2, 3]
    assert s.engine._last_metrics["recovery_retries"] == 1
    assert "recovery" in s.engine.telemetry_report()
    assert atomic.read_latest(str(tmp_path / "run")) == "global_step2"


def test_failed_commit_does_not_stop_the_run_and_no_tag_gives_up(tmp_path):
    cfg = dict(DS, resilience={"watchdog": {"enabled": True,
                                            "max_skipped_steps": 1}})

    def factory(world):
        return deepspeed_tpu_torch.initialize(
            model=GPT2Model(GPT2Config(dtype=torch.float32, **TINY)),
            config_params=cfg, device="cpu")[0]

    s = sup.TrainingSupervisor(factory, _stream, save_dir=str(tmp_path / "a"),
                               world_size=1,
                               config={"checkpoint_every_steps": 1})
    chaos.arm(kill_once_at_point="before_manifest")
    s.run(2)
    chaos.disarm()
    rep = s.report()
    assert rep["commit_failures"] == 1 and rep["committed_steps"] == 2
    assert rep["last_committed_tag"] == "global_step2"
    s = sup.TrainingSupervisor(factory, _stream, save_dir=str(tmp_path / "b"),
                               world_size=1,
                               config={"checkpoint_every_steps": 0})
    chaos.arm(nan_grad_steps=1)
    with pytest.raises(sup.SupervisorGaveUp, match="NO committed tag"):
        s.run(2)
    assert not os.path.exists(str(tmp_path / "b" / "latest"))
