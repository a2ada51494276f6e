"""Memory accounting of the PyTorch port against the JAX package.

The analytic side is held byte for byte: ``train_memory_report``,
``kv_pool_bytes``, ``sparse_kv_blocks_per_seq`` and
``quantization_scratch_bytes`` on the same leaf specs, and the training
engines' own component bytes on a tiny GPT-2 at ZeRO stages 0, 1 and 2,
at bf16 and fp16, and under ZeRO-Offload (the gloo world of 2 is in
test_torch_zero.py). The measured side reads the CUDA allocator; on the
CPU it reports nothing (``modeled: False``), and its running maximum over
reset windows is held here on a stand-in allocator.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2Model as JGPT2Model
from deepspeed_tpu.runtime import comm_accounting as jca
from deepspeed_tpu.runtime import memory_accounting as jmem
from deepspeed_tpu.runtime.engine import _first_micro
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from deepspeed_tpu_torch.runtime import comm_accounting as tca
from deepspeed_tpu_torch.runtime import memory_accounting as tmem

SHAPES = [("wte", (50304, 64), 0), ("wpe", (1024, 64), 0),
          ("c_attn", (64, 192), 1), ("bias", (192,), None),
          ("odd", (7, 3), 0), ("ln", (64,), None)]


def _leaves(mod):
    return [mod.LeafSpec(n, s, d) for n, s, d in SHAPES]


@pytest.mark.parametrize("dp", [1, 2, 4])
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
@pytest.mark.parametrize("kw", [
    {}, {"compute_dtype": "bfloat16"}, {"compute_dtype": "float16",
                                        "optimizer_slots": 1},
    {"cpu_offload": True, "compute_dtype": "bfloat16"},
    {"quantized_gradients": True, "block_size": 64,
     "gathered_stage3_bytes": 4096, "stash_bytes": 8,
     "extra_transient_bytes": 3},
])
def test_train_memory_report_equals_jax(dp, stage, kw):
    assert tmem.train_memory_report(_leaves(tca), dp, zero_stage=stage,
                                    **kw) \
        == jmem.train_memory_report(_leaves(jca), dp, zero_stage=stage, **kw)


@pytest.mark.parametrize("kw", [
    dict(kv_dtype="bfloat16"), dict(kv_dtype="float32"),
    dict(kv_dtype="float16", quantized=True),
    dict(kv_dtype="bfloat16", shards=2),
    dict(kv_dtype="bfloat16", shared_blocks=3, shared_refs=5),
])
def test_kv_pool_bytes_equals_jax(kw):
    args = (24, 194, 16, 16, 64)
    assert tmem.kv_pool_bytes(*args, **kw) == jmem.kv_pool_bytes(*args, **kw)
    # the torch dtype names the same bytes
    if not kw.get("quantized"):
        tkw = dict(kw, kv_dtype=getattr(torch, kw["kv_dtype"]))
        assert tmem.kv_pool_bytes(*args, **tkw) \
            == jmem.kv_pool_bytes(*args, **kw)


def test_small_builders_equal_jax():
    for n, bs, w, g in ((5, 16, 4, 1), (900, 16, 16, 1), (4096, 64, 3, 0)):
        kw = dict(num_sliding_window_blocks=w, num_global_blocks=g)
        assert tmem.sparse_kv_blocks_per_seq(n, bs, **kw) \
            == jmem.sparse_kv_blocks_per_seq(n, bs, **kw)
    for dp in (1, 2, 4):
        assert tmem.quantization_scratch_bytes(_leaves(tca), dp, 128) \
            == jmem.quantization_scratch_bytes(_leaves(jca), dp, 128)
    assert tmem.bytes_of((3, 5), torch.bfloat16) \
        == jmem.bytes_of((3, 5), np.float16) == 30
    t = torch.zeros(4, 6)
    assert tmem.leaf_device_bytes(t[:2]) == 48
    assert tmem.tree_device_bytes({"a": [t, None], "b": (t[0],)}) == 120


TINY = dict(vocab_size=256, n_positions=32, n_embd=64, n_layer=2, n_head=1)


def _config(stage, precision, offload):
    cfg = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
           "gradient_accumulation_steps": 2,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
           "zero_optimization": {"stage": stage, "cpu_offload": offload},
           "steps_per_print": 10 ** 9}
    if precision == "fp16":
        cfg["fp16"] = {"enabled": True, "loss_scale": 0}
    elif precision == "bf16":
        cfg["bf16"] = {"enabled": True}
    return cfg


_DTYPES = {"fp32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16),
           "fp16": (jnp.float16, torch.float16)}


@pytest.mark.parametrize("stage,precision,offload", [
    (0, "fp32", False), (1, "fp32", False), (2, "fp32", False),
    (0, "bf16", False), (1, "bf16", False), (2, "fp16", False),
    (2, "fp32", True), (2, "bf16", True), (1, "bf16", True),
])
def test_engine_components_equal_jax(stage, precision, offload):
    """Byte for byte on every component the JAX engine prices; under
    offload the port's device also holds its flat compute-dtype buffer
    (``offload_staging_bytes``), which the JAX engine does not have."""
    cfg = _config(stage, precision, offload)
    jdt, tdt = _DTYPES[precision]
    jeng = deepspeed_tpu.initialize(
        model=JGPT2Model(JGPT2Config(dtype=jdt, **TINY)),
        config_params=dict(cfg, mesh={"data": 1, "allow_partial": True}))[0]
    ids = np.zeros((2, 32), np.int64)
    jeng._ensure_state(_first_micro({"input_ids": ids[None],
                                     "labels": ids[None]}))
    eng = deepspeed_tpu_torch.initialize(
        model=GPT2Model(GPT2Config(dtype=tdt, **TINY)), config_params=cfg,
        device="cpu")[0]
    want = jeng._analytic_memory_components()
    got = eng._analytic_memory_components()
    assert {k: got["components"][k] for k in want["components"]} \
        == want["components"]
    if offload:
        assert set(got["components"]) - set(want["components"]) \
            == {"offload_staging_bytes"}
    else:
        assert got == want
    rep = eng.memory_report()
    assert rep["analytic"] == got and rep["armed"] is False
    assert rep["devices"][0]["bytes_in_use"] is None


def test_measured_side_on_the_cpu_reports_nothing(tmp_path):
    assert tmem.normalize_memory_stats("cpu") is None
    assert tmem.normalize_memory_stats({}) is None
    assert tmem.normalize_memory_stats(None) is None
    stats = {"allocated_bytes.all.current": 5, "allocated_bytes.all.peak": 9}
    assert tmem.normalize_memory_stats(stats) == {
        "bytes_in_use": 5, "peak_bytes_in_use": 9, "bytes_limit": None}
    entry = tmem.device_memory_report("cpu")[0]
    assert entry["platform"] == "cpu" and entry["headroom_bytes"] is None
    acct = tmem.MemoryAccounting("cpu")
    acct.register("micro_step", calls_per_step=2)
    acct.begin("micro_step")
    acct.end("micro_step")
    assert acct.device_peak_bytes() is None
    assert acct.measured_memory() == {"micro_step": {
        "calls_per_step": 2.0, "analytic_argument_bytes": None,
        "modeled": False}}
    cfg = dict(_config(0, "fp32", False),
               telemetry={"enabled": True, "memory": True})
    eng = deepspeed_tpu_torch.initialize(
        model=GPT2Model(GPT2Config(dtype=torch.float32, **TINY)),
        config_params=cfg, device="cpu")[0]
    ids = np.zeros((2, 2, 32), np.int64)
    eng.train_batch(batch={"input_ids": ids, "labels": ids})
    rep = eng.memory_report()
    assert rep["armed"] and rep["cross_check"] == {}
    assert {k: v["modeled"] for k, v in rep["measured"].items()} \
        == {"micro_step": False, "apply_step": False}


class _Allocator:
    """A stand-in for the CUDA allocator's counters."""

    def __init__(self):
        self.cur = self.peak = 0

    def alloc(self, n):
        self.cur += n
        self.peak = max(self.peak, self.cur)

    def free(self, n):
        self.cur -= n

    def install(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "memory_allocated",
                            lambda device=None: self.cur)
        monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                            lambda device=None: self.peak)
        monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                            lambda device=None: setattr(self, "peak",
                                                        self.cur))


def test_windows_keep_the_peak_no_reset_would_have_lost(monkeypatch):
    """Each window's transient is its peak less the bytes in use at its
    start; the device peak is what the counter would read had no window
    reset it, and the analytic claim is cross-checked at 15 %."""
    a = _Allocator()
    a.install(monkeypatch)
    acct = tmem.MemoryAccounting(torch.device("cuda", 0))
    acct.register("micro_step", calls_per_step=2)
    a.alloc(1000)                   # the state
    a.alloc(500)
    a.free(500)                     # an earlier peak of 1500
    for extra in (300, 700, 200):
        acct.begin("micro_step")
        a.alloc(extra)
        a.free(extra)
        acct.end("micro_step")
    a.alloc(50)
    a.free(50)                      # after the last window
    m = acct.measured_memory()["micro_step"]
    assert (m["transient_bytes"], m["peak_bytes"], m["windows"]) \
        == (700, 1700, 3)
    assert m["modeled"] is True
    assert acct.device_peak_bytes() == 1700
    acct.note("train_state", in_use_bytes=a.cur)
    acct.expect("train_state", "state", lambda: 900, field="in_use_bytes")
    assert acct.cross_check()["train_state"]["underestimated"] is False
    acct.expect("train_state", "state", 800, field="in_use_bytes")
    verdict = acct.cross_check(warn=False)["train_state"]
    assert verdict["underestimated"] is True and verdict["ratio"] == 1.25


def test_cross_check_matches_jax_on_the_same_numbers():
    """The verdict rule is the JAX ledger's: more than the tolerance over
    the analytic claim is an underestimate."""
    for measured, analytic in ((1150, 1000), (1151, 1000), (10, 0)):
        acct = tmem.MemoryAccounting("cpu")
        acct.note("p", transient_bytes=measured)
        acct.expect("p", "x", analytic)
        got = acct.cross_check(warn=False)["p"]
        j = jmem.MemoryAccounting()
        j.register("p", lambda: None)
        j._measured["p"] = {"transient_bytes": measured}
        j.measured_memory = lambda: {"p": {"transient_bytes": measured}}
        j.expect("p", "x", analytic, field="transient_bytes")
        want = j.cross_check(warn=False)["p"]
        assert got == want
