"""Engine, config, optimizer and package boundary of the PyTorch port,
against the JAX package where both have the function.

The engine comparison runs three train_batch steps of one tiny fp32 GPT-2
through both engines with one ds_config (Adam with weight decay, WarmupLR,
gas 2, clipping); the port starts from the parameters the JAX engine
initializes under seed 42. Per-step losses and gradient norms match at
rtol 1e-4: both engines run the same fp32 arithmetic in different
summation orders, and three Adam steps keep the drift around 1e-6.
"""
import ast
import os
import shutil
import subprocess
import sys
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2Model as JGPT2Model
from deepspeed_tpu.ops.adam.fused_adam import FusedAdam as JFusedAdam
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
from deepspeed_tpu.runtime.lr_schedules import \
    SCHEDULER_REGISTRY as J_SCHEDULERS
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.lr_schedules import SCHEDULER_REGISTRY
from deepspeed_tpu_torch.runtime.resilience import atomic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "deepspeed_tpu_torch")
TINY = dict(vocab_size=256, n_positions=64, n_embd=64, n_layer=2, n_head=2)
RTOL = 1e-4
DS_CONFIG = {
    "train_batch_size": 4,
    "train_micro_batch_size_per_gpu": 2,
    "gradient_accumulation_steps": 2,
    "optimizer": {"type": "Adam",
                  "params": {"lr": 3e-3, "weight_decay": 0.01}},
    "scheduler": {"type": "WarmupLR",
                  "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 3e-3,
                             "warmup_num_steps": 2}},
    "gradient_clipping": 0.5,
    "steps_per_print": 10 ** 9,
}


def test_three_train_batch_steps_match_jax_engine():
    from deepspeed_tpu.runtime.engine import _first_micro

    ids = np.random.default_rng(0).integers(0, TINY["vocab_size"],
                                            (2, 2, 64))
    batch = {"input_ids": ids, "labels": ids.copy()}
    jeng, _, _, _ = deepspeed_tpu.initialize(
        model=JGPT2Model(JGPT2Config(dtype=jnp.float32, **TINY)),
        config_params=dict(DS_CONFIG, mesh={"data": 1,
                                            "allow_partial": True}))
    # the parameters the JAX engine starts from (seed 42)
    jeng._ensure_state(_first_micro(batch))
    init = {k: np.asarray(v) for k, v in _flatten(jeng.state.params).items()}

    cfg = GPT2Config(dtype=torch.float32, **TINY)
    eng, opt, loader, sched = deepspeed_tpu_torch.initialize(
        model=GPT2Model(cfg), config_params=DS_CONFIG, device="cpu")
    assert opt is eng.optimizer and loader is None
    assert sched is eng.lr_scheduler
    eng.module.load_state_dict(params_from_jax(_unflatten(init), cfg))

    for step in range(3):
        jloss = float(jeng.train_batch(batch=batch))
        jnorm = float(jeng._last_metrics["grad_norm"])
        loss = eng.train_batch(batch=batch)
        np.testing.assert_allclose(loss.item(), jloss, rtol=RTOL,
                                   err_msg=f"loss of step {step + 1}")
        np.testing.assert_allclose(float(eng._last_metrics["grad_norm"]),
                                   jnorm, rtol=RTOL,
                                   err_msg=f"grad norm of step {step + 1}")
        assert eng.get_lr() == pytest.approx(jeng.get_lr())
    assert eng.global_steps == jeng.global_steps == 3
    assert eng.micro_steps == 6


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = v
    return out


def _unflatten(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def test_forward_backward_step_equals_train_batch():
    """The manual loop (forward/backward x gas, step) and train_batch give
    the same parameters."""
    cfg = GPT2Config(dtype=torch.float32, **TINY)
    ids = np.random.default_rng(1).integers(0, TINY["vocab_size"],
                                            (2, 2, 64))
    batch = {"input_ids": ids, "labels": ids.copy()}
    a, _, _, _ = deepspeed_tpu_torch.initialize(
        model=GPT2Model(cfg), config_params=DS_CONFIG, device="cpu")
    b, _, _, _ = deepspeed_tpu_torch.initialize(
        model=GPT2Model(cfg), config_params=DS_CONFIG, device="cpu")
    a.train_batch(batch=batch)
    for i in range(2):
        loss = b({k: v[i] for k, v in batch.items()})
        b.backward(loss)
        assert b.is_gradient_accumulation_boundary() == (i == 1)
        b.step()
    assert b.global_steps == 1
    for p, q in zip(a.module.parameters(), b.module.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="without a preceding forward"):
        b.backward()
    b.eval()
    assert b({k: v[0] for k, v in batch.items()}).requires_grad is False


@pytest.mark.parametrize("sizes", [
    dict(train_batch_size=8, train_micro_batch_size_per_gpu=2),
    dict(train_batch_size=8, gradient_accumulation_steps=4),
    dict(train_micro_batch_size_per_gpu=2, gradient_accumulation_steps=3),
    dict(train_batch_size=6),
    dict(train_micro_batch_size_per_gpu=5),
])
def test_batch_triangulation_matches_jax(sizes):
    ours, theirs = DeepSpeedConfig(dict(sizes), world_size=1), \
        JConfig(dict(sizes), world_size=1)
    for attr in ("train_batch_size", "train_micro_batch_size_per_gpu",
                 "gradient_accumulation_steps"):
        assert getattr(ours, attr) == getattr(theirs, attr)


def test_inconsistent_batch_sizes_raise():
    with pytest.raises(AssertionError, match="train_batch_size is not equal"):
        DeepSpeedConfig({"train_batch_size": 8,
                         "train_micro_batch_size_per_gpu": 3,
                         "gradient_accumulation_steps": 2}, world_size=1)


def test_duplicate_config_keys_raise(tmp_path):
    path = tmp_path / "ds_config.json"
    path.write_text('{"train_batch_size": 2, "train_batch_size": 4}')
    with pytest.raises(ValueError, match="train_batch_size"):
        DeepSpeedConfig(str(path))
    with pytest.raises(ValueError, match="train_batch_size"):
        deepspeed_tpu_torch.initialize(
            model=GPT2Model(GPT2Config(dtype=torch.float32, **TINY)),
            config_params=str(path), device="cpu")


@pytest.mark.parametrize("adam_w_mode", [True, False])
@pytest.mark.parametrize("bias_correction", [True, False])
def test_fused_adam_matches_jax(adam_w_mode, bias_correction):
    rng = np.random.default_rng(2)
    p0 = [rng.standard_normal((5, 3)).astype(np.float32),
          rng.standard_normal(7).astype(np.float32)]
    grads = [[rng.standard_normal(p.shape).astype(np.float32) for p in p0]
             for _ in range(3)]
    kw = dict(lr=1e-2, weight_decay=0.1, adam_w_mode=adam_w_mode,
              bias_correction=bias_correction)
    jopt = JFusedAdam(**kw)
    jparams = [jnp.asarray(p) for p in p0]
    jstate = jopt.init_state(jparams)
    opt = FusedAdam(**kw)
    params = [torch.tensor(p) for p in p0]
    opt.init_state(params)
    for step, g in enumerate(grads):
        scale = 2.0 if step == 1 else 1.0
        jparams, jstate = jopt.update([jnp.asarray(x) for x in g], jstate,
                                      jparams, scale=scale)
        opt.update(params, [torch.tensor(x) for x in g], scale=scale)
        for a, b in zip(params, jparams):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)
    with pytest.raises(ValueError, match="amsgrad"):
        FusedAdam(amsgrad=True)


@pytest.mark.parametrize("name,params", [
    ("WarmupLR", dict(warmup_min_lr=0.0, warmup_max_lr=1e-3,
                      warmup_num_steps=10)),
    ("WarmupDecayLR", dict(total_num_steps=30, warmup_max_lr=1e-3,
                           warmup_num_steps=10)),
    ("OneCycle", dict(cycle_min_lr=1e-4, cycle_max_lr=1e-3,
                      cycle_first_step_size=5, decay_lr_rate=0.1)),
    ("LRRangeTest", dict(lr_range_test_min_lr=1e-4,
                         lr_range_test_step_size=3)),
])
def test_lr_schedules_match_jax(name, params):
    ours, theirs = SCHEDULER_REGISTRY[name](**params), \
        J_SCHEDULERS[name](**params)
    assert [ours.step() for _ in range(40)] == \
        [theirs.step() for _ in range(40)]


@pytest.mark.parametrize("extra,item", [
    # ZeRO stage 3 and the quantized collectives (A13's ZeRO half) run
    # now: the engine accepts them (item None)
    pytest.param({"zero_optimization": {"stage": 2,
                                        "quantized_gradients": True}},
                 None, id="extra0-A13"),
    pytest.param({"zero_optimization": {"stage": 3}}, None,
                 id="extra1-A13"),
    # ZeRO-Offload (A14) and activation checkpoints in host memory (A14b)
    # both run now: the engine accepts the pair (item None)
    pytest.param({"zero_optimization": {"stage": 2, "cpu_offload": True},
                  "activation_checkpointing": {"cpu_checkpointing": True}},
                 None, id="extra2-A14"),
    # the model axis (A7b) is the grid's now: model 2 in a world of one
    # raises the JAX mesh's message (tests/test_torch_tp.py trains it)
    pytest.param({"mesh": {"model": 2}}, ValueError, id="extra3-A7"),
    ({"mesh": {"pipe": 2}}, "A12"),
    # 1-bit Adam and 0/1 Adam (A13b) run now: in a world of one their
    # wires are disarmed, as the JAX engine disarms them at dp 1
    pytest.param({"optimizer": {"type": "OneBitAdam",
                                "params": {"lr": 1e-3}}}, None,
                 id="extra5-A13"),
    pytest.param({"optimizer": {"type": "ZeroOneAdam",
                                "params": {"lr": 1e-3}}}, None,
                 id="extra6-A13"),
    # asynchronous commits (A16) run now in one process: the commit is in
    # flight after save_checkpoint and published by wait_pending_commit
    pytest.param({"resilience": {"async_commit": True}}, None,
                 id="extra7-A16"),
])
def test_unported_configurations_raise(extra, item):
    def build():
        return deepspeed_tpu_torch.initialize(
            model=GPT2Model(GPT2Config(dtype=torch.float32, **TINY)),
            config_params=dict(DS_CONFIG, **extra), device="cpu")[0]

    if item is None:
        eng = build()
        if "resilience" in extra:
            ids = np.random.default_rng(3).integers(0, 256, (2, 2, 64))
            eng.train_batch(batch={"input_ids": ids, "labels": ids})
            save_dir = tempfile.mkdtemp()
            eng.save_checkpoint(save_dir)
            assert eng.pending_commit()
            assert eng.wait_pending_commit() and not eng.pending_commit()
            assert atomic.read_latest(save_dir) == "global_step1"
            assert atomic.verify_tag(os.path.join(save_dir,
                                                  "global_step1"))[0]
            shutil.rmtree(save_dir)
            return
        if "optimizer" in extra:
            assert eng.optimizer.name == extra["optimizer"]["type"].lower()
            assert eng._wire is None and eng.optimizer.group is None
            ids = np.random.default_rng(3).integers(0, 256, (2, 2, 64))
            assert np.isfinite(eng.train_batch(
                batch={"input_ids": ids, "labels": ids}).item())
            return
        if eng._config.zero_config.cpu_offload:
            assert eng._offload and \
                eng._config.activation_checkpointing_config.cpu_checkpointing
        else:
            assert eng.zero_optimization_stage() == \
                extra["zero_optimization"]["stage"]
            # a world of one: nothing to quantize or partition, as the
            # JAX engine disarms both at dp 1
            assert not eng._qgz_armed and not eng._s3_sched_armed
        return
    if isinstance(item, type):
        with pytest.raises(item, match="1 devices not divisible by fixed "
                           "axes product 2"):
            build()
        return
    with pytest.raises(NotImplementedError, match=item):
        build()


def test_zero_stage_2_on_one_device_trains():
    eng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=GPT2Model(GPT2Config(dtype=torch.float32, **TINY)),
        config_params=dict(DS_CONFIG, zero_optimization={"stage": 2}),
        device="cpu")
    ids = np.random.default_rng(3).integers(0, 256, (2, 2, 64))
    losses = [eng.train_batch(batch={"input_ids": ids, "labels": ids}).item()
              for _ in range(3)]
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("mode", ["bf16", "remat_dropout", "data_iter"])
def test_engine_trains_in_each_supported_mode(mode):
    """bf16 compute over fp32 master weights, per-block remat with dropout
    (generator replayed in the recompute), and micro-batches drawn from a
    data iterator: losses finite and falling, master weights stay fp32 and
    the module's parameters are the compute-dtype copy."""
    over = {"bf16": dict(dtype=torch.bfloat16),
            "remat_dropout": dict(dtype=torch.float32, remat=True,
                                  dropout=0.1),
            "data_iter": dict(dtype=torch.float32)}[mode]
    config = dict(DS_CONFIG, bf16={"enabled": mode == "bf16"})
    eng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=GPT2Model(GPT2Config(**dict(TINY, **over))),
        config_params=config, device="cpu")
    ids = np.random.default_rng(4).integers(0, 256, (2, 2, 64))
    losses = []
    for _ in range(4):
        if mode == "data_iter":
            micros = iter([{"input_ids": ids[i], "labels": ids[i]}
                           for i in range(2)])
            loss = eng.train_batch(data_iter=micros)
        else:
            loss = eng.train_batch(batch={"input_ids": ids, "labels": ids})
        losses.append(loss.item())
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert all(p.dtype == torch.float32 for p in eng.master)
    want = torch.bfloat16 if mode == "bf16" else torch.float32
    assert all(p.dtype == want for p in eng.module.parameters())
    assert eng.eval_loss({"input_ids": ids[0], "labels": ids[0]}).item() \
        < losses[0]


def test_initialize_without_cuda_raises_unless_cpu_is_asked_for():
    model = GPT2Model(GPT2Config(dtype=torch.float32, **TINY))
    if torch.cuda.is_available():
        eng, _, _, _ = deepspeed_tpu_torch.initialize(
            model=model, config_params=DS_CONFIG)
        assert eng.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            deepspeed_tpu_torch.initialize(model=model,
                                           config_params=DS_CONFIG)


def test_import_does_not_load_jax():
    code = ("import sys, deepspeed_tpu_torch, "
            "deepspeed_tpu_torch.runtime.engine, "
            "deepspeed_tpu_torch.models.gpt2, "
            "deepspeed_tpu_torch.models.convert, "
            "deepspeed_tpu_torch.models.bert, "
            "deepspeed_tpu_torch.ops.sparse_attention, "
            "deepspeed_tpu_torch.ops.transformer, "
            "deepspeed_tpu_torch.ops.op_builder, "
            "deepspeed_tpu_torch.parallel.mesh, "
            "deepspeed_tpu_torch.runtime.comm_accounting, "
            "deepspeed_tpu_torch.runtime.dataloader, "
            "deepspeed_tpu_torch.runtime.utils, "
            "deepspeed_tpu_torch.runtime.zero.partition, "
            "deepspeed_tpu_torch.runtime.zero.utils, "
            "deepspeed_tpu_torch.utils.distributed, "
            "deepspeed_tpu_torch.telemetry.programs, "
            "deepspeed_tpu_torch.telemetry.program_checks, "
            "deepspeed_tpu_torch.telemetry.program_lint, "
            "deepspeed_tpu_torch.runtime.activation_checkpointing"
            ".checkpointing; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'deepspeed_tpu', 'tools')]; assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("module", [
    "deepspeed_tpu_torch.ops.sparse_attention",
    "deepspeed_tpu_torch.ops.sparse_attention.block_sparse_kernel",
    "deepspeed_tpu_torch.ops.transformer.transformer",
    "deepspeed_tpu_torch.models.bert",
    "deepspeed_tpu_torch.models.generation",
    "deepspeed_tpu_torch.serving",
    "deepspeed_tpu_torch.moe",
])
def test_module_imports_first_in_a_fresh_process(module):
    """Each of these imports on its own (no import cycle between the
    attention packages, whichever is imported first)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", f"import {module}"],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_no_port_file_imports_jax_flax_or_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        bad = set(_imported_roots(path)) & {"jax", "flax", "deepspeed_tpu",
                                            "tools"}
        assert not bad, f"{path} imports {bad}"


def test_kernel_sources_ship_with_the_package():
    from deepspeed_tpu_torch.ops.op_builder import SOURCES

    source = SOURCES["flash_attention"]
    assert os.path.exists(source), source
    text = open(source).read()
    assert "deepspeed_tpu/ops/transformer/flash_attention.py" in text
    setup = open(os.path.join(REPO, "setup.py")).read()
    assert "deepspeed_tpu_torch" in setup and "csrc/*.cu" in setup


def test_every_kernel_source_is_registered_and_ships():
    """Each CUDA source builds into its own library and names the Pallas
    functions it replaces; setup.py ships every csrc directory."""
    from deepspeed_tpu_torch.ops import op_builder

    assert set(op_builder.SOURCES) == {"flash_attention",
                                       "block_sparse_attention"}
    assert set(op_builder.SIGNATURES) == set(op_builder.SOURCES)
    paths = {name: op_builder.so_path(name) for name in op_builder.SOURCES}
    assert len(set(paths.values())) == 2
    text = open(op_builder.SOURCES["block_sparse_attention"]).read()
    assert "deepspeed_tpu/ops/sparse_attention/block_sparse_kernel.py" in text
    for fn in ("_fwd_kernel", "_bwd_dq_kernel", "_bwd_dkdv_kernel"):
        assert fn in text
    setup = open(os.path.join(REPO, "setup.py")).read()
    assert "ops/sparse_attention/csrc/*.cu" in setup


def test_library_path_follows_every_header_of_the_source_directory(
        tmp_path, monkeypatch):
    """A source's library name hashes the headers beside it too: an edited
    header must not load a library built from the old one."""
    from deepspeed_tpu_torch.ops import op_builder

    src = tmp_path / "kernels.cu"
    src.write_text('#include "helpers.cuh"\n')
    header = tmp_path / "helpers.cuh"
    monkeypatch.setitem(op_builder.SOURCES, "probe", str(src))
    paths = []
    for body in ("#define TILE 64\n", "#define TILE 128\n"):
        header.write_text(body)
        paths.append(op_builder.so_path("probe"))
    assert paths[0] != paths[1]
    header.write_text("#define TILE 64\n")
    assert op_builder.so_path("probe") == paths[0]


def test_library_paths_follow_the_shared_header(tmp_path, monkeypatch):
    """Both libraries include ops/transformer/csrc/hopper.cuh, the
    block-sparse one from outside its own directory: editing a copy of that
    header changes the hashed path of both, and restoring it restores
    them."""
    import shutil

    from deepspeed_tpu_torch.ops import op_builder

    ops = os.path.join(PORT, "ops")
    for name, src in list(op_builder.SOURCES.items()):
        rel = os.path.relpath(src, ops)
        shutil.copytree(os.path.dirname(src),
                        tmp_path / os.path.dirname(rel), dirs_exist_ok=True)
        monkeypatch.setitem(op_builder.SOURCES, name, str(tmp_path / rel))
    header = tmp_path / "transformer" / "csrc" / "hopper.cuh"
    sparse = op_builder.SOURCES["block_sparse_attention"]
    assert '#include "../../transformer/csrc/hopper.cuh"' in open(
        sparse).read()
    before = {n: op_builder.so_path(n) for n in op_builder.SOURCES}
    text = header.read_text()
    header.write_text(text + "// edited\n")
    after = {n: op_builder.so_path(n) for n in op_builder.SOURCES}
    assert all(after[n] != before[n] for n in before), (before, after)
    header.write_text(text)
    assert {n: op_builder.so_path(n) for n in op_builder.SOURCES} == before


def test_chip_smoke_refuses_without_cuda_or_package(tmp_path):
    """No result without a card, and none from a copy of the script alone."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    for cwd, script in ((REPO, os.path.join(REPO, "chip_smoke.py")),
                        (str(tmp_path), str(lone))):
        if cwd == REPO and torch.cuda.is_available():
            continue
        proc = subprocess.run([sys.executable, script], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
