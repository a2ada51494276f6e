"""The pipeline jobs of the session-shared gloo worlds of 2 and 4 ranks
(tests/test_torch_zero.py ``_world_dp2`` / ``_world_dp4``; the ranks'
side is tests/torch_zero_worker.py ``job_pipe``), read by
tests/test_torch_pipe.py.

- dp2 world: 1f1b (tied, saving its checkpoint) and ZB-H1 (untied) at
  ``{"pipe": 2}``, one process per stage; the single-controller layout at ``{"pipe": 2,
  "data": 2}`` (each rank drives its pipe line, the data line is the
  world) at ZeRO 1.
  The program lint's ``pipe`` and ``pipe-bf16`` families
  (telemetry/program_lint.py ``pipe_family``), clean and with a planted
  fault each.
- dp4 world: ``{"pipe": 2, "data": 2}``, one process per stage, at ZeRO
  1 and 2.

Each starts from the JAX PipelineEngine's initial parameters of its
model (``jax_init``), runs ``STEPS`` steps of gas ``GAS`` over
``global_batches(SEED, ...)`` and returns its losses and each owned
chunk's final master.
"""
import functools
import os

import torch_zero_worker as W

SEED = 5
STEPS = 3
GAS = 4
MICRO = 2
PIPE_TINY = dict(W.TINY, n_layer=4)


def job(name, mesh, schedule="1f1b", untied=False, stage=0, init=None,
        save=None):
    return (name, "pipe", dict(mesh=mesh, schedule=schedule, untied=untied,
                               stage=stage, steps=STEPS, gas=GAS, seed=SEED,
                               micro=MICRO, init=init, save=save))


@functools.lru_cache(maxsize=None)
def jax_engine(untied=False, dp=1, stage=0):
    """The JAX PipelineEngine at pipe 2 x data ``dp`` of the worlds'
    config (imports JAX: the launcher's side only)."""
    import jax.numpy as jnp

    import deepspeed_tpu
    from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
    from deepspeed_tpu.models.gpt2_pipe import gpt2_pipeline_module

    mod = gpt2_pipeline_module(JGPT2Config(dtype=jnp.float32, **PIPE_TINY),
                               untied_head=untied)
    cfg = W.pipe_config({"pipe": 2, "data": dp, "allow_partial": True},
                        "1f1b", stage, GAS, MICRO, dp)
    return deepspeed_tpu.initialize(model=mod, config_params=cfg)[0]


@functools.lru_cache(maxsize=None)
def jax_init(untied=False):
    """The JAX engine's initial parameters in the port's pipeline names
    (fp32 tensors)."""
    import jax
    import numpy as np
    import torch

    from deepspeed_tpu_torch.models.convert import pipe_params_from_jax
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config
    from deepspeed_tpu_torch.models.gpt2_pipe import gpt2_pipeline_module

    jeng = jax_engine(untied)
    ids = W.global_batches(SEED, 1, GAS, MICRO)[0]
    jeng._ensure_pipe_state({"input_ids": ids[0], "labels": ids[0]})
    tree = {}
    for st in jeng.stage_states:
        for key, sub in jax.device_get(st.params).items():
            tree.setdefault(key, jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float32), sub))
    mod = gpt2_pipeline_module(GPT2Config(dtype=torch.float32, **PIPE_TINY),
                               untied_head=untied)
    return pipe_params_from_jax(tree, mod)


def dp2_jobs(out):
    """``out``: the world's directory; the 1f1b job saves its checkpoint
    (one process per stage: every stage's layers gathered to rank 0) in
    ``out/pipe_tag``."""
    return [job("pipe_1f1b", {"pipe": 2}, init=jax_init(),
                save=os.path.join(out, "pipe_tag")),
            job("pipe_zb", {"pipe": 2}, "zb-h1", untied=True,
                init=jax_init(True)),
            job("pipe_line_z1", {"pipe": 2, "data": 2}, stage=1,
                init=jax_init())] + [
        (f"lint_{f}", "pipe_lint", {"family": f})
        for f in ("pipe", "pipe-bf16")]


def dp4_jobs():
    return [job(f"pipe_z{s}", {"pipe": 2, "data": 2}, stage=s,
                init=jax_init()) for s in (1, 2)]
