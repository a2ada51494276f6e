"""The JAX engine's side of the ZeRO-3 and int8-collective tests of the
PyTorch port (tests/test_torch_zero3.py), run in a process of its own.

    python tests/jax_zero_reference.py SPEC

SPEC is a pickle {"out": path, "jobs": [(name, kind, kwargs)]}; the
results {name: result} are pickled to ``out``. Each JAX engine runs on
virtual CPU devices at ``mesh {"data": dp}``, as tests/conftest.py sets
them up. A separate process, because one JAX configuration aborts the
whole process on the CPU backend (bf16 qgZ: ROADMAP C-w1), and an abort
must not take a test worker down with it.
"""
import os
import pickle
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _setup():
    """JAX on virtual CPU devices (as tests/conftest.py sets it up), and
    the modules the jobs use as globals."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    global jax, jnp, deepspeed_tpu, W, JGPT2Config, JGPT2Model
    global npz_dict_to_leaves, _first_micro
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_threefry_partitionable", True)
    from deepspeed_tpu.utils.jax_compat import ensure_compat

    ensure_compat()
    import deepspeed_tpu
    import torch_zero_worker as W
    from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
    from deepspeed_tpu.models.gpt2 import GPT2Model as JGPT2Model
    from deepspeed_tpu.runtime.checkpoint_utils import npz_dict_to_leaves
    from deepspeed_tpu.runtime.engine import _first_micro


def engine(dp, stage, gas, zero=None, offload=False, fp16=False):
    cfg = dict(W.ds_config(dp, stage, gas, zero=zero, offload=offload,
                           fp16=fp16),
               mesh={"data": dp, "allow_partial": True})
    dtype = jnp.float16 if fp16 else jnp.float32
    return deepspeed_tpu.initialize(
        model=JGPT2Model(JGPT2Config(dtype=dtype, **W.TINY)),
        config_params=cfg)[0]


def port_names(tree):
    """A JAX parameter tree as {port parameter name: numpy}."""
    import torch

    from deepspeed_tpu_torch.models.convert import params_from_jax
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config

    cfg = GPT2Config(dtype=torch.float32, **W.TINY)
    return {n: t.numpy() for n, t in params_from_jax(tree, cfg).items()}


def _contracts(eng, names):
    """{program: (contract, calls_per_step, donated)} of ``names``, the
    donated flat indices as the state fields (arg 0) or "stash" (arg 1)
    they name, tiny leaves under ``donation_min_elements`` left out."""
    summary = eng.program_registry.summary()
    out = {}
    for name in names:
        c = dict(summary[name]["contract"])
        out[name] = (c, summary[name]["calls_per_step"],
                     sorted(eng._zero3_donated.get(name, set())))
    return out


def _capture_donations(eng):
    """Record, at each program's registration, which argument each
    donated flat index lands in (state fields by name, the stash as
    "stash")."""
    import deepspeed_tpu.telemetry as jtelemetry

    eng._zero3_donated = {}
    original = jtelemetry.register_program

    def capture(programs, name, jit_fn, args, **kw):
        if programs is not None and not programs.has(name):
            result = original(programs, name, jit_fn, args, **kw)
            contract = programs.summary()[name]["contract"]
            leaves = jax.tree_util.tree_flatten_with_path(args)[0]
            floor = contract.get("donation_min_elements", 0)
            got = set()
            for i in contract.get("donates", ()):
                path, leaf = leaves[i]
                if np.size(leaf) < floor:
                    continue
                got.add("stash" if path[0].idx == 1 else path[1].name)
            eng._zero3_donated[name] = got
            return result
        return original(programs, name, jit_fn, args, **kw)

    jtelemetry.register_program = capture
    return lambda: setattr(jtelemetry, "register_program", original)


def job_train(dp, stage, gas, steps, seed, zero=None, offload=False,
              save=None, programs=None):
    """``steps`` train_batch steps from the engine's own initial
    parameters (seed 42, the port's ``init``) on the tests' global
    batches: losses, grad norms, the final master (port names), the comm
    and stage-3 reports, the analytic memory; ``save``: a tag after the
    last step; ``programs``: then gas forward / backward / step calls
    (and eval_loss) and the contracts of the programs they register."""
    eng = engine(dp, stage, gas, zero=zero, offload=offload)
    restore = _capture_donations(eng)
    batches = W.global_batches(seed, steps, gas, dp * W.MICRO)
    eng._ensure_state(_first_micro({"input_ids": batches[0],
                                    "labels": batches[0]}))
    out = {"losses": [], "norms": []}
    for b in batches:
        out["losses"].append(float(eng.train_batch(
            batch={"input_ids": b, "labels": b})))
        out["norms"].append(float(eng.get_global_grad_norm()))
    if offload:
        tree = jax.tree_util.tree_unflatten(
            eng._host_treedef, [np.asarray(x) for x in
                                eng._host_master_flat])
    else:
        state = jax.device_get(eng.state)
        tree = state.master if state.master is not None else state.params
    out["master"] = port_names(jax.tree_util.tree_map(np.asarray, tree))
    out["report"] = eng.comm_volume_report()
    out["stage3"] = eng.stage3_report()
    out["memory"] = eng._analytic_memory_components()
    if save is not None:
        eng.save_checkpoint(save, backend="npz")
        out["saved"] = os.path.join(save, f"global_step{steps}")
    if programs is not None:
        micro = _first_micro({"input_ids": batches[0], "labels": batches[0]})
        for _ in range(gas):
            loss = eng(micro)
            eng.backward(loss)
            eng.step()
        if "eval_loss" in programs:
            eng.eval_loss(micro)
        out["contracts"] = _contracts(eng, programs)
    restore()
    return out


def job_load(dp, stage, gas, load, seed, step):
    """A JAX engine loads the port's tag ``load``: the state leaves it
    holds against the npz's, and the loss of global batch ``step``."""
    eng = engine(dp, stage, gas)
    batches = W.global_batches(seed, step + 1, gas, dp * W.MICRO)
    eng._ensure_state(_first_micro({"input_ids": batches[0],
                                    "labels": batches[0]}))
    path, _ = eng.load_checkpoint(load)
    with np.load(os.path.join(path, "model_states.npz")) as data:
        saved = npz_dict_to_leaves(data)
    got = jax.tree_util.tree_leaves(jax.device_get(eng.state))
    same = len(got) == len(saved) and all(
        np.array_equal(np.asarray(x), np.asarray(y))
        for x, y in zip(got[:-1], saved[:-1]))           # not the rng
    loss = float(eng.train_batch(batch={"input_ids": batches[step],
                                        "labels": batches[step]}))
    return {"global_steps": eng.global_steps, "same": same, "loss": loss}


def job_collectives(cases, seed):
    """The JAX ``quantized_reduce_scatter`` and ``quantized_all_gather``
    under ``shard_map`` over w virtual CPU devices, compiled as the
    engine compiles them (jit), on numpy-seeded inputs: for each case
    (kind, w, intra_size, shape, dim, block_size) the inputs and every
    device's output."""
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from deepspeed_tpu.runtime import custom_collectives as cc

    rng = np.random.default_rng(seed)
    out = []
    for kind, w, k, shape, dim, block in cases:
        mesh = Mesh(np.array(jax.devices()[:w]), ("data",))
        if kind == "reduce_scatter":
            xs = rng.standard_normal((w,) + shape).astype(np.float32)

            def body(x, dim=dim, block=block, k=k):
                return cc.quantized_reduce_scatter(
                    x[0], "data", dim=dim, block_size=block,
                    intra_size=k)[None]

            f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("data"),
                                      out_specs=P("data"), check_vma=False))
            out.append((xs, np.asarray(f(jnp.asarray(xs)))))
            continue
        full = rng.standard_normal(shape).astype(np.float32)
        spec = [None] * len(shape)
        spec[dim] = "data"
        x = jax.device_put(jnp.asarray(full), NamedSharding(mesh, P(*spec)))
        with jax.set_mesh(mesh):
            got = jax.jit(lambda v, dim=dim, block=block:
                          cc.quantized_all_gather(v, mesh, dim=dim,
                                                  block_size=block))(x)
        out.append((full, np.asarray(got)))
    return out


def job_codec(shapes, seed, block_size):
    """The JAX codec compiled (jit), as the engine runs it, and its numpy
    twins, on numpy-seeded rows: for each shape the input and the
    outputs of quantize_rows / dequantize_rows, quantize_blockwise_ef,
    quantize_signs_rows / dequantize_signs_rows, quantize_blockwise_np /
    dequantize_blockwise_np and quantize_signs_rows_np."""
    from deepspeed_tpu.runtime import quantization as qz

    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        x = (rng.standard_normal(shape) * rng.uniform(
            1e-3, 10, (shape[0], 1))).astype(np.float32)
        res = rng.standard_normal(shape[1]).astype(np.float32) * 1e-2
        q, s = jax.jit(lambda v: qz.quantize_rows(v, block_size))(x)
        deq = jax.jit(lambda a, b: qz.dequantize_rows(a, b, shape[1]))(q, s)
        ef = jax.jit(lambda v, r: qz.quantize_blockwise_ef(
            v, r, block_size))(x[0], res)
        sp, ss = jax.jit(lambda v: qz.quantize_signs_rows(v, block_size))(x)
        sdeq = jax.jit(lambda a, b: qz.dequantize_signs_rows(
            a, b, shape[1], block_size=block_size))(sp, ss)
        qn, sn = qz.quantize_blockwise_np(x[0], block_size)
        out.append({
            "x": x, "res": res, "q": np.asarray(q), "s": np.asarray(s),
            "deq": np.asarray(deq), "ef": [np.asarray(t) for t in ef],
            "signs": np.asarray(sp), "sign_scales": np.asarray(ss),
            "sign_deq": np.asarray(sdeq), "q_np": qn, "s_np": sn,
            "deq_np": qz.dequantize_blockwise_np(qn, sn, shape[1]),
            "signs_np": qz.quantize_signs_rows_np(x, block_size)})
    return out


def _wire_engine(dp, gas, optimizer, opt_params, model, stage=0,
                 sparse=False, offload=False, lr=1e-3):
    """A JAX engine of the 1-bit / 0/1 Adam and CSR tests: the tiny GPT-2
    or (``model="embed"``) the tests' SimpleEmbedModel, no clipping."""
    cfg = dict(W.ds_config(dp, stage, gas, optimizer, opt_params=opt_params,
                           clipping=0.0, sparse=sparse, offload=offload,
                           lr=lr),
               mesh={"data": dp, "allow_partial": True})
    if model == "embed":
        from unit.simple_model import SimpleEmbedModel

        net = SimpleEmbedModel(**W.EMBED)
    else:
        net = JGPT2Model(JGPT2Config(dtype=jnp.float32, **W.TINY))
    return deepspeed_tpu.initialize(model=net, config_params=cfg)[0]


def _wire_batches(model, seed, steps, gas, rows):
    if model == "embed":
        data = W.embed_batches(seed, steps, gas, rows)
        return [{"ids": data["ids"][s], "y": data["y"][s]}
                for s in range(steps)]
    return [{"input_ids": b, "labels": b}
            for b in W.global_batches(seed, steps, gas, rows)]


def _master_tree(eng):
    if eng._offload:
        tree = jax.tree_util.tree_unflatten(
            eng._host_treedef, [np.asarray(x) for x in
                                eng._host_master_flat])
    else:
        state = jax.device_get(eng.state)
        tree = state.master if state.master is not None else state.params
    return jax.tree_util.tree_map(np.asarray, tree)


def job_wire(dp, gas, steps, seed, optimizer="Adam", opt_params=None,
             model="gpt2", stage=0, sparse=False, offload=False,
             save_at=None, save=None, lr=1e-3):
    """The JAX side of torch_zero_worker.job_wire: ``steps`` train_batch
    steps from the engine's own initial parameters, each step's loss and
    comm report, the final master (port names for the GPT-2), the
    registered programs' contracts; ``save``: a tag after step
    ``save_at``."""
    eng = _wire_engine(dp, gas, optimizer, opt_params, model, stage,
                       sparse, offload, lr)
    batches = _wire_batches(model, seed, steps, gas, dp * W.MICRO)
    eng._ensure_state(_first_micro(batches[0]))
    out = {"losses": [], "reports": []}
    for step, b in enumerate(batches):
        out["losses"].append(float(eng.train_batch(batch=b)))
        out["reports"].append(eng.comm_volume_report(refresh=True))
        if save is not None and step + 1 == save_at:
            eng.save_checkpoint(save, backend="npz")
            out["saved"] = os.path.join(save, f"global_step{save_at}")
    tree = _master_tree(eng)
    out["master"] = port_names(tree) if model != "embed" else tree
    summary = eng.program_registry.summary()
    out["contracts"] = {name: {k: (v() if callable(v) else v)
                               for k, v in e["contract"].items()
                               if k != "donates"}
                        for name, e in summary.items()}
    return out


def job_wire_load(dp, gas, steps, seed, load, optimizer, opt_params,
                  lr=1e-3):
    """A JAX engine loads the port's tag ``load`` (the tiny GPT-2) and
    trains on to step ``steps`` of the same batches: the losses and the
    final master."""
    eng = _wire_engine(dp, gas, optimizer, opt_params, "gpt2", lr=lr)
    batches = _wire_batches("gpt2", seed, steps, gas, dp * W.MICRO)
    eng._ensure_state(_first_micro(batches[0]))
    eng.load_checkpoint(load)
    losses = [float(eng.train_batch(batch=b))
              for b in batches[eng.global_steps:]]
    return {"losses": losses, "master": port_names(_master_tree(eng))}


def job_wire_fns(w, seed, n, steps=3):
    """The JAX compressed_allreduce and quantized_all_reduce (bits 1 and
    8, flat and at w 4 intra size 2, block 32) under shard_map over w
    virtual CPU devices, jitted, on torch_zero_worker.wire_inputs,
    ``steps`` rounds with the residuals carried: each round's per-device
    (mean, worker residual, server residual)."""
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from deepspeed_tpu.runtime import custom_collectives as cc

    mesh = Mesh(np.array(jax.devices()[:w]), ("data",))
    x = W.wire_inputs(seed, steps, w, n)

    def rounds(fn):
        f = jax.jit(jax.shard_map(
            lambda a, b, c: tuple(t[None] for t in fn(a[0], b[0], c[0])),
            mesh=mesh, in_specs=(P("data"),) * 3, out_specs=(P("data"),) * 3,
            check_vma=False))
        we = np.zeros((w, n), np.float32)
        se = np.zeros((w, n // w), np.float32)
        got = []
        for s in range(steps):
            mean, we, se = (np.asarray(t) for t in f(x[s], we, se))
            got.append((mean, we, se))
        return got

    out = {"x": x, "onebit": rounds(
        lambda a, b, c: cc.compressed_allreduce(a, b, c, "data"))}
    for bits in (1, 8):
        for k in ((0, 2) if w == 4 else (0,)):
            out[f"zeroone_b{bits}_k{k}"] = rounds(
                lambda a, b, c, bits=bits, k=k: cc.quantized_all_reduce(
                    a, "data", bits=bits, block_size=32, intra_size=k,
                    worker_error=b, server_error=c))
    return out


JOBS = {"train": job_train, "load": job_load,
        "collectives": job_collectives, "codec": job_codec,
        "wire": job_wire, "wire_load": job_wire_load,
        "wire_fns": job_wire_fns}


def main(spec_path):
    _setup()
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    results = {}
    for name, kind, kwargs in spec["jobs"]:
        results[name] = JOBS[kind](**kwargs)
    tmp = spec["out"] + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(results, f)
    os.replace(tmp, spec["out"])


def run(jobs, out_dir, timeout=240):
    """Run ``jobs`` in a new process; its results by name. Raises with
    the process's output when it fails (an abort included)."""
    import subprocess

    os.makedirs(out_dir, exist_ok=True)
    spec = os.path.join(out_dir, "jax_spec.pkl")
    out = os.path.join(out_dir, "jax_results.pkl")
    with open(spec, "wb") as f:
        pickle.dump({"out": out, "jobs": jobs}, f)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), spec],
                          env=env, capture_output=True, text=True,
                          timeout=timeout, cwd=REPO)
    if proc.returncode != 0:
        raise RuntimeError(f"the JAX reference process failed (rc "
                           f"{proc.returncode}):\n{proc.stderr[-4000:]}")
    with open(out, "rb") as f:
        return pickle.load(f)


if __name__ == "__main__":
    main(sys.argv[1])
