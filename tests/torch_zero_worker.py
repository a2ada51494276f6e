"""One rank of a gloo world for the data- and sequence-parallel tests of
the PyTorch port (tests/test_torch_zero.py, tests/test_torch_distributed.py,
tests/test_torch_moe_ep.py, tests/test_torch_ulysses.py,
tests/test_torch_ring_attention.py), and the launcher that starts a world
of them.

    python tests/torch_zero_worker.py SPEC

with MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE and LOCAL_RANK set. SPEC is
a pickle {"out": directory, "jobs": [(name, kind, kwargs)]}; the rank runs
each job in order in one process group and writes {name: result} to
``out/rank<R>.pkl``. Imports torch and the port only, never JAX.
"""
import gc
import os
import pickle
import socket
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the tiny GPT-2 of the data-parallel tests: every dim a multiple of 4
TINY = dict(vocab_size=128, n_positions=32, n_embd=32, n_layer=2, n_head=2)
SEQ = 16
MICRO = 2          # per rank
# the tiny GPT-2 with MoE blocks (the odd layers) of the expert-parallel
# tests: 8 experts split over the data axis
MOE = dict(TINY, moe_num_experts=8)
# the tiny GPT-2 and BERT of the sequence-parallel tests: 4 heads, so that
# Ulysses divides them over 4 sequence ranks, and their sequence lengths
SP_GPT2 = dict(TINY, n_head=4)
SP_BERT = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
               num_attention_heads=4, intermediate_size=64,
               max_position_embeddings=64, hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0)
SP_BERT_SEQ = 64
SP_SPARSITY = dict(num_heads=4, block=16, num_local_blocks=2)


def ds_config(dp, stage, gas, optimizer="Adam", fp16=False, lr=1e-3,
              micro=MICRO, offload=False, weight_decay=0.01, zero=None,
              bf16=False, opt_params=None, clipping=1.0, sparse=False):
    cfg = {"train_batch_size": micro * gas * dp,
           "train_micro_batch_size_per_gpu": micro,
           "gradient_accumulation_steps": gas,
           "optimizer": {"type": optimizer,
                         "params": dict({"lr": lr,
                                         "weight_decay": weight_decay},
                                        **(opt_params or {}))},
           "gradient_clipping": clipping,
           "zero_optimization": dict({"stage": stage,
                                      "cpu_offload": offload}, **(zero or {})),
           "steps_per_print": 10 ** 9}
    if sparse:
        cfg["sparse_gradients"] = True
    if bf16:
        cfg["bf16"] = {"enabled": True}
    if fp16:
        cfg["fp16"] = {"enabled": True, "loss_scale": 0,
                       "initial_scale_power": 8, "hysteresis": 1}
    return cfg


def global_batches(seed, steps, gas, rows, vocab=TINY["vocab_size"],
                   seq=SEQ):
    """(steps, gas, rows, seq) token ids from a numpy seed: the global
    batch of each step (``rows`` = micro * dp); rank r of a world with
    micro-batch m feeds rows r*m:(r+1)*m."""
    return np.random.default_rng(seed).integers(0, vocab,
                                                (steps, gas, rows, seq))


def _digest(master):
    """sha256 of a {name: array} master's bytes, in name order."""
    import hashlib

    h = hashlib.sha256()
    for name in sorted(master):
        h.update(np.ascontiguousarray(master[name]).tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# the rank's side
# ---------------------------------------------------------------------------
def _engine(config, init, dtype=torch.float32, device="cpu", model=None):
    """An engine on the CPU, or (``device="cuda"``) on this rank's card,
    over the GPT-2 of ``model``'s sizes (default TINY)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.convert import params_from_jax
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model

    cfg = GPT2Config(dtype=dtype, **(model or TINY))
    eng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=GPT2Model(cfg), config_params=config,
        device=None if device == "cuda" else device)
    if init is not None:
        eng.load_module_state_dict(params_from_jax(init, cfg))
    return eng


def bert_batches(seed, steps, gas, rows, seq=SP_BERT_SEQ,
                 vocab=SP_BERT["vocab_size"]):
    """(steps, gas, rows, seq) BERT batches from a numpy seed: the last 6
    keys of every odd row padded, 20 % MLM labels (the rest -100), token
    types and NSP labels."""
    rng = np.random.default_rng(seed)
    shape = (steps, gas, rows, seq)
    ids = rng.integers(0, vocab, shape)
    mask = np.ones(shape, np.int64)
    mask[:, :, 1::2, -6:] = 0
    return {"input_ids": ids, "attention_mask": mask,
            "token_type_ids": rng.integers(0, 2, shape),
            "masked_lm_labels": np.where(rng.random(shape) < 0.2, ids, -100),
            "next_sentence_label": rng.integers(0, 2, shape[:3])}


def _local(batch, rank, micro):
    rows = slice(rank * micro, (rank + 1) * micro)
    ids = batch[:, rows]
    return {"input_ids": ids, "labels": ids}


def _full_master(eng):
    """The master weights, gathered to full arrays (the whole expert
    stacks too), by parameter name."""
    master = eng._gather_full(eng.master) if eng.partition.sharded_idx \
        else eng.master
    master = eng._gather_experts(master)
    return {n: m.detach().float().cpu().numpy().copy()
            for n, m in zip(eng.param_names, master)}


def _layout(eng):
    """Each parameter's full shape and the shapes this rank holds of its
    master, optimizer state and accumulator (under offload, the host's)."""
    opt = [eng._host_m, eng._host_v] if eng._offload \
        else eng.optimizer.state_lists()
    return {n: {"full": eng.partition.shapes[i],
                "master": tuple(eng.master[i].shape),
                "opt": [tuple(lst[i].shape) for lst in opt],
                "accum": tuple(eng.accum[i].shape)}
            for i, (n, p) in enumerate(zip(eng.param_names, eng.params))}


def job_train(dp, stage, gas, steps, seed, init, optimizer="Adam",
              micro=MICRO, save=None, save_at=None, device="cpu",
              model=None, offload=False, zero=None, dtype=torch.float32,
              load=None, programs=None, master_out=True, seq=SEQ):
    """``steps`` train_batch steps; losses, grad norms, the final master
    and the counted collectives of each step. With ``save``, a checkpoint
    after step ``save_at``; ``offload``: ZeRO-Offload (cpu_offload);
    ``zero``: more ``zero_optimization`` keys; ``load``: a tag loaded
    first; ``programs``: then the programs of gas forward / backward /
    step calls, linted (``_drive_programs``). At stage 3 also the gather
    plan's report and the shapes the parameters hold at rest. The
    master's digest always, the master itself with ``master_out``; on the
    card each step's ms, the peak of the bytes allocated and the bytes
    allocated between steps."""
    import torch.distributed as dist

    rank = dist.get_rank()
    cuda = device == "cuda"
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    eng = _engine(ds_config(dp, stage, gas, optimizer, micro=micro,
                            offload=offload, zero=zero,
                            bf16=dtype == torch.bfloat16), init,
                  dtype=dtype, device=device, model=model)
    if load is not None:
        eng.load_checkpoint(load)
    batches = global_batches(seed, steps, gas, micro * dp,
                             (model or TINY)["vocab_size"], seq)
    out = {"losses": [], "norms": [], "comm": [], "layout": _layout(eng),
           "step_ms": []}
    for step in range(steps):
        t0 = time.perf_counter()
        out["losses"].append(eng.train_batch(
            batch=_local(batches[step], rank, micro)).item())
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["norms"].append(float(eng._last_metrics["grad_norm"]))
        out["comm"].append(eng.last_step_comm)
        if save is not None and step + 1 == save_at:
            eng.save_checkpoint(save)
            out["saved"] = os.path.join(save, f"global_step{save_at}")
    if cuda:
        torch.cuda.synchronize()
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        # what the device holds between steps: the train state at rest
        out["rest_bytes"] = torch.cuda.memory_allocated()
    master = _full_master(eng)
    out["digest"] = _digest(master)
    out["master"] = master if master_out else None
    out["report"] = eng.comm_volume_report()
    out["memory"] = eng._analytic_memory_components()
    out["skipped"] = eng.skipped_steps
    out["stage3"] = eng.stage3_report()
    out["rest"] = {n: tuple(p.shape)
                   for n, p in zip(eng.param_names, eng.params)}
    if programs is not None:
        out["lint"], out["contracts"] = _drive_programs(
            eng, _local(batches[0], rank, micro), programs)
    return out


def _drive_programs(eng, batch, names):
    """gas forward / backward / step calls (and eval_loss when ``names``
    has it) on one micro-batch, observed: the lint's findings and
    {program: (contract, calls_per_step, donated state fields)} of
    ``names`` (a donated name's field: its part before the first "/",
    tiny tensors under the contract's floor left out)."""
    from deepspeed_tpu_torch.telemetry.program_lint import lint_programs

    reg = eng.program_registry
    reg.observing = True
    micro = {k: v[0] for k, v in batch.items()}
    for _ in range(eng.gradient_accumulation_steps()):
        eng.backward(eng(micro))
        eng.step()
    if "eval_loss" in names:
        eng.eval_loss(micro)
    reg.observing = False
    res = lint_programs([reg], use_baseline=False)
    paths = {f"<{reg.engine}:{name}>" for name in names}
    summary = reg.summary()
    contracts = {}
    for name in names:
        c = dict(summary[name]["contract"])
        floor = c.get("donation_min_elements", 0)
        donated = sorted({n.split("/")[0] for n, (_, _, size) in
                          reg.get(name).observation.donated.items()
                          if n in c.get("donates", ()) and size >= floor})
        contracts[name] = (c, summary[name]["calls_per_step"], donated)
    # the family's programs (train_batch's ran before the lint observed)
    return [(f.rule, f.path, f.message) for f in res.new
            if f.path in paths], contracts


def job_zero3_faults(dp, seed, init):
    """One planted fault per program of the stage-3 and qgZ families, each
    on a new engine: the backward gathering again (s3_bwd forbids
    all-gathers), one int8 gather beyond the plan's (s3_fwd's op count),
    and qgZ's codes sent twice (micro_step's analytic budget): the
    findings of each."""
    import torch.distributed as dist

    rank = dist.get_rank()
    batch = _local(global_batches(seed, 1, 1, MICRO * dp)[0], rank, MICRO)
    qgz = {"quantized_gradients": True}

    def regather(eng):
        run = eng._backward_micro

        def backward_micro(loss):
            eng._s3_blocks.gather(0, counted=True)
            run(loss)
        eng._backward_micro = backward_micro

    def extra_gather(eng):
        run = eng._s3_gather

        def gather():
            run()
            codes = torch.zeros(8, dtype=torch.int8)
            eng.dp_group.quantized_all_gather(
                torch.empty(8 * dp, dtype=torch.int8), codes, "qwz_ag",
                [("extra", 8 * dp)])
        eng._s3_gather = gather

    def codes_twice(eng):
        group = eng.dp_group
        post = group.quantized_all_to_all

        def all_to_all(out, inp, prefix, leaves, link="flat"):
            if prefix == "qgz_a2a":
                post(torch.empty_like(out), inp, prefix, leaves, link)
            return post(out, inp, prefix, leaves, link)
        group.quantized_all_to_all = all_to_all

    out = {}
    for name, stage, zero, plant, programs in (
            ("regather", 3, None, regather, ["s3_bwd"]),
            ("extra_gather", 3, None, extra_gather, ["s3_fwd"]),
            ("codes_twice", 2, qgz, codes_twice, ["micro_step"])):
        eng = _engine(ds_config(dp, stage, 1, zero=zero), init)
        plant(eng)
        out[name] = _drive_programs(eng, batch, programs)[0]
    return out


def job_zero3_blocks(dp, seed, init, steps, gas=2):
    """The implicit stage-3 path under no remat and each remat policy:
    the losses and the final master's digest, and, watched through the
    engine's per-block gathers (runtime/zero/gathers.py), the number of
    blocks, the most of them whole at once and, of the weights one more
    forward gathered, how many are still alive after it."""
    import weakref

    import torch.distributed as dist

    rank = dist.get_rank()
    batches = global_batches(seed, steps, gas, MICRO * dp)
    out = {}
    for policy in (None, "nothing", "attn_out", "dots"):
        model = dict(TINY, remat=policy is not None,
                     remat_policy=policy or "nothing")
        eng = _engine(ds_config(dp, 3, gas, zero={
            "stage3_scheduled_gathers": False}), init, model=model)
        blocks = eng._s3_blocks
        most, freed = [0], []
        gather, free = blocks.gather, blocks.free

        def watched_gather(b, counted, gather=gather, blocks=blocks):
            gather(b, counted)
            most[0] = max(most[0], len(blocks.live))

        def watched_free(b, free=free, blocks=blocks, eng=eng):
            freed.extend(weakref.ref(eng.params[i].data)
                         for i in blocks.blocks[b])
            free(b)
        blocks.gather, blocks.free = watched_gather, watched_free
        losses = [eng.train_batch(batch=_local(b, rank, MICRO)).item()
                  for b in batches]
        digest = _digest(_full_master(eng))
        freed.clear()
        micro = _local(batches[0], rank, MICRO)
        loss = eng.forward({k: v[0] for k, v in micro.items()})
        alive = sum(r() is not None for r in freed)
        n_freed = len(freed)
        eng.backward(loss)
        out[str(policy)] = dict(
            losses=losses, digest=digest, blocks=len(blocks.blocks),
            pinned=blocks.pinned is not None, most=most[0],
            freed=n_freed, alive=alive)
    return out


def job_resume(dp, stage, gas, steps, seed, load, start):
    """A new engine loads ``load`` (written after step ``start``) and runs
    the remaining steps of the same batches."""
    import torch.distributed as dist

    rank = dist.get_rank()
    eng = _engine(ds_config(dp, stage, gas), None)
    eng.load_checkpoint(load)
    batches = global_batches(seed, steps, gas, MICRO * dp)
    losses = [eng.train_batch(batch=_local(batches[s], rank, MICRO)).item()
              for s in range(start, steps)]
    return {"losses": losses, "master": _full_master(eng),
            "global_steps": eng.global_steps}


def job_load(dp, stage, gas, load, model=None):
    """Load a tag (e.g. the JAX engine's) and return the full state
    leaves it restored, in the npz's order."""
    eng = _engine(ds_config(dp, stage, gas), None, model=model)
    path, _ = eng.load_checkpoint(load)
    leaves = [t.detach().float().cpu().numpy() if torch.is_tensor(t)
              else np.asarray(t) for t in eng._state_leaves()]
    return {"path": path, "leaves": leaves, "layout": _layout(eng)}


def job_overflow(dp, seed, init, plant_rank, param, stage=2, zero=None):
    """fp16 at ``stage`` (default 2): a non-finite gradient planted on
    ``plant_rank`` only (element 0 of ``param``) in the first step."""
    import torch.distributed as dist

    rank = dist.get_rank()
    eng = _engine(ds_config(dp, stage, 1, fp16=True, zero=zero), init,
                  torch.float16)
    i = eng.param_names.index(param)
    if rank == plant_rank:
        def plant(g):
            g = g.clone()
            g.view(-1)[0] = float("inf")
            return g
        handle = eng.params[i].register_hook(plant)
    batches = global_batches(seed, 2, 1, MICRO * dp)
    before = _full_master(eng)
    scale0 = eng.loss_scale()
    eng.train_batch(batch=_local(batches[0], rank, MICRO))
    out = {"scale0": scale0, "scale1": eng.loss_scale(),
           "skipped1": eng.skipped_steps,
           "overflow1": bool(eng._last_metrics["overflow"]),
           "unchanged": all(np.array_equal(before[n], m) for n, m in
                            _full_master(eng).items()),
           # the rank whose shard holds the planted element
           "holder": [r for r in range(dp) if eng.partition.sharded[i]
                      and eng.partition.slices[i][r][1] == 0]}
    if rank == plant_rank:
        handle.remove()
    eng.train_batch(batch=_local(batches[1], rank, MICRO))
    out["skipped2"] = eng.skipped_steps
    return out


def job_zero3_misc(dp, seed):
    """The int8 collectives over the world: each rank's shard of a (4 *
    dp, 6) leaf along dim 0 gathered (quantized_all_gather) and its
    straight-through backward (each rank's cotangent reduce-scattered to
    the shards); each rank's (6, 4 * dp) tensor reduce-scattered along
    dim 1 (quantized_reduce_scatter, block 8); then a stage-3 engine's
    forward() twice without backward()."""
    import torch.distributed as dist

    from deepspeed_tpu_torch.runtime.custom_collectives import (
        quantized_all_gather, quantized_reduce_scatter)

    rank = dist.get_rank()
    rng = np.random.default_rng(seed)
    full = torch.from_numpy(rng.standard_normal((4 * dp, 6)).astype(
        np.float32))
    cot = torch.from_numpy(rng.standard_normal((dp, 4 * dp, 6)).astype(
        np.float32))
    xs = torch.from_numpy(rng.standard_normal((dp, 6, 4 * dp)).astype(
        np.float32))
    eng = _engine(ds_config(dp, 3, 1), None)
    shard = full[4 * rank:4 * (rank + 1)].clone().requires_grad_(True)
    gathered = quantized_all_gather(shard, eng.dp_group, dim=0, name="w")
    (gathered * cot[rank]).sum().backward()
    reduced = quantized_reduce_scatter(xs[rank], eng.dp_group, dim=1,
                                       block_size=8, name="g")
    comm = eng.dp_group.counter.take()
    batch = _local(global_batches(seed, 1, 1, MICRO * dp)[0], rank, MICRO)
    eng.forward({k: v[0] for k, v in batch.items()})
    try:
        eng.forward({k: v[0] for k, v in batch.items()})
        twice = None
    except RuntimeError as e:
        twice = str(e)
    return {"gathered": gathered.detach().numpy(),
            "grad": shard.grad.numpy(), "full": full.numpy(),
            "cot": cot.numpy(), "xs": xs.numpy(),
            "reduced": reduced.numpy(), "comm": comm, "twice": twice}


class EmbedModel(torch.nn.Module):
    """The torch counterpart of the JAX tests' ``SimpleEmbedModel``
    (tests/unit/simple_model.py:153-198): ids -> an untied embedding ->
    mean over the sequence -> a linear classifier. Its embedding's
    gradient is row-sparse (``sparse_grad_spec``), and the rows are the
    looked-up ids (``sparse_grad_tokens``)."""

    def __init__(self, vocab=256, dim=8, n_classes=4):
        super().__init__()
        self.emb = torch.nn.Parameter(torch.zeros(vocab, dim))
        self.w = torch.nn.Parameter(torch.zeros(dim, n_classes))
        self.b = torch.nn.Parameter(torch.zeros(n_classes))

    def init_weights(self, generator):
        with torch.no_grad():
            for p in (self.emb, self.w):
                p.copy_(torch.randn(p.shape, generator=generator) * 0.1)
            self.b.zero_()

    def loss(self, batch, generator=None, train=True):
        x = self.emb[batch["ids"]].mean(dim=1)
        logp = torch.log_softmax((x @ self.w + self.b).float(), dim=-1)
        loss = -logp.gather(1, batch["y"][:, None].long()).mean()
        return loss, {"loss": loss}

    def sparse_grad_spec(self):
        return {"emb": True, "w": False, "b": False}

    def sparse_grad_tokens(self, batch):
        return int(np.prod(tuple(batch["ids"].shape)))

    def reference_leaf_specs(self):
        # the JAX tree's order: the dict's keys sorted
        return [("b", False), ("emb", False), ("w", False)]

    def reference_leaf_paths(self):
        return ["b", "emb", "w"]


#: the embedding model of the CSR tests and its batches
EMBED = dict(vocab=256, dim=8, n_classes=4)
EMBED_SEQ = 6


def embed_batches(seed, steps, gas, rows, vocab=EMBED["vocab"],
                  seq=EMBED_SEQ, n_classes=EMBED["n_classes"]):
    """(steps, gas, rows, seq) ids from the first ``vocab // 4`` rows of
    the table (so that most rows get no gradient) and (steps, gas, rows)
    labels, from a numpy seed."""
    rng = np.random.default_rng(seed)
    return {"ids": rng.integers(0, vocab // 4, (steps, gas, rows, seq)),
            "y": rng.integers(0, n_classes, (steps, gas, rows))}


def _wire_engine(config, init, model, device="cpu"):
    """An engine over ``EmbedModel`` (``model="embed"``), the tiny GPT-2
    (``"gpt2"``) or a GPT-2 of the sizes ``model`` gives."""
    import deepspeed_tpu_torch

    if model == "embed":
        eng, _, _, _ = deepspeed_tpu_torch.initialize(
            model=EmbedModel(**EMBED), config_params=config,
            device=None if device == "cuda" else device)
        if init is not None:
            eng.load_module_state_dict(
                {k: torch.from_numpy(np.array(v)) for k, v in init.items()})
        return eng
    return _engine(config, init, device=device,
                   model=None if model == "gpt2" else model)


def job_wire(dp, gas, steps, seed, init, optimizer="Adam", opt_params=None,
             stage=0, model="gpt2", sparse=False, offload=False, lr=1e-3,
             save_at=None, save=None, load=None, fp16=False, device="cpu"):
    """``steps`` train_batch steps of the tiny GPT-2 (``model="embed"``:
    ``EmbedModel`` on ``embed_batches``) with ``optimizer`` and
    ``opt_params``, no clipping, every program's first dispatch observed
    by the lint: losses, the final master, each step's counted
    collectives and the report after it, the lint's findings and the
    contracts, the wire's arming; with ``save`` a tag after step
    ``save_at``, with ``load`` a tag loaded first (then the steps after
    its global step, of the same batches); under offload the last copy
    down's bytes. ``model``: "embed", "gpt2" (the tiny one) or GPT-2
    sizes; ``device="cuda"``: this rank's card."""
    import torch.distributed as dist

    from deepspeed_tpu_torch.telemetry.program_lint import lint_programs

    rank = dist.get_rank()
    config = ds_config(dp, stage, gas, optimizer, opt_params=opt_params,
                       clipping=0.0, sparse=sparse, offload=offload, lr=lr,
                       fp16=fp16)
    eng = _wire_engine(config, init, model, device)
    start = 0
    if load is not None:
        eng.load_checkpoint(load)
        start = eng.global_steps
    if model == "embed":
        data = embed_batches(seed, steps, gas, MICRO * dp)
        rows = slice(rank * MICRO, (rank + 1) * MICRO)
        local = [{"ids": data["ids"][s][:, rows], "y": data["y"][s][:, rows]}
                 for s in range(steps)]
    else:
        vocab = (model if isinstance(model, dict) else TINY)["vocab_size"]
        batches = global_batches(seed, steps, gas, MICRO * dp, vocab)
        local = [_local(batches[s], rank, MICRO) for s in range(steps)]
    reg = eng.program_registry
    reg.observing = True
    out = {"losses": [], "comm": [], "reports": [], "phases": [],
           "wire": eng._wire, "csr": [eng.param_names[i]
                                      for i in eng._csr_idx]}
    for step in range(start, steps):
        out["losses"].append(eng.train_batch(batch=local[step]).item())
        out["comm"].append(eng.last_step_comm)
        out["reports"].append(eng.comm_volume_report())
        out["phases"].append(eng._wire_phase)
        if save is not None and step + 1 == save_at:
            eng.save_checkpoint(save)
            out["saved"] = os.path.join(save, f"global_step{save_at}")
    reg.observing = False
    res = lint_programs([reg], use_baseline=False)
    out["lint"] = [(f.rule, f.path, f.message) for f in res.new]
    summary = reg.summary()
    out["contracts"] = {name: {k: v for k, v in e["contract"].items()
                               if k != "donates"}
                        for name, e in summary.items()}
    master = _full_master(eng)
    out["master"] = master
    out["digest"] = _digest(master)
    if eng._wire is not None:
        # the moments (whole at stage 0): what bounds a 1-bit step
        out["m"], out["v"] = ({n: t.cpu().numpy().copy() for n, t in
                               zip(eng.param_names, lst)}
                              for lst in (eng.optimizer.m, eng.optimizer.v))
    if offload:
        out["fetch_bytes"] = eng.last_fetch_bytes
    return out


def job_wires(dp, seed, n, steps=3):
    """The wires over the world on numpy-seeded inputs (rank r's rows
    ``x[:, r]`` of (steps, dp, n)), ``steps`` rounds with the residuals
    carried: ``compressed_allreduce`` (server residual chunk-sized) and
    ``quantized_all_reduce`` at bits 1 and 8, flat and with intra size 2
    (at dp 4): each round's mean, residuals and counted collectives."""
    import torch.distributed as dist

    from deepspeed_tpu_torch.runtime import custom_collectives as cc

    rank = dist.get_rank()
    eng = _engine(ds_config(dp, 0, 1), None)
    group = eng.dp_group
    x = wire_inputs(seed, steps, dp, n)
    out = {}
    we, se = torch.zeros(n), torch.zeros(n // dp)
    rounds = []
    for s in range(steps):
        mean, we, se = cc.compressed_allreduce(
            torch.from_numpy(x[s, rank]), we, se, group, name="x")
        rounds.append((mean.numpy(), we.numpy(), se.numpy(),
                       group.counter.take()))
    out["onebit"] = rounds
    for bits in (1, 8):
        for k in ((0, 2) if dp == 4 else (0,)):
            we, se = torch.zeros(n), torch.zeros(n // dp)
            rounds = []
            for s in range(steps):
                mean, we, se = cc.quantized_all_reduce(
                    torch.from_numpy(x[s, rank]), group, bits=bits,
                    block_size=32, intra_size=k, worker_error=we,
                    server_error=se, name="x")
                rounds.append((mean.numpy(), we.numpy(), se.numpy(),
                               group.counter.take()))
            out[f"zeroone_b{bits}_k{k}"] = rounds
    return out


def job_wire_refusals(dp):
    """What the world refuses: 1-bit Adam's armed wire with clipping
    (ValueError), 1-bit Adam at stage 1 (NotImplementedError); and 0/1
    Adam beside sparse_gradients, which disarms its wire and keeps the
    CSR exchange: (wire, CSR parameters)."""
    out = {}
    for key, kw in (("clipping", dict(clipping=1.0)),
                    ("stage1", dict(stage=1, clipping=0.0))):
        stage = kw.pop("stage", 0)
        try:
            _engine(ds_config(dp, stage, 1, "OneBitAdam", **kw), None)
            out[key] = None
        except (ValueError, NotImplementedError) as e:
            out[key] = (type(e).__name__, str(e))
    eng = _wire_engine(ds_config(dp, 0, 1, "ZeroOneAdam", clipping=0.0,
                                 sparse=True), None, "embed")
    out["zeroone_csr"] = ("armed" if eng._csr_idx else "disarmed", eng._wire,
                          [eng.param_names[i] for i in eng._csr_idx])
    return out


def wire_inputs(seed, steps, dp, n):
    """(steps, dp, n) fp32 inputs of the wire tests, from a numpy seed,
    with a few exact zeros (sign(0) = +1)."""
    x = np.random.default_rng(seed).standard_normal(
        (steps, dp, n)).astype(np.float32)
    x[:, :, ::37] = 0.0
    return x


def job_sampler(dp, n):
    """The dataset indices this rank's DeepSpeedDataLoader reads."""
    import torch.distributed as dist

    from torch.utils.data import TensorDataset

    eng = _engine(ds_config(dp, 0, 1), None)
    data = TensorDataset(torch.arange(n))
    loader = eng.deepspeed_io(data)
    seen = [int(x) for (b,) in loader for x in b]
    return {"indices": seen, "rank": dist.get_rank(),
            "sampler": type(loader.data_sampler).__name__}


def job_tag_check(dp):
    """Checkpoint tag validation (mode FAIL) on a tag that differs by rank
    and on one that does not."""
    import torch.distributed as dist

    config = dict(ds_config(dp, 2, 1), checkpoint={"tag_validation": "FAIL"})
    eng = _engine(config, None)
    eng._checkpoint_tag_validation("same")
    try:
        eng._checkpoint_tag_validation(f"rank{dist.get_rank()}")
    except AssertionError as e:
        return {"error": str(e)}
    return {"error": None}


def job_programs(dp, seed, init):
    """The program lint on a ZeRO-2 world: the clean step's findings,
    contracts and collective order, then one planted fault per rule —
    the parameter all-gather skipped under a declared op count, the
    optimizer state replaced by fresh copies, and two programs of one
    uniform_group posting their collectives in different orders (a
    second registry holds a third program of that group name, which must
    not be compared across engines), a raw ``dist.all_reduce`` posted
    inside the step around the group's counter (under a declared
    all-reduce count), and a raw collective in a collective-free
    program."""
    from deepspeed_tpu_torch.telemetry.program_lint import lint_programs
    from deepspeed_tpu_torch.telemetry.programs import ProgramRegistry

    import torch.distributed as dist

    rank = dist.get_rank()
    batches = global_batches(seed, 2, 2, MICRO * dp)
    count = [("all-gather", "f32", 1)]

    def linted(patch=None, expect=count):
        eng = _engine(ds_config(dp, 2, 2), init)
        if patch is not None:
            patch(eng)
        eng.program_registry.observing = True
        loss = eng.train_batch(batch=_local(batches[0], rank, MICRO)).item()
        eng.program_registry.declare("fused_train_step",
                                     expect_op_counts=expect)
        res = lint_programs([eng.program_registry], use_baseline=False)
        return eng, loss, [(f.rule, f.path) for f in res.new]

    def fresh_state(eng):
        update = eng.optimizer.update

        def copying_update(*a, **k):
            update(*a, **k)
            eng.optimizer.m = [t.clone() for t in eng.optimizer.m]
        eng.optimizer.update = copying_update

    def skip_gather(eng):
        eng._gather_params = lambda: None

    def stray_all_reduce(eng):
        gather = eng._gather_params

        def gather_after_a_raw_all_reduce():
            dist.all_reduce(torch.ones(3))
            gather()
        eng._gather_params = gather_after_a_raw_all_reduce

    eng, loss, clean = linted()
    obs = eng.program_registry.get("fused_train_step").observation
    out = {"clean": clean, "loss": loss,
           "summary": eng.program_registry.summary(),
           "order": [(c.op, c.dtype, c.elements) for c in obs.collectives]}
    out["op_count"] = linted(skip_gather)[2]
    reduces = sum(1 for c in obs.collectives
                  if (c.op, c.dtype) == ("all-reduce", "f32"))
    out["stray"] = linted(stray_all_reduce, count + [
        ("all-reduce", "f32", reduces)])[2]
    out["donation"] = linted(fresh_state)[2]

    group = eng.dp_group
    a, b = torch.ones(4), torch.ones(2 * dp)
    regs = [ProgramRegistry("zero-a"), ProgramRegistry("zero-b")]
    for reg in regs:
        reg.observing = True
    programs = [(regs[0], "reduce_then_gather", False),
                (regs[0], "gather_then_reduce", True),
                (regs[1], "gather_then_reduce", True)]
    for reg, name, gather_first in programs:
        with reg.dispatch(name, (), {"uniform_group": "zero:step"}):
            if gather_first:
                group.all_gather(b, torch.ones(2), leaves=[("b", 2)])
            group.all_reduce(a, leaves=[("a", 4)])
            if not gather_first:
                group.all_gather(b, torch.ones(2), leaves=[("b", 2)])
    group.counter.take()
    out["order_fault"] = [(f.rule, f.path) for f in
                          lint_programs(regs, use_baseline=False).new]
    # a collective posted around the group: the observer reads it off the
    # dispatcher's c10d op as it reads the group's own
    raw = ProgramRegistry("raw")
    raw.observing = True
    with raw.dispatch("stray_all_reduce", (), {"collective_free": True}):
        dist.all_reduce(a)
    out["raw"] = [(f.rule, f.message) for f in
                  lint_programs([raw], use_baseline=False).new]
    out["raw_ops"] = list(raw.get("stray_all_reduce").observation.collectives)
    return out


def _moe_metrics(eng, micro):
    """The model's ``moe_aux_loss`` on one micro-batch (train) and each MoE
    layer's dropped fraction, with the engine's current weights; every
    rank takes part (the statistics are the global batch's). What the
    exchanges posted is taken off the counter, not left to the step's."""
    from deepspeed_tpu_torch.moe.sharded_moe import MoE

    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, args, out: seen.append((mod, args[0])))
        for m in eng.module.modules() if isinstance(m, MoE)]
    batch = {k: torch.as_tensor(v).long().to(eng.device)
             for k, v in micro.items()}
    try:
        with torch.no_grad():
            _, metrics = eng.module.loss(batch, train=True)
            dropped = [float(mod.gate(x, train=True)[-1]["moe_dropped_frac"])
                       for mod, x in seen]
    finally:
        for h in hooks:
            h.remove()
    if eng.dp_group is not None:
        eng.dp_group.counter.take()
    return float(metrics["moe_aux_loss"]), dropped


def job_moe(dp, stage, gas, steps, seed, init, offload=False, save=None,
            programs=False, model=MOE, device="cpu", zero=None):
    """``steps`` train_batch steps of an MoE GPT-2 (default ``MOE``) with
    expert parallelism over the world: before each step the model's aux
    metric and dropped fractions on the step's first micro-batch; the
    losses, the counted collectives of each step, the gathered master, the
    layout, the comm report and the analytic memory; with ``save`` a tag
    after the last step; with ``programs`` the program lint over the
    engine; ``zero``: more zero_optimization keys."""
    import torch.distributed as dist

    rank = dist.get_rank()
    eng = _engine(ds_config(dp, stage, gas, offload=offload, zero=zero),
                  init, model=model, device=device)
    batches = global_batches(seed, steps, gas, MICRO * dp)
    out = {"losses": [], "aux": [], "dropped": [], "comm": [],
           "layout": _layout(eng)}
    for step in range(steps):
        local = _local(batches[step], rank, MICRO)
        # at stage 3 the module holds its shards between steps: no
        # forward outside the engine
        aux, dropped = (None, None) if eng._stage3 else _moe_metrics(
            eng, {k: v[0] for k, v in local.items()})
        out["aux"].append(aux)
        out["dropped"].append(dropped)
        if programs and step == steps - 1:
            eng.program_registry.observing = True
        out["losses"].append(eng.train_batch(batch=local).item())
        out["comm"].append(eng.last_step_comm)
    if programs:
        from deepspeed_tpu_torch.telemetry.program_lint import lint_programs

        res = lint_programs([eng.program_registry], use_baseline=False)
        out["lint"] = [(f.rule, f.path, f.message) for f in res.new]
        obs = eng.program_registry.get("fused_train_step").observation
        out["lint_ops"] = [(c.op, c.dtype, c.elements)
                           for c in obs.collectives]
    out["master"] = _full_master(eng)
    out["report"] = eng.comm_volume_report()
    out["memory"] = eng._analytic_memory_components()
    out["norm"] = float(eng._last_metrics["grad_norm"])
    out["stage3"] = eng.stage3_report()
    if save is not None:
        eng.save_checkpoint(save)
        out["saved"] = os.path.join(save, f"global_step{steps}")
    return out


def sp_model(kind, dtype=torch.float32, **over):
    """The port's sequence-parallel GPT-2 (``SP_GPT2`` and ``over``) or
    BERT (``SP_BERT`` and ``over``; ``sparse``: a FixedSparsityConfig of
    ``SP_SPARSITY`` and the dict ``sparse`` gives)."""
    over = dict(over)
    if kind == "gpt2":
        from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model

        return GPT2Model(GPT2Config(dtype=dtype, **dict(SP_GPT2, **over)))
    from deepspeed_tpu_torch.models.bert import (BertConfig,
                                                 BertForPreTraining)
    from deepspeed_tpu_torch.ops.sparse_attention import \
        FixedSparsityConfig

    sparse = over.pop("sparse", False)
    layout = dict(SP_SPARSITY, **sparse) if isinstance(sparse, dict) \
        else SP_SPARSITY
    return BertForPreTraining(BertConfig(
        dtype=dtype, sparsity_config=FixedSparsityConfig(**layout)
        if sparse else None, **dict(SP_BERT, **over)))


def sp_batches(kind, seed, steps, gas, rows, seq=None, vocab=None):
    """The global batches of ``steps`` steps: (steps, gas, rows, seq) per
    entry (default: the tiny models' seq and vocab)."""
    if kind == "gpt2":
        ids = np.random.default_rng(seed).integers(
            0, vocab or TINY["vocab_size"], (steps, gas, rows, seq or SEQ))
        return {"input_ids": ids, "labels": ids}
    return bert_batches(seed, steps, gas, rows, seq or SP_BERT_SEQ,
                        vocab or SP_BERT["vocab_size"])


def job_seq(kind, mesh, stage, gas, steps, seed, init=None, model=None,
            micro=MICRO, dtype=torch.float32, save=None, load=None,
            programs=False, device="cpu", lr=1e-3, seq=None,
            telemetry=False, offload=False, optimizer="Adam",
            weight_decay=0.01, master="final", zero=None):
    """``steps`` train_batch steps of ``sp_model(kind, **model)`` at
    ``mesh`` ({"data": D, "seq": N}): every rank feeds its data rows of
    the global batch at full sequence. The losses, the counted collectives
    of each step, the gathered master (``master``: "final", "delta" its
    change from the initial one, or None: left out), the comm report, the
    analytic memory, the program registry's contracts and (``programs``)
    the lint of the last step; on the card the peak of the bytes allocated
    (``peak_bytes``, above what was allocated before); ``save``: a tag
    after the last step; ``load``: a tag loaded before the first; ``seq``:
    the batches' sequence length (the model's vocabulary); ``telemetry``:
    armed, and its MFU report's counts; ``offload``: ZeRO-Offload;
    ``zero``: more zero_optimization keys."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.convert import (bert_params_from_jax,
                                                    params_from_jax)

    cuda = device == "cuda"
    if cuda:
        # an earlier job's engine may sit in a reference cycle
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    module = sp_model(kind, dtype, **(model or {}))
    dp = mesh.get("data", 1)
    config = dict(ds_config(dp, stage, gas, micro=micro, lr=lr,
                            offload=offload, optimizer=optimizer,
                            weight_decay=weight_decay, zero=zero),
                  mesh=mesh)
    if dtype == torch.bfloat16:
        config["bf16"] = {"enabled": True}
    if telemetry:
        config["telemetry"] = {"enabled": True}
    eng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=module, config_params=config,
        device=None if device == "cuda" else device)
    if init is not None:
        convert = params_from_jax if kind == "gpt2" else bert_params_from_jax
        eng.load_module_state_dict(convert(init, module.config))
    if load is not None:
        eng.load_checkpoint(load)
    batches = sp_batches(kind, seed, steps, gas, micro * dp, seq,
                         module.config.vocab_size)
    rows = slice(eng.dp_rank * micro, (eng.dp_rank + 1) * micro)
    out = {"losses": [], "comm": [], "norms": [],
           "grid": (eng.dp_rank, eng.sp_rank)}
    init_master = _full_master(eng) if master == "delta" else None
    _launches(reset=True)
    for step in range(steps):
        if programs and step == steps - 1:
            eng.program_registry.observing = True
        local = {k: v[step][:, rows] for k, v in batches.items()}
        out["losses"].append(eng.train_batch(batch=local).item())
        out["norms"].append(float(eng._last_metrics["grad_norm"]))
        out["comm"].append(eng.last_step_comm)
    if programs:
        from deepspeed_tpu_torch.telemetry.program_lint import lint_programs

        res = lint_programs([eng.program_registry], use_baseline=False)
        out["lint"] = [(f.rule, f.path, f.message) for f in res.new]
    out["contracts"] = {name: eng.program_registry.get(name).contract
                        for name in eng.program_registry.names()}
    if cuda:
        torch.cuda.synchronize()
        out["peak_bytes"] = torch.cuda.max_memory_allocated() - base
    if master is not None:
        out["master"] = _full_master(eng)
    if init_master is not None:
        out["master"] = {n: m - init_master[n]
                         for n, m in out["master"].items()}
    out["report"] = eng.comm_volume_report()
    out["memory"] = eng._analytic_memory_components()
    out["launches"] = _launches()
    out["stage3"] = eng.stage3_report()
    if telemetry:
        mfu = eng.telemetry_report()["mfu"]
        out["mfu"] = {k: mfu[k] for k in (
            "n_devices", "n_params", "tokens_per_step",
            "model_flops_per_step", "hw_flops_per_step")}
    if save is not None:
        eng.save_checkpoint(save)
        out["saved"] = os.path.join(save, f"global_step{steps}")
    return out


def _launches(reset=False):
    """The port's kernel launch counts (0 on the CPU); ``reset``: set them
    to 0 first."""
    from deepspeed_tpu_torch.ops.sparse_attention import \
        block_sparse_kernel as bsk
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

    if reset:
        fa.reset_launch_counts()
        bsk.reset_launch_counts()
    return dict(fa.LAUNCHES, **bsk.LAUNCHES)


def job_seq_attention(mode, q, k, v, do, causal=True, dtype=torch.float32,
                      heads_dropout=None):
    """Ulysses (``mode="ulysses"``, through the port's default attention)
    or the ring over the world as one seq group: this rank's chunk of the
    full (B, H, S, D) q, k, v in, its chunk of the output and of dQ, dK, dV
    (against the output gradient ``do``) out; the collectives counted.
    ``heads_dropout``: (rate, seed) of the attention's dropout, through
    the flash kernels' plain versions (Ulysses only)."""
    from deepspeed_tpu_torch.parallel.mesh import SequenceParallelGroup
    from deepspeed_tpu_torch.parallel.ring_attention import \
        make_ring_attention
    from deepspeed_tpu_torch.parallel.ulysses import (make_ulysses_attention,
                                                      ulysses_attention)

    group = SequenceParallelGroup()
    n, r = group.size, group.rank
    s = q.shape[2] // n

    def chunk(x, grad=True):
        t = torch.as_tensor(x[:, :, r * s:(r + 1) * s]).to(dtype)
        return t.clone().requires_grad_(grad)

    qc, kc, vc = chunk(q), chunk(k), chunk(v)
    if heads_dropout is not None:
        rate, seed = heads_dropout
        out = ulysses_attention(
            qc, kc, vc, group=group, causal=causal, use_pallas=True,
            dropout_rate=rate,
            dropout_rng=torch.Generator().manual_seed(seed))
    else:
        make = make_ring_attention if mode == "ring" \
            else make_ulysses_attention
        out = make(group, causal=causal)(qc, kc, vc)
    out.backward(chunk(do, grad=False))
    host = lambda t: t.detach().float().numpy()  # noqa: E731
    return {"out": host(out), "dq": host(qc.grad), "dk": host(kc.grad),
            "dv": host(vc.grad), "dtype": str(out.dtype),
            "comm": group.counter.take()}


def job_seq_load(mesh, stage, load, gas=2):
    """The sequence-parallel GPT-2 at ``mesh`` loads ``load``; the full
    state leaves it restored, in the npz's order."""
    import deepspeed_tpu_torch

    config = dict(ds_config(mesh.get("data", 1), stage, gas), mesh=mesh)
    eng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=sp_model("gpt2"), config_params=config, device="cpu")
    path, _ = eng.load_checkpoint(load)
    leaves = [t.detach().float().cpu().numpy() if torch.is_tensor(t)
              else np.asarray(t) for t in eng._state_leaves()]
    return {"path": path, "leaves": leaves, "master": _full_master(eng),
            "global_steps": eng.global_steps}


def job_seq_refusals():
    """What the seq axis refuses, in a world of one seq line: {case:
    (exception type, message)} of an MoE model, ring attention with
    dropout, heads Ulysses cannot divide (the model, and the function),
    and a sequence the axis does not divide."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.parallel.mesh import SequenceParallelGroup
    from deepspeed_tpu_torch.parallel.ulysses import ulysses_attention

    n = torch.distributed.get_world_size()
    config = dict(ds_config(1, 0, 1), mesh={"data": 1, "seq": n})
    ids = global_batches(0, 1, 1, MICRO)[0]
    batch = {"input_ids": ids, "labels": ids}

    def engine(**over):
        return deepspeed_tpu_torch.initialize(
            model=sp_model("gpt2", **over), config_params=config,
            device="cpu")[0]

    cases = {
        "moe": lambda: engine(moe_num_experts=4),
        "ring_dropout": lambda: engine(attention_sp_mode="ring",
                                       dropout=0.1).train_batch(batch=batch),
        "model_heads": lambda: engine(n_head=1),
        "function_heads": lambda: ulysses_attention(
            *[torch.zeros(1, 3, 8, 16)] * 3, group=SequenceParallelGroup()),
        "sequence": lambda: engine().train_batch(
            batch={k: v[:, :, :-1] for k, v in batch.items()}),
    }
    out = {}
    for name, case in cases.items():
        try:
            case()
            out[name] = None
        except Exception as e:   # the type and message are the result
            out[name] = (type(e).__name__, str(e))
    return out


JOBS = {"seq": job_seq, "seq_attention": job_seq_attention,
        "seq_load": job_seq_load, "seq_refusals": job_seq_refusals,
        "moe": job_moe, "programs": job_programs, "tag_check": job_tag_check, "train": job_train, "resume": job_resume, "load": job_load,
        "overflow": job_overflow, "sampler": job_sampler,
        "zero3_misc": job_zero3_misc, "zero3_faults": job_zero3_faults,
        "zero3_blocks": job_zero3_blocks, "wire": job_wire,
        "wires": job_wires, "wire_refusals": job_wire_refusals}


def main(spec_path):
    import torch.distributed as dist

    import deepspeed_tpu_torch

    torch.set_num_threads(1)
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    deepspeed_tpu_torch.init_distributed(device=spec["device"], timeout=60,
                                         verbose=False)
    rank = dist.get_rank()
    results = {}
    for name, kind, kwargs in spec["jobs"]:
        results[name] = JOBS[kind](**kwargs)
    dist.barrier()
    dist.destroy_process_group()
    tmp = os.path.join(spec["out"], f"rank{rank}.pkl.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(results, f)
    os.replace(tmp, os.path.join(spec["out"], f"rank{rank}.pkl"))


def assert_master_close(got, want, rtol, atol, steps, lr, what):
    """Every element of the master weights within rtol/atol, but the key
    third of each fused QKV bias (GPT-2's ``c_attn``, the BERT layer's
    ``qkv``): its gradient is zero in exact
    arithmetic (softmax ignores a shift common to all keys), so Adam moves
    it by the sign of rounding noise, up to lr per step, and it is held to
    2 * steps * lr."""
    assert set(got) == set(want)
    for name in want:
        a, b = np.asarray(got[name]), np.asarray(want[name])
        if name.endswith(("attn.c_attn.bias", "body.qkv.bias")):
            e = a.shape[0] // 3
            np.testing.assert_allclose(a[e:2 * e], b[e:2 * e], rtol=0,
                                       atol=2 * steps * lr,
                                       err_msg=f"{what}: {name} keys")
            a, b = np.delete(a, range(e, 2 * e)), np.delete(b, range(e, 2 * e))
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                   err_msg=f"{what}: {name}")


# ---------------------------------------------------------------------------
# the launcher's side
# ---------------------------------------------------------------------------
def session_worlds(tmp_path_factory, worlds):
    """get(key) -> one result dict per rank of the world ``worlds[key](out
    directory)`` builds; each world runs once per test session, shared
    across xdist workers through a lock file (keys are unique across the
    test modules that share the directory)."""
    import fcntl

    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    root = (tmp_path_factory.getbasetemp().parent / f"worlds-{run}") if run \
        else tmp_path_factory.getbasetemp() / "worlds"
    root.mkdir(parents=True, exist_ok=True)
    cache = {}

    def get(key):
        if key in cache:
            return cache[key]
        with open(root / f"{key}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            done, failed = root / f"{key}.pkl", root / f"{key}.failed"
            if failed.exists():
                raise RuntimeError(failed.read_text())
            if not done.exists():
                try:
                    results = worlds[key](str(root / key))
                except Exception as e:
                    failed.write_text(str(e))
                    raise
                with open(done, "wb") as f:
                    pickle.dump(results, f)
            with open(done, "rb") as f:
                cache[key] = pickle.load(f)
        return cache[key]

    return get


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(world, jobs, out, timeout=120, device="cpu"):
    """Start ``world`` ranks on ``jobs`` (gloo on the CPU, or NCCL with
    rank r on card r for ``device="cuda"``) and return each rank's
    results; every process is killed when the world outlives ``timeout``
    seconds, and a rank's failure raises with its output."""
    os.makedirs(out, exist_ok=True)
    spec_path = os.path.join(out, "spec.pkl")
    with open(spec_path, "wb") as f:
        pickle.dump({"out": out, "jobs": jobs, "device": device}, f)
    port = free_port()
    procs, logs = [], []
    for rank in range(world):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   OMP_NUM_THREADS="1", PYTHONPATH=REPO)
        log = open(os.path.join(out, f"rank{rank}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), spec_path],
            env=env, stdout=log, stderr=subprocess.STDOUT, cwd=REPO))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        tails = []
        for r in bad:
            with open(os.path.join(out, f"rank{r}.log")) as f:
                tails.append(f"--- rank {r} (rc {procs[r].returncode}):\n"
                             + f.read()[-3000:])
        raise RuntimeError(f"a world of {world} failed (timeout {timeout} "
                           f"s):\n" + "\n".join(tails))
    results = []
    for rank in range(world):
        with open(os.path.join(out, f"rank{rank}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


if __name__ == "__main__":
    main(sys.argv[1])
