"""Step time of the port's bf16 training slices for two or more checkouts,
in turns, on one GPU.

    python3 -m deepspeed_tpu_torch.runtime.step_ab ROOT_A ROOT_B \
        [--order ABBA] [--steps 10] [--out step_ab.json]

Each turn is one process that imports ``deepspeed_tpu_torch`` from its
checkout (ROOT_A is A, ROOT_B is B, ...; each builds its kernels inside
its own tree on first use) and trains, from the same seeds and batches as
``chip_smoke.py``'s train phases:

- gpt2-350m, seq 1024, micro 8, gas 2, bf16, Adam, WarmupLR, clipping 1.0;
- bert-base with Fixed block-sparse attention (block 64, 4 local, 1
  global), seq 4096, micro 4, gas 2, the same optimizer.

For each it reports the median step time of steps 2..N (each step ends
with a host read of its loss), then the device busy time and the number
of device operations per step under ``torch.profiler`` over 2 more steps.
The turns alternate (A B B A by default), so that a drift of the host or
of the card's clocks falls on both checkouts. One JSON line per turn, then
one summary line: per checkout and model the median of its turns, and each
checkout's difference to A.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

GPT2 = dict(name="gpt2-350m", seq=1024, micro=8, gas=2)
BERT = dict(name="bert-base", seq=4096, micro=4, gas=2,
            sparsity=dict(block=64, num_local_blocks=4, num_global_blocks=1))


def _config(micro, gas):
    """chip_smoke.py's training config: bf16 over fp32 master weights."""
    return {
        "train_batch_size": micro * gas,
        "train_micro_batch_size_per_gpu": micro,
        "gradient_accumulation_steps": gas,
        "optimizer": {"type": "Adam", "params": {"lr": 1e-4}},
        "scheduler": {"type": "WarmupLR",
                      "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 1e-4,
                                 "warmup_num_steps": 4}},
        "gradient_clipping": 1.0,
        "bf16": {"enabled": True},
        "steps_per_print": 10 ** 9,
    }


def _measure(engine, batch, steps):
    import torch
    from torch.profiler import ProfilerActivity, profile

    losses, step_ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch=batch)))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            engine.train_batch(batch=batch)
        torch.cuda.synchronize()
    busy_us, n_ops = 0.0, 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            busy_us += evt.time_range.elapsed_us()
            n_ops += 1
    if not n_ops:
        raise RuntimeError("the profiler recorded no device time")
    if not all(x == x and abs(x) != float("inf") for x in losses):
        raise RuntimeError(f"non-finite loss: {losses}")
    return {"step_ms": statistics.median(step_ms[1:]), "step_ms_all": step_ms,
            "device_ms": busy_us / 2 / 1e3, "device_ops": n_ops // 2,
            "losses": losses}


def turn(steps):
    """One checkout's measurements (the first on sys.path): one JSON
    line."""
    import numpy as np
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.bert import BertForPreTraining, bert_config
    from deepspeed_tpu_torch.models.gpt2 import GPT2Model, gpt2_config
    from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig

    out = {"package": os.path.dirname(os.path.abspath(
        deepspeed_tpu_torch.__file__))}
    cfg = gpt2_config(GPT2["name"], n_positions=GPT2["seq"],
                      dtype=torch.bfloat16, remat=False)
    gen = torch.Generator().manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size,
                        (GPT2["gas"], GPT2["micro"], GPT2["seq"]),
                        generator=gen)
    engine = initialize(model=GPT2Model(cfg), config_params=_config(
        GPT2["micro"], GPT2["gas"]))[0]
    out[GPT2["name"]] = _measure(
        engine, {"input_ids": ids, "labels": ids.clone()}, steps)
    del engine
    torch.cuda.empty_cache()

    cfg = bert_config(
        BERT["name"], max_position_embeddings=BERT["seq"],
        dtype=torch.bfloat16, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0,
        sparsity_config=FixedSparsityConfig(num_heads=12,
                                            **BERT["sparsity"]))
    rng = np.random.default_rng(0)
    shape = (BERT["gas"], BERT["micro"], BERT["seq"])
    ids = rng.integers(0, cfg.vocab_size, shape)
    labels = np.where(rng.random(shape) < 0.15, ids, -100)
    batch = {"input_ids": torch.as_tensor(ids),
             "attention_mask": torch.ones(shape, dtype=torch.int32),
             "masked_lm_labels": torch.as_tensor(labels)}
    engine = initialize(model=BertForPreTraining(cfg), config_params=_config(
        BERT["micro"], BERT["gas"]))[0]
    out[BERT["name"]] = _measure(engine, batch, steps)
    print(json.dumps(out), flush=True)


def _run_turn(root, steps, timeout):
    """``turn`` in a new process that imports the package from ``root``."""
    here = os.path.abspath(__file__)
    code = ("import importlib.util as u, sys; "
            f"sys.path.insert(0, {root!r}); "
            f"s = u.spec_from_file_location('step_ab', {here!r}); "
            "m = u.module_from_spec(s); s.loader.exec_module(m); "
            f"m.turn({steps})")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
        raise RuntimeError(f"the turn in {root} exited {proc.returncode}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    if got["package"] != os.path.join(root, "deepspeed_tpu_torch"):
        raise RuntimeError(f"the turn in {root} imported {got['package']}")
    return got


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+", help="checkouts, A first")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--timeout", type=int, default=900,
                    help="seconds per turn")
    ap.add_argument("--out", help="also write every line to this file")
    args = ap.parse_args(argv)
    roots = [os.path.abspath(r) for r in args.roots]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    lines = []

    def emit(obj):
        lines.append(json.dumps(obj))
        print(lines[-1], flush=True)

    turns = []
    for i, letter in enumerate(args.order):
        root = roots[ord(letter) - ord("A")]
        got = _run_turn(root, args.steps, args.timeout)
        got.update(turn=i, checkout=letter, root=root)
        turns.append(got)
        emit(got)
    summary = {"card": smi, "order": args.order, "steps": args.steps}
    for model in (GPT2["name"], BERT["name"]):
        per = {}
        for letter in sorted(set(args.order)):
            mine = [t[model] for t in turns if t["checkout"] == letter]
            per[letter] = {k: statistics.median(m[k] for m in mine)
                           for k in ("step_ms", "device_ms", "device_ops")}
        for letter, row in per.items():
            row.update({f"{k}_minus_A": row[k] - per["A"][k]
                        for k in ("step_ms", "device_ms", "device_ops")})
        summary[model] = per
    emit(summary)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
