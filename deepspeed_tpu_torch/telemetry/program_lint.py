"""Whole-program lint — every registered program held to its contract.

Port of tools/graftlint/program_lint.py. Every engine registers each
program it dispatches in a ``telemetry.programs.ProgramRegistry`` with
declarative contract metadata (host_transfer_free, collective_free,
donates, wire_dtype, expect_op_counts, uniform_group, ...). The lint arms
the registries (``observing``), lets the engines dispatch, and holds the
observation of one dispatch of each program (telemetry/program_checks.py)
to its declared contract. Registering a program IS opting into coverage.

One analysis spans programs: **collective order**
(``program-collective-order``): programs sharing a ``uniform_group`` must
post the identical (op, dtype) collective sequence; two SPMD programs
that dispatch in the same step but disagree on it deadlock.

Findings are reported under pseudo-paths ``<engine:program>`` and split
against a baseline (``program_baseline.json`` beside this file, empty:
acknowledge a load-bearing violation by baselining it with a note, or fix
the contract).

CLI::

    python -m deepspeed_tpu_torch.telemetry.program_lint [--json]
        [--device cpu|cuda]

builds the tiny-engine corpus below on ``device`` (the card by default),
lints it, prints the report (``--json``: the shape of the JAX package's
``--programs --json`` output: ``summary.new``, ``summary.stale_baseline``,
``rules``, ``programs``) and exits 1 on any new finding.
"""
import argparse
import hashlib
import json
import logging
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from deepspeed_tpu_torch.telemetry import program_checks as pc

DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "program_baseline.json")

#: dtypes a "wire" contract considers wide — a declared sub-fp32 wire
#: must not move gradient-sized payloads in any of these.
WIDE_DTYPES = ("f32", "f64", "bf16", "f16")

#: payloads at or above this element count are "gradient-sized" unless
#: the contract overrides via ``wire_min_elements``.
DEFAULT_WIRE_MIN_ELEMENTS = 512


class ProgramRule:
    """Catalog entry of one program-lint check (the checks run in
    :func:`lint_entry`)."""

    def __init__(self, name: str, description: str):
        self.name = name
        self.description = description


PROGRAM_RULES: Dict[str, ProgramRule] = {r.name: r for r in [
    ProgramRule("program-lower-error",
                "a registered program could not be observed — the lint "
                "saw no dispatch of it, or the observed dispatch failed "
                "— so its contract cannot be checked"),
    ProgramRule("program-host-transfer",
                "program declared host_transfer_free but its dispatch "
                "read the device back to the host (.item(), a blocking or "
                "pageable device-to-host copy, a data-dependent shape)"),
    ProgramRule("program-collective-free",
                "program declared collective_free but its dispatch "
                "posted collectives"),
    ProgramRule("program-wire-widening",
                "program declares a sub-fp32 wire but a wide-dtype "
                "collective moves a gradient-sized payload"),
    ProgramRule("program-forbidden-collective",
                "program forbids specific collective ops but its "
                "dispatch posted one"),
    ProgramRule("program-op-count",
                "collective op/dtype count differs from the contract "
                "(e.g. one parameter all-gather per ZeRO step)"),
    ProgramRule("program-collective-budget",
                "total collective payload exceeds the analytic byte "
                "budget from runtime/comm_accounting.py"),
    ProgramRule("program-donation",
                "declared-donated state was not updated in place: its "
                "storage moved (a fresh copy per call)"),
    ProgramRule("program-output-alias",
                "a result the contract pins as written-into-donated-"
                "memory allocates a fresh buffer instead"),
    ProgramRule("program-boundary-dtype",
                "the program emits an output dtype outside the declared "
                "boundary set"),
    ProgramRule("program-collective-order",
                "programs sharing a uniform_group disagree on their "
                "(op, dtype) collective sequence — static SPMD "
                "deadlock"),
]}


def program_rules() -> List[ProgramRule]:
    return list(PROGRAM_RULES.values())


# ---------------------------------------------------------------------------
# findings and the baseline (the parts of tools/graftlint/core.py used here)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Finding:
    """One contract violation of one program."""
    rule: str
    path: str          # <engine:program>
    line: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def fingerprint(finding: Finding, line_text: str, occurrence: int) -> str:
    """Stable id for baselining: (path, rule, text, occurrence)."""
    key = f"{finding.path}|{finding.rule}|{line_text.strip()}|{occurrence}"
    return hashlib.sha1(key.encode()).hexdigest()[:16]


@dataclass
class RunResult:
    new: List[Finding] = field(default_factory=list)
    baselined: List[Finding] = field(default_factory=list)
    stale: List[dict] = field(default_factory=list)   # baseline entries
    fingerprints: Dict[str, Finding] = field(default_factory=dict)
    # a baseline entry is only judged stale when its program was linted
    # AND its rule ran
    scanned_paths: set = field(default_factory=set)
    rule_names: set = field(default_factory=set)

    def covers(self, entry: dict) -> bool:
        return entry.get("path") in self.scanned_paths \
            and entry.get("rule") in self.rule_names

    @property
    def exit_code(self) -> int:
        return 1 if self.new else 0


def load_baseline(path: str = DEFAULT_BASELINE) -> dict:
    if not os.path.exists(path):
        return {"version": 1, "entries": []}
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    assert isinstance(data.get("entries"), list), \
        f"malformed baseline {path}: no 'entries' list"
    return data


def save_baseline(result: RunResult, path: str = DEFAULT_BASELINE,
                  notes: Optional[Dict[str, str]] = None) -> dict:
    """Write every current finding as the fresh baseline; stale covered
    entries are pruned, entries the run did not cover are kept. ``notes``
    maps fingerprint -> why it stays; notes on surviving entries are
    kept."""
    old = load_baseline(path)["entries"]
    old_notes = {e["fingerprint"]: e.get("note", "") for e in old}
    entries = [e for e in old if not result.covers(e)]
    for fp, f in sorted(result.fingerprints.items(),
                        key=lambda kv: (kv[1].path, kv[1].line, kv[1].rule)):
        note = (notes or {}).get(fp) or old_notes.get(fp, "")
        entries.append({"fingerprint": fp, "rule": f.rule, "path": f.path,
                        "line": f.line, "message": f.message, "note": note})
    entries.sort(key=lambda e: (e["path"], e["line"], e["rule"]))
    data = {"version": 1, "entries": entries}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2, sort_keys=True)
        f.write("\n")
    return data


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------

def _cget(contract: dict, key: str, default=None):
    """Contract lookup that treats an explicit None value as absent."""
    v = contract.get(key, default)
    return default if v is None else v


def _fmt_ops(ops: Sequence[pc.CollectiveOp], limit: int = 3) -> str:
    return ", ".join(f"{c.op}[{c.dtype}x{c.elements}]" for c in ops[:limit])


def collective_order(obs: pc.Observation) -> List[tuple]:
    """The program's collective sequence as (op, dtype) pairs, in posting
    order."""
    return [(c.op, c.dtype) for c in pc.collective_ops(obs)]


def lint_entry(engine: str, entry) -> List[Finding]:
    """Run every applicable contract check on one registered program
    (``telemetry.programs.ProgramEntry``) over its observed dispatch.
    Cross-program checks (collective order) live in
    :func:`lint_programs`."""
    path = f"<{engine}:{entry.name}>"
    c = entry.contract or {}
    out: List[Finding] = []

    def emit(rule, message):
        out.append(Finding(rule=rule, path=path, line=0, message=message))

    obs = entry.observation
    if obs is None:
        emit("program-lower-error",
             "not observed: the lint saw no completed dispatch of this "
             "program (registered before the registry was armed, or its "
             "observed dispatch raised)")
        return out
    ops = pc.collective_ops(obs)

    if _cget(c, "host_transfer_free"):
        hits = pc.host_transfer_ops(obs)
        if hits:
            emit("program-host-transfer",
                 f"declared host_transfer_free but its dispatch made "
                 f"{len(hits)} host read(s): {hits[0]}")

    if _cget(c, "collective_free"):
        if ops:
            emit("program-collective-free",
                 f"declared collective_free but its dispatch posted "
                 f"{len(ops)} collective(s): {_fmt_ops(ops)}")

    wire = _cget(c, "wire_dtype")
    if wire:
        declared = {wire} if isinstance(wire, str) else set(wire)
        min_el = int(_cget(c, "wire_min_elements",
                           DEFAULT_WIRE_MIN_ELEMENTS))
        wide = [o for o in ops
                if o.dtype in WIDE_DTYPES and o.dtype not in declared
                and o.elements >= min_el]
        if wide:
            emit("program-wire-widening",
                 f"declares {sorted(declared)} wire but moves "
                 f"wide-dtype payload(s) >= {min_el} elements through "
                 f"collectives: {_fmt_ops(wide)}")
        elif ops and not any(o.dtype in declared for o in ops) \
                and any(o.elements >= min_el for o in ops):
            emit("program-wire-widening",
                 f"declares {sorted(declared)} wire but no collective "
                 f"rides it — the whole wire ran in "
                 f"{sorted({o.dtype for o in ops})}")

    forbid = _cget(c, "forbid_collectives")
    if forbid:
        hits = [o for o in ops if o.op in set(forbid)]
        if hits:
            emit("program-forbidden-collective",
                 f"contract forbids {sorted(set(forbid))} but its "
                 f"dispatch posted: {_fmt_ops(hits)}")

    for spec in _cget(c, "expect_op_counts", ()) or ():
        if not spec:
            continue
        op, dtype, count = spec
        got = sum(1 for o in ops if o.op == op and o.dtype == dtype)
        if got != int(count):
            emit("program-op-count",
                 f"expected exactly {count} {op}[{dtype}] collective(s), "
                 f"its dispatch posted {got}")

    budget = _cget(c, "comm_budget_bytes")
    if budget is not None:
        key = _cget(c, "comm_budget_key", "comm_budget_bytes")
        try:
            budget = int(budget() if callable(budget) else budget)
        except Exception as e:  # a budget that cannot resolve is a finding
            emit("program-collective-budget",
                 f"budget callable for {key!r} raised "
                 f"{type(e).__name__}: {e}")
            budget = None
        if budget is not None:
            cutoff = int(_cget(c, "comm_small_op_cutoff", 0))
            measured = sum(o.bytes for o in ops if o.elements > cutoff)
            if measured > budget:
                emit("program-collective-budget",
                     f"moves {measured} collective bytes (ops > {cutoff} "
                     f"elements), over the analytic budget {budget} "
                     f"({key}): {_fmt_ops(ops)}")

    donates = _cget(c, "donates")
    if donates:
        min_el = int(_cget(c, "donation_min_elements", 0))
        moved = pc.moved_donations(obs, donates, min_el)
        if moved:
            emit("program-donation",
                 f"declared-donated state {moved[:4]}"
                 f"{' ...' if len(moved) > 4 else ''} ({len(moved)} "
                 f"tensor(s)) not updated in place: its storage moved "
                 f"— silent copy per call")

    n_aliased = _cget(c, "outputs_aliased")
    if n_aliased:
        got = pc.aliased_outputs(obs)
        missing = [i for i in range(int(n_aliased)) if i not in got]
        if missing:
            emit("program-output-alias",
                 f"output(s) {missing} of {n_aliased} must be written "
                 f"into donated memory but allocate fresh buffers "
                 f"(aliased: {sorted(got) or 'none'})")

    boundary = _cget(c, "boundary_dtypes")
    if boundary:
        allowed = {boundary} if isinstance(boundary, str) else set(boundary)
        got = pc.entry_output_dtypes(obs)
        extra = sorted({d for d in got if d not in allowed})
        if extra:
            emit("program-boundary-dtype",
                 f"boundary must stay in {sorted(allowed)} but the "
                 f"program emits {extra} (outputs: {got})")

    return out


def lint_programs(registries, baseline_path: str = DEFAULT_BASELINE,
                  use_baseline: bool = True) -> RunResult:
    """Lint every program in ``registries`` (iterable of
    ProgramRegistry). Pseudo-paths of ALL linted programs count as
    covered, so stale baseline entries are judged and pruned."""
    result = RunResult(rule_names=set(PROGRAM_RULES))
    findings: List[Finding] = []
    groups: Dict[tuple, list] = {}
    for reg in registries:
        for entry in reg.entries():
            path = f"<{reg.engine}:{entry.name}>"
            result.scanned_paths.add(path)
            findings.extend(lint_entry(reg.engine, entry))
            group = _cget(entry.contract or {}, "uniform_group")
            if group:
                # scoped per registry: programs from different engines
                # never dispatch in the same SPMD cohort
                groups.setdefault((reg.engine, group), []) \
                    .append((path, entry))

    for engine, group in sorted(groups):
        members = sorted(groups[(engine, group)], key=lambda pe: pe[0])
        orders = [(path, collective_order(entry.observation))
                  for path, entry in members
                  if entry.observation is not None]
        if len(orders) < 2:
            continue
        ref_path, ref_order = orders[0]
        for path, order in orders[1:]:
            if order != ref_order:
                findings.append(Finding(
                    rule="program-collective-order", path=path, line=0,
                    message=f"collective order diverges from {ref_path} "
                            f"within uniform_group {group!r}: "
                            f"{order} vs {ref_order} — programs "
                            f"dispatched in the same step would "
                            f"deadlock"))

    seen_occ: Dict[tuple, int] = {}
    for f in sorted(findings, key=lambda f: (f.path, f.rule, f.message)):
        k = (f.path, f.rule, f.message)
        occ = seen_occ.get(k, 0)
        seen_occ[k] = occ + 1
        result.fingerprints[fingerprint(f, f.message, occ)] = f

    baseline = load_baseline(baseline_path) if use_baseline \
        else {"entries": []}
    known = {e["fingerprint"]: e for e in baseline["entries"]}
    for fp, f in result.fingerprints.items():
        (result.baselined if fp in known else result.new).append(f)
    live = set(result.fingerprints)
    result.stale = [e for e in baseline["entries"]
                    if e["fingerprint"] not in live and result.covers(e)]
    result.new.sort(key=lambda f: (f.path, f.line, f.rule))
    result.baselined.sort(key=lambda f: (f.path, f.line, f.rule))
    return result


def report_json(result: RunResult, registries=()) -> dict:
    """The JSON report: the JAX package's ``--programs --json`` shape."""
    def enc(f: Finding):
        return {"rule": f.rule, "path": f.path, "line": f.line,
                "message": f.message}

    return {
        "version": 1,
        "rules": sorted(PROGRAM_RULES),
        "new": [enc(f) for f in result.new],
        "baselined": [enc(f) for f in result.baselined],
        "stale_baseline": result.stale,
        "summary": {"new": len(result.new),
                    "baselined": len(result.baselined),
                    "stale_baseline": len(result.stale)},
        "programs": {reg.engine: reg.summary() for reg in registries},
    }


# ---------------------------------------------------------------------------
# corpus: tiny engines covering every program family the port builds, at
# the JAX corpus's sizes. The families that need a world of dp > 1
# (base-qgz, stage3, zeroone, onebit, and pipe and pipe-bf16: pipe 2 x
# data 2, ``pipe_family``) are linted in the tests' gloo worlds
# (tests/test_torch_programs.py, test_torch_zeroone.py,
# test_torch_onebit.py, test_torch_pipe.py).
# ---------------------------------------------------------------------------

#: the tiny GPT-2 of the JAX corpus (tools/graftlint/program_lint.py)
TINY_GPT2 = dict(vocab_size=97, n_positions=64, n_embd=32, n_layer=2,
                 n_head=4)
TRAIN_SEQ = 16


def tiny_gpt2(device):
    """TINY_GPT2, with one head of 64 on the card: the flash kernels take
    head_dim 64, 96 or 128 only."""
    import torch

    if torch.device(device).type == "cuda":
        return dict(TINY_GPT2, n_embd=64, n_head=1)
    return TINY_GPT2


def train_config(offload=False):
    """The base and offload families' ds_config: Adam, 2 micro-batches
    of 2 (offload: ZeRO stage 2 with cpu_offload)."""
    cfg = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
           "gradient_accumulation_steps": 2,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
           "steps_per_print": 10 ** 9}
    if offload:
        cfg["zero_optimization"] = {"stage": 2, "cpu_offload": True}
    return cfg


def train_batch(seed=0):
    """(gas, micro, seq) token ids of the base and offload families."""
    import numpy as np

    ids = np.random.default_rng(seed).integers(
        0, TINY_GPT2["vocab_size"], (2, 2, TRAIN_SEQ))
    return {"input_ids": ids, "labels": ids.copy()}


def _train_engine(device, offload=False):
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model

    model = GPT2Model(GPT2Config(dtype=torch.float32, **tiny_gpt2(device)))
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, config_params=train_config(offload), device=device)
    engine.program_registry.observing = True
    return engine


def drive_base(engine, batch):
    """The base family's calls: train_batch (fused_train_step), then
    forward / backward / step over the same micro-batches (micro_step,
    apply_step), then eval_loss. Any engine with the DeepSpeed API."""
    engine.train_batch(batch=batch)
    for i in range(engine.gradient_accumulation_steps()):
        micro = {k: v[i] for k, v in batch.items()}
        engine.backward(engine(micro))
        engine.step()
    engine.eval_loss({k: v[0] for k, v in batch.items()})


def _corpus_base(device):
    """Stage 0, fp32: every program of the training engine's step."""
    engine = _train_engine(device)
    drive_base(engine, train_batch())
    return engine.program_registry


def _corpus_offload(device):
    """ZeRO-Offload (stage 2, cpu_offload): train_batch's micro steps."""
    engine = _train_engine(device, offload=True)
    engine.train_batch(batch=train_batch())
    reg = engine.program_registry
    reg.engine = "offload"
    return reg


def serving_model(device):
    """The JAX serving corpus's GPT-2 (``tiny_gpt2``), fp32, seed-0
    weights."""
    import torch

    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model

    return GPT2Model(GPT2Config(dtype=torch.float32, **tiny_gpt2(device)),
                     torch.Generator().manual_seed(0))


def serving_engines(make, observe=True):
    """The three serving engines of the JAX corpus, armed (``observe``),
    each driven through the same requests as there: a plain one
    (decode_step), one with prefix cache + speculative decoding (prefill
    buckets, COW page copy, spec verify) and one with a sparse attention
    context. ``make(**kwargs)`` builds one engine (an ``InferenceEngine``
    over the model and weights)."""
    import numpy as np

    rng = np.random.default_rng(1)
    kw = dict(kv_block_size=4, prefill_chunk=8, max_blocks_per_seq=8)

    plain = make(max_slots=3, **kw)
    plain.program_registry.observing = observe
    plain.submit(rng.integers(0, 97, 5).astype(np.int32),
                 max_new_tokens=4)
    plain.serve(max_steps=100)
    plain.program_registry.engine = "serving"

    spec = make(max_slots=3, prefix_cache=True, speculative=3, **kw)
    spec.program_registry.observing = observe
    # two requests sharing a prefix: the second forks COW pages off the
    # cached prefix; speculative drafting covers the verify program
    shared = rng.integers(0, 97, 9).astype(np.int32)
    spec.submit(shared, max_new_tokens=6)
    spec.serve(max_steps=200)
    spec.submit(np.concatenate([shared, rng.integers(0, 97, 3)])
                .astype(np.int32), max_new_tokens=6)
    spec.serve(max_steps=200)
    spec.program_registry.engine = "serving-spec"

    sparse = make(max_slots=2,
                  sparse_context={"num_sliding_window_blocks": 2,
                                  "num_global_blocks": 1}, **kw)
    sparse.program_registry.observing = observe
    # 9-token prompt: one full chunk8 + a 1-token final chunk (bucket 4)
    # covers both sparse prefill shapes plus the sparse decode step
    sparse.submit(rng.integers(0, 97, 9).astype(np.int32),
                  max_new_tokens=4)
    sparse.serve(max_steps=200)
    sparse.program_registry.engine = "serving-sparse"
    return [plain, spec, sparse]


def _corpus_serving(device):
    from deepspeed_tpu_torch.serving import InferenceEngine

    model = serving_model(device)
    engines = serving_engines(
        lambda **kw: InferenceEngine(model, None, device=device, **kw))
    return [e.program_registry for e in engines]


def pipe_family(family, device="cpu"):
    """The engine of the ``pipe`` or ``pipe-bf16`` family (JAX corpus,
    tools/graftlint/program_lint.py:482-520) at mesh pipe 2 x data 2, its
    registry observing, after one train_batch: ``pipe`` a ZB-H1 pipeline
    with the stash armed (an untied tiny GPT-2, fp32: the JAX family's
    untied stack model), ``pipe-bf16`` the tied bf16 GPT-2 pipeline (its
    ZB-H1 request falls back to 1f1b over the tied head), whose
    non-last forwards carry the boundary-dtype contract. Needs a world
    of 2 (each rank drives its pipe line) or 4 processes."""
    import numpy as np
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config
    from deepspeed_tpu_torch.models.gpt2_pipe import gpt2_pipeline_module

    bf16 = family == "pipe-bf16"
    cfg = GPT2Config(vocab_size=64, n_positions=16, n_embd=32, n_layer=2,
                     n_head=4, dtype=torch.bfloat16 if bf16
                     else torch.float32, loss_chunk_tokens=0)
    module = gpt2_pipeline_module(cfg, partition_method="uniform",
                                  untied_head=not bf16)
    config = {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 2,
              "gradient_accumulation_steps": 2,
              "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
              "pipeline": {"schedule": "zb-h1"},
              "mesh": {"pipe": 2, "data": 2},
              "steps_per_print": 10 ** 9}
    if bf16:
        config["bf16"] = {"enabled": True}
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=module, config_params=config, device=device)
    engine.program_registry.observing = True
    engine.program_registry.engine = family
    ids = np.random.default_rng(0).integers(0, 64, (2, 2, 16))
    engine.train_batch(batch={"input_ids": ids, "labels": ids.copy()})
    return engine


CORPUS_BUILDERS = {
    "base": _corpus_base,
    "offload": _corpus_offload,
    "serving": _corpus_serving,
}


def build_corpus(only: Optional[Sequence[str]] = None, device="cuda"):
    """Build the tiny-engine corpus on ``device`` and return its
    ProgramRegistry list; ``only`` restricts it to a subset of
    CORPUS_BUILDERS' keys."""
    names = list(CORPUS_BUILDERS) if only is None else list(only)
    unknown = set(names) - set(CORPUS_BUILDERS)
    if unknown:
        raise ValueError(f"unknown corpus engine(s) {sorted(unknown)}; "
                         f"known: {sorted(CORPUS_BUILDERS)}")
    registries = []
    for n in names:
        built = CORPUS_BUILDERS[n](device)
        registries.extend(built if isinstance(built, list) else [built])
    return registries


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deepspeed_tpu_torch.telemetry.program_lint",
        description="lint the contracts of the programs the port's "
                    "engines dispatch, over a corpus of tiny engines")
    ap.add_argument("--json", action="store_true",
                    help="print the JSON report (logs go to stderr)")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="where the corpus's engines run (default: the "
                         "card)")
    args = ap.parse_args(argv)
    for handler in logging.getLogger("deepspeed_tpu_torch").handlers:
        handler.setStream(sys.stderr)       # stdout is the report's
    t0 = time.perf_counter()
    registries = build_corpus(device=args.device)
    result = lint_programs(registries)
    if args.json:
        report = report_json(result, registries)
        report["seconds"] = time.perf_counter() - t0
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        for f in result.new:
            print(f.format())
        for f in result.baselined:
            print(f"{f.format()}  (baselined)")
        for e in result.stale:
            print(f"stale baseline entry {e['path']} [{e['rule']}]")
        n = sum(len(r.names()) for r in registries)
        print(f"program lint: {n} programs, {len(result.new)} new, "
              f"{len(result.baselined)} baselined, {len(result.stale)} "
              f"stale ({len(PROGRAM_RULES)} rules, "
              f"{time.perf_counter() - t0:.1f} s)")
    return result.exit_code


if __name__ == "__main__":
    sys.exit(main())
