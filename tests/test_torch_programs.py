"""The port's dispatched-program registry and its contract lint
(deepspeed_tpu_torch/telemetry/{programs,program_checks,program_lint}.py)
against the JAX package's (deepspeed_tpu/telemetry/programs.py,
tools/graftlint/program_lint.py).

- **Against the JAX engines**: the same calls on the same tiny configs,
  the port starting from the JAX engine's parameters (models/convert.py),
  register the same program names with the same contracts (the JAX flat
  ``donates`` indices translated to the leaves they name) and the same
  ``calls_per_step``, for the base, offload and serving families.
- **The CLI over the port's CPU corpus** comes out clean and complete in
  one subprocess.
- **The stage-3 and qgZ families** (``stage3``: s3_fwd, s3_bwd,
  apply_step; ``base-qgz``: micro_step on the s8 wire, apply_step,
  eval_loss) on gloo worlds of 2 against the JAX engines at mesh data 2
  (tests/test_torch_zero3.py's worlds): the same contracts and no finding;
  three planted faults, one finding each.
- **One test per rule**: each of the eleven rules fires once on its
  planted fault and stays quiet without it, on hand-registered programs
  (observed for real on CPU tensors) or on observations built by hand.
  The op-count, donation and collective-order rules on the ZeRO-2 step
  run on a gloo world of 2 (tests/torch_zero_worker.py).
- **Observing changes nothing**: the same losses bit for bit, and an
  engine that is not being linted runs the same aten ops per step as one
  without the registry.

The JAX side is imported inside the tests that run it: the cuda-marked
case runs on a card's machine, which has no JAX.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from deepspeed_tpu_torch.runtime.engine import LOSS_REDUCTION_BYTES
from deepspeed_tpu_torch.serving import InferenceEngine
from deepspeed_tpu_torch.telemetry import program_checks as pc
from deepspeed_tpu_torch.telemetry import program_lint as pl
from deepspeed_tpu_torch.telemetry.programs import (CONTRACT_KEYS,
                                                    NO_OBSERVER,
                                                    ProgramRegistry,
                                                    register_program)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_zero3 as Z3  # noqa: E402
import torch_zero_worker as W  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the port's corpus: the JAX corpus's serving families
# (tests/unit/test_program_lint.py EXPECTED_PROGRAMS) and the base and
# offload families it builds beside them
EXPECTED_PROGRAMS = {
    "base": {"apply_step", "eval_loss", "fused_train_step", "micro_step"},
    "offload": {"micro_offload"},
    "serving": {"decode_step", "prefill_chunk8_final"},
    "serving-spec": {"cow_copy", "prefill_chunk4_final", "prefill_chunk8",
                     "spec_verify"},
    "serving-sparse": {"sparse_decode_step", "sparse_prefill_chunk8",
                       "sparse_prefill_chunk4_final"},
}
# the JAX corpus's stage-3 and qgZ families (EXPECTED_PROGRAMS there),
# which need a world of dp > 1: built in the gloo worlds of
# tests/test_torch_zero3.py, on the tiny GPT-2 at dp 2
WORLD_FAMILIES = {
    "base-qgz": {"apply_step", "eval_loss", "micro_step"},
    "stage3": {"apply_step", "s3_bwd", "s3_fwd"},
}
CLI_BUDGET_S = 60
# TrainState fields that are host values in the port (its step counters
# and rng key are ints and a generator), never donated tensors
HOST_FIELDS = {"step", "micro_step", "rng"}


def rules(result):
    return [f.rule for f in result.new]


# ---------------------------------------------------------------------------
# the catalog and the registry
# ---------------------------------------------------------------------------

def test_rules_and_contract_keys_are_the_jax_packages():
    from deepspeed_tpu.telemetry.programs import CONTRACT_KEYS as J_KEYS
    from tools.graftlint.program_lint import PROGRAM_RULES as J_RULES

    assert set(pl.PROGRAM_RULES) == set(J_RULES)
    assert len(pl.PROGRAM_RULES) == 11
    assert CONTRACT_KEYS == J_KEYS and len(CONTRACT_KEYS) == 15
    for r in pl.program_rules():
        assert r.name in pl.PROGRAM_RULES and r.description


def test_contract_key_typo_fails_loudly_and_values_resolve_lazily():
    reg = ProgramRegistry(engine="t")
    with pytest.raises(ValueError, match="wire_dtpye"):
        reg.register("p", contract={"wire_dtpye": "s8"})
    with pytest.raises(ValueError, match="donatez"):
        reg.dispatch("q", contract={"donatez": [0]})
    calls = []

    def budget():
        calls.append(1)
        return 64

    reg.register("p", contract={"comm_budget_bytes": budget,
                                "forbid_collectives": ("all-gather",)})
    with pytest.raises(ValueError, match="donatez"):
        reg.declare("p", donatez=[0])
    assert calls == []                       # nothing resolved yet
    got = reg.summary()["p"]["contract"]
    assert got == {"comm_budget_bytes": 64,
                   "forbid_collectives": ["all-gather"]} and calls == [1]
    reg.declare("p", comm_budget_bytes=lambda: 1 / 0)
    assert reg.summary()["p"]["contract"]["comm_budget_bytes"] \
        .startswith("<unresolvable: ZeroDivisionError")


def test_donates_argnums_expand_to_state_names_at_registration():
    state = {"w": torch.zeros(4), "m": torch.zeros(4)}
    reg = ProgramRegistry(engine="t")
    register_program(reg, "step", (lambda: state, torch.zeros(2)),
                     {"donates_argnums": (0, 1), "donates": ["x"]})
    assert reg.get("step").contract == {"donates": ["arg1", "m", "w", "x"]}
    register_program(reg, "step", (), {"collective_free": True})
    assert reg.names() == ["step"]           # the first registration holds
    assert reg.dispatch("step") is NO_OBSERVER   # not observing


# ---------------------------------------------------------------------------
# one test per rule: a planted fault fires exactly one finding of the
# rule, and its twin without the fault none
# ---------------------------------------------------------------------------

def _observed(contract, body, args=(), engine="t", name="p"):
    """A program registered with ``contract`` and observed running
    ``body()`` for real (CPU tensors); returns its registry."""
    reg = ProgramRegistry(engine=engine)
    reg.observing = True
    with reg.dispatch(name, args, contract) as obs:
        out = body()
        if isinstance(out, tuple):
            obs.outputs(*out)
    return reg


def _recorded(contract, **observation):
    """A program registered with ``contract`` whose observation is built
    by hand."""
    reg = ProgramRegistry(engine="t")
    reg.register("p", contract)
    reg.get("p").observation = pc.Observation(**observation)
    return reg


def _state():
    return {"w": torch.ones(64), "small": torch.ones(2)}


def _case_lower_error(fault):
    reg = ProgramRegistry(engine="t")
    reg.register("p", {"host_transfer_free": True})
    if fault:
        reg.observing = True
        with pytest.raises(RuntimeError, match="drift"):
            with reg.dispatch("p"):
                raise RuntimeError("registration drift")
    else:
        reg.get("p").observation = pc.Observation()
    return reg


def _case_host_transfer(fault):
    x = torch.arange(8.0)

    def body():
        y = x * 2
        return (y, torch.tensor(y.sum().item())) if fault else (y,)
    return _observed({"host_transfer_free": True}, body)


def _case_collective_free(fault):
    ops = (pc.collective("all-reduce", "f32", 1024),) if fault else ()
    return _recorded({"collective_free": True}, collectives=ops)


def _case_wire_widening(fault):
    ops = (pc.collective("all-reduce", "bf16" if fault else "s8", 1024),
           pc.collective("all-reduce", "f32", 8))
    return _recorded({"wire_dtype": "s8"}, collectives=ops)


def _case_forbidden_collective(fault):
    ops = (pc.collective("all-gather" if fault else "reduce-scatter", "f32",
                         4096),)
    return _recorded({"forbid_collectives": ("all-gather",)},
                     collectives=ops)


def _case_op_count(fault):
    ops = (pc.collective("all-gather", "f32", 512),) * (1 if fault else 2)
    return _recorded({"expect_op_counts": [("all-gather", "f32", 2)]},
                     collectives=ops)


def _case_collective_budget(fault):
    ops = (pc.collective("all-reduce", "f32", 300 if fault else 100),
           pc.collective("all-reduce", "f32", 1))
    return _recorded({"comm_budget_bytes": lambda: 800,
                      "comm_small_op_cutoff": 8}, collectives=ops)


def _case_donation(fault):
    state = _state()

    def body():
        with torch.no_grad():
            if fault:
                state["w"] = state["w"] * 2      # a fresh copy
            else:
                state["w"].mul_(2)
            state["small"] = state["small"] + 1  # exempt: 2 elements
    return _observed({"donates_argnums": (0,),
                      "donation_min_elements": 4}, body,
                     args=(lambda: state,))


def _case_output_alias(fault):
    state = _state()

    def body():
        state["w"].add_(1)
        return (state["w"].clone() if fault else state["w"][:8],)
    return _observed({"donates_argnums": (0,), "outputs_aliased": 1}, body,
                     args=(lambda: state,))


def _case_boundary_dtype(fault):
    x = torch.ones(4, dtype=torch.bfloat16)
    return _observed({"boundary_dtypes": ("bf16",)},
                     lambda: (x.float() if fault else x * 2,))


def _case_collective_order(fault):
    reg = ProgramRegistry("t")
    for name, ops in (("a", ("all-reduce", "all-gather")),
                      ("b", ("all-gather", "all-reduce") if fault
                       else ("all-reduce", "all-gather"))):
        reg.register(name, {"uniform_group": "g"})
        reg.get(name).observation = pc.Observation(
            collectives=tuple(pc.collective(op, "f32", 64) for op in ops))
    # the same group name in another engine is never compared
    other = ProgramRegistry("u")
    other.register("c", {"uniform_group": "g"})
    other.get("c").observation = pc.Observation(
        collectives=(pc.collective("all-to-all", "s8", 64),))
    return [reg, other]


CASES = {
    "program-lower-error": _case_lower_error,
    "program-host-transfer": _case_host_transfer,
    "program-collective-free": _case_collective_free,
    "program-wire-widening": _case_wire_widening,
    "program-forbidden-collective": _case_forbidden_collective,
    "program-op-count": _case_op_count,
    "program-collective-budget": _case_collective_budget,
    "program-donation": _case_donation,
    "program-output-alias": _case_output_alias,
    "program-boundary-dtype": _case_boundary_dtype,
    "program-collective-order": _case_collective_order,
}


@pytest.mark.parametrize("rule", sorted(CASES))
def test_each_rule_fires_once_on_its_planted_fault(rule):
    assert set(CASES) == set(pl.PROGRAM_RULES)

    def lint(fault):
        built = CASES[rule](fault)
        regs = built if isinstance(built, list) else [built]
        return pl.lint_programs(regs, use_baseline=False)

    assert rules(lint(False)) == []
    got = lint(True)
    assert rules(got) == [rule], [f.format() for f in got.new]
    assert got.exit_code == 1


def test_observer_reads_host_syncs_off_the_dispatched_ops():
    """What the observer counts as a host read, op by op on CPU tensors;
    device work alone (and a host-to-device upload) counts as none."""
    x = torch.arange(6.0)
    reads = {
        "item": lambda: x.sum().item(),
        "float": lambda: float(x[0]),
        "nonzero": lambda: torch.nonzero(x),
        "bool mask": lambda: x[x > 2],
        "masked_select": lambda: torch.masked_select(x, x > 2),
        "unique": lambda: torch.unique(x),
        "equal": lambda: torch.equal(x, x),
    }
    for what, fn in reads.items():
        reg = _observed({}, fn)
        got = pc.host_transfer_ops(reg.get("p").observation)
        assert len(got) == 1, (what, got)
    quiet = _observed({}, lambda: (torch.where(x > 2, x, 0) * 2,
                                   torch.from_numpy(np.ones(3)).to("cpu")))
    assert pc.host_transfer_ops(quiet.get("p").observation) == []
    assert pc.entry_output_dtypes(quiet.get("p").observation) == \
        ["f32", "f64"]


def test_a_program_spanning_two_calls_is_one_observation():
    """forward() and backward() are one micro_step: start/stop around
    each part, close after the last; reads from both parts count."""
    reg = ProgramRegistry("t")
    reg.observing = True
    obs = reg.dispatch("micro", contract={"host_transfer_free": True})
    x = torch.ones(3, requires_grad=True)
    obs.start()
    loss = (x * 2).sum()
    obs.stop()
    float(loss.detach())                          # between the parts
    obs.start()
    loss.backward()
    bool(x.grad.sum())
    obs.stop()
    obs.close()
    got = pc.host_transfer_ops(reg.get("micro").observation)
    assert len(got) == 1 and "_local_scalar_dense" in got[0]
    assert reg.dispatch("micro") is NO_OBSERVER   # observed once


def test_baseline_round_trip_and_stale_entries(tmp_path):
    path = str(tmp_path / "baseline.json")
    bad = _case_host_transfer(True)
    res = pl.lint_programs([bad], baseline_path=path)
    assert rules(res) == ["program-host-transfer"]
    pl.save_baseline(res, path, notes={
        next(iter(res.fingerprints)): "load-bearing: a planted read"})
    entries = pl.load_baseline(path)["entries"]
    assert len(entries) == 1 and entries[0]["note"]
    again = pl.lint_programs([_case_host_transfer(True)], baseline_path=path)
    assert again.new == [] and len(again.baselined) == 1
    assert again.stale == [] and again.exit_code == 0
    fixed = pl.lint_programs([_case_host_transfer(False)],
                             baseline_path=path)
    assert fixed.new == [] and len(fixed.stale) == 1
    # a run that did not lint the program leaves its entry alone
    elsewhere = _case_collective_free(False)
    elsewhere.engine = "elsewhere"
    other = pl.lint_programs([elsewhere], baseline_path=path)
    assert other.stale == []
    pl.save_baseline(fixed, path)
    assert pl.load_baseline(path)["entries"] == []
    assert pl.load_baseline(pl.DEFAULT_BASELINE)["entries"] == []


def test_build_corpus_rejects_unknown_engine():
    with pytest.raises(ValueError, match="no-such-engine"):
        pl.build_corpus(only=["no-such-engine"], device="cpu")
    assert set(pl.CORPUS_BUILDERS) == {"base", "offload", "serving"}


# ---------------------------------------------------------------------------
# the port's registries against the JAX engines'
# ---------------------------------------------------------------------------

@pytest.fixture
def jax_args(monkeypatch):
    """{(registry id, name): the args the JAX engine registered with}."""
    import deepspeed_tpu.telemetry as jtelemetry

    seen = {}
    original = jtelemetry.register_program

    def capture(programs, name, jit_fn, args, **kw):
        if programs is not None and not programs.has(name):
            seen[(id(programs), name)] = args
        return original(programs, name, jit_fn, args, **kw)

    monkeypatch.setattr(jtelemetry, "register_program", capture)
    return seen


def _jax_donated(contract, args, leaf_name):
    """The JAX flat ``donates`` indices as the names the port gives those
    leaves (``leaf_name(path, leaf)``; None: a leaf the port keeps on the
    host), tiny leaves under ``donation_min_elements`` left out."""
    import jax

    leaves = jax.tree_util.tree_flatten_with_path(args)[0]
    floor = contract.get("donation_min_elements", 0)
    names = set()
    for i in contract.get("donates", ()):
        path, leaf = leaves[i]
        if np.size(leaf) < floor:
            continue
        name = leaf_name(path, leaf)
        if name is not None:
            names.add(name)
    return names


def _assert_contracts_equal(jreg, reg, jargs, leaf_name, port_name):
    assert set(jreg.names()) == set(reg.names())
    jsum, tsum = jreg.summary(), reg.summary()
    for name in jreg.names():
        jc, tc = dict(jsum[name]["contract"]), dict(tsum[name]["contract"])
        assert jsum[name]["calls_per_step"] == tsum[name]["calls_per_step"]
        want = _jax_donated(jc, jargs[(id(jreg), name)],
                            lambda p, leaf: leaf_name(name, p, leaf))
        floor = tc.get("donation_min_elements", 0)
        got = {port_name(n) for n, (_, _, size) in
               reg.get(name).observation.donated.items()
               if n in tc.get("donates", ()) and size >= floor}
        assert got == want, name
        jc.pop("donates", None), tc.pop("donates", None)
        assert jc == tc, name


def _train_field(program, path, leaf):
    field = path[1].name
    return None if field in HOST_FIELDS else field


@pytest.mark.parametrize("family", ["base", "offload", "base-moe"])
def test_train_registry_matches_the_jax_engine(family, jax_args):
    """``base-moe``: the base family's programs over a GPT-2 with MoE
    blocks (4 experts), which keep the JAX engine's names and
    contracts."""
    import jax
    import jax.numpy as jnp

    import deepspeed_tpu
    from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
    from deepspeed_tpu.models.gpt2 import GPT2Model as JGPT2Model
    from deepspeed_tpu.runtime.engine import _first_micro

    offload = family == "offload"
    sizes = dict(pl.TINY_GPT2, moe_num_experts=4 if family == "base-moe"
                 else 0)
    family = family.replace("-moe", "")
    batch = pl.train_batch()
    cfg = pl.train_config(offload)
    jeng, _, _, _ = deepspeed_tpu.initialize(
        model=JGPT2Model(JGPT2Config(dtype=jnp.float32, loss_chunk_tokens=0,
                                     **sizes)),
        config_params=dict(cfg, mesh={"data": 1, "allow_partial": True}))
    jeng._ensure_state(_first_micro(batch))
    init = jax.tree_util.tree_map(np.asarray, jeng.state.params)
    tcfg = GPT2Config(dtype=torch.float32, loss_chunk_tokens=0, **sizes)
    eng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=GPT2Model(tcfg), config_params=cfg, device="cpu")
    eng.load_module_state_dict(params_from_jax(init, tcfg))
    eng.program_registry.observing = True
    if offload:
        jloss = float(jeng.train_batch(batch=batch))
        loss = float(eng.train_batch(batch=batch))
    else:
        pl.drive_base(jeng, batch)
        pl.drive_base(eng, batch)
        jloss = float(jeng.eval_loss({k: v[0] for k, v in batch.items()}))
        loss = float(eng.eval_loss({k: v[0] for k, v in batch.items()}))
    np.testing.assert_allclose(loss, jloss, rtol=1e-4)
    reg = eng.program_registry
    assert set(reg.names()) == EXPECTED_PROGRAMS[family]
    _assert_contracts_equal(jeng.program_registry, reg, jax_args,
                            _train_field, lambda n: n.split("/")[0])
    assert pl.lint_programs([reg], use_baseline=False).new == []


def test_serving_registries_match_the_jax_engines(jax_args):
    """The JAX corpus's three serving engines and the port's, over the
    JAX init's weights (the port reads the JAX tree), the same requests."""
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
    from deepspeed_tpu.models.gpt2 import GPT2Model as JGPT2Model
    from deepspeed_tpu.serving.engine import InferenceEngine as JEngine

    jm = JGPT2Model(JGPT2Config(dtype=jnp.float32, loss_chunk_tokens=0,
                                **pl.TINY_GPT2))
    ids = np.random.default_rng(0).integers(0, 97, (2, 8))
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), {"input_ids": ids, "labels": ids}))
    model = GPT2Model(GPT2Config(dtype=torch.float32, loss_chunk_tokens=0,
                                 **pl.TINY_GPT2))
    jengines = pl.serving_engines(lambda **kw: JEngine(jm, params, **kw))
    engines = pl.serving_engines(
        lambda **kw: InferenceEngine(model, params, device="cpu", **kw))
    fields = ("k", "v", "k_scale", "v_scale")

    def pool_leaf(program, path, leaf):
        if program == "cow_copy":          # args (pool arrays, src, dst)
            return fields[path[1].idx]
        return fields[path[0].idx - 1]     # args (params, *pool, ...)

    for jeng, eng in zip(jengines, engines):
        reg = eng.program_registry
        assert reg.engine == jeng.program_registry.engine
        assert set(reg.names()) == EXPECTED_PROGRAMS[reg.engine]
        _assert_contracts_equal(jeng.program_registry, reg, jax_args,
                                pool_leaf, lambda n: n)
        # observing changed nothing the engines computed
        assert {r: res["tokens"].tolist() for r, res in eng.results.items()} \
            == {r: np.asarray(res["tokens"]).tolist()
                for r, res in jeng.results.items()}
    assert pl.lint_programs([e.program_registry for e in engines],
                            use_baseline=False).new == []


def test_cli_corpus_is_clean_and_complete():
    """One subprocess run of the port's lint over its CPU corpus: no new
    finding, no stale baseline entry, every family complete."""
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.telemetry.program_lint",
         "--device", "cpu", "--json"],
        cwd=REPO, capture_output=True, text=True, timeout=CLI_BUDGET_S + 60,
        env=dict(os.environ, PYTHONPATH=REPO))
    elapsed = time.monotonic() - t0
    assert proc.returncode == 0, proc.stdout + "\n" + proc.stderr
    assert elapsed < CLI_BUDGET_S, f"the lint took {elapsed:.0f} s"
    payload = json.loads(proc.stdout)
    assert payload["summary"]["new"] == 0, payload["new"]
    assert payload["summary"]["stale_baseline"] == 0
    assert set(payload["rules"]) == set(pl.PROGRAM_RULES)
    progs = payload["programs"]
    assert {e: set(p) for e, p in progs.items()} == EXPECTED_PROGRAMS
    c = progs["serving"]["decode_step"]["contract"]
    assert c == {"collective_free": True, "donates": ["k", "v"],
                 "host_transfer_free": True}
    c = progs["base"]["fused_train_step"]["contract"]
    assert c["host_transfer_free"] and c["donation_min_elements"] == 4
    assert "params/wte" in c["donates"] and "accum/wte" in c["donates"]
    assert progs["base"]["micro_step"]["calls_per_step"] == 2.0
    assert progs["serving-sparse"]["sparse_prefill_chunk8"]["contract"][
        "uniform_group"] == "serving:sparse_prefill"


# ---------------------------------------------------------------------------
# observing changes nothing
# ---------------------------------------------------------------------------

class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_linted_and_unlinted_engines_compute_the_same(monkeypatch):
    """Three engines from one seed: the registry as always (not linted),
    the registry stubbed out, and linted (observing). Losses equal bit
    for bit; the unlinted engine runs as many aten ops per step as the one
    without a registry."""
    def engine():
        model = GPT2Model(GPT2Config(dtype=torch.float32, **pl.TINY_GPT2))
        return deepspeed_tpu_torch.initialize(
            model=model, config_params=pl.train_config(), device="cpu")[0]

    batch = pl.train_batch()
    plain, bare, linted = engine(), engine(), engine()
    bare._programs.dispatch = lambda *a, **k: NO_OBSERVER
    linted.program_registry.observing = True
    losses, ops = {}, {}
    for name, eng in (("plain", plain), ("bare", bare), ("linted", linted)):
        counts, out = [], []
        for _ in range(2):
            with _CountOps() as c:
                out.append(eng.train_batch(batch=batch))
            counts.append(c.n)
        losses[name], ops[name] = torch.stack(out), counts
    assert torch.equal(losses["plain"], losses["bare"])
    assert torch.equal(losses["plain"], losses["linted"])
    assert ops["plain"] == ops["bare"]
    assert plain.program_registry.names() == ["fused_train_step"]
    assert bare.program_registry.names() == []
    for a, b in zip(plain.params, linted.params):
        assert torch.equal(a, b)


def test_zero2_step_rules_on_a_gloo_world_of_two(tmp_path):
    """ZeRO stage 2 at dp 2: the clean step has no finding, one parameter
    all-gather and one reduce-scatter per micro step in its collective
    order; the gather skipped (under a declared op count), a raw
    ``dist.all_reduce`` posted inside the step around the group (under a
    declared all-reduce count), the optimizer state replaced by copies,
    two programs of one uniform_group in different orders, and a raw
    all-reduce in a collective-free program each give exactly one finding
    of their rule."""
    jobs = [("programs", "programs", dict(dp=2, seed=3, init=None))]
    results = W.run_world(2, jobs, str(tmp_path))
    r0, r1 = (r["programs"] for r in results)
    assert r0["clean"] == r1["clean"] == []
    assert r0["loss"] == r1["loss"]
    assert r0["order"] == r1["order"]
    ops = [op for op, _, _ in r0["order"]]
    assert ops.count("all-gather") == 1 and ops.count("reduce-scatter") == 2
    assert ops[-1] == "all-gather"           # the parameters, after Adam
    c = r0["summary"]["fused_train_step"]["contract"]
    assert c["expect_op_counts"] == [["all-gather", "f32", 1]] \
        or c["expect_op_counts"] == [("all-gather", "f32", 1)]
    for r in (r0, r1):
        assert [rule for rule, _ in r["op_count"]] == ["program-op-count"]
        assert r["stray"] == [("program-op-count",
                               "<base:fused_train_step>")]
        assert [rule for rule, _ in r["donation"]] == ["program-donation"]
        assert r["order_fault"] == [("program-collective-order",
                                     "<zero-a:reduce_then_gather>")]
        assert [rule for rule, _ in r["raw"]] == ["program-collective-free"]
        assert [(c.op, c.dtype, c.elements) for c in r["raw_ops"]] == [
            ("all-reduce", "f32", 4)]


@pytest.mark.cuda
def test_the_lint_on_the_card():
    """The port's corpus on the card: clean and complete, its dispatches
    observed under set_sync_debug_mode("error") as well; a planted
    ``.item()`` in the decode step function is one program-host-transfer
    finding in each program that runs it (the dense and the sparse decode
    step; the verify runs its own)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the corpus runs on the card")
    from deepspeed_tpu_torch.serving import engine as serving_engine

    registries = pl.build_corpus(device="cuda")
    assert {r.engine: set(r.names()) for r in registries} == \
        EXPECTED_PROGRAMS
    assert pl.lint_programs(registries, use_baseline=False).new == []
    original = serving_engine._decode_step

    def decode(*args, **kw):
        out = original(*args, **kw)
        out.sum().item()
        return out

    serving_engine._decode_step = decode
    try:
        regs = pl.build_corpus(only=["serving"], device="cuda")
    finally:
        serving_engine._decode_step = original
    got = pl.lint_programs(regs, use_baseline=False).new
    assert [(f.rule, f.path) for f in got] == [
        ("program-host-transfer", "<serving-sparse:sparse_decode_step>"),
        ("program-host-transfer", "<serving:decode_step>")]


@pytest.fixture(scope="session")
def zero3_world(tmp_path_factory):
    """The worlds of tests/test_torch_zero3.py (gloo worlds of the port and
    the JAX engines beside), shared with it."""
    return Z3.worlds(tmp_path_factory)


@pytest.mark.parametrize("name,family", [("s3g2", "stage3"),
                                         ("qgz2", "base-qgz")])
def test_zero3_families_match_the_jax_engines(zero3_world, name, family):
    """The ``stage3`` and ``base-qgz`` families of the JAX program lint's
    corpus (tests/unit/test_program_lint.py), on the tiny GPT-2 at dp 2:
    the same programs with the same contracts and calls per step, the
    same state donated (the stash at s3_bwd; the port's fp32 master
    beside, C-w10), and no finding."""
    got = Z3.port_result(zero3_world, name)
    want = Z3.jax_result(zero3_world, name)
    assert got["lint"] == []
    assert set(got["contracts"]) == set(want["contracts"]) \
        == WORLD_FAMILIES[family]
    for prog, (c, calls, donated) in got["contracts"].items():
        jc, jcalls, jdonated = want["contracts"][prog]
        assert calls == jcalls, prog
        # C-w10: at fp32 the port keeps its master shards apart from the
        # parameters (the JAX TrainState has no master there)
        assert set(donated) - {"master"} == set(jdonated) - HOST_FIELDS, \
            prog
        c, jc = dict(c), dict(jc)
        c.pop("donates", None)
        jc.pop("donates", None)
        if "comm_budget_bytes" in jc:
            # C-w16: the port's budget adds the loss's all-reduce over the
            # ranks, which the JAX report leaves out
            assert c.pop("comm_budget_bytes") == \
                jc.pop("comm_budget_bytes") + LOSS_REDUCTION_BYTES, prog
        assert c == jc, prog


def test_zero3_family_faults_fire_once_each(zero3_world):
    for rank in Z3.port_world(zero3_world, "faults"):
        got = rank["faults"]
        assert [(r, p) for r, p, _ in got["regather"]] == [
            ("program-forbidden-collective", "<base:s3_bwd>")]
        assert [(r, p) for r, p, _ in got["extra_gather"]] == [
            ("program-op-count", "<base:s3_fwd>")]
        assert [(r, p) for r, p, _ in got["codes_twice"]] == [
            ("program-collective-budget", "<base:micro_step>")]
