"""Dispatched-program registry: every program an engine runs, with contracts.

Port of deepspeed_tpu/telemetry/programs.py. The JAX package registers
each jitted function at its first dispatch and reads the contract off its
compiled HLO. The port has no HLO: a program here is the piece of device
work the JAX program covers, under the same name (the training engine's
``fused_train_step`` is the whole of ``train_batch``, the serving
engine's ``decode_step`` one decode dispatch), and the lint
(telemetry/program_lint.py) checks its contract on one real dispatch,
observed (telemetry/program_checks.py). Each entry carries
**declarative contract metadata**, the same keys as the JAX package's:

- ``host_transfer_free``: the dispatch reads nothing back to the host (no
  ``.item()``, no blocking or pageable device-to-host copy, no op whose
  output shape depends on the data);
- ``collective_free``: the program posts no collective;
- ``wire_dtype``: the collective payload dtype(s) the program declares;
  any f32/bf16 collective at or above ``wire_min_elements`` means the
  wire was re-widened;
- ``donates`` / ``donates_argnums``: state the program must update in
  place; a declared-donated tensor whose storage moved (a fresh copy
  returned) pays a copy per call and re-arms the allocator at every
  dispatch; ``donation_min_elements`` exempts tiny leaves (a step
  counter rebuilt each step costs nothing);
- ``comm_budget_bytes`` (+ ``comm_budget_key``, ``comm_small_op_cutoff``):
  byte ceiling for the program's total collective payload;
- ``boundary_dtypes``: the dtypes the program's outputs may have;
- ``forbid_collectives`` / ``expect_op_counts``: collective kinds that
  must not appear / exact (op, dtype, count) expectations;
- ``outputs_aliased``: at least this many outputs live in donated
  memory;
- ``uniform_group``: programs sharing a group name run at the same
  schedule slot on different callers and must post an IDENTICAL
  collective sequence.

Contract values may be zero-arg callables: they resolve lazily when the
lint reads them.

Registration costs one dict insert at a program's first dispatch.
Observation happens only while the lint has armed the registry
(``observing``), once per program, off the hot path: an engine that is
not being linted runs exactly the operations it would run without the
registry, and a linted dispatch computes what an unlinted one does.
"""
import threading

import torch

# every key a contract dict may carry — program_lint validates against
# this so a typo'd declaration fails loudly instead of never checking
CONTRACT_KEYS = frozenset({
    "host_transfer_free", "collective_free",
    "wire_dtype", "wire_min_elements",
    "donates", "donates_argnums", "donation_min_elements",
    "comm_budget_bytes", "comm_budget_key", "comm_small_op_cutoff",
    "boundary_dtypes", "forbid_collectives", "expect_op_counts",
    "outputs_aliased", "uniform_group",
})


class ProgramEntry:
    """One registered program: its contract, and the observation of one
    dispatch once the lint has made it. It keeps no argument of a
    dispatch: a live view of an engine's state held here would tie the
    engine into a reference cycle through its own registry, and its
    device memory would outlive ``del engine`` until the cyclic
    collector ran."""

    __slots__ = ("name", "contract", "calls_per_step", "observation")

    def __init__(self, name, contract, calls_per_step):
        self.name = name
        self.contract = dict(contract or {})
        self.calls_per_step = float(calls_per_step)
        self.observation = None


class _NoObserver:
    """The observer of a dispatch nobody observes: every method is a
    no-op."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def start(self):
        pass

    def stop(self):
        pass

    def outputs(self, *tensors):
        pass

    def close(self):
        pass


NO_OBSERVER = _NoObserver()


class ProgramRegistry:
    """Per-engine registry of every program the engine dispatches."""

    def __init__(self, engine="engine"):
        self.engine = str(engine)
        self._entries = {}
        self._lock = threading.Lock()
        # armed by the lint: the next dispatch of each program not yet
        # observed runs under program_checks.Observer
        self.observing = False

    def has(self, name):
        return name in self._entries

    def names(self):
        return sorted(self._entries)

    def get(self, name):
        return self._entries.get(name)

    def entries(self):
        """Entries in sorted-name order (stable lint reports)."""
        return [self._entries[n] for n in sorted(self._entries)]

    def register(self, name, contract=None, calls_per_step=1.0):
        bad = set(contract or ()) - CONTRACT_KEYS
        if bad:
            raise ValueError(
                f"unknown contract key(s) {sorted(bad)} for program "
                f"{name!r}; known: {sorted(CONTRACT_KEYS)}")
        with self._lock:
            if name not in self._entries:
                self._entries[name] = ProgramEntry(
                    name, contract, calls_per_step)

    def declare(self, name, **contract):
        """Merge contract keys into an already-registered entry (for
        claims only known after registration)."""
        bad = set(contract) - CONTRACT_KEYS
        if bad:
            raise ValueError(f"unknown contract key(s) {sorted(bad)}")
        entry = self._entries[name]
        entry.contract.update(contract)

    def summary(self):
        """JSON-able view: {name: {contract (callables resolved),
        calls_per_step}} — what the lint's ``--json`` ships."""
        out = {}
        for entry in self.entries():
            out[entry.name] = {
                "contract": {k: resolve_contract_value(v)
                             for k, v in sorted(entry.contract.items())},
                "calls_per_step": entry.calls_per_step,
            }
        return out

    def dispatch(self, name, args=(), contract=None, calls_per_step=1.0):
        """The dispatch point of program ``name``: registers it at its
        first dispatch (:func:`register_program`) and returns the
        dispatch's observer — a live ``program_checks.Observer`` while the
        lint observes this registry and the program has no observation
        yet, else ``NO_OBSERVER``. Use it as a context manager around the
        dispatch, or ``start()``/``stop()`` around each part of a program
        that spans two calls and ``close()`` after the last."""
        register_program(self, name, args, contract, calls_per_step)
        if not self.observing:
            return NO_OBSERVER
        entry = self._entries[name]
        if entry.observation is not None:
            return NO_OBSERVER
        from deepspeed_tpu_torch.telemetry.program_checks import Observer

        return Observer(entry, args)


def resolve_contract_value(value):
    """Contract values may be zero-arg callables (lazy analytic budgets);
    resolve to something JSON-able."""
    if callable(value):
        try:
            value = value()
        except Exception as e:  # a budget that cannot resolve is itself
            # a reportable fact
            return f"<unresolvable: {type(e).__name__}: {e}>"
    if isinstance(value, (tuple, set, frozenset, range)):
        return list(value)
    return value


def named_tensors(arg, argnum=0):
    """{name: tensor} of one program argument: a zero-arg callable (a live
    view of state the program updates) is called; a NamedTuple names its
    fields, a mapping its keys; a bare tensor is ``arg<argnum>``. Other
    values (and None fields) name no tensor."""
    if callable(arg) and not isinstance(arg, torch.Tensor):
        arg = arg()
    if isinstance(arg, torch.Tensor):
        return {f"arg{argnum}": arg}
    if hasattr(arg, "_fields"):
        return {f: t for f, t in zip(arg._fields, arg)
                if isinstance(t, torch.Tensor)}
    if isinstance(arg, dict):
        return {k: t for k, t in arg.items() if isinstance(t, torch.Tensor)}
    return {}


def register_program(programs, name, args=(), contract=None,
                     calls_per_step=1.0):
    """Register program ``name`` with its contract at its first dispatch.
    ``args`` are the dispatch's arguments as the JAX program takes them;
    those whose tensors a contract may donate are live views (zero-arg
    callables, mappings or NamedTuples of the state the program updates in
    place: :func:`named_tensors`). A ``donates_argnums`` contract key is
    expanded here, while the arguments are in hand, into the ``donates``
    names of their tensors (the JAX package expands it into flat HLO
    parameter indices). No-op when ``programs`` is None or ``name`` is
    already registered."""
    if programs is None or programs.has(name):
        return
    contract = dict(contract or {})
    if "donates_argnums" in contract:
        donated = []
        for argnum in contract.pop("donates_argnums"):
            donated.extend(named_tensors(args[argnum], argnum))
        existing = list(contract.get("donates", ()))
        contract["donates"] = sorted(set(existing) | set(donated))
    programs.register(name, contract, calls_per_step)
