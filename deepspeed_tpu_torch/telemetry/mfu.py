"""MFU/HFU accounting from FLOPs counted by a replay on meta tensors.

Port of deepspeed_tpu/telemetry/mfu.py. Two FLOP ledgers, reported side
by side because they answer different questions:

- **model FLOPs** (``model_flops_per_step``): the 6ND forward+backward
  formula (2ND forward-only for serving decode) — what the model
  mathematically requires.  ``MFU = model_flops / (step_time × devices
  × peak)``; remat recompute and padding never inflate it.
- **hardware FLOPs**: summed per-program FLOPs of every registered
  program × its calls per step — what the card actually computes,
  remat recompute and tile padding included, so ``HFU >= MFU`` and the
  gap IS the recompute/padding tax.  Where the JAX package reads
  ``compiled.cost_analysis()``, this port counts: the program runs once
  more on META tensors (shapes and dtypes only, no memory, no launch)
  under ``torch.utils.flop_counter.FlopCounterMode``, which counts the
  aten matmuls (mm, addmm, bmm, ...; an autograd backward's too), and
  every attention call that reaches a dispatch on meta tensors adds the
  FLOPs its hand-written kernels compute at those shapes instead of
  launching them (``flash_attention.flash_*_flops``,
  ``block_sparse_kernel.sparse_*_flops``; FlopCounterMode sees nothing
  of kernels launched through ctypes).  The count is the same whichever
  route the real step took, kernel or plain version.  Element-wise work
  is not counted (XLA's count includes it): the hardware FLOPs here are
  matmul and attention-kernel FLOPs.  The programs are per process, so
  ``hfu`` divides by ``step_time × peak`` alone, while ``mfu`` divides
  the global model FLOPs by ``step_time × n_devices × peak``.

Registration is capture-by-shape: an engine registers a program the
FIRST time it dispatches, capturing the shapes and dtypes of its real
arguments; the replay runs lazily, once, at report time — never on the
step path.

Peak FLOPS resolution: an explicit ``peak_tflops_per_device`` config
wins; otherwise the card table below (dense bf16/fp16 tensor-core
peaks, keyed on the full name ``torch.cuda.get_device_name`` gives, so
that a PCIe card is never read as an SXM one); an unknown name (the
CPU) reports achieved FLOPS with ``mfu``/``hfu`` = None rather than a
ratio against a guessed peak.
"""
import threading

import torch

# dense bf16/fp16 tensor-core peak TFLOPS per card, by full device name
# (NVIDIA's H100 data sheet; the NVL figure is per card of the pair)
PEAK_TFLOPS_TABLE = {
    "NVIDIA H100 80GB HBM3": 989.4,     # SXM5
    "NVIDIA H100 PCIe": 756.5,
    "NVIDIA H100 NVL": 835.5,
}


def peak_flops_per_device(device_kind):
    """(peak FLOPS/s per device, known) for a device name."""
    peak = PEAK_TFLOPS_TABLE.get((device_kind or "").strip())
    if peak is None:
        return None, False
    return peak * 1e12, True


def device_kind(device):
    """The name the peak table is keyed on: ``torch.cuda.get_device_name``
    for a CUDA device, else the device type ("cpu")."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def model_flops_per_step(n_params, tokens_per_step, fwd_only=False):
    """The dense-transformer FLOP formula: 6ND fwd+bwd, 2ND fwd-only."""
    return (2.0 if fwd_only else 6.0) * float(n_params) \
        * float(tokens_per_step)


# ---------------------------------------------------------------------------
# the count: FlopCounterMode's matmuls + the attention kernels' formulas
# ---------------------------------------------------------------------------
_SESSIONS = []


def counting():
    """True inside ``count_flops``: meta tensors reaching an attention
    dispatch then count the kernels' FLOPs instead of being refused."""
    return bool(_SESSIONS)


def add_kernel_flops(name, flops):
    """Called by an attention dispatch that meets meta tensors: one
    launch of kernel ``name`` that would compute ``flops``.  Adds to the
    innermost active count (a no-op outside one)."""
    if _SESSIONS:
        s = _SESSIONS[-1]
        s["kernel_flops"][name] = s["kernel_flops"].get(name, 0) + int(flops)
        s["kernel_launches"][name] = s["kernel_launches"].get(name, 0) + 1


def count_flops(fn):
    """Run ``fn()`` (on meta tensors) counting its FLOPs; returns
    ``{"flops", "matmul_flops", "kernel_flops": {kernel: FLOPs},
    "kernel_launches": {kernel: n}, "bytes_accessed": None}``."""
    from torch.utils.flop_counter import FlopCounterMode

    session = {"kernel_flops": {}, "kernel_launches": {}}
    _SESSIONS.append(session)
    try:
        with FlopCounterMode(display=False) as counter:
            fn()
    finally:
        _SESSIONS.remove(session)
    matmul = int(counter.get_total_flops())
    kernels = sum(session["kernel_flops"].values())
    return {"flops": float(matmul + kernels), "matmul_flops": matmul,
            "kernel_flops": session["kernel_flops"],
            "kernel_launches": session["kernel_launches"],
            "bytes_accessed": None}


def meta_like(tree):
    """The same structure with every tensor an empty meta tensor of its
    shape and dtype (other leaves as they are)."""
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    if isinstance(tree, dict):
        return {k: meta_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(meta_like(v) for v in tree)
    return tree


class _LossStep(torch.nn.Module):
    """The module's loss forward and backward as one call, so that the
    backward (and a remat recompute in it) runs while the replay's meta
    parameters stand in for the module's."""

    def __init__(self, module):
        super().__init__()
        self.module = module

    def forward(self, batch):
        loss, _ = self.module.loss(batch, generator=torch.Generator(),
                                   train=True)
        loss.float().backward()
        return loss


def loss_step_flops(module, batch, shapes=None):
    """FLOPs of one training micro step of ``module``:
    ``module.loss(batch)`` and its backward, replayed on meta parameters
    of the module's own shapes and dtypes (``batch`` may be meta
    already); ``shapes`` {parameter name: shape} overrides a parameter's
    shape (ZeRO-3's shards at rest compute at their whole shape). Dropout
    draws from a CPU generator in the replay."""
    from torch.func import functional_call

    wrapper = _LossStep(module)
    shapes = {f"module.{n}": s for n, s in (shapes or {}).items()}
    state = {n: torch.empty(shapes.get(n, p.shape), dtype=p.dtype,
                            device="meta").requires_grad_(p.requires_grad)
             for n, p in wrapper.named_parameters()}
    state.update({n: meta_like(b) for n, b in wrapper.named_buffers()})
    meta_batch = meta_like(batch)
    return count_flops(lambda: functional_call(wrapper, state,
                                               (meta_batch,)))


def fn_flops(fn, args):
    """FLOPs of ``fn(*args)`` (no gradient) replayed on meta tensors."""
    meta_args = meta_like(tuple(args))

    def run():
        with torch.no_grad():
            fn(*meta_args)

    return count_flops(run)


def register_loss_step(mfu, name, module, batch, calls_per_step=1.0,
                       param_shapes=None):
    """Capture-by-shape registration of a module's micro step: the batch's
    shapes and dtypes are taken NOW (first dispatch) and the replay runs
    lazily at report time (``param_shapes``: ``loss_step_flops``'s
    ``shapes``).  No-op when ``mfu`` is None or ``name`` is registered
    already."""
    if mfu is None or mfu.has(name):
        return
    shapes = meta_like(batch)
    mfu.register(name, lambda: loss_step_flops(module, shapes, param_shapes),
                 calls_per_step)


def register_fn(mfu, name, fn, args, calls_per_step=1.0):
    """Capture-by-shape registration of a function of tensors (a serving
    program): shapes now, the replay at report time."""
    if mfu is None or mfu.has(name):
        return
    shapes = meta_like(tuple(args))
    mfu.register(name, lambda: fn_flops(fn, shapes), calls_per_step)


class MfuAccounting:
    """Per-program FLOPs registry + MFU/HFU report builder."""

    def __init__(self, peak_tflops_per_device=0.0):
        # explicit peak (TFLOPS) overrides the card table; 0 = auto
        self.peak_tflops_per_device = float(peak_tflops_per_device or 0.0)
        self._progs = {}       # name -> (make_cost, calls_per_step)
        self._costs = {}       # name -> cost dict (lazy)
        self._lock = threading.Lock()

    def has(self, name):
        return name in self._progs

    def register(self, name, make_cost, calls_per_step=1.0):
        """Register one program.  ``make_cost`` is a zero-arg callable
        returning its cost dict (``count_flops``'s); it runs lazily,
        once, at report time."""
        with self._lock:
            if name not in self._progs:
                self._progs[name] = (make_cost, float(calls_per_step))

    def costs(self):
        """{name: {flops, bytes_accessed, calls_per_step, ...}} — counted
        lazily on first call, cached after.  A program whose replay fails
        reports its error string instead of poisoning the rest."""
        with self._lock:
            progs = dict(self._progs)
        for name, (make, calls) in progs.items():
            if name in self._costs:
                continue
            try:
                cost = dict(make())
            except Exception as e:  # one program's replay quirk must
                # not kill the report
                cost = {"flops": None, "bytes_accessed": None,
                        "error": f"{type(e).__name__}: {e}"}
            cost["calls_per_step"] = calls
            self._costs[name] = cost
        return dict(self._costs)

    def hw_flops_per_step(self):
        total, complete = 0.0, True
        for cost in self.costs().values():
            if cost["flops"] is None:
                complete = False
                continue
            total += cost["flops"] * cost["calls_per_step"]
        return (total if total > 0 else None), complete

    def report(self, *, step_time_s, n_devices, model_flops=None,
               device_kind=None):
        """The ``telemetry_report()["mfu"]`` section.  ``model_flops``
        is per step, all devices; ``step_time_s`` mean seconds per
        optimizer/serving step."""
        hw_flops, complete = self.hw_flops_per_step()
        if self.peak_tflops_per_device > 0:
            peak, peak_known = self.peak_tflops_per_device * 1e12, True
        else:
            peak, peak_known = peak_flops_per_device(device_kind)
        denom = None
        if step_time_s and step_time_s > 0 and n_devices:
            denom = step_time_s * n_devices
        return {
            "per_jit": self.costs(),
            "hw_flops_per_step": hw_flops,
            "hw_flops_complete": complete,
            "model_flops_per_step": model_flops,
            "step_time_s": step_time_s,
            "n_devices": n_devices,
            "device_kind": device_kind,
            "peak_flops_per_device": peak,
            "peak_known": peak_known,
            "achieved_tflops_per_device":
                (model_flops / denom / 1e12)
                if (denom and model_flops) else None,
            # hardware FLOPs are per process: no n_devices here
            "achieved_hw_tflops_per_device":
                (hw_flops / step_time_s / 1e12)
                if (step_time_s and hw_flops) else None,
            "mfu": (model_flops / (denom * peak))
            if (denom and model_flops and peak) else None,
            "hfu": (hw_flops / (step_time_s * peak))
            if (step_time_s and hw_flops and peak) else None,
        }
