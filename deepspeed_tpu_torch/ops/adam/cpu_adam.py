"""DeepSpeedCPUAdam: the host Adam of ZeRO-Offload.

Port of deepspeed_tpu/ops/adam/cpu_adam.py over the port's own copy of its
C++ kernel (ops/adam/csrc/cpu_adam.cpp: AVX-512/AVX2 SIMD, OpenMP), built
with g++ at first use by ops/op_builder.py and called through ctypes. The
fp32 master weights and the moments are host tensors (or numpy arrays);
``step`` updates them in place, with the gradients divided by
``grad_scale`` on the fly (the fused unscale and clip), and ``cast_to``
rounds the master to the compute dtype for the host-to-device push. There
is no Python fallback: a kernel that cannot be built or loaded raises.

``cpu_adam_reference`` is the plain PyTorch version of the same update,
for the tests.
"""
import ctypes

import numpy as np
import torch

from deepspeed_tpu_torch.ops import op_builder

_CAST = {torch.bfloat16: "ds_fp32_to_bf16", torch.float16: "ds_fp32_to_fp16"}
_ADD = {torch.bfloat16: "ds_accum_add_bf16", torch.float16: "ds_accum_add_fp16",
        torch.float32: "ds_accum_add_f32"}


def host_lib():
    """The loaded host library (built at first use; raises on failure)."""
    return op_builder.load_host("cpu_adam")


_NUMPY = {np.dtype(np.float32): torch.float32}


def _numel(a):
    return a.size if isinstance(a, np.ndarray) else a.numel()


def _ptr(a, dtypes, n):
    """The address of ``a``, a contiguous host tensor or numpy array of one
    of ``dtypes`` (torch dtypes; a numpy array must be float32) and ``n``
    elements; anything else raises before a pointer reaches the kernel."""
    if isinstance(a, np.ndarray):
        dtype, ok = _NUMPY.get(a.dtype), a.flags["C_CONTIGUOUS"]
        addr = a.ctypes.data
    else:
        if a.device.type != "cpu":
            raise ValueError(f"host Adam: a {a.device} tensor; the offload "
                             f"state lives in host memory")
        dtype, ok, addr = a.dtype, a.is_contiguous(), a.data_ptr()
    if dtype not in dtypes or not ok or _numel(a) != n:
        raise ValueError(f"host Adam: expected a contiguous {dtypes} host "
                         f"buffer of {n} elements, got {dtype} "
                         f"(contiguous {ok}) of {_numel(a)}")
    return ctypes.c_void_p(addr)


def _contiguous(a):
    if isinstance(a, np.ndarray):
        return a.flags["C_CONTIGUOUS"]
    return a.is_contiguous()


def _as_contiguous_f32(a):
    if isinstance(a, np.ndarray):
        return np.ascontiguousarray(a, dtype=np.float32)
    return a.to(torch.float32).contiguous()


def _copy_back(dst, src):
    if isinstance(dst, np.ndarray):
        dst[...] = src
    else:
        dst.copy_(src)


class DeepSpeedCPUAdam:
    name = "cpu_adam"
    needs_host_state = True   # the engine keeps master and moments on host

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, bias_correction=True, adamw_mode=True,
                 amsgrad=False, full_precision_optimizer_states=True):
        if amsgrad:
            raise ValueError("CPU Adam does not support AMSGrad")
        self.lr = lr
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.bias_correction = bias_correction
        self.adamw_mode = adamw_mode
        self._lib = host_lib()

    def init_state(self, master_params):
        """Host state: fp32 zero moments shaped like each master tensor, and
        the step counter."""
        return {"step": 0,
                "m": [torch.zeros(tuple(p.shape), dtype=torch.float32)
                      for p in master_params],
                "v": [torch.zeros(tuple(p.shape), dtype=torch.float32)
                      for p in master_params]}

    def step(self, master_params, grads, state, lr=None, grad_scale=1.0):
        """One Adam step over each (master, gradient, m, v), in place, the
        gradients divided by ``grad_scale``; advances ``state["step"]`` and
        returns ``state``. A non-contiguous master or moment is stepped in
        a contiguous copy that is written back."""
        lr = self.lr if lr is None else lr
        state["step"] += 1
        step = state["step"]
        for p_orig, g, m_orig, v_orig in zip(master_params, grads,
                                             state["m"], state["v"]):
            origs = (p_orig, m_orig, v_orig)
            bufs = [o if _contiguous(o) else _as_contiguous_f32(o)
                    for o in origs]
            p, m, v = bufs
            g32 = _as_contiguous_f32(g)
            n = _numel(p)
            f32 = (torch.float32,)
            self._lib.ds_adam_step(
                _ptr(p, f32, n), _ptr(g32, f32, n), _ptr(m, f32, n),
                _ptr(v, f32, n), n, lr, self.beta1,
                self.beta2, self.eps, self.weight_decay,
                int(self.adamw_mode), int(self.bias_correction), step,
                grad_scale)
            for orig, buf in zip(origs, bufs):
                if buf is not orig:
                    _copy_back(orig, buf)
        return state

    def cast_into(self, src, dst):
        """Round the contiguous fp32 host tensor ``src`` into ``dst`` (bf16,
        fp16 or fp32, as many elements), to nearest even."""
        n = src.numel()
        if dst.dtype == torch.float32:
            dst.copy_(src)
            return dst
        getattr(self._lib, _CAST[dst.dtype])(
            _ptr(src, (torch.float32,), n), _ptr(dst, (dst.dtype,), n), n)
        return dst

    def cast_to(self, leaves, dtype):
        """fp32 leaves -> new host tensors in ``dtype`` (a torch dtype or its
        name), rounded to nearest even."""
        if isinstance(dtype, str):
            dtype = getattr(torch, dtype)
        out = []
        for p in leaves:
            p = torch.as_tensor(p, dtype=torch.float32).contiguous()
            out.append(self.cast_into(p, torch.empty(p.shape, dtype=dtype)))
        return out


def accumulate(lib, acc, src):
    """``acc += src`` on the host: ``acc`` a contiguous fp32 tensor, ``src``
    a contiguous bf16, fp16 or fp32 tensor of as many elements."""
    n = acc.numel()
    getattr(lib, _ADD[src.dtype])(_ptr(acc, (torch.float32,), n),
                                  _ptr(src, tuple(_ADD), n), n)


def sum_of_squares(lib, x):
    """The float64 sum of squares of the contiguous fp32 host tensor ``x``
    (inf or nan when an element is not finite)."""
    return float(lib.ds_sumsq_f64(_ptr(x, (torch.float32,), x.numel()),
                                  x.numel()))


def cpu_adam_reference(p, g, m, v, step, lr, beta1=0.9, beta2=0.999,
                       eps=1e-8, weight_decay=0.0, adamw=True,
                       bias_correction=True, grad_scale=1.0):
    """The plain PyTorch version of one ``ds_adam_step`` in fp32, in place
    on ``p``, ``m`` and ``v`` (``step`` 1-based). It rounds where the
    kernel's scalar path rounds; the kernel fuses some products into one
    rounding, so the two agree to a few fp32 ulps, not bit for bit."""
    f32 = torch.float32
    g = g.to(f32) * (1.0 / torch.tensor(grad_scale, dtype=f32))
    if not adamw and weight_decay > 0:
        g = g + weight_decay * p
    m.mul_(beta1).add_((1 - torch.tensor(beta1, dtype=f32)) * g)
    v.mul_(beta2).add_((1 - torch.tensor(beta2, dtype=f32)) * g * g)
    if bias_correction:
        bc1 = 1 - torch.tensor(beta1, dtype=f32) ** step
        bc2 = 1 - torch.tensor(beta2, dtype=f32) ** step
    else:
        bc1 = bc2 = torch.tensor(1.0, dtype=f32)
    update = (m / bc1) / ((v / bc2).sqrt() + eps)
    if adamw and weight_decay > 0:
        update = update + weight_decay * p
    p.sub_(lr * update)
    return p, m, v
