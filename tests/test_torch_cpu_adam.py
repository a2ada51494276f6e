"""The host Adam of the port's ZeRO-Offload (ops/adam/cpu_adam.py over
ops/adam/csrc/cpu_adam.cpp, built with g++ at first use).

- On the same numpy inputs it equals the JAX package's DeepSpeedCPUAdam bit
  for bit: the two C++ files share ``ds_adam_step`` line for line and are
  built with the same flags. Sizes 1, 15, 16, 17 and 4099 cover the SIMD
  tails (AVX-512 is 16 wide, AVX2 8); Adam and AdamW, weight decay, bias
  correction on and off, and a gradient scale other than 1 (the fused
  unscale).
- Against ``cpu_adam_reference`` (plain PyTorch, fp32) within rtol 1e-5,
  atol 1e-7 over 5 steps: the kernel fuses a multiply-add into one
  rounding where the plain version rounds twice, a few fp32 ulps.
- The bf16 and fp16 casts of the push equal ``torch.Tensor.to`` bit for bit
  on a grid of ties, both infinities, fp16 overflow and subnormals (and
  NaN stays NaN), and on 10**6 random bit patterns.
- The host adds and the float64 sum of squares are exact / float64.
- A build that cannot find its compiler raises; nothing falls back.
"""
import os

import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.adam.cpu_adam import DeepSpeedCPUAdam as JaxCPUAdam
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.adam import cpu_adam
from deepspeed_tpu_torch.ops.adam.cpu_adam import (DeepSpeedCPUAdam,
                                                   cpu_adam_reference)

SIZES = [1, 15, 16, 17, 4099]
MODES = [  # (adamw, weight_decay, bias_correction)
    (True, 0.01, True), (False, 0.01, True), (True, 0.0, True),
    (True, 0.01, False), (False, 0.0, False)]


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n).astype(np.float32),
            [rng.standard_normal(n).astype(np.float32) for _ in range(5)])


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("adamw,wd,bc", MODES)
def test_equals_the_jax_package_bit_for_bit(n, adamw, wd, bc):
    p0, grads = _inputs(n, n)
    kw = dict(lr=0.01, weight_decay=wd, bias_correction=bc, adamw_mode=adamw)
    port, ref = DeepSpeedCPUAdam(**kw), JaxCPUAdam(**kw)
    assert ref.using_native, "the JAX package's kernel did not build"
    ours, theirs = [p0.copy()], [p0.copy()]
    s_ours = {"step": 0, "m": [np.zeros(n, np.float32)],
              "v": [np.zeros(n, np.float32)]}
    s_theirs = ref.init_state({"w": theirs[0]})
    for k, g in enumerate(grads):
        scale = 1.0 if k % 2 else 128.0
        port.step(ours, [g * scale], s_ours, grad_scale=scale)
        ref.step(theirs, [g * scale], s_theirs, grad_scale=scale)
    assert s_ours["step"] == s_theirs["step"] == 5
    for a, b in ((ours[0], theirs[0]), (s_ours["m"][0], s_theirs["m"][0]),
                 (s_ours["v"][0], s_theirs["v"][0])):
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("adamw,wd,bc", MODES)
def test_matches_the_plain_version(n, adamw, wd, bc):
    p0, grads = _inputs(n, 100 + n)
    opt = DeepSpeedCPUAdam(lr=0.01, weight_decay=wd, bias_correction=bc,
                           adamw_mode=adamw)
    p = torch.from_numpy(p0.copy())
    state = opt.init_state([p])
    ref = [torch.from_numpy(p0.copy()), torch.zeros(n), torch.zeros(n)]
    for step, g in enumerate(grads, 1):
        g = torch.from_numpy(g) * 4.0
        opt.step([p], [g], state, grad_scale=4.0)
        cpu_adam_reference(*ref[:1], g, *ref[1:], step, 0.01,
                           weight_decay=wd, adamw=adamw,
                           bias_correction=bc, grad_scale=4.0)
    for a, b in zip((p, state["m"][0], state["v"][0]), ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_non_contiguous_views_are_updated_in_place():
    """A strided master (a column slice) is stepped through a contiguous
    copy and written back, as the JAX package's step does."""
    rng = np.random.default_rng(3)
    full = torch.from_numpy(rng.standard_normal((8, 6)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((8, 3)).astype(np.float32))
    opt = DeepSpeedCPUAdam(lr=0.1)
    view = full[:, 3:]
    want = view.clone()
    state, ref_state = opt.init_state([view]), opt.init_state([want])
    opt.step([view], [g], state)
    opt.step([want], [g], ref_state)
    assert torch.equal(full[:, 3:], want)
    assert not torch.equal(full[:, 3:], ref_state["m"][0])


def _cast_grid():
    """Ties and their neighbours at both widths, the fp16 overflow edge,
    fp16 and bf16 subnormals, zeros and infinities, both signs."""
    vals = [0.0, 1.0, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, 1.0 + 2 ** -11,
            1.0 + 3 * 2 ** -11, 1.0 + 2 ** -11 + 2 ** -20, 3.14159, 65504.0,
            65519.996, 65520.0, 1e6, 3.4e38, 2.0 ** -14, 2.0 ** -15,
            2.0 ** -24, 2.0 ** -25, 3 * 2.0 ** -26, 2.0 ** -25 + 2.0 ** -40,
            5e-8, 6e-8, 1e-5, 1e-40, 1.1754942e-38, float("inf")]
    grid = torch.tensor(vals, dtype=torch.float32)
    return torch.cat([grid, -grid])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_casts_equal_torch_to(dtype):
    opt = DeepSpeedCPUAdam()
    grid = _cast_grid()
    got = opt.cast_to([grid], dtype)[0]
    assert torch.equal(got.view(torch.int16), grid.to(dtype).view(torch.int16))
    bits = np.random.default_rng(5).integers(0, 2 ** 32, 10 ** 6,
                                             dtype=np.uint64)
    x = torch.from_numpy(bits.astype(np.uint32).view(np.float32))
    x = x[~torch.isnan(x)]
    got = opt.cast_to([x], dtype)[0]
    assert torch.equal(got.view(torch.int16), x.to(dtype).view(torch.int16))
    nan = opt.cast_to([torch.tensor([float("nan"), -float("nan")])],
                      dtype)[0]
    assert torch.isnan(nan.float()).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_host_add_is_the_exact_widening_add(dtype):
    lib = cpu_adam.host_lib()
    gen = torch.Generator().manual_seed(7)
    acc = torch.randn(4099, generator=gen)
    src = (torch.randn(4099, generator=gen) * 1e-3).to(dtype)
    src[:4] = torch.tensor([2.0 ** -24, -(2.0 ** -20), 0.0, 65504.0]) \
        .to(dtype)
    want = acc + src.float()
    cpu_adam.accumulate(lib, acc, src)
    assert torch.equal(acc, want)


def test_sum_of_squares_is_float64_and_flags_non_finite():
    lib = cpu_adam.host_lib()
    x = torch.randn(100003, generator=torch.Generator().manual_seed(1))
    want = float((x.double() ** 2).sum())
    assert cpu_adam.sum_of_squares(lib, x) == pytest.approx(want, rel=1e-12)
    big = torch.full((1000,), 3.0e38)
    assert np.isfinite(cpu_adam.sum_of_squares(lib, big))
    for bad in (float("inf"), float("nan")):
        y = x.clone()
        y[77] = bad
        assert not np.isfinite(cpu_adam.sum_of_squares(lib, y))


def test_a_wrong_buffer_raises_before_the_kernel_reads_it():
    opt = DeepSpeedCPUAdam()
    p = torch.zeros(8)
    state = opt.init_state([p])
    for bad in (torch.zeros(8, dtype=torch.float64), torch.zeros(7),
                np.zeros(8, np.float64)):
        with pytest.raises(ValueError, match="host Adam"):
            opt.step([bad], [torch.zeros(8)], dict(state, step=0))
    with pytest.raises(ValueError, match="host Adam"):
        opt.step([p], [torch.zeros(9)], state)
    lib = cpu_adam.host_lib()
    with pytest.raises(ValueError, match="host Adam"):
        cpu_adam.accumulate(lib, torch.zeros(8), torch.zeros(4))
    with pytest.raises(ValueError, match="host Adam"):
        opt.cast_into(torch.zeros(8), torch.zeros(16, dtype=torch.bfloat16))


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """No compiler: the host Adam raises instead of falling back."""
    monkeypatch.setattr(op_builder, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(op_builder, "_libs", {})
    monkeypatch.setenv("CXX", "no-such-compiler-here")
    with pytest.raises(RuntimeError, match="not found"):
        DeepSpeedCPUAdam()
    # a compiler that fails: the error carries its output
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="false failed"):
        DeepSpeedCPUAdam()


def test_the_library_is_named_by_source_flags_and_cpu():
    """The library's name hashes the source, the flags and the CPU; the
    source ships with the package."""
    setup = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "setup.py")
    assert "ops/adam/csrc/*.cpp" in open(setup).read()
    assert os.path.exists(op_builder.HOST_SOURCES["cpu_adam"])
    path = op_builder.host_so_path("cpu_adam")
    assert path.startswith(op_builder.BUILD_DIR)
    assert "-march=native" in op_builder.host_flags() or \
        not ({"avx2", "avx512f"} & set(op_builder._cpu_identity()[1].split()))
    assert cpu_adam.host_lib().ds_simd_width() in (1, 8, 16)


def test_a_loaded_library_is_not_hashed_or_built_again(monkeypatch):
    """After the first load, ``load_host`` (and ``load``, which the kernels'
    wrappers call at every launch) is a lookup: no source hashing, no
    compiler query, no build."""
    lib = cpu_adam.host_lib()

    def refuse(*args, **kwargs):
        raise AssertionError("the library was looked up by building it")

    for name in ("build_host", "host_so_path", "host_flags", "build",
                 "so_path"):
        monkeypatch.setattr(op_builder, name, refuse)
    assert op_builder.load_host("cpu_adam") is lib
