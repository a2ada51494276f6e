"""Build the port's CUDA sources with nvcc, and its host C++ sources with
g++, and load them with ctypes.

Each source in ``SOURCES`` compiles into its own shared library with a plain
C interface (no PyTorch headers in the build, so a build takes seconds), for
``sm_90a`` (Hopper), at first use, into ``build/deepspeed_tpu_torch/``
beside the package. A library's file name carries a hash of its source
directory, of every header the source includes (from there or from another
directory, such as the shared ``ops/transformer/csrc/hopper.cuh``) and of
the flags, so an edited source or header is rebuilt and concurrent builds
never write the same file. Sources build independently: ``build(name)`` for each name
may run at the same time.

The host sources (``HOST_SOURCES``: the ZeRO-Offload host Adam) build the
same way with g++ and the JAX package's flags (``-O3 -fopenmp``, plus
``-march=native`` where the CPU has AVX2 or AVX-512), into the same
directory, under a name that also hashes the CPU's model and flags: a
checkout copied to another host rebuilds rather than loading code for the
wrong instruction set. A failed build or load raises; nothing falls back
to a Python version.
"""
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time

from deepspeed_tpu_torch.utils.logging import logger

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "deepspeed_tpu_torch")
SOURCES = {
    "flash_attention": os.path.join(_PKG_DIR, "ops", "transformer", "csrc",
                                    "flash_attention.cu"),
    "block_sparse_attention": os.path.join(_PKG_DIR, "ops",
                                           "sparse_attention", "csrc",
                                           "block_sparse_attention.cu"),
}
HOST_SOURCES = {
    "cpu_adam": os.path.join(_PKG_DIR, "ops", "adam", "csrc", "cpu_adam.cpp"),
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
_libs = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint
# C signatures of each library: {function: argtypes}; every one returns int
_FLASH_TAIL = [_I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _U, _F, _P, _P]
_BSA_TAIL = [_I, _I, _I, _I, _I, _I, _I, _F, _I, _P]
SIGNATURES = {
    "flash_attention": {
        # (dtype, head_dim, bh, heads, head_offset, total_heads, s_q, s_k,
        #  scale, causal, bias_kind, use_dropout, threshold, inv_keep, seed
        #  (a device int32), stream)
        "ds_flash_fwd": [_P] * 6 + _FLASH_TAIL,
        "ds_flash_bwd_dkdv": [_P] * 9 + _FLASH_TAIL,
        "ds_flash_bwd_dq": [_P] * 8 + _FLASH_TAIL,
        "ds_flash_bwd_dq_scalar": [_P] * 8 + _FLASH_TAIL,
    },
    "block_sparse_attention": {
        # (dtype, head_dim, bh, heads, seq, block, max_nnz, scale, scalar,
        #  stream)
        "ds_bsa_fwd": [_P] * 8 + _BSA_TAIL,
        "ds_bsa_bwd_dq": [_P] * 10 + _BSA_TAIL,
        "ds_bsa_bwd_dkdv": [_P] * 12 + _BSA_TAIL,
    },
}
_C = ctypes.c_int64
_D = ctypes.c_double
HOST_SIGNATURES = {
    "cpu_adam": {
        # (params, grads, exp_avg, exp_avg_sq, n, lr, beta1, beta2, eps,
        #  weight_decay, adamw, bias_correction, step, grad_scale)
        "ds_adam_step": ([_P] * 4 + [_C] + [_F] * 5 + [_I, _I, _C, _F],
                         None),
        "ds_fp32_to_bf16": ([_P, _P, _C], None),
        "ds_fp32_to_fp16": ([_P, _P, _C], None),
        "ds_accum_add_bf16": ([_P, _P, _C], None),
        "ds_accum_add_fp16": ([_P, _P, _C], None),
        "ds_accum_add_f32": ([_P, _P, _C], None),
        "ds_sumsq_f64": ([_P, _C], _D),
        "ds_set_num_threads": ([_I], None),
        "ds_get_num_threads": ([], _I),
        "ds_simd_width": ([], _I),
    },
}


def find_nvcc():
    """nvcc from PATH, CUDA_HOME or the default toolkit location."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels are built from source at first use")


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _included(path, seen):
    """``path`` and every file it includes with ``#include "..."``, followed
    from header to header, each resolved against its includer's directory
    (as nvcc resolves them); added to ``seen``."""
    path = os.path.normpath(path)
    if path in seen or not os.path.isfile(path):
        return
    seen.add(path)
    with open(path, encoding="utf-8", errors="replace") as f:
        text = f.read()
    for rel in _INCLUDE.findall(text):
        _included(os.path.join(os.path.dirname(path), rel), seen)


def _library_path(name, source, flags, extra=()):
    """The library path of ``source``: a hash of every file in its
    directory and of every header it includes from elsewhere, names
    (relative to the source's directory) and contents, of the flags and
    of the strings ``extra``."""
    src_dir = os.path.dirname(source)
    files = set()
    _included(source, files)
    files |= {os.path.join(src_dir, f) for f in os.listdir(src_dir)}
    digest = hashlib.sha256()
    for path in sorted(os.path.relpath(f, src_dir) for f in files
                       if os.path.isfile(f)):
        digest.update(path.encode() + b"\0")
        with open(os.path.join(src_dir, path), "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(flags).encode())
    for item in extra:
        digest.update(b"\0" + item.encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:12]}.so")


def _compile(cmd, so):
    """Run the compiler command ``cmd`` (ending in ``-o``) into a temporary
    file moved to ``so``; returns its stderr, raises with it on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    cmd = cmd + [f"{so}.tmp.{os.getpid()}"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{os.path.basename(cmd[0])} failed "
                           f"({' '.join(cmd)}):\n{proc.stderr[-4000:]}")
    os.replace(cmd[-1], so)
    logger.info(f"built {so} in {time.perf_counter() - t0:.1f}s")
    return proc.stderr


def _load(name, build_fn, signatures):
    """The library of ``name``, built by ``build_fn()`` (which returns its
    path) and loaded on first use only, each function given its
    (argtypes, restype). Later calls are a dict lookup: the kernels'
    wrappers call this at every launch."""
    if name not in _libs:
        lib = ctypes.CDLL(build_fn())
        for fn_name, (argtypes, restype) in signatures.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = restype
        _libs[name] = lib
    return _libs[name]


def so_path(name):
    """The library path of source ``name`` (``_library_path``)."""
    return _library_path(name, SOURCES[name], NVCC_FLAGS)


def build(name, verbose=False):
    """Compile source ``name`` if its library is missing. Returns (path,
    ptxas report); ``verbose`` adds ``-Xptxas -v``, whose report lists the
    registers, shared memory and spills of every kernel ("" when the
    library was already built)."""
    so = so_path(name)
    if os.path.exists(so):
        return so, ""
    # -Xptxas -v only reports; the library is the same either way
    extra = ["-Xptxas", "-v"] if verbose else []
    return so, _compile([find_nvcc()] + NVCC_FLAGS + extra
                        + [SOURCES[name], "-o"], so)


def find_gxx():
    """g++ from PATH (or $CXX)."""
    found = shutil.which(os.environ.get("CXX", "g++"))
    if not found:
        raise RuntimeError("g++ not found on PATH: the host Adam of "
                           "ZeRO-Offload is built from source at first use")
    return found


def host_arch_flags():
    """``-march=native`` where the CPU has AVX-512 or AVX2, else none (the
    JAX package's op_builder.py rule)."""
    if {"avx512f", "avx2"} & set(_cpu_identity()[1].split()):
        return ["-march=native"]
    return []


def _cpu_identity():
    """(model name, flags) of the first CPU in /proc/cpuinfo ("" where it
    is not readable)."""
    model = flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                key = key.strip()
                if key == "model name" and not model:
                    model = value.strip()
                elif key == "flags" and not flags:
                    flags = value.strip()
    except OSError:
        pass
    return model, flags


def _gxx_query(*args):
    proc = subprocess.run([find_gxx(), *args], capture_output=True,
                          text=True)
    return proc.stdout.strip() if proc.returncode == 0 else ""


def openmp_flags():
    """``-fopenmp``, plus ``-B`` the directory of the distribution's
    libgomp.spec where the compiler's own search path lacks it (a driver
    relocated outside its install tree, which otherwise fails with
    "cannot read spec file 'libgomp.spec'")."""
    found = _gxx_query("-print-file-name=libgomp.spec")
    if os.path.isabs(found) and os.path.exists(found):
        return ["-fopenmp"]
    spec_dir = os.path.join("/usr/lib/gcc", _gxx_query("-dumpmachine"),
                            _gxx_query("-dumpversion"))
    if os.path.exists(os.path.join(spec_dir, "libgomp.spec")):
        return ["-fopenmp", f"-B{spec_dir}/"]
    return ["-fopenmp"]


def host_flags():
    return ["-O3", "-shared", "-fPIC"] + openmp_flags() + host_arch_flags()


def host_so_path(name):
    """The library path of host source ``name`` (``_library_path``), the
    CPU's model and flags hashed too."""
    return _library_path(name, HOST_SOURCES[name], host_flags(),
                         _cpu_identity())


def build_host(name):
    """Compile host source ``name`` with g++ if its library is missing;
    returns its path."""
    so = host_so_path(name)
    if not os.path.exists(so):
        _compile([find_gxx()] + host_flags() + [HOST_SOURCES[name], "-o"],
                 so)
    return so


def load_host(name):
    """The loaded library of host source ``name``, built on first use, with
    its C signatures. Raises if it cannot be built or loaded."""
    return _load(name, lambda: build_host(name), HOST_SIGNATURES[name])


def load(name):
    """The loaded library of source ``name``, built on first use, with its C
    signatures (each returns int)."""
    return _load(name, lambda: build(name)[0],
                 {fn: (argtypes, _I)
                  for fn, argtypes in SIGNATURES[name].items()})
