"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each source in ``SOURCES`` compiles into its own shared library with a plain
C interface (no PyTorch headers in the build, so a build takes seconds), for
``sm_90a`` (Hopper), at first use, into ``build/deepspeed_tpu_torch/``
beside the package. A library's file name carries a hash of its source
directory, of every header the source includes (from there or from another
directory, such as the shared ``ops/transformer/csrc/hopper.cuh``) and of
the flags, so an edited source or header is rebuilt and concurrent builds
never write the same file. Sources build independently: ``build(name)`` for each name
may run at the same time.
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
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
_libs = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint
# C signatures of each library: {function: argtypes}; every one returns int
_FLASH_TAIL = [_I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _U, _F, _U, _P]
_BSA_TAIL = [_I, _I, _I, _I, _I, _I, _I, _F, _I, _P]
SIGNATURES = {
    "flash_attention": {
        # (dtype, head_dim, bh, heads, s_q, s_k, scale, causal, bias_kind,
        #  use_dropout, threshold, inv_keep, seed, stream)
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


def so_path(name):
    """The library path of source ``name``: a hash of every file in the
    source's directory and of every header it includes from elsewhere,
    names (relative to the source's directory) and contents, and of the
    flags."""
    src_dir = os.path.dirname(SOURCES[name])
    files = set()
    _included(SOURCES[name], files)
    files |= {os.path.join(src_dir, f) for f in os.listdir(src_dir)}
    digest = hashlib.sha256()
    for path in sorted(os.path.relpath(f, src_dir) for f in files
                       if os.path.isfile(f)):
        digest.update(path.encode() + b"\0")
        with open(os.path.join(src_dir, path), "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:12]}.so")


def build(name, verbose=False):
    """Compile source ``name`` if its library is missing. Returns (path,
    ptxas report); ``verbose`` adds ``-Xptxas -v``, whose report lists the
    registers, shared memory and spills of every kernel ("" when the
    library was already built)."""
    so = so_path(name)
    if os.path.exists(so):
        return so, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp.{os.getpid()}"
    # -Xptxas -v only reports; the library is the same either way
    extra = ["-Xptxas", "-v"] if verbose else []
    cmd = [find_nvcc()] + NVCC_FLAGS + extra + [SOURCES[name], "-o", tmp]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, so)
    logger.info(f"built {so} in {time.perf_counter() - t0:.1f}s")
    return so, proc.stderr


def load(name):
    """The loaded library of source ``name``, built on first use, with its C
    signatures."""
    if name not in _libs:
        lib = ctypes.CDLL(build(name)[0])
        for fn_name, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = _I
        _libs[name] = lib
    return _libs[name]
