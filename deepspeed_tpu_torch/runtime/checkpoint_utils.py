"""Checkpoint serialization helpers: the JAX package's npz leaf layout.

Port of deepspeed_tpu/runtime/checkpoint_utils.py. A checkpoint's
``model_states.npz`` holds ``leaf_i`` (the i-th leaf of the train state) and
``dtype_i`` (its dtype name). numpy has no bfloat16, so a bf16 leaf is
stored as a 2-byte void view of its bits with the name "bfloat16", the
convention the JAX package uses for ml_dtypes arrays; fp16, fp32 and the
integer types are numpy's own. Every round trip is bit-exact.
"""
import io
import mmap
import struct
import warnings
import zipfile

import numpy as np
import torch

_VOID = {"bfloat16": torch.bfloat16}


def tensor_to_numpy(t):
    """(numpy array, dtype name) of a tensor in C order, bf16 as a void
    view."""
    t = t.detach()
    if t.device.type != "cpu":
        # a transposed leaf's copy in C order is made on its device
        t = t.contiguous()
    t = t.cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2")), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def numpy_to_tensor(arr, name):
    """Inverse of tensor_to_numpy: a CPU tensor. A read-only array (one
    mapped by ``load_npz``) gives a tensor over its memory, not a copy:
    read it, never write it."""
    void = arr.dtype.kind == "V"
    if void:
        if name not in _VOID:
            raise ValueError(f"checkpoint leaf of dtype {name!r} is not "
                             f"supported")
        arr = arr.view(np.int16)
    if arr.flags.writeable:
        t = torch.from_numpy(np.array(arr))
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            t = torch.from_numpy(arr)
    return t.view(_VOID[name]) if void else t


class _MappedNpz:
    """The members of an npz file, each stored member an array over the
    file's memory map (no copy, no per-read CRC: the manifest's sha256
    covers the bytes); any other member through np.load. ``files`` and
    ``[name]`` as np.load's NpzFile; a context manager."""

    def __init__(self, path):
        self._path = path
        self._arrays = {}
        self._loaded = None
        with zipfile.ZipFile(path) as zf:
            infos = zf.infolist()
        with open(path, "rb") as f:
            # the whole map faulted in at once: a copy out of it then
            # runs at memory speed, not one page fault per page
            self._mm = mmap.mmap(
                f.fileno(), 0, prot=mmap.PROT_READ,
                flags=mmap.MAP_SHARED | getattr(mmap, "MAP_POPULATE", 0)) \
                if infos else None
        self.files = []
        for info in infos:
            name = info.filename[:-4] if info.filename.endswith(".npy") \
                else info.filename
            self.files.append(name)
            arr = self._mapped(info)
            if arr is not None:
                self._arrays[name] = arr

    def _mapped(self, info):
        if info.compress_type != zipfile.ZIP_STORED:
            return None
        off = info.header_offset
        n_name, n_extra = struct.unpack("<HH", self._mm[off + 26:off + 30])
        start = off + 30 + n_name + n_extra
        head = io.BytesIO(self._mm[start:start + min(info.file_size, 1 << 16)])
        version = np.lib.format.read_magic(head)
        read = {(1, 0): np.lib.format.read_array_header_1_0,
                (2, 0): np.lib.format.read_array_header_2_0}.get(version)
        if read is None:
            return None
        shape, fortran, dtype = read(head)
        if dtype.hasobject:
            return None
        count = int(np.prod(shape, dtype=np.int64))
        arr = np.frombuffer(self._mm, dtype=dtype, count=count,
                            offset=start + head.tell())
        return arr.reshape(shape, order="F" if fortran else "C")

    def __getitem__(self, name):
        if name in self._arrays:
            return self._arrays[name]
        if self._loaded is None:
            self._loaded = np.load(self._path)
        return self._loaded[name]

    def close(self):
        # the arrays keep the map alive until they are dropped
        self._arrays = {}
        if self._loaded is not None:
            self._loaded.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def load_npz(path):
    """An npz file's members, mapped (``_MappedNpz``)."""
    return _MappedNpz(path)


def leaves_to_npz_dict(flat_leaves):
    """Tensors or arrays -> kwargs for np.savez (leaf_i + dtype_i pairs)."""
    out = {}
    for i, leaf in enumerate(flat_leaves):
        if isinstance(leaf, torch.Tensor):
            arr, name = tensor_to_numpy(leaf)
        else:
            arr = np.asarray(leaf)
            name = str(arr.dtype)
        out[f"leaf_{i}"] = arr
        out[f"dtype_{i}"] = np.str_(name)
    return out


def npz_dict_to_leaves(data):
    """Inverse of leaves_to_npz_dict: the list of CPU tensors."""
    n = sum(1 for name in data.files if name.startswith("leaf_"))
    return [numpy_to_tensor(data[f"leaf_{i}"], str(data[f"dtype_{i}"]))
            for i in range(n)]


def named_leaf_entry(name, leaf):
    """One name-keyed npz entry of a tensor (the layer-granular pipeline
    layout) and its dtype sidecar ``dtype::<name>``."""
    arr, dtype = tensor_to_numpy(torch.as_tensor(leaf))
    return {name: arr, f"dtype::{name}": np.str_(dtype)}


def named_leaf_lookup(data, name):
    """Inverse of named_leaf_entry against an open np.load handle: a CPU
    tensor."""
    dkey = f"dtype::{name}"
    dtype = str(data[dkey]) if dkey in data.files else ""
    return numpy_to_tensor(data[name], dtype)
