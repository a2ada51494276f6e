"""Checkpoint serialization helpers: the JAX package's npz leaf layout.

Port of deepspeed_tpu/runtime/checkpoint_utils.py. A checkpoint's
``model_states.npz`` holds ``leaf_i`` (the i-th leaf of the train state) and
``dtype_i`` (its dtype name). numpy has no bfloat16, so a bf16 leaf is
stored as a 2-byte void view of its bits with the name "bfloat16", the
convention the JAX package uses for ml_dtypes arrays; fp16, fp32 and the
integer types are numpy's own. Every round trip is bit-exact.
"""
import numpy as np
import torch

_VOID = {"bfloat16": torch.bfloat16}


def tensor_to_numpy(t):
    """(numpy array, dtype name) of a tensor, bf16 as a void view."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2")), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def numpy_to_tensor(arr, name):
    """Inverse of tensor_to_numpy: a CPU tensor."""
    if arr.dtype.kind == "V":
        if name not in _VOID:
            raise ValueError(f"checkpoint leaf of dtype {name!r} is not "
                             f"supported")
        return torch.from_numpy(np.array(arr).view(np.int16)).view(
            _VOID[name])
    return torch.from_numpy(np.array(arr))


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
