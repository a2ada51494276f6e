"""CSR (row-sparse) tensor for embedding gradients.

Port of deepspeed_tpu/runtime/csr_tensor.py: an embedding gradient is
nonzero only on the rows whose tokens appeared in the batch, so moving
(row indices, row values) beats moving the dense table, on the
data-parallel wire (``allgather_csr``, the reference's sparse all-gather)
and on ZeRO-Offload's device-to-host copy.

With ``max_rows`` the result has a fixed shape, decided without a host
sync: the nonzero rows first in index order, then rows of index -1 and
zero values.
"""
from typing import Optional

import numpy as np
import torch


def nonzero_rows(dense):
    """A bool per row of ``dense``: whether any element is nonzero."""
    return (dense != 0).reshape(dense.shape[0], -1).any(dim=1)


class CSRTensor:
    """Row-sparse view: indices (nnz_rows,), values (nnz_rows, *row)."""

    def __init__(self, indices, values, dense_size):
        self.indices = indices
        self.values = values
        self.dense_size = tuple(dense_size)

    @staticmethod
    def from_dense(dense, max_rows: Optional[int] = None):
        """The nonzero rows of ``dense``. With ``max_rows`` the shapes are
        fixed: indices padded with -1, values with zeros (rows beyond
        ``max_rows`` are dropped: the caller sizes it)."""
        dense = torch.as_tensor(dense)
        nz = nonzero_rows(dense)
        if max_rows is None:
            idx = torch.nonzero(nz).reshape(-1)
            return CSRTensor(idx, dense[idx], dense.shape)
        # nonzero rows first, each group in index order
        order = torch.argsort((~nz).to(torch.int8), stable=True)
        idx = order[:max_rows]
        valid = nz[idx]
        mask = valid.reshape((-1,) + (1,) * (dense.dim() - 1))
        values = torch.where(mask, dense[idx], torch.zeros((), dtype=dense.dtype,
                                                           device=dense.device))
        indices = torch.where(valid, idx, torch.full_like(idx, -1))
        return CSRTensor(indices, values, dense.shape)

    def to_dense(self):
        out = torch.zeros(self.dense_size, dtype=self.values.dtype,
                          device=self.values.device)
        return scatter_add_rows(out, self.indices, self.values)

    def sparse_size(self):
        """(#stored elements, #dense elements) (reference csr_tensor.py:47)."""
        stored = int(np.prod(tuple(self.values.shape)))
        dense = int(np.prod(self.dense_size))
        return stored, dense

    def add(self, other: "CSRTensor") -> "CSRTensor":
        """Merge two row-sparse gradients (combining data-parallel
        shards)."""
        assert self.dense_size == other.dense_size
        return CSRTensor.from_dense(self.to_dense() + other.to_dense())

    def __repr__(self):
        return (f"CSRTensor(indices={self.indices.tolist()}, "
                f"dense_size={self.dense_size})")


def scatter_add_rows(out, indices, values):
    """``out[indices[j]] += values[j]`` for every valid row (index >= 0),
    in place; returns ``out``."""
    valid = indices >= 0
    mask = valid.reshape((-1,) + (1,) * (values.dim() - 1))
    vals = torch.where(mask, values, torch.zeros((), dtype=values.dtype,
                                                 device=values.device))
    out.index_add_(0, torch.clamp(indices, min=0), vals.to(out.dtype))
    return out


def allgather_csr(csr: CSRTensor, group, name="x"):
    """Every rank's rows of ``csr`` (fixed capacity) gathered over
    ``group`` (a parallel.mesh.DataParallelGroup) and summed into the
    dense tensor (the reference's sparse_allreduce_and_scatter,
    engine.py:1227-1253), counted as ``csr_indices`` / ``csr_values``
    under ``name``."""
    w = group.size
    elements = int(np.prod(csr.dense_size))
    idx = torch.empty(w * csr.indices.numel(), dtype=csr.indices.dtype,
                      device=csr.indices.device)
    vals = torch.empty(w * csr.values.numel(), dtype=csr.values.dtype,
                       device=csr.values.device)
    group.quantized_all_gather(idx, csr.indices.reshape(-1), "csr_indices",
                               [(name, elements, idx.numel())])
    group.quantized_all_gather(vals, csr.values.reshape(-1), "csr_values",
                               [(name, elements, vals.numel())])
    out = torch.zeros(csr.dense_size, dtype=csr.values.dtype,
                      device=csr.values.device)
    return scatter_add_rows(out, idx,
                            vals.view((-1,) + tuple(csr.values.shape[1:])))
