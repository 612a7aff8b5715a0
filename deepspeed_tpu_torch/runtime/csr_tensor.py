"""Row-sparse (CSR) tensors (counterpart of
``deepspeed_tpu/runtime/csr_tensor.py``).

An embedding's gradient touches few rows; :class:`CSRTensor` keeps those
rows and their ids, so a host-side exchange or a checkpoint moves only
them (``sparse_size``, ``to_dense``, ``scale``, ``add``).  Tensors stay on
the device they come from.
"""
from __future__ import annotations

from typing import Iterable, Tuple

import torch


class CSRTensor:
    def __init__(self, values: torch.Tensor, indices: torch.Tensor,
                 dense_shape: Tuple[int, int]):
        """``values``: (nnz_rows, ncols); ``indices``: (nnz_rows,) row ids."""
        self.values = torch.as_tensor(values)
        self.indices = torch.as_tensor(indices, dtype=torch.int64, device=self.values.device)
        self.dense_shape = tuple(dense_shape)

    @classmethod
    def from_dense(cls, dense: torch.Tensor, tol: float = 0.0) -> "CSRTensor":
        dense = torch.as_tensor(dense)
        if dense.dim() != 2:
            raise ValueError("CSRTensor is row-sparse over 2-D tensors")
        rows = torch.nonzero(dense.abs().amax(dim=1) > tol).flatten()
        return cls(dense[rows], rows, dense.shape)

    def to_dense(self) -> torch.Tensor:
        out = torch.zeros(self.dense_shape, dtype=self.values.dtype, device=self.values.device)
        out[self.indices] = self.values
        return out

    def sparse_size(self) -> int:
        """Elements stored: the values and the row ids."""
        return int(self.values.numel() + self.indices.numel())

    @property
    def density(self) -> float:
        return self.values.shape[0] / max(1, self.dense_shape[0])

    def scale(self, factor: float) -> "CSRTensor":
        return CSRTensor(self.values * factor, self.indices, self.dense_shape)

    def add(self, other: "CSRTensor") -> "CSRTensor":
        """The sum over the union of both row sets (sorted)."""
        if self.dense_shape != other.dense_shape:
            raise ValueError(f"shapes differ: {self.dense_shape} vs {other.dense_shape}")
        rows = torch.unique(torch.cat([self.indices, other.indices]))  # sorted
        dtype = torch.promote_types(self.values.dtype, other.values.dtype)
        vals = torch.zeros((rows.numel(), self.dense_shape[1]), dtype=dtype,
                           device=self.values.device)
        vals.index_add_(0, torch.searchsorted(rows, self.indices), self.values.to(dtype))
        vals.index_add_(0, torch.searchsorted(rows, other.indices), other.values.to(dtype))
        return CSRTensor(vals, rows, self.dense_shape)


def csr_allreduce_host(csr: CSRTensor, all_csrs: Iterable[CSRTensor]) -> CSRTensor:
    """Row-sparse gradients summed over every rank's (``all_csrs``, this
    rank's among them): the union of their rows."""
    out = csr
    for other in all_csrs:
        if other is not csr:
            out = out.add(other)
    return out
