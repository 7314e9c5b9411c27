"""DIA (offset-diagonal) sparse matrix — the flat engine's banded format.

Counterpart of mgtpu/ops/dia.py.  Layout: ``data[d, i] = A[i, i +
offsets[d]]`` (zero where out of range), so the product is
y_i = sum_d data[d, i] x[i + off_d] with x read as zero outside [0, n).
That is kernel D (ops/cuda/stencil.py) on a (1, 1, n) box with taps
(0, 0, off_d): `dia_matvec` launches it on a CUDA tensor and takes the
plain shifted adds on a CPU one.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from .cuda.stencil import dia_apply

__all__ = ["DIA", "dia_from_scipy", "dia_matvec"]


@dataclass(frozen=True, eq=False)
class DIA:
    data: torch.Tensor              # (ndiags, n)
    offsets: tuple[int, ...]
    shape: tuple[int, int]

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nnz(self) -> int:
        """Stored entries, out-of-range padding included."""
        return int(self.data.numel())

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return dia_matvec(self.data, self.offsets, x)

    def to_scipy(self) -> sp.csr_matrix:
        n = self.shape[0]
        data = self.data.cpu().numpy()
        rows, cols, vals = [], [], []
        for d, off in enumerate(self.offsets):
            i = np.arange(max(0, -off), min(n, n - off))
            rows.append(i)
            cols.append(i + off)
            vals.append(data[d, i])
        A = sp.coo_matrix((np.concatenate(vals),
                           (np.concatenate(rows), np.concatenate(cols))),
                          shape=self.shape)
        return A.tocsr()


def dia_from_scipy(A: sp.spmatrix, dtype=None, max_diags: int = 64,
                   device="cpu") -> DIA | None:
    """DIA form of a square matrix with at most `max_diags` occupied
    diagonals, on `device`; None otherwise (the caller takes ELL)."""
    if A.shape[0] != A.shape[1]:
        return None
    Ad = A.tocoo()
    diff = Ad.col.astype(np.int64) - Ad.row.astype(np.int64)
    offs = np.unique(diff)
    if len(offs) > max_diags:
        return None
    n = A.shape[0]
    dt = dtype if dtype is not None else A.dtype
    data = np.zeros((len(offs), n), dtype=dt)
    np.add.at(data, (np.searchsorted(offs, diff), Ad.row), Ad.data.astype(dt))
    return DIA(torch.as_tensor(data, device=device),
               tuple(int(o) for o in offs), (int(n), int(n)))


def dia_matvec(data: torch.Tensor, offsets, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x; x is (n,) or (n, m)."""
    return dia_apply(data, offsets, x)
