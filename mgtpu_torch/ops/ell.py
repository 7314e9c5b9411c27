"""ELL (padded fixed-width row) sparse matrix — the flat engine's general
device format.

Counterpart of mgtpu/ops/ell.py.  Each row keeps K (column, value) pairs;
padding entries use column 0 with value 0 (always safe), and K is padded to
a multiple of ``pad_k``.  Right-hand sides are trailing columns: x is
(n_cols,) or (n_cols, m).

mgtpu computes the product in XLA (a gather and a row reduction), outside
any Pallas kernel, so the port's `ell_matvec` is plain torch: `index_select`
then an `einsum` over the row's K entries.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

__all__ = ["ELL", "ell_arrays_from_scipy", "ell_from_scipy", "ell_matvec",
           "ell_rows"]


@dataclass(frozen=True, eq=False)
class ELL:
    indices: torch.Tensor       # (n_rows, K) int32
    values: torch.Tensor        # (n_rows, K)
    shape: tuple[int, int]

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def nnz(self) -> int:
        """Stored entries, padding included."""
        return int(self.indices.numel())

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return ell_matvec(self.indices, self.values, x)

    def to_scipy(self) -> sp.csr_matrix:
        n, k = self.indices.shape
        rows = np.repeat(np.arange(n), k)
        cols = self.indices.cpu().numpy().ravel()
        vals = self.values.cpu().numpy().ravel()
        A = sp.coo_matrix((vals, (rows, cols)), shape=self.shape)
        A.sum_duplicates()
        return A.tocsr()


def ell_arrays_from_scipy(A: sp.spmatrix, dtype=None, pad_k: int = 4):
    """Host ELL layout (numpy indices, values, shape) of a scipy matrix."""
    A = A.tocsr()
    A.sum_duplicates()
    n, m = A.shape
    counts = np.diff(A.indptr)
    kmax = int(counts.max()) if n > 0 else 0
    K = max(pad_k, int(-(-kmax // pad_k) * pad_k))
    idx = np.zeros((n, K), dtype=np.int32)
    val = np.zeros((n, K), dtype=dtype if dtype is not None else A.dtype)
    # position of each stored entry within its row
    within = np.arange(A.nnz) - np.repeat(A.indptr[:-1], counts)
    rows = np.repeat(np.arange(n), counts)
    idx[rows, within] = A.indices
    val[rows, within] = A.data.astype(val.dtype)
    return idx, val, (int(n), int(m))


def ell_from_scipy(A: sp.spmatrix, dtype=None, pad_k: int = 4,
                   device="cpu") -> ELL:
    """An ELL matrix on `device` from a scipy sparse matrix."""
    idx, val, shape = ell_arrays_from_scipy(A, dtype, pad_k)
    return ELL(torch.as_tensor(idx, device=device),
               torch.as_tensor(val, device=device), shape)


def ell_matvec(indices: torch.Tensor, values: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for ELL A; x is (n_cols,) or (n_cols, m)."""
    n, K = indices.shape
    squeeze = x.ndim == 1
    x2 = x[:, None] if squeeze else x
    xg = x2.index_select(0, indices.reshape(-1)).reshape(n, K, x2.shape[1])
    y = torch.einsum("nk,nkm->nm", values, xg)
    return y[:, 0] if squeeze else y


def ell_rows(indices: torch.Tensor, values: torch.Tensor,
             rows: torch.Tensor):
    """(indices, values) of a set of rows."""
    return indices.index_select(0, rows), values.index_select(0, rows)
