"""Slab form of a banded grid operator (host side).

The port's copy of `StencilLevel` and `stencil_from_banded` from
mgtpu/parallel/stencil.py.  A flat vector x (dim-0 fastest) is viewed as
G[j, i] = x[i + j*NI], with j the last mesh dimension and i the flattened
remaining ones; every stencil offset decomposes as off = dj*NI + di with
|dj| <= 1.  Kernel D applies this form (ops/cuda/stencil.py::
stencil_matvec).  The halo exchange and the matrix-free transfers of the
reference module belong to the multi-device tier and are not here yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

__all__ = ["StencilLevel", "stencil_from_banded"]


@dataclass(frozen=True, eq=False)
class StencilLevel:
    """One level: variable stencil coefficients + Jacobi diagonal, slab form.

    coeff: (ndiags, NJ, NI) with coeff[k, j, i] = A[row(j,i), row(j,i)+off_k];
    d:     (NJ, NI) damped-Jacobi inverse diagonal;
    di/dj: per-diagonal offset decomposition; shape = (NJ, NI).
    Host numpy arrays.
    """
    coeff: np.ndarray
    d: np.ndarray
    di: tuple[int, ...]
    dj: tuple[int, ...]
    shape: tuple[int, int]


def stencil_from_banded(A: sp.spmatrix, n_nodes, omega: float,
                        dtype=np.float32) -> StencilLevel:
    """The slab-form stencil of a banded operator on an n_nodes grid.

    n_nodes: per-dim node counts (dim 0 fastest).  NI = prod(n_nodes[:-1]),
    NJ = n_nodes[-1].  Raises ValueError when an offset reaches beyond the
    neighbouring plane."""
    n_nodes = [int(v) for v in np.asarray(n_nodes).ravel()]
    NI = int(np.prod(n_nodes[:-1]))
    NJ = n_nodes[-1]
    A = A.tocoo()
    off_all = A.col.astype(np.int64) - A.row.astype(np.int64)
    offs = np.unique(off_all)
    dj = np.round(offs / NI).astype(np.int64)
    di = offs - dj * NI
    if np.any(np.abs(dj) > 1):
        raise ValueError("operator is not a 1-plane-halo stencil on this grid")
    coeff = np.zeros((len(offs), NJ * NI), dtype=dtype)
    pos = np.searchsorted(offs, off_all)
    np.add.at(coeff, (pos, A.row), A.data.astype(dtype))
    coeff = coeff.reshape(len(offs), NJ, NI)
    diag = A.tocsr().diagonal()
    d = (omega / diag).astype(dtype).reshape(NJ, NI)
    return StencilLevel(coeff, d, tuple(int(v) for v in di),
                        tuple(int(v) for v in dj), (NJ, NI))
