"""Geometric full-weighting transfers (host-side construction).

The port's own copy of the scalar nodal part of mgtpu/setup/transfers.py:
bilinear/trilinear full-weighting prolongation built from 1D factors composed
by Kronecker products.  Builders return (operator, coarse_size[s]);
prolongations map coarse -> fine.  The Galerkin scaling R = 0.5^dim P^T is
applied in mgtpu_torch.setup.hierarchy.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["fw_interp", "fw_interp_1d"]


def _speye(n: int) -> sp.csr_matrix:
    return sp.identity(n, format="csr")


def _kron_nd(mats: list[sp.spmatrix]) -> sp.csr_matrix:
    out = mats[0]
    for m in mats[1:]:
        out = sp.kron(m, out, format="csr")
    return out.tocsr()


def fw_interp_1d(n_nodes: int, geometric: bool = False):
    """1D linear interpolation on nodes: (n_nodes x nc).

    Odd n_nodes: coarse points are every other node.  Even n_nodes: the last
    two nodes are kept as-is (identity tail); in geometric mode an even grid
    stops coarsening (returns identity) because the coarse mesh must have
    integer cells.
    """
    if n_nodes <= 2:
        return _speye(n_nodes), n_nodes
    half = 0.5 * np.ones(n_nodes - 1)
    P = sp.diags([half, np.ones(n_nodes), half], [-1, 0, 1]).tocsc()
    if n_nodes % 2 == 1:
        P = P[:, 0::2]
    else:
        if geometric:
            return _speye(n_nodes), n_nodes
        cols = list(range(0, n_nodes, 2)) + [n_nodes - 1]
        P = P[:, cols].tolil()
        P[n_nodes - 2:, -2:] = sp.identity(2)
        P = P.tocsc()
    return P.tocsr(), P.shape[1]


def fw_interp(n_nodes, geometric: bool = False):
    """Tensor-product prolongation on nodes: (P, per-dim coarse node counts)."""
    ops, ncs = [], []
    for nd in n_nodes:
        P1, nc1 = fw_interp_1d(int(nd), geometric)
        ops.append(P1)
        ncs.append(nc1)
    return _kron_nd(ops), np.array(ncs, dtype=np.int64)
