"""Geometric transfers (host-side construction).

The port's own copy of mgtpu/setup/transfers.py: bilinear/trilinear
full-weighting prolongation built from 1D factors composed by Kronecker
products, and the staggered-grid (faces +- pressure) family of the systems
engine (reference Systems.jl): linear node prolongation and full weighting
along a face's normal, cell-centered prolongation and aggregation along the
other axes.  Each constructor returns (operator, coarse_size[s]);
prolongations map coarse -> fine.  The Galerkin scaling by 0.5^dim is
applied in mgtpu_torch.setup.hierarchy.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["fw_interp", "fw_interp_1d", "linear_operators_systems_faces",
           "injection_operators_systems_faces",
           "restrict_cell_centered_variables", "restrict_nodal_variables"]


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


# ---------------------------------------------------------------------------
# 1D staggered building blocks (reference Systems.jl:80-164)
# ---------------------------------------------------------------------------

_MIN_COARSEN = 8  # below this many cells a 1D factor refuses to coarsen


def node_injection_1d(n_cells: int):
    """Injection restriction on nodes: keep every other node."""
    if n_cells < _MIN_COARSEN:
        return _speye(n_cells + 1), n_cells
    if n_cells % 2 != 0:
        raise ValueError("node_injection_1d: n_cells must be even")
    R = _speye(n_cells + 1).tocsc()[::2, :]
    return R.tocsr(), n_cells // 2


def node_fw_restriction_1d(n_cells: int):
    """Full-weighting restriction on nodes (0.25,0.5,0.25)*2, injection at
    the boundary."""
    if n_cells < _MIN_COARSEN:
        return _speye(n_cells + 1), n_cells
    if n_cells % 2 != 0:
        raise ValueError("node_fw_restriction_1d: n_cells must be even")
    n = n_cells
    R = sp.diags([0.25 * np.ones(n), 0.5 * np.ones(n + 1), 0.25 * np.ones(n)],
                 [-1, 0, 1]).tocsc()
    R = (R[:, 0::2].T) * 2.0
    return R.tocsr(), n // 2


def prolongation_cells_1d(n_cells: int):
    """Linear prolongation on cell centers (1/4,3/4,3/4,1/4), clamped at
    the boundary."""
    if n_cells < _MIN_COARSEN:
        return _speye(n_cells), n_cells
    if n_cells % 2 != 0:
        raise ValueError("prolongation_cells_1d: n_cells must be even")
    n = n_cells
    d0 = np.concatenate([0.75 * np.ones(n - 1), [0.0]])
    P = sp.diags([0.25 * np.ones(n - 2), 0.75 * np.ones(n - 1),
                  d0, 0.25 * np.ones(n - 1)],
                 [-2, -1, 0, 1], shape=(n, n)).tocsc()
    P = P[:, 0::2].tolil()
    P[0, 0] = 1.0
    P[n - 1, n // 2 - 1] = 1.0
    return P.tocsr(), n // 2


def restriction_cells_1d(n_cells: int):
    """2->1 cell aggregation restriction (rows [1, 1])."""
    if n_cells < _MIN_COARSEN:
        return _speye(n_cells), n_cells
    if n_cells % 2 != 0:
        raise ValueError("restriction_cells_1d: n_cells must be even")
    n = n_cells
    R = sp.diags([0.5 * np.ones(n - 1), 0.5 * np.ones(n - 1)], [0, 1],
                 shape=(n - 1, n)).tocsc()
    R = 2.0 * R[0::2, :]
    return R.tocsr(), n // 2


def prolongation_nodes_1d(n_cells: int):
    """Linear prolongation on nodes (0.5,1,0.5)."""
    if n_cells < _MIN_COARSEN:
        return _speye(n_cells + 1), n_cells
    if n_cells % 2 != 0:
        raise ValueError("prolongation_nodes_1d: n_cells must be even")
    n = n_cells
    half = 0.5 * np.ones(n)
    P = sp.diags([half, np.ones(n + 1), half], [-1, 0, 1]).tocsc()
    P = P[:, 0::2]
    return P.tocsr(), n // 2


def restriction_cell_centered(n):
    """Tensor-product cell aggregation restriction; returns (R, nc)."""
    ops, ncs = [], []
    for nd in n:
        R1, nc1 = restriction_cells_1d(int(nd))
        ops.append(R1)
        ncs.append(nc1)
    return _kron_nd(ops), np.array(ncs, dtype=np.int64)


def prolongation_cell_centered(n):
    """Tensor-product cell-centered prolongation; returns (P, nc)."""
    ops, ncs = [], []
    for nd in n:
        P1, nc1 = prolongation_cells_1d(int(nd))
        ops.append(P1)
        ncs.append(nc1)
    return _kron_nd(ops), np.array(ncs, dtype=np.int64)


def _face_op(n, j, along_face_normal, along_other):
    """Kron composite for face-j fields: one factory along axis j, another
    on the rest.  Factories return (op, nc)."""
    ops, ncs = [], []
    for k in range(len(n)):
        f = along_face_normal if k == j else along_other
        op, nc = f(int(n[k]))
        ops.append(op)
        ncs.append(nc)
    return _kron_nd(ops), np.array(ncs, dtype=np.int64)


# ---------------------------------------------------------------------------
# staggered systems transfers (reference Systems.jl:8-76)
# ---------------------------------------------------------------------------

def linear_operators_systems_faces(n, with_cells_block: bool):
    """(P, R, nc) for face-staggered vector fields (+ optional pressure
    block), assembled block-diagonally.

    P: per component, linear nodal prolongation along the face normal x
    cell-centered prolongation along the other axes; R: nodal full
    weighting along the normal x cell aggregation otherwise.
    with_cells_block appends the cell-centered (pressure) block, the
    reference's "SystemsFacesMixedLinear"."""
    dim = len(n)
    Ps, Rs = [], []
    nc = None
    for j in range(dim):
        Pj, ncj = _face_op(n, j, prolongation_nodes_1d, prolongation_cells_1d)
        Rj, _ = _face_op(n, j, node_fw_restriction_1d, restriction_cells_1d)
        Ps.append(Pj)
        Rs.append(Rj)
        if nc is None:
            nc = ncj
    if with_cells_block:
        Pc, _ = prolongation_cell_centered(n)
        Rc, _ = restriction_cell_centered(n)
        Ps.append(Pc)
        Rs.append(Rc)
    P = sp.block_diag(Ps, format="csr")
    R = sp.block_diag(Rs, format="csr")
    return P, R, nc


def injection_operators_systems_faces(n, with_cells_block: bool):
    """Injection restriction variant (reference Systems.jl:8-31)."""
    dim = len(n)
    Rs = []
    for j in range(dim):
        Rj, _ = _face_op(n, j, node_injection_1d, restriction_cells_1d)
        Rs.append(Rj)
    if with_cells_block:
        Rc, _ = restriction_cell_centered(n)
        Rs.append(Rc)
    return sp.block_diag(Rs, format="csr")


# ---------------------------------------------------------------------------
# PDE-coefficient coarsening for re-discretization hierarchies
# (reference GeometricTransferOperators.jl:52-82)
# ---------------------------------------------------------------------------

def restrict_cell_centered_variables(rho: np.ndarray, n):
    """Average cell-centered coefficients onto the coarse mesh."""
    R, _ = restriction_cell_centered(n)
    dim = len(n)
    return (0.5 ** dim) * (R @ np.asarray(rho).ravel(order="F"))


def restrict_nodal_variables(rho: np.ndarray, n_nodes):
    """Full-weighting restriction of nodal coefficients onto the coarse
    mesh."""
    ops = []
    for nd in n_nodes:
        R1, _ = node_fw_restriction_1d(int(nd) - 1)
        ops.append(R1)
    R = _kron_nd(ops)
    dim = len(n_nodes)
    return (0.5 ** dim) * (R @ np.asarray(rho).ravel(order="F"))
