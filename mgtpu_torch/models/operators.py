"""Nodal discretizations on regular meshes (host-side, scipy.sparse).

The port's own copy of the nodal family of mgtpu/models/operators.py: the
Laplacian and the variable-coefficient DivSigGrad operator.
Matrices are built once at setup time on the host and use 0-based, dim-0
fastest linearisation (see mgtpu_torch.models.mesh).  The staggered
(elasticity) operators wait for the systems engine.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .mesh import RegularMesh

__all__ = ["nodal_gradient_matrix", "nodal_laplacian_matrix",
           "nodal_div_sig_grad_matrix"]


def _speye(n: int) -> sp.csr_matrix:
    return sp.identity(n, format="csr")


def _ddx_cell(n: int, h: float) -> sp.csr_matrix:
    """1D derivative nodes->cells: (n x n+1), (x[i+1]-x[i])/h."""
    e = np.ones(n) / h
    return sp.diags([-e, e], [0, 1], shape=(n, n + 1)).tocsr()


def _av_clamped(n: int) -> sp.csr_matrix:
    """1D averaging cells->nodes with nearest-neighbour clamp at the ends
    (GMG needs a sigma average that is nearest-neighbour at the
    boundaries)."""
    e = 0.5 * np.ones(n)
    A = sp.diags([e, e], [-1, 0], shape=(n + 1, n)).tolil()
    A[0, 0] = 1.0
    A[n, n - 1] = 1.0
    return A.tocsr()


def _kron_nd(mats: list[sp.spmatrix]) -> sp.csr_matrix:
    """Kronecker composite with dim-0 fastest ordering: kron(m[d-1],...,m[0])."""
    out = mats[0]
    for m in mats[1:]:
        out = sp.kron(m, out, format="csr")
    return out.tocsr()


def _axis_op(mesh: RegularMesh, axis: int, op_axis: sp.spmatrix,
             other_sizes: list[int]) -> sp.csr_matrix:
    """Compose op on one axis with identities of `other_sizes` on the rest."""
    mats = []
    for d in range(mesh.dim):
        mats.append(op_axis if d == axis else _speye(other_sizes[d]))
    return _kron_nd(mats)


def nodal_gradient_matrix(mesh: RegularMesh) -> sp.csr_matrix:
    """Gradient nodes -> edges; stacked per derivative direction."""
    blocks = []
    node_sizes = [ni + 1 for ni in mesh.n]
    for d in range(mesh.dim):
        D = _ddx_cell(mesh.n[d], mesh.h[d])
        blocks.append(_axis_op(mesh, d, D, node_sizes))
    return sp.vstack(blocks).tocsr()


def nodal_laplacian_matrix(mesh: RegularMesh) -> sp.csr_matrix:
    """Nodal Laplacian with natural (Neumann) BC: G' G."""
    G = nodal_gradient_matrix(mesh)
    return (G.T @ G).tocsr()


def nodal_div_sig_grad_matrix(mesh: RegularMesh,
                              sigma: np.ndarray) -> sp.csr_matrix:
    """G' diag(sigma_edges) G with cell sigma averaged to the edges
    (clamped at the boundary): jInv's getNodalDivSigGradMatrix."""
    sigma = np.asarray(sigma).ravel(order="F")
    if sigma.size != mesh.num_cells:
        raise ValueError("sigma must be cell-centered")
    G = nodal_gradient_matrix(mesh)
    sig_edges = []
    for d in range(mesh.dim):
        mats = [_speye(mesh.n[k]) if k == d else _av_clamped(mesh.n[k])
                for k in range(mesh.dim)]
        sig_edges.append(_kron_nd(mats) @ sigma)
    S = sp.diags(np.concatenate(sig_edges))
    return (G.T @ S @ G).tocsr()
