"""Nodal Poisson discretizations on regular meshes (host-side, scipy.sparse).

The port's own copy of the nodal family of mgtpu/models/operators.py.
Matrices are built once at setup time on the host and use 0-based, dim-0
fastest linearisation (see mgtpu_torch.models.mesh).  The staggered
(elasticity) operators wait for the systems engine.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .mesh import RegularMesh

__all__ = ["nodal_gradient_matrix", "nodal_laplacian_matrix"]


def _speye(n: int) -> sp.csr_matrix:
    return sp.identity(n, format="csr")


def _ddx_cell(n: int, h: float) -> sp.csr_matrix:
    """1D derivative nodes->cells: (n x n+1), (x[i+1]-x[i])/h."""
    e = np.ones(n) / h
    return sp.diags([-e, e], [0, 1], shape=(n, n + 1)).tocsr()


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
