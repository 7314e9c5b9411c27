"""Discretizations on regular meshes (host-side, scipy.sparse).

The port's own copy of mgtpu/models/operators.py: the nodal family (the
Laplacian and the variable-coefficient DivSigGrad operator), the
face-staggered elasticity operators (pure displacement and the mixed
displacement-pressure form) and the face and cell mass matrices.
Matrices are built once at setup time on the host and use 0-based, dim-0
fastest linearisation (see mgtpu_torch.models.mesh).
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .mesh import RegularMesh

__all__ = ["nodal_gradient_matrix", "nodal_laplacian_matrix",
           "nodal_div_sig_grad_matrix", "face_divergence_matrix",
           "linear_elasticity_operator", "linear_elasticity_operator_mixed",
           "face_mass_matrix", "tensor_mass_matrix"]


def _speye(n: int) -> sp.csr_matrix:
    return sp.identity(n, format="csr")


def _ddx_cell(n: int, h: float) -> sp.csr_matrix:
    """1D derivative nodes->cells: (n x n+1), (x[i+1]-x[i])/h."""
    e = np.ones(n) / h
    return sp.diags([-e, e], [0, 1], shape=(n, n + 1)).tocsr()


def _ddx_node(n: int, h: float) -> sp.csr_matrix:
    """1D derivative cells->nodes: (n+1 x n), zero rows at the boundary.

    Natural (free) boundary: the tangential-derivative terms vanish at the
    domain boundary, keeping A = J' M J symmetric positive semidefinite."""
    e = np.ones(n - 1) / h
    interior = sp.diags([-e, e], [0, 1], shape=(n - 1, n))
    return sp.vstack([sp.csr_matrix((1, n)), interior,
                      sp.csr_matrix((1, n))]).tocsr()


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


# ---------------------------------------------------------------------------
# face-staggered operators (elasticity / Stokes family)
# ---------------------------------------------------------------------------

def _face_sizes(mesh: RegularMesh, j: int) -> list[int]:
    return [mesh.n[k] + (1 if k == j else 0) for k in range(mesh.dim)]


def face_divergence_matrix(mesh: RegularMesh) -> sp.csr_matrix:
    """DIV: staggered face field -> cells. Block row [D_1, D_2(, D_3)]."""
    blocks = []
    for j in range(mesh.dim):
        sizes = _face_sizes(mesh, j)
        D = _ddx_cell(mesh.n[j], mesh.h[j])
        blocks.append(_axis_op(mesh, j, D, sizes))
    return sp.hstack(blocks).tocsr()


def _component_gradient(mesh: RegularMesh, j: int, d: int) -> sp.csr_matrix:
    """Derivative of face-j field along axis d (on the face-j grid)."""
    sizes = _face_sizes(mesh, j)
    if d == j:
        D = _ddx_cell(mesh.n[d], mesh.h[d])   # nodes->cells along d
    else:
        D = _ddx_node(mesh.n[d], mesh.h[d])   # cells->nodes (zero at bdry)
    return _axis_op(mesh, d, D, sizes)


def _mu_at(mesh: RegularMesh, mu: np.ndarray,
           node_axes: tuple[int, ...]) -> np.ndarray:
    """Average cell mu to a grid that is nodal along `node_axes` (clamped)."""
    mats = []
    for k in range(mesh.dim):
        mats.append(_av_clamped(mesh.n[k]) if k in node_axes
                    else _speye(mesh.n[k]))
    return _kron_nd(mats) @ mu


def _shear_blocks(mesh: RegularMesh, mu: np.ndarray) -> sp.csr_matrix:
    """block_diag over components j of sum_d J_dj' diag(mu) J_dj."""
    blocks = []
    for j in range(mesh.dim):
        Aj = None
        for d in range(mesh.dim):
            Jdj = _component_gradient(mesh, j, d)
            mloc = mu if d == j else _mu_at(mesh, mu, tuple(sorted({j, d})))
            T = (Jdj.T @ sp.diags(mloc) @ Jdj).tocsr()
            Aj = T if Aj is None else Aj + T
        blocks.append(Aj)
    return sp.block_diag(blocks, format="csr")


def linear_elasticity_operator(mesh: RegularMesh, mu: np.ndarray,
                               lam: np.ndarray) -> sp.csr_matrix:
    """Face-staggered linear elasticity: J' diag(mu) J + DIV' diag(lam+mu)
    DIV (jInv's GetLinearElasticityOperator).  Symmetric positive
    semidefinite; callers add a small diagonal shift."""
    mu = np.asarray(mu, dtype=np.float64).ravel(order="F")
    lam = np.asarray(lam, dtype=np.float64).ravel(order="F")
    A = _shear_blocks(mesh, mu)
    DIV = face_divergence_matrix(mesh)
    A = A + DIV.T @ sp.diags(lam + mu) @ DIV
    return A.tocsr()


def linear_elasticity_operator_mixed(mesh: RegularMesh, mu: np.ndarray,
                                     lam: np.ndarray) -> sp.csr_matrix:
    """Mixed (u, p) formulation: [[A_mu, DIV'], [DIV, -diag(1/lam)]], a
    symmetric saddle-point system on faces + cell pressure (jInv's
    GetLinearElasticityOperatorMixedFormulation), smoothed with cell-wise
    Vanka blocks."""
    mu = np.asarray(mu, dtype=np.float64).ravel(order="F")
    lam = np.asarray(lam, dtype=np.float64).ravel(order="F")
    A_mu = _shear_blocks(mesh, mu)
    DIV = face_divergence_matrix(mesh)
    C = sp.diags(1.0 / lam)
    top = sp.hstack([A_mu, DIV.T])
    bot = sp.hstack([DIV, -C])
    return sp.vstack([top, bot]).tocsr()


# ---------------------------------------------------------------------------
# mass matrices
# ---------------------------------------------------------------------------

def face_mass_matrix(mesh: RegularMesh, sigma: np.ndarray) -> sp.csr_matrix:
    """Diagonal face mass matrix: cell sigma averaged onto each face grid."""
    sigma = np.asarray(sigma).ravel(order="F")
    vol = float(np.prod(mesh.h))
    diags = []
    for j in range(mesh.dim):
        mats = [_av_clamped(mesh.n[k]) if k == j else _speye(mesh.n[k])
                for k in range(mesh.dim)]
        diags.append((_kron_nd(mats) @ sigma) * vol)
    return sp.diags(np.concatenate(diags)).tocsr()


def tensor_mass_matrix(mesh: RegularMesh, sigma: np.ndarray) -> sp.csr_matrix:
    """Diagonal cell-centered mass matrix with cell volumes."""
    sigma = np.asarray(sigma).ravel(order="F")
    vol = float(np.prod(mesh.h))
    return sp.diags(sigma * vol).tocsr()
