"""Smoother setup (host side): diagonal preconditioners, spectral bounds
and line-Jacobi pivots.

Counterpart of mgtpu/setup/smoothers.py without Vanka.  Everything here
runs once at setup on the host (numpy/scipy); the grid hierarchy moves the
diagonals and line coefficients to the device.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..cycle.relax import (AltLineRelax, ChebyshevRelax, DiagRelax,
                           LineRelax)

__all__ = ["jacobi_diag", "spai_diag", "jacobi_prec", "spai_prec",
           "estimate_lam_max", "chebyshev_prec", "line_prec"]


def jacobi_diag(A: sp.spmatrix, omega) -> np.ndarray:
    """Host-side damped-Jacobi diagonal d = omega / diag(A)."""
    return np.asarray(omega / A.diagonal())


def spai_diag(A: sp.spmatrix, omega) -> np.ndarray:
    """Host-side SPAI(0) diagonal minimising ||I - M A||_F:
    d_i = omega * conj(a_ii) / ||A e_i||^2."""
    A = A.tocsr()
    s = np.asarray(A.multiply(A.conj()).sum(axis=0)).ravel().real
    return omega * np.conj(A.diagonal()) / np.maximum(s, 1e-300)


def jacobi_prec(A: sp.spmatrix, omega, dtype=None) -> DiagRelax:
    """Damped Jacobi: d = omega / diag(A)."""
    d = jacobi_diag(A, omega)
    return DiagRelax(d.astype(dtype if dtype is not None else d.dtype))


def spai_prec(A: sp.spmatrix, omega, dtype=None) -> DiagRelax:
    """SPAI(0) diagonal preconditioner (see spai_diag)."""
    d = spai_diag(A, omega)
    return DiagRelax(d.astype(dtype if dtype is not None else d.dtype))


def estimate_lam_max(A: sp.spmatrix, d: np.ndarray, iters: int = 15,
                     seed: int = 7, safety: float = 1.05) -> float:
    """Power-iteration bound on spec(D^-1 A) (host, once at setup)."""
    rng = np.random.RandomState(seed)
    x = rng.rand(A.shape[0])
    x /= np.linalg.norm(x)
    lam = 1.0
    for _ in range(iters):
        y = d * (A @ x)
        lam = np.linalg.norm(y)
        if lam == 0:
            return 1.0
        x = y / lam
    return float(lam * safety)


def chebyshev_prec(A: sp.spmatrix, omega, dtype=None) -> ChebyshevRelax:
    """Chebyshev smoother state: inverse diagonal + spectral upper bound.
    `omega` is accepted for dispatch uniformity but unused."""
    d = 1.0 / np.asarray(A.diagonal())
    lam = estimate_lam_max(A.tocsr(), d)
    return ChebyshevRelax(d.astype(dtype if dtype is not None else d.dtype),
                          lam)


def line_prec(A: sp.spmatrix, mesh, omega, dtype=None, axis=None):
    """Line-Jacobi smoother state: the tridiagonal part of A along one grid
    axis with host-computed Thomas pivots (see cycle.relax.LineRelax).

    axis: grid axis of the lines (slowest mesh dim first); None picks the
    axis with the strongest mean unit-offset coupling; "alt" gives
    alternating-direction lines over every grid axis (AltLineRelax).
    `omega` may be a float or a {"omega": w, "axis": a} mapping."""
    if isinstance(omega, dict) and omega.get("axis") == "alt":
        axis, omega = "alt", omega.get("omega", 1.0)
    if axis == "alt":
        g = len(np.asarray(mesh.n).ravel())
        return AltLineRelax(tuple(
            line_prec(A, mesh, omega, dtype=dtype, axis=a)
            for a in range(g)))
    from ..ops.grid_stencil import grid_stencil_from_csr

    if isinstance(omega, dict):
        axis = omega.get("axis", axis)
        omega = omega.get("omega", 1.0)
    if mesh is None:
        raise ValueError("line-jacobi needs a regular mesh (grid engine)")
    nodes = [int(v) + 1 for v in np.asarray(mesh.n).ravel()]
    gs = grid_stencil_from_csr(sp.csr_matrix(A), nodes)
    grid = gs.grid
    g = len(grid)
    coeff = np.asarray(gs.coeff, dtype=np.float64)

    def unit_coeff(a, sgn):
        want = tuple(sgn if k == a else 0 for k in range(g))
        for k, off in enumerate(gs.offsets):
            if tuple(off) == want:
                return coeff[k]
        return np.zeros(grid)

    if axis is None:
        strength = [abs(unit_coeff(a, -1)).mean() + abs(unit_coeff(a, 1)).mean()
                    for a in range(g)]
        axis = int(np.argmax(strength))

    diag = unit_coeff(axis, 0)       # the offset-0 coefficient
    sub = np.moveaxis(unit_coeff(axis, -1), axis, -1)
    sup = np.moveaxis(unit_coeff(axis, 1), axis, -1)
    dia = np.moveaxis(diag, axis, -1)
    n = dia.shape[-1]
    piv = np.zeros_like(dia)
    cp = np.zeros_like(dia)
    piv[..., 0] = 1.0 / dia[..., 0]
    cp[..., 0] = sup[..., 0] * piv[..., 0]
    for i in range(1, n):
        piv[..., i] = 1.0 / (dia[..., i] - sub[..., i] * cp[..., i - 1])
        cp[..., i] = sup[..., i] * piv[..., i]
    alpha = -piv * sub               # zero at line starts (sub[..., 0] == 0)
    dt = dtype if dtype is not None else coeff.dtype
    mv = lambda a: np.ascontiguousarray(np.moveaxis(a, -1, axis).astype(dt))
    return LineRelax(mv(alpha), mv(piv), mv(cp), int(axis), float(omega))
