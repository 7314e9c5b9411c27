"""Smoother setup (host side): diagonal preconditioners and spectral bounds.

Counterpart of the pointwise part of mgtpu/setup/smoothers.py.  Everything
here runs once at setup on the host (numpy/scipy); the grid hierarchy moves
the diagonals to the device.  Vanka and line smoothers wait.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..cycle.relax import DiagRelax, ChebyshevRelax

__all__ = ["jacobi_diag", "spai_diag", "jacobi_prec", "spai_prec",
           "estimate_lam_max", "chebyshev_prec"]


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
