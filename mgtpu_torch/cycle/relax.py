"""Pointwise relaxation states and polynomial smoothers (torch).

Counterpart of the pointwise part of mgtpu/cycle/relax.py: damped Jacobi /
SPAI(0) diagonal relaxation and the first- and fourth-kind Chebyshev
smoothers.  The smoothers work on any tensor shape `d` broadcasts against
(grid fields (m, *grid) with a grid-shaped `d`).  FGMRES smoothing and line
relaxation wait for later slices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

__all__ = ["DiagRelax", "ChebyshevRelax", "chebyshev_smooth",
           "chebyshev4_smooth", "relax_diag"]


@dataclass(frozen=True, eq=False)
class DiagRelax:
    """Damped Jacobi / SPAI(0) diagonal preconditioner: x += d .* r.
    `d` is a host numpy array at setup and a tensor in a device hierarchy."""
    d: Any


@dataclass(frozen=True, eq=False)
class ChebyshevRelax:
    """Chebyshev polynomial smoother state: Jacobi diagonal + spectral bound
    on spec(D^-1 A) (with a safety factor)."""
    d: Any
    lam_max: float


def chebyshev4_smooth(matvec, d, lam_max, degree: int, r, x):
    """Fourth-kind Chebyshev smoothing (Lottes, arXiv:2407.09848): damps the
    whole interval (0, lam_max] with no lower-bound parameter.  One matvec
    per degree; `r` is the incoming residual b - A x."""
    z = (4.0 / (3.0 * lam_max)) * (d * r)
    x = x + z
    for k in range(2, degree + 1):
        r = r - matvec(z)
        z = ((2.0 * k - 3.0) / (2.0 * k + 1.0)) * z + \
            ((8.0 * k - 4.0) / ((2.0 * k + 1.0) * lam_max)) * (d * r)
        x = x + z
    return x


def chebyshev_smooth(matvec, d, lam_max, degree: int, frac: float, r, x, b):
    """Degree-`degree` Chebyshev smoothing on [frac*lam, 1.02*lam].

    Saad, Iterative Methods, Alg. 12.1, with M = D^-1 folded in; `r` is the
    incoming residual b - A x, so each degree costs exactly one matvec."""
    lo = frac * lam_max
    hi = 1.02 * lam_max
    theta = 0.5 * (hi + lo)
    delta = 0.5 * (hi - lo)
    sigma1 = theta / delta
    rho = 1.0 / sigma1
    p = (1.0 / theta) * (d * r)
    x = x + p
    for _ in range(degree - 1):
        r = b - matvec(x)
        w = d * r
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        p = (rho_new * rho) * p + (2.0 * rho_new / delta) * w
        x = x + p
        rho = rho_new
    return x


def relax_diag(matvec, r, x, b, d, num_it: int):
    """num_it sweeps of x += d.*r with the residual refreshed between sweeps.

    The residual is NOT refreshed after the final sweep (callers recompute).
    Flat (n, m) columns take a (n,) diagonal."""
    dcol = d[:, None] if x.ndim == 2 else d
    for _ in range(num_it - 1):
        x = x + dcol * r
        r = b - matvec(x)
    return x + dcol * r
