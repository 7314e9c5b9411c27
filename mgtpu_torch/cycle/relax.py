"""Relaxation states and smoothers (torch).

Counterpart of mgtpu/cycle/relax.py: damped Jacobi / SPAI(0) diagonal
relaxation, the first- and fourth-kind Chebyshev smoothers, damped line
Jacobi (single-axis and alternating-direction), and the FGMRES projection
that is both the Jac-GMRES smoother and the K-cycle accelerator.
The pointwise smoothers work on any tensor shape `d` broadcasts against
(grid fields (m, *grid) with a grid-shaped `d`).  Line corrections run the
tridiagonal line kernel of ops/cuda/tridiag.py (its plain version on the
CPU).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ..ops.cuda import tridiag

__all__ = ["DiagRelax", "ChebyshevRelax", "LineRelax", "AltLineRelax",
           "chebyshev_smooth", "chebyshev4_smooth", "relax_diag",
           "fgmres_relaxation",
           "line_solve", "line_correct", "line_smooth"]


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


def fgmres_relaxation(matvec, prec, r0, x0, inner: int, reduce=None):
    """Minimal-residual correction over the preconditioned Krylov subspace
    (the reference's FGMRES_relaxation, FGMRES.jl:40-126).

    Returns x0 + Z t with Z = [M r0, M A M r0, ...] (`inner` vectors) and
    t = argmin ||r0 - (A Z) t||_2 over the flattened block system: the m
    right-hand sides share one subspace (FGMRES.jl:51-53).  The projection
    is a Tikhonov-regularised solve of the normal equations, the form mgtpu
    uses in place of the reference's pinv.

    `reduce` (mgtpu's `axis_name`): when the operands are this rank's row
    blocks of partitioned vectors, the Gram matrix G = (AZ)^H AZ and the
    right-hand side c = (AZ)^H r0 are this rank's partial sums;
    reduce(t) returns the sum of t over the ranks (`RankGrid.psum`) and is
    called once, on G and c stacked as one (inner, inner + 1) tensor.  The
    regularisation is taken from the summed G, so every rank solves the
    same projection.  Rows outside the operator (a zero pad) must hold
    zeros."""
    zs, azs = [], []
    w = r0
    for j in range(inner):
        z = prec(r0 if j == 0 else w)
        w = matvec(z)
        zs.append(z.reshape(-1))
        azs.append(w.reshape(-1))
    Z = torch.stack(zs, dim=1)          # (n*m, inner)
    AZ = torch.stack(azs, dim=1)
    G = AZ.conj().T @ AZ                # (inner, inner) normal equations
    c = AZ.conj().T @ r0.reshape(-1)
    k = G.shape[0]
    if reduce is not None:              # row blocks: the global sums
        Gc = reduce(torch.cat([G, c[:, None]], dim=1))
        G, c = Gc[:, :k], Gc[:, k]
    reg = (8 * k) * torch.finfo(G.dtype).eps * (
        torch.diagonal(G).sum().real / k + 1e-30)
    t = torch.linalg.solve_ex(
        G + reg * torch.eye(k, dtype=G.dtype, device=G.device), c)[0]
    return x0 + (Z @ t).reshape(x0.shape)


@dataclass(frozen=True, eq=False)
class LineRelax:
    """Damped line-Jacobi smoother state: x += omega * T^-1 r, with T the
    tridiagonal part of A along one grid axis.

    The Thomas pivots depend only on the matrix and are computed on the host
    at setup (setup/smoothers.py::line_prec); each application runs two
    first-order linear recurrences along the line axis:
        forward:  y_i = alpha_i y_{i-1} + pivot_i r_i
        backward: s_i = y_i - cprime_i s_{i+1}

    alpha  = -pivot * sub   (grid-shaped, zero at line starts)
    pivot  = 1 / (diag - sub * cprime_{i-1})
    cprime = super * pivot  (zero at line ends)
    axis   = grid axis of the lines; omega = damping.
    The arrays are host numpy at setup and tensors in a device hierarchy."""
    alpha: Any
    pivot: Any
    cprime: Any
    axis: int
    omega: float


@dataclass(frozen=True, eq=False)
class AltLineRelax:
    """Alternating-direction line Jacobi: one damped T_axis^-1 correction per
    grid axis per smoothing step, the residual refreshed between directions.
    For operators whose strong axis varies over the domain, where one line
    axis stalls."""
    lines: tuple  # one LineRelax per grid axis


def line_solve(lr: LineRelax, r, omega: float = 1.0):
    """omega * T^-1 r for grid fields r of shape (..., *grid)."""
    return tridiag.line_apply("solve", lr.alpha, lr.pivot, lr.cprime,
                              lr.axis, r, omega=omega)


def line_correct(lr: LineRelax, r, x):
    """x + lr.omega * T^-1 r, the damped add folded into the kernel's
    backward pass."""
    return tridiag.line_apply("correct", lr.alpha, lr.pivot, lr.cprime,
                              lr.axis, r, x=x, omega=lr.omega)


def line_smooth(matvec, lr, r, x, b, nu: int, x_zero: bool = False):
    """nu sweeps of x += omega * T^-1 r with refreshed residuals.

    `lr` is a LineRelax (one axis) or an AltLineRelax (every axis in turn
    each sweep).  The residual is NOT refreshed after the final correction
    (callers recompute), as in relax_diag; nu == 0 returns x.  `x_zero`
    declares x to be exactly zero: the first correction is then
    omega * T^-1 r, which does not read x (0 + v == v, so the result is
    the same)."""
    corrs = lr.lines if isinstance(lr, AltLineRelax) else (lr,)
    steps = [c for _ in range(nu) for c in corrs]
    for k, c in enumerate(steps):
        if k:
            r = b - matvec(x)
        x = (line_solve(c, r, c.omega) if k == 0 and x_zero
             else line_correct(c, r, x))
    return x
