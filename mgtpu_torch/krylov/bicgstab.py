"""Preconditioned BiCGSTAB (batched right-hand sides).

Counterpart of mgtpu/krylov/bicgstab.py on (m, *space) fields: per-RHS
scalar recurrences with convergence masking, left preconditioning (the
multigrid cycle as M1).  One device sync per iteration (the stop test).
"""
from __future__ import annotations

import torch

from ._layout import Layout, safe_div

__all__ = ["bicgstab"]


def bicgstab(matvec, b, prec=None, x0=None, tol: float = 1e-6,
             max_iter: int = 100):
    """Solve A x = b with preconditioned BiCGSTAB; b: (m, *space)."""
    M = (lambda r: r) if prec is None else prec
    lay = Layout(b)
    X = torch.zeros_like(b) if x0 is None else x0
    bnorm = torch.clamp(lay.norm(b), min=1e-300)
    R = b - matvec(X)
    Rhat = R
    resvec = torch.zeros((max_iter + 1, lay.nbatch), dtype=bnorm.dtype,
                         device=b.device)
    resvec[0] = lay.norm(R)
    ones = torch.ones((lay.nbatch,), dtype=b.dtype, device=b.device)
    P = V = torch.zeros_like(b)
    rho = alpha = omega = ones
    active = resvec[0] / bnorm >= tol
    k = 0
    while k < max_iter and bool(active.any()):
        rho_new = lay.dot(Rhat, R)
        beta = safe_div(rho_new * alpha, rho * omega)
        P = R + lay.scale(P - lay.scale(V, omega), beta)
        Ph = M(P)
        V = matvec(Ph)
        alpha = safe_div(rho_new, lay.dot(Rhat, V))
        S = R - lay.scale(V, alpha)
        Sh = M(S)
        T = matvec(Sh)
        omega = safe_div(lay.dot(T, S), lay.dot(T, T))
        upd = lay.scale(Ph, alpha) + lay.scale(Sh, omega)
        X = X + lay.scale(upd, active.to(b.dtype))
        R = S - lay.scale(T, omega)
        rn = lay.norm(R)
        resvec[k + 1] = torch.where(active, rn, resvec[k])
        active = active & (rn / bnorm >= tol)
        rho = rho_new
        k += 1
    return X, {"iters": k, "relres": resvec[k] / bnorm, "resvec": resvec}
