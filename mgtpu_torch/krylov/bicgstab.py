"""Preconditioned BiCGSTAB (batched right-hand sides).

Counterpart of mgtpu/krylov/bicgstab.py on (m, *space) fields: per-RHS
scalar recurrences with convergence masking, left preconditioning (the
multigrid cycle as M1).  The stop test runs on the card, the iterations as
one recorded loop (krylov/_loop.py).
"""
from __future__ import annotations

import torch

from ._layout import Layout, safe_div
from ._loop import history, iterate, rows_where, scalars

__all__ = ["bicgstab"]


def bicgstab(matvec, b, prec=None, x0=None, tol: float = 1e-6,
             max_iter: int = 100, *, device_loop: bool = True, cache=None,
             reduce=None):
    """Solve A x = b with preconditioned BiCGSTAB; b: (m, *space).
    `device_loop` and `cache` are krylov/_loop.py's `iterate` arguments;
    `reduce` sums the inner products over the ranks of a sharded b."""
    M = (lambda r: r) if prec is None else prec
    lay = Layout(b, reduce)
    X = torch.zeros_like(b) if x0 is None else x0

    def init(b, X, tol, maxit):
        bnorm = torch.clamp(lay.norm(b), min=1e-300)
        R = b - matvec(X)
        rn = lay.norm(R)
        ones = torch.ones((lay.nbatch,), dtype=b.dtype, device=b.device)
        zero = torch.zeros_like(b)
        return (X, R, R, zero, zero, ones, ones, ones, history(rn, max_iter),
                rn, rn / bnorm >= tol, torch.zeros_like(maxit), bnorm, tol,
                maxit)

    def step(s):
        (X, R, Rhat, P, V, rho, alpha, omega, resvec, cur, active, k,
         bnorm, tol, maxit) = s
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
        cur = torch.where(active, rn, cur)
        resvec = rows_where(resvec, k, cur)
        active = active & (rn / bnorm >= tol)
        return (X, R, Rhat, P, V, rho_new, alpha, omega, resvec, cur,
                active, k + 1, bnorm, tol, maxit)

    def go(s):
        return (s[11] < s[14]) & s[10].any()

    s, k = iterate(init, step, go, (0, 8, 9, 10, 11),
                   scalars(b, X, tol, max_iter), count=11,
                   device_loop=device_loop, cache=cache,
                   static=("bicgstab", max_iter))
    X, resvec, bnorm = s[0], s[8], s[12]
    return X, {"iters": k, "relres": resvec[k] / bnorm, "resvec": resvec}
