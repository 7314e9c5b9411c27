"""Preconditioned conjugate gradients (batched right-hand sides).

Counterpart of mgtpu/krylov/cg.py on (m, *space) fields: every scalar of
classical PCG becomes a per-RHS (m,) tensor, and converged columns are
frozen by masking.  The stop test runs on the card: the iterations run as
one recorded loop (krylov/_loop.py), as mgtpu runs a `lax.while_loop`.
"""
from __future__ import annotations

import torch

from ._layout import Layout, safe_div
from ._loop import history, iterate, rows_where, scalars

__all__ = ["pcg"]


def pcg(matvec, b, prec=None, x0=None, tol: float = 1e-6,
        max_iter: int = 100, *, device_loop: bool = True, cache=None,
        reduce=None):
    """Solve A x = b (A HPD) with preconditioned CG.

    b: (m, *space).  Returns (x, info) with info = dict(iters, relres (m,),
    resvec (max_iter+1, m)).  `device_loop` and `cache` are
    krylov/_loop.py's `iterate` arguments; `reduce` sums the inner products
    over the ranks of a sharded b (krylov/_layout.py)."""
    M = (lambda r: r) if prec is None else prec
    lay = Layout(b, reduce)
    X = torch.zeros_like(b) if x0 is None else x0

    def init(b, X, tol, maxit):
        bnorm = torch.clamp(lay.norm(b), min=1e-300)
        R = b - matvec(X)
        Z = M(R)
        rn = lay.norm(R)
        return (X, R, Z, lay.dot(R, Z), history(rn, max_iter),
                rn / bnorm >= tol, torch.zeros_like(maxit), bnorm, tol,
                maxit)

    def step(s):
        X, R, P, rz, resvec, active, k, bnorm, tol, maxit = s
        AP = matvec(P)
        alpha = safe_div(rz, lay.dot(P, AP))
        alpha = torch.where(active, alpha, torch.zeros_like(alpha))
        X = X + lay.scale(P, alpha)
        R = R - lay.scale(AP, alpha)
        rn = lay.norm(R)
        resvec = rows_where(resvec, k, rn)
        active = active & (rn / bnorm >= tol)
        Z = M(R)
        rz_new = lay.dot(R, Z)
        beta = torch.where(active, safe_div(rz_new, rz),
                           torch.zeros_like(rz_new))
        P = Z + lay.scale(P, beta)
        return X, R, P, rz_new, resvec, active, k + 1, bnorm, tol, maxit

    def go(s):
        return (s[6] < s[9]) & s[5].any()

    s, k = iterate(init, step, go, (0, 4, 5, 6),
                   scalars(b, X, tol, max_iter), count=6,
                   device_loop=device_loop, cache=cache,
                   static=("pcg", max_iter))
    X, resvec, bnorm = s[0], s[4], s[7]
    return X, {"iters": k, "relres": resvec[k] / bnorm, "resvec": resvec}
