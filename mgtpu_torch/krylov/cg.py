"""Preconditioned conjugate gradients (batched right-hand sides).

Counterpart of mgtpu/krylov/cg.py on (m, *space) fields: every scalar of
classical PCG becomes a per-RHS (m,) tensor, and converged columns are
frozen by masking.  The loop runs on the host with one device sync per
iteration (the stop test), where mgtpu compiles a `lax.while_loop`.
"""
from __future__ import annotations

import torch

from ._layout import Layout, safe_div

__all__ = ["pcg"]


def pcg(matvec, b, prec=None, x0=None, tol: float = 1e-6,
        max_iter: int = 100):
    """Solve A x = b (A HPD) with preconditioned CG.

    b: (m, *space).  Returns (x, info) with info = dict(iters, relres (m,),
    resvec (max_iter+1, m))."""
    M = (lambda r: r) if prec is None else prec
    lay = Layout(b)
    X = torch.zeros_like(b) if x0 is None else x0
    bnorm = torch.clamp(lay.norm(b), min=1e-300)
    R = b - matvec(X)
    Z = M(R)
    P = Z
    rz = lay.dot(R, Z)
    resvec = torch.zeros((max_iter + 1, lay.nbatch), dtype=bnorm.dtype,
                         device=b.device)
    resvec[0] = lay.norm(R)
    active = resvec[0] / bnorm >= tol
    k = 0
    while k < max_iter and bool(active.any()):
        AP = matvec(P)
        alpha = safe_div(rz, lay.dot(P, AP))
        alpha = torch.where(active, alpha, torch.zeros_like(alpha))
        X = X + lay.scale(P, alpha)
        R = R - lay.scale(AP, alpha)
        rn = lay.norm(R)
        resvec[k + 1] = rn
        active = active & (rn / bnorm >= tol)
        Z = M(R)
        rz_new = lay.dot(R, Z)
        beta = torch.where(active, safe_div(rz_new, rz),
                           torch.zeros_like(rz_new))
        P = Z + lay.scale(P, beta)
        rz = rz_new
        k += 1
    return X, {"iters": k, "relres": resvec[k] / bnorm, "resvec": resvec}
