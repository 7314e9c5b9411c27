"""Shared-Krylov-space block CG and block BiCGSTAB.

Counterpart of mgtpu/krylov/block.py on (m, *space) fields: all right-hand
sides share ONE Krylov space (the reference's blockCG / blockBiCGSTB
dispatch), at the price of m x m Gram solves per iteration.  The m x m
coefficient blocks act on the RHS axis (Layout.mix); the Gram solves use a
Tikhonov-guarded explicit solve, because converged or dependent columns
make the Gram blocks singular.

 * block_pcg       — O'Leary block CG (D. O'Leary, LAA 29, 1980).
 * block_bicgstab  — Bl-BiCGSTAB (El Guennouni, Jbilou, Sadok, ETNA 16,
                     2003), preconditioned in the same positions as
                     krylov.bicgstab.
One device sync per iteration (the stop test).
"""
from __future__ import annotations

import torch

from ._layout import Layout

__all__ = ["block_pcg", "block_bicgstab"]


def _guarded_solve(G, Y):
    """Solve G S = Y for the m x m coefficient block, with a relative ridge
    so converged (near-dependent) columns do not blow up the block step."""
    m = G.shape[0]
    scale = torch.clamp(torch.max(torch.abs(G)), min=1e-300)
    eps = 1e-7 if G.dtype in (torch.float32, torch.complex64) else 1e-14
    Gr = G + (eps * scale) * torch.eye(m, dtype=G.dtype, device=G.device)
    return torch.linalg.solve_ex(Gr, Y)[0]


def _stopped(resvec, k, bnorm, tol) -> bool:
    return bool(torch.max(resvec[k] / bnorm) < tol)


def block_pcg(matvec, b, prec=None, x0=None, tol: float = 1e-6,
              max_iter: int = 100):
    """Block preconditioned CG: solve A X = B (A HPD) with one shared space.

    b: (m, *space).  Returns (x, info) with info = dict(iters, relres (m,),
    resvec (max_iter+1, m))."""
    M = (lambda r: r) if prec is None else prec
    lay = Layout(b)
    X = torch.zeros_like(b) if x0 is None else x0
    bnorm = torch.clamp(lay.norm(b), min=1e-300)
    R = b - matvec(X)
    P = M(R)
    S = lay.gram(R, P)
    resvec = torch.zeros((max_iter + 1, lay.nbatch), dtype=bnorm.dtype,
                         device=b.device)
    resvec[0] = lay.norm(R)
    k = 0
    while k < max_iter and not _stopped(resvec, k, bnorm, tol):
        Q = matvec(P)
        alpha = _guarded_solve(lay.gram(P, Q), S)
        X = X + lay.mix(P, alpha)
        R = R - lay.mix(Q, alpha)
        resvec[k + 1] = lay.norm(R)
        Z = M(R)
        S_new = lay.gram(R, Z)
        beta = _guarded_solve(S, S_new)
        P = Z + lay.mix(P, beta)
        S = S_new
        k += 1
    return X, {"iters": k, "relres": resvec[k] / bnorm, "resvec": resvec}


def block_bicgstab(matvec, b, prec=None, x0=None, tol: float = 1e-6,
                   max_iter: int = 100):
    """Bl-BiCGSTAB: solve A X = B (general A) with one shared block space;
    omega is the scalar trace-minimising stabilisation of the block
    variant."""
    M = (lambda r: r) if prec is None else prec
    lay = Layout(b)
    X = torch.zeros_like(b) if x0 is None else x0
    bnorm = torch.clamp(lay.norm(b), min=1e-300)
    R = b - matvec(X)
    Rhat = R
    P = R
    resvec = torch.zeros((max_iter + 1, lay.nbatch), dtype=bnorm.dtype,
                         device=b.device)
    resvec[0] = lay.norm(R)
    k = 0
    while k < max_iter and not _stopped(resvec, k, bnorm, tol):
        Ph = M(P)
        V = matvec(Ph)
        G = lay.gram(Rhat, V)
        alpha = _guarded_solve(G, lay.gram(Rhat, R))
        S = R - lay.mix(V, alpha)
        Sh = M(S)
        T = matvec(Sh)
        ts = torch.sum(T.conj() * S)
        tt = torch.clamp(torch.sum(T.conj() * T).real, min=1e-300)
        omega = ts / tt
        X = X + lay.mix(Ph, alpha) + omega * Sh
        R = S - omega * T
        resvec[k + 1] = lay.norm(R)
        beta = _guarded_solve(G, -lay.gram(Rhat, T))
        P = R + lay.mix(P - omega * V, beta)
        k += 1
    return X, {"iters": k, "relres": resvec[k] / bnorm, "resvec": resvec}
