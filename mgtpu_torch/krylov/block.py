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
The stop test runs on the card, the iterations as one recorded loop
(krylov/_loop.py).
"""
from __future__ import annotations

import torch

from ._layout import Layout
from ._loop import history, iterate, rows_where, scalars

__all__ = ["block_pcg", "block_bicgstab"]


def _guarded_solve(G, Y):
    """Solve G S = Y for the m x m coefficient block, with a relative ridge
    so converged (near-dependent) columns do not blow up the block step."""
    m = G.shape[0]
    scale = torch.clamp(torch.max(torch.abs(G)), min=1e-300)
    eps = 1e-7 if G.dtype in (torch.float32, torch.complex64) else 1e-14
    Gr = G + (eps * scale) * torch.eye(m, dtype=G.dtype, device=G.device)
    return torch.linalg.solve_ex(Gr, Y)[0]


def _go(s, k, cur, bnorm, tol, maxit):
    """The block loops' condition: below max_iter and not every column
    below tol."""
    return (s[k] < s[maxit]) & ~(torch.max(s[cur] / s[bnorm]) < s[tol])


def block_pcg(matvec, b, prec=None, x0=None, tol: float = 1e-6,
              max_iter: int = 100, *, device_loop: bool = True,
              cache=None, reduce=None):
    """Block preconditioned CG: solve A X = B (A HPD) with one shared space.

    b: (m, *space).  Returns (x, info) with info = dict(iters, relres (m,),
    resvec (max_iter+1, m)).  `device_loop` and `cache` are
    krylov/_loop.py's `iterate` arguments; `reduce` sums the Gram blocks
    and norms over the ranks of a sharded b (krylov/_layout.py)."""
    M = (lambda r: r) if prec is None else prec
    lay = Layout(b, reduce)
    X = torch.zeros_like(b) if x0 is None else x0

    def init(b, X, tol, maxit):
        bnorm = torch.clamp(lay.norm(b), min=1e-300)
        R = b - matvec(X)
        P = M(R)
        rn = lay.norm(R)
        return (X, R, P, lay.gram(R, P), history(rn, max_iter), rn,
                torch.zeros_like(maxit), bnorm, tol, maxit)

    def step(s):
        X, R, P, S, resvec, cur, k, bnorm, tol, maxit = s
        Q = matvec(P)
        alpha = _guarded_solve(lay.gram(P, Q), S)
        X = X + lay.mix(P, alpha)
        R = R - lay.mix(Q, alpha)
        cur = lay.norm(R)
        resvec = rows_where(resvec, k, cur)
        Z = M(R)
        S_new = lay.gram(R, Z)
        beta = _guarded_solve(S, S_new)
        P = Z + lay.mix(P, beta)
        return X, R, P, S_new, resvec, cur, k + 1, bnorm, tol, maxit

    s, k = iterate(init, step, lambda s: _go(s, 6, 5, 7, 8, 9), (0, 4, 5, 6),
                   scalars(b, X, tol, max_iter), count=6,
                   device_loop=device_loop, cache=cache,
                   static=("block_pcg", max_iter))
    X, resvec, bnorm = s[0], s[4], s[7]
    return X, {"iters": k, "relres": resvec[k] / bnorm, "resvec": resvec}


def block_bicgstab(matvec, b, prec=None, x0=None, tol: float = 1e-6,
                   max_iter: int = 100, *, device_loop: bool = True,
                   cache=None, reduce=None):
    """Bl-BiCGSTAB: solve A X = B (general A) with one shared block space;
    omega is the scalar trace-minimising stabilisation of the block
    variant.  `device_loop` and `cache` are krylov/_loop.py's `iterate`
    arguments; `reduce` sums the Gram blocks, norms and omega's two sums
    over the ranks of a sharded b."""
    M = (lambda r: r) if prec is None else prec
    lay = Layout(b, reduce)
    X = torch.zeros_like(b) if x0 is None else x0

    def init(b, X, tol, maxit):
        bnorm = torch.clamp(lay.norm(b), min=1e-300)
        R = b - matvec(X)
        rn = lay.norm(R)
        return (X, R, R, R, history(rn, max_iter), rn,
                torch.zeros_like(maxit), bnorm, tol, maxit)

    def step(s):
        X, R, Rhat, P, resvec, cur, k, bnorm, tol, maxit = s
        Ph = M(P)
        V = matvec(Ph)
        G = lay.gram(Rhat, V)
        alpha = _guarded_solve(G, lay.gram(Rhat, R))
        S = R - lay.mix(V, alpha)
        Sh = M(S)
        T = matvec(Sh)
        ts = lay.sum(torch.sum(T.conj() * S))
        tt = torch.clamp(lay.sum(torch.sum(T.conj() * T).real), min=1e-300)
        omega = ts / tt
        X = X + lay.mix(Ph, alpha) + omega * Sh
        R = S - omega * T
        cur = lay.norm(R)
        resvec = rows_where(resvec, k, cur)
        beta = _guarded_solve(G, -lay.gram(Rhat, T))
        P = R + lay.mix(P - omega * V, beta)
        return X, R, Rhat, P, resvec, cur, k + 1, bnorm, tol, maxit

    s, k = iterate(init, step, lambda s: _go(s, 6, 5, 7, 8, 9), (0, 4, 5, 6),
                   scalars(b, X, tol, max_iter), count=6,
                   device_loop=device_loop, cache=cache,
                   static=("block_bicgstab", max_iter))
    X, resvec, bnorm = s[0], s[4], s[7]
    return X, {"iters": k, "relres": resvec[k] / bnorm, "resvec": resvec}
