"""(Flexible) restarted GMRES (batched right-hand sides).

Counterpart of mgtpu/krylov/fgmres.py on (m, *space) fields.  Each restart
runs `restart` Arnoldi steps with modified Gram-Schmidt per right-hand side
and solves the small least-squares problem through the regularised normal
equations (`ridge_solve`, which tolerates the rank-deficient H of a happy
breakdown); one restart is one recorded program (mgtpu's jitted
`_fgmres_cycle`), and the host checks the stop once per restart.  Right
preconditioning: flexible stores Z_i = M(v_i) and corrects with Z y;
non-flexible corrects with M(V y).

 * `fgmres`: independent per-RHS Arnoldi recurrences.
 * `block_fgmres`: the reference's block-diagonal trick (FGMRES.jl:51-53) —
   the whole (m, *space) field is one Krylov vector, so all right-hand
   sides share one space.
"""
from __future__ import annotations

import numpy as np
import torch

from ..cycle.capture import run
from ._layout import Layout

__all__ = ["fgmres", "block_fgmres"]


def _fgmres_cycle(matvec, prec, restart: int, X, B, reduce=None):
    """One restart cycle for all right-hand sides; returns the updated X
    and the per-RHS residual norms.  The Hessenberg matrix is built from
    reduced inner products, so every rank holds it whole and G and c need
    no reduction."""
    lay = Layout(B, reduce)
    m = lay.nbatch
    R = B - matvec(X)
    beta = lay.norm(R)
    inv_beta = 1.0 / torch.where(beta == 0, torch.ones_like(beta), beta)
    V = [lay.scale(R, inv_beta.to(B.dtype))]
    Z = []
    H = torch.zeros((restart + 1, restart, m), dtype=B.dtype, device=B.device)
    for i in range(restart):
        z = prec(V[i])
        Z.append(z)
        w = matvec(z)
        for l in range(i + 1):               # modified Gram-Schmidt
            h = lay.dot(V[l], w)
            H[l, i] = h
            w = w - lay.scale(V[l], h)
        hnorm = lay.norm(w)
        H[i + 1, i] = hnorm.to(B.dtype)
        inv_h = (1.0 / torch.where(hnorm == 0, torch.ones_like(hnorm),
                                   hnorm)).to(B.dtype)
        V.append(lay.scale(w, inv_h))
    # min || beta e1 - H y || per RHS on the normal equations
    Hb = H.permute(2, 0, 1)                                 # (m, k+1, k)
    e1 = torch.zeros((m, restart + 1), dtype=B.dtype, device=B.device)
    e1[:, 0] = beta.to(B.dtype)
    G = torch.einsum("mki,mkj->mij", Hb.conj(), Hb)
    c = torch.einsum("mki,mk->mi", Hb.conj(), e1)
    y = ridge_solve(G, c)
    X = X + torch.einsum("m...k,mk->m...", torch.stack(Z, dim=-1), y)
    return X, lay.norm(B - matvec(X))


def ridge_solve(G, c):
    """y = (G + reg I)^-1 c for a batch of Hermitian positive semidefinite
    normal-equation blocks G (m, k, k), reg = eps mean(diag G) / k + 1e-30.

    It stands for mgtpu's pinv(G, rtol=1e-12), whose SVD checks its result
    on the host and so cannot be recorded.  The ridge is below the LU's own
    rounding (its backward error is about k eps ||G||), so a regular G
    solves as without it; the singular G of an exact happy breakdown (zero
    rows and columns, c zero there) gets y zero there, as from the pinv."""
    k = G.shape[-1]
    reg = torch.finfo(G.dtype).eps / k ** 2 * torch.diagonal(
        G, dim1=-2, dim2=-1).sum(-1).real + 1e-30
    eye = torch.eye(k, dtype=G.dtype, device=G.device)
    return torch.linalg.solve_ex(G + reg[:, None, None] * eye,
                                 c[..., None])[0][..., 0]


def _restart_program(ctx, X, B):
    """One restart: (F)GMRES on X, B; the updated X and its residual norms."""
    matvec, M, restart, flexible, reduce = ctx
    if flexible:
        return _fgmres_cycle(matvec, M, restart, X, B, reduce)
    # right-preconditioned standard GMRES: solve (A M) u = r, x += M u
    Xp, _ = _fgmres_cycle(lambda v: matvec(M(v)), lambda v: v, restart,
                          torch.zeros_like(X), B - matvec(X), reduce)
    X = X + M(Xp)
    return X, Layout(B, reduce).norm(B - matvec(X))


def fgmres(matvec, b, restart: int = 5, prec=None, x0=None,
           tol: float = 1e-6, max_iter: int = 10, flexible: bool = True,
           verbose: bool = False, *, device_loop: bool = True, cache=None,
           reduce=None):
    """Restarted (F)GMRES on b (m, *space): at most max_iter restarts of
    `restart` inner steps; stops once max over RHS of ||r|| / max ||b||
    falls below tol.  Each restart is one recorded program (capture.run;
    `cache` = (owner, key, keep) as in krylov/_loop.py's `iterate`, key
    determining matvec and prec; `device_loop=False` runs it eagerly); the
    host reads the residuals once a restart, as mgtpu does.  `reduce` sums
    the inner products over the ranks of a sharded b (krylov/_layout.py)."""
    M = (lambda r: r) if prec is None else prec
    X = torch.zeros_like(b) if x0 is None else x0
    lay = Layout(b, reduce)
    owner, key, keep = cache if cache is not None else (None, (), ())
    bnorm = max(float(torch.max(lay.norm(b))), 1e-300)
    resvec = [lay.norm(b - matvec(X)).cpu().numpy()]
    iters = 0
    rel = float("inf")
    ctx = (matvec, M, restart, flexible, reduce)
    for outer in range(max_iter):
        X, rn = (run(owner, (key, "fgmres", restart, flexible),
                     _restart_program, ctx, X, b, keep=keep)
                 if device_loop else _restart_program(ctx, X, b))
        iters += 1
        resvec.append(rn.cpu().numpy())
        rel = float(torch.max(rn)) / bnorm
        if verbose:
            print(f"fgmres restart {outer + 1}: relres {rel:.3e}")
        if rel < tol:
            break
    return X, {"iters": iters, "relres": rel, "resvec": np.array(resvec)}


def block_fgmres(matvec, b, restart: int = 5, prec=None, x0=None,
                 tol: float = 1e-6, max_iter: int = 10, flexible: bool = True,
                 verbose: bool = False, *, device_loop: bool = True,
                 cache=None, reduce=None):
    """Block FGMRES (FGMRES.jl:51-53): the whole (m, *space) field is ONE
    Krylov vector, so every right-hand side shares a single space."""
    blk_mv = lambda v: matvec(v[0])[None]
    blk_prec = None if prec is None else (lambda v: prec(v[0])[None])
    x0b = None if x0 is None else x0[None]
    xb, info = fgmres(blk_mv, b[None], restart, blk_prec, x0b, tol,
                      max_iter, flexible, verbose, device_loop=device_loop,
                      cache=cache, reduce=reduce)
    return xb[0], info
