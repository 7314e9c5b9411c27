"""Recursive multigrid cycle of the flat engine (ELL/DIA levels).

Counterpart of mgtpu/cycle/cycle.py: pre-smooth, restrict the
residual, solve or recurse on the coarse level (V once, W twice, F as F
then V, K as a `kcycle_inner`-step FGMRES preconditioned by the coarser
cycle), prolongate-correct, post-smooth.  Vectors are flat columns
(n, m).  A `GridHierarchy` goes to the grid engine through its flat
adapter (grid_cycle.grid_cycle_flat), a `SystemsGridHierarchy` to the
systems engine through its own (systems_grid.systems_grid_cycle_flat).
Vanka levels smooth with cycle/vanka.py's sweeps, hybrid-Kaczmarz levels
with cycle/kaczmarz.py's (kernel F).  `cycle_jit` /
`make_cycle_fn` run one cycle as a recorded program (capture.py), mgtpu's
jitted cycle.
"""
from __future__ import annotations

import functools

import torch

from .capture import run, static_config
from .kaczmarz import kaczmarz_sweep
from .relax import (chebyshev4_smooth, chebyshev_smooth, fgmres_relaxation,
                    relax_diag)
from .vanka import VankaRelax, vanka_sweep

__all__ = ["recursive_cycle", "cycle_jit", "make_cycle_fn"]


def _smooth(cfg, level, r, x, b, nu: int, matvec, reduce=None):
    """One smoothing stage (reference MGcycle.jl:46-55); `reduce` the
    hierarchy's (Jac-GMRES's Gram sums over the ranks)."""
    if nu <= 0:
        return x
    rt = cfg.relax_type
    if rt == "jac-gmres":
        d = level.relax.d[:, None]
        return fgmres_relaxation(matvec, lambda v: d * v, r, x, nu, reduce)
    if rt == "chebyshev":
        return chebyshev_smooth(matvec, level.relax.d[:, None],
                                level.relax.lam_max, cfg.cheby_degree * nu,
                                cfg.cheby_frac, r, x, b)
    if rt == "chebyshev4":
        return chebyshev4_smooth(matvec, level.relax.d[:, None],
                                 level.relax.lam_max, cfg.cheby_degree * nu,
                                 r, x)
    if rt == "line-jacobi":
        raise ValueError("line-jacobi is a grid-engine smoother (regular "
                         "meshes with full-weighting transfers)")
    if isinstance(level.relax, VankaRelax):
        return vanka_sweep(x, b, level.relax, nu)
    if rt == "hybrid-kaczmarz":
        return kaczmarz_sweep(x, b, level.relax, nu * level.relax.num_it)
    return relax_diag(matvec, r, x, b, level.relax.d, nu)


def recursive_cycle(cfg, hier, b, x, level: int = 0,
                    ctype: str | None = None, x_zero: bool = False):
    """One multigrid cycle at `level`; b, x are (n, m) tensors.

    `x_zero` declares the incoming iterate exactly zero (every coarse-level
    entry, and the refined solve's correction cycles): the entry residual
    is b itself and the r = b - A*0 matvec is skipped."""
    from .grid_cycle import GridHierarchy, grid_cycle_flat
    if isinstance(hier, GridHierarchy):
        return grid_cycle_flat(cfg, hier, b, x, ctype, x_zero=x_zero)
    from .systems_grid import SystemsGridHierarchy, systems_grid_cycle_flat
    if isinstance(hier, SystemsGridHierarchy):
        return systems_grid_cycle_flat(cfg, hier, b, x, ctype, x_zero=x_zero)
    ctype = cfg.cycle_type if ctype is None else ctype
    if ctype not in ("V", "W", "F", "K"):
        raise NotImplementedError(f"cycle type {ctype!r} not yet ported")
    nlev = len(hier.levels)
    if level == nlev - 1:
        return hier.coarse.solve(b)

    lvl = hier.levels[level]
    matvec = lvl.A.matvec
    r = b if x_zero else b - matvec(x)
    x = _smooth(cfg, lvl, r, x, b, cfg.nu_pre[level], matvec, hier.reduce)
    r = b - matvec(x) if cfg.nu_pre[level] > 0 or not x_zero else b
    bc = lvl.R.matvec(r)
    xc0 = torch.zeros((lvl.R.shape[0], b.shape[1]), dtype=b.dtype,
                      device=b.device)
    if level == nlev - 2:
        xc = hier.coarse.solve(bc)
    elif ctype == "K":
        prec = lambda v: recursive_cycle(cfg, hier, v, torch.zeros_like(v),
                                         level + 1, "K", x_zero=True)
        xc = fgmres_relaxation(hier.levels[level + 1].A.matvec, prec, bc,
                               xc0, cfg.kcycle_inner, hier.reduce)
    else:
        xc = recursive_cycle(cfg, hier, bc, xc0, level + 1, ctype,
                             x_zero=True)
        if ctype == "W":
            xc = recursive_cycle(cfg, hier, bc, xc, level + 1, "W")
        elif ctype == "F":
            xc = recursive_cycle(cfg, hier, bc, xc, level + 1, "V")

    x = x + lvl.P.matvec(xc)
    r = b - matvec(x)
    return _smooth(cfg, lvl, r, x, b, cfg.nu_post[level], matvec,
                   hier.reduce)


def _cycle_program(ctx, b, x):
    cfg, hier, x_zero = ctx
    return recursive_cycle(cfg, hier, b, x, x_zero=x_zero)


def cycle_jit(cfg, hier, b, x, x_zero: bool = False):
    """One cycle on (n, m) columns as a recorded program (mgtpu's jitted
    cycle; capture.py): a CUDA graph replayed on the card, recorded on
    first use per shape, dtype and `x_zero`; `recursive_cycle` itself on
    the CPU."""
    return run(hier, ("cycle", static_config(cfg), bool(x_zero)),
               _cycle_program,
               (cfg, hier, bool(x_zero)), b, x)


def make_cycle_fn(cfg):
    """One recorded cycle closed over the configuration:
    fn(hier, b, x, x_zero)."""
    return functools.partial(cycle_jit, cfg)
