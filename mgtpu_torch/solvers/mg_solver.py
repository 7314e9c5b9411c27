"""Stand-alone multigrid solve drivers.

Counterpart of `solve_mg` and `solve_mg_refined` in
mgtpu/solvers/mg_solver.py, on the grid engine:

 * `solve_mg` iterates cycles with a relative-tolerance stop checked every
   cycle, a divergence stop at 1e3 * res0, and the residual history.
 * `solve_mg_refined` is mixed-precision iterative refinement: the residual
   b - A x in native float64 against the ORIGINAL operator (`A_input`), the
   correction one cycle of the (float32) hierarchy from a zero guess;
   `fmg=True` starts from one full-multigrid pass instead of zero.

Both run on the state's device and return torch tensors there.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..config import torch_dtype
from ..cycle.grid_cycle import grid_cycle, grid_fmg
from ..ops.grid_stencil import flat_to_grid, grid_to_flat, make_grid_stencil
from ..setup.hierarchy import MGState

__all__ = ["solve_mg", "solve_mg_refined"]


def _as_2d(v: torch.Tensor):
    return (v[:, None], True) if v.ndim == 1 else (v, False)


def _norm(v: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(v))


def solve_mg(state: MGState, b, x=None, verbose: bool = False):
    """Iterate cycles until ||r||/||r0|| < relative_tol or max_outer_iter.

    b, x: (n,) or (n, m) arrays or tensors.  Returns (x, info) with x a
    tensor on the state's device and info = {"iters", "relres", "resvec"}.
    """
    t0 = time.perf_counter()
    cfg, gh, dev = state.config, state.hier, state.device
    dt = torch_dtype(cfg.dtype)
    b2, squeeze = _as_2d(torch.as_tensor(b, dtype=dt, device=dev))
    x2 = (torch.zeros_like(b2) if x is None
          else _as_2d(torch.as_tensor(x, dtype=dt, device=dev))[0])
    grid = gh.fine_grid
    matvec = gh.levels[0].A.matvec
    bv, xv = flat_to_grid(b2, grid), flat_to_grid(x2, grid)

    res0 = _norm(bv - matvec(xv)) if _norm(xv) > 0 else _norm(bv)
    res = res0
    resvec = [res0]
    iters = 0
    for count in range(cfg.max_outer_iter):
        xv = grid_cycle(cfg, gh, bv, xv)
        res_prev = res
        res = _norm(bv - matvec(xv))
        resvec.append(res)
        iters += 1
        if verbose:
            print(f"Cycle {count + 1} done with relres: {res / res0:.3e}. "
                  f"Convergence factor: {res / max(res_prev, 1e-300):.3f}")
        if res / max(res0, 1e-300) < cfg.relative_tol:
            break
        if not np.isfinite(res) or res > 1e3 * max(res0, 1e-300):
            break              # diverging
    state.n_iter += iters * b2.shape[1]
    state.time_solve += time.perf_counter() - t0
    x2 = grid_to_flat(xv)
    return (x2[:, 0] if squeeze else x2), {
        "iters": iters, "relres": res / max(res0, 1e-300),
        "resvec": np.array(resvec)}


def _high_precision_fine_op(state: MGState):
    """Float64 fine-level matvec of the ORIGINAL operator, cached on the
    state (the hierarchy's fine matrix was cast to the cycle dtype)."""
    if state._hi_op_cache is None:
        A_host = state.A_input if state.A_input is not None else state.As[0]
        grid = state.hier.fine_grid
        state._hi_op_cache = make_grid_stencil(
            A_host, list(reversed(grid)), dtype=np.float64,
            max_shift=(min(grid) - 1) // 2 if min(grid) < 7 else 3,
            device=state.device).matvec
    return state._hi_op_cache


def solve_mg_refined(state: MGState, b, x=None, tol: float = 1e-8,
                     max_iter: int | None = None, fmg: bool = False,
                     verbose: bool = False):
    """Iterative refinement x += Cycle(b - A x) to a float64 relative
    residual below `tol`.

    The residual is computed in native float64 against `A_input`; each
    correction is one cycle of the hierarchy (its own dtype) from a zero
    guess.  With `fmg` and no `x`, the iterate starts from one full
    multigrid pass on b (grid_fmg) instead of zero.  The loop stops at
    `tol`, at `max_iter` (default max_outer_iter), or once the residual
    exceeds 1e3 * ||b||.  Returns (x, info) with x a float64 tensor on the
    state's device."""
    t0 = time.perf_counter()
    cfg, gh, dev = state.config, state.hier, state.device
    cd = torch_dtype(cfg.dtype)
    if max_iter is None:
        max_iter = cfg.max_outer_iter
    b2, squeeze = _as_2d(torch.as_tensor(b, dtype=torch.float64, device=dev))
    x2 = (torch.zeros_like(b2) if x is None
          else _as_2d(torch.as_tensor(x, dtype=torch.float64, device=dev))[0])
    matvec_hi = _high_precision_fine_op(state)
    grid = gh.fine_grid
    bv, xv = flat_to_grid(b2, grid), flat_to_grid(x2, grid)
    if fmg and x is None:
        xv = grid_fmg(cfg, gh, bv.to(cd)).to(torch.float64)

    res0 = max(_norm(bv), 1e-300)
    r = bv - matvec_hi(xv)
    res = _norm(r)
    resvec = [res]
    iters = 0
    while iters < max_iter and tol * res0 <= res < 1e3 * res0:
        rl = r.to(cd)
        z = grid_cycle(cfg, gh, rl, torch.zeros_like(rl), x_zero=True)
        xv = xv + z.to(torch.float64)
        r = bv - matvec_hi(xv)
        res_prev, res = res, _norm(r)
        resvec.append(res)
        iters += 1
        if verbose:
            print(f"Refined cycle {iters} relres: {res / res0:.3e}. "
                  f"Factor: {res / max(res_prev, 1e-300):.3f}")
    state.n_iter += iters * b2.shape[1]
    state.time_solve += time.perf_counter() - t0
    x2 = grid_to_flat(xv)
    return (x2[:, 0] if squeeze else x2), {
        "iters": iters, "relres": res / res0, "resvec": np.array(resvec)}
