"""Solve-to-completion loops on the sharded grid and systems engines
(mgtpu/parallel/sharded_solve.py).

`ShardedGridSolver` runs over one sharded hierarchy
(parallel/grid_sharded.py, slab or pencil):

 * `solve_refined` — iterative refinement certified in native float64 (the
   port's rule since it left mgtpu's double-single arithmetic): a float64
   padded fine operator on each rank, its residual by kernel D in float64
   on the halo-extended block, the norms summed over the ranks in float64,
   one host read of the norm an iteration; each correction one float32
   cycle from zero;
 * `solve_fgmres`, `solve_cg`, `solve_bicgstab` (and their block forms) —
   the Krylov methods of krylov/ with their inner products summed over the
   ranks (`reduce`), the float64 operator outside and the float32 cycle as
   the preconditioner when b is float64 (mgtpu's `_krylov_ops`).

`ShardedSystemsSolver` runs over one sharded systems hierarchy
(parallel/systems_sharded.py): `solve_refined` in the same form, its
float64 residual the original operator's blocks padded and sharded like
the fine level and applied by kernel D's halo apply.

The loops run eagerly (`device_loop=False`): gloo's calls cannot be
recorded into a CUDA graph.  b and x cross the boundary as flat (n,) or
(n, m) arrays that every rank holds whole, as the single-device solves
take them; every rank returns the whole x.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import torch_dtype
from ..ops.grid_stencil import grid_stencil_from_csr
from ..solvers.mg_solver import cast_hierarchy, high_precision_fine_operator
from .grid_sharded import (ShardedGridStencil, _local, _pad_to, _radius,
                           make_grid_sharded_cycle)
from .systems_sharded import (make_systems_sharded_cycle,
                              pad_block_operator, shard_block_operator)

__all__ = ["ShardedGridSolver", "make_sharded_refined_solver",
           "ShardedSystemsSolver", "make_sharded_systems_solver"]


def _cycle_copy(solver, cycle_dtype):
    """(the sharded hierarchy a correction cycle in `cycle_dtype` runs, its
    torch type): the solver's own for the hierarchy's type, else its
    `cast_hierarchy` copy, made once and kept on the solver."""
    cd = torch_dtype(solver.cfg.dtype if cycle_dtype is None
                     else cycle_dtype)
    if cd == torch_dtype(solver.cfg.dtype):
        return solver.gh, cd
    lo = getattr(solver, "_lo", None)
    if lo is None or lo[0] != cd:
        solver._lo = lo = (cd, cast_hierarchy(solver.gh, cd))
    return lo[1], cd


class ShardedGridSolver:
    """Sharded solve-to-completion loops over one grid hierarchy, built
    once a (state, rank grid) on every rank, on `device` (default the
    rank's card)."""

    def __init__(self, state, comm, axes=(0,), device=None):
        cfg = state.config
        if np.dtype(cfg.dtype) != np.float32:
            raise ValueError("the sharded refined solver takes a float32 "
                             "hierarchy (its residual is float64)")
        self.state, self.cfg, self.comm = state, cfg, comm
        self.axes = tuple(axes)
        gh, cycle, to_grid, from_grid = make_grid_sharded_cycle(
            state, comm, self.axes, device)
        self.gh, self.cycle = gh, cycle
        self._to_grid, self._from_grid = to_grid, from_grid
        A0 = gh.levels[0].A
        self.device = A0.coeff.device
        self.true_grid = tuple(state.hier.fine_grid)
        divs = [1] * len(A0.grid)
        for ga, ra in A0.shard:
            divs[ga] = comm.axis_size(ra)
        self.pad_grid = tuple(s * d for s, d in zip(A0.grid, divs))
        self._A64 = None

    def f64_operator(self) -> ShardedGridStencil:
        """The ORIGINAL fine operator (`A_input`) in float64, padded and
        sharded like the cycle's fine level (made once)."""
        if self._A64 is None:
            st = self.state
            A_hi = st.A_input if st.A_input is not None else st.As[0]
            gs = grid_stencil_from_csr(A_hi, list(reversed(self.true_grid)),
                                       dtype=np.float64)
            A0 = self.gh.levels[0].A
            coeff = _pad_to(torch.as_tensor(gs.coeff), self.pad_grid,
                            range(1, len(self.pad_grid) + 1))
            coeff = _local(coeff, self.comm, A0.shard, 1).to(self.device)
            radius = tuple(_radius(gs.offsets, ga) for ga, _ in A0.shard)
            self._A64 = ShardedGridStencil(coeff, gs.offsets, A0.grid,
                                           self.comm, A0.shard, radius)
        return self._A64

    # -- fields ------------------------------------------------------------
    def to_grid(self, v, dtype=None):
        """(this rank's block (m, *block), squeeze) of a flat array."""
        squeeze = np.ndim(v) == 1
        return self._to_grid(v, dtype), squeeze

    def from_grid(self, xg, squeeze):
        x2 = self._from_grid(xg)
        return x2[:, 0] if squeeze else x2

    def _norm(self, v) -> float:
        """The global 2-norm over every column, summed over the ranks."""
        return float(torch.sqrt(self.comm.psum(torch.sum(v * v))))

    # -- refined solve -----------------------------------------------------
    def solve_refined(self, b, x=None, tol: float = 1e-8,
                      max_iter: int | None = None, cycle_dtype=None):
        """Refinement to a true float64 relative residual below `tol`, at
        most `max_iter` (default max_outer_iter) corrections, each one
        cycle from zero in `cycle_dtype` (default the hierarchy's float32;
        another type cycles a copy of the sharded hierarchy, as mgtpu's
        cycle_dtype); stops once the residual exceeds 1e3 ||b||.  Returns
        (x float64 numpy, info)."""
        cfg = self.cfg
        max_iter = cfg.max_outer_iter if max_iter is None else max_iter
        gh, cd = _cycle_copy(self, cycle_dtype)
        A64 = self.f64_operator()
        bv, squeeze = self.to_grid(b, torch.float64)
        xv = (torch.zeros_like(bv) if x is None
              else self.to_grid(x, torch.float64)[0])
        res0 = max(self._norm(bv), 1e-300)
        r = A64.residual(bv, xv)
        res = self._norm(r)
        resvec = [res]
        iters = 0
        while iters < max_iter and tol * res0 <= res < 1e3 * res0:
            rl = r.to(cd)
            z = self.cycle(gh, rl, torch.zeros_like(rl), True)
            xv = xv + z.to(torch.float64)
            r = A64.residual(bv, xv)
            res = self._norm(r)
            resvec.append(res)
            iters += 1
        x_np = self.from_grid(xv, squeeze).cpu().numpy()
        return x_np, {"iters": iters, "relres": res / res0,
                      "resvec": np.array(resvec)}

    # -- Krylov ------------------------------------------------------------
    def _krylov_ops(self, outer: torch.dtype):
        cd = torch_dtype(self.cfg.dtype)
        mixed = outer != cd
        matvec = (self.f64_operator().matvec if mixed
                  else self.gh.levels[0].A.matvec)

        def prec(r):
            rl = r.to(cd) if mixed else r
            z = self.cycle(self.gh, rl, torch.zeros_like(rl), True)
            return z.to(r.dtype) if mixed else z

        return matvec, prec

    def _solve_krylov(self, fn, b, x0, tol, max_iter, **kw):
        cfg = self.cfg
        bdt = np.asarray(b).dtype
        outer = torch_dtype(bdt if np.issubdtype(bdt, np.floating)
                            else cfg.dtype)
        bv, squeeze = self.to_grid(b, outer)
        xv = (torch.zeros_like(bv) if x0 is None
              else self.to_grid(x0, outer)[0])
        matvec, prec = self._krylov_ops(outer)
        tol = cfg.relative_tol if tol is None else tol
        max_iter = cfg.max_outer_iter if max_iter is None else max_iter
        x, info = fn(matvec, bv, prec=prec, x0=xv, tol=tol,
                     max_iter=max_iter, device_loop=False,
                     reduce=self.comm.psum, **kw)
        return self.from_grid(x, squeeze).cpu().numpy(), info

    def solve_fgmres(self, b, x0=None, tol=None, max_iter=None,
                     restart: int = 5, block: bool = False):
        from ..krylov.fgmres import block_fgmres, fgmres
        multi = np.ndim(b) > 1 and np.shape(b)[-1] > 1
        fn = block_fgmres if (block and multi) else fgmres
        return self._solve_krylov(fn, b, x0, tol, max_iter, restart=restart)

    def solve_cg(self, b, x0=None, tol=None, max_iter=None,
                 block: bool = False):
        from ..krylov.block import block_pcg
        from ..krylov.cg import pcg
        multi = np.ndim(b) > 1 and np.shape(b)[-1] > 1
        fn = block_pcg if (block and multi) else pcg
        return self._solve_krylov(fn, b, x0, tol, max_iter)

    def solve_bicgstab(self, b, x0=None, tol=None, max_iter=None,
                       block: bool = False):
        from ..krylov.bicgstab import bicgstab
        from ..krylov.block import block_bicgstab
        multi = np.ndim(b) > 1 and np.shape(b)[-1] > 1
        fn = block_bicgstab if (block and multi) else bicgstab
        return self._solve_krylov(fn, b, x0, tol, max_iter)


def make_sharded_refined_solver(state, comm, axes=(0,),
                                device=None) -> ShardedGridSolver:
    """The sharded end-to-end solver of a scalar grid MGState on this
    rank."""
    return ShardedGridSolver(state, comm, axes=axes, device=device)


# ---------------------------------------------------------------------------
# the systems (face-staggered) tier
# ---------------------------------------------------------------------------

class ShardedSystemsSolver:
    """The sharded refined solve of a systems (staggered) MGState, built
    once a (state, rank grid) on every rank, on `device` (default the
    rank's card).  mgtpu certifies with a double-single block residual;
    the port's residual is native float64 (ROADMAP item 11)."""

    def __init__(self, state, comm, device=None):
        cfg = state.config
        if np.dtype(cfg.dtype) != np.float32:
            raise ValueError("the sharded refined solver takes a float32 "
                             "hierarchy (its residual is float64)")
        self.state, self.cfg, self.comm = state, cfg, comm
        gh, cycle, to_fields, from_fields = make_systems_sharded_cycle(
            state, comm, device)
        self.gh, self.cycle = gh, cycle
        self._to_fields, self._from_fields = to_fields, from_fields
        A0 = gh.levels[0].A
        self.device = A0.coeffs[0].device
        self.true_grids = state.hier.fine_grids
        D = comm.axis_size(0)
        self.pad_grids = tuple((w * D,) + tuple(g[1:])
                               for w, g in zip(A0.layout.widths, A0.grids))
        # the original operator's blocks in float64 (the state's cached
        # one), padded along grid axis 0 like the fine level (zero pad
        # coefficients keep the pad inert) and sharded like it
        self.A64 = shard_block_operator(pad_block_operator(
            high_precision_fine_operator(state), self.pad_grids), comm,
            self.device)

    def to_fields(self, v, dtype=None):
        """(this rank's padded blocks, squeeze) of flat (n,) or (n, m)
        columns."""
        return self._to_fields(v, dtype), np.ndim(v) == 1

    def from_fields(self, xs, squeeze):
        x2 = self._from_fields(xs)
        return x2[:, 0] if squeeze else x2

    def _norm(self, v) -> float:
        """The global 2-norm over every component and column."""
        return float(torch.sqrt(self.comm.psum(sum(torch.sum(t * t)
                                                   for t in v))))

    def solve_refined(self, b, x=None, tol: float = 1e-8,
                      max_iter: int | None = None, cycle_dtype=None):
        """Refinement to a true float64 relative residual below `tol`, at
        most `max_iter` (default max_outer_iter) corrections, each one
        cycle from zero in `cycle_dtype` (default the hierarchy's: a copy
        of the sharded hierarchy otherwise); stops once the residual
        exceeds 1e3 ||b||.  b (n,) or (n, m); returns (x float64 numpy,
        info)."""
        cfg = self.cfg
        max_iter = cfg.max_outer_iter if max_iter is None else max_iter
        gh, cd = _cycle_copy(self, cycle_dtype)
        bv, squeeze = self.to_fields(b, torch.float64)
        xv = (tuple(torch.zeros_like(t) for t in bv) if x is None
              else self.to_fields(x, torch.float64)[0])
        res0 = max(self._norm(bv), 1e-300)
        r = tuple(p - q for p, q in zip(bv, self.A64.matvec(xv)))
        res = self._norm(r)
        resvec = [res]
        iters = 0
        while iters < max_iter and tol * res0 <= res < 1e3 * res0:
            rl = tuple(t.to(cd) for t in r)
            z = self.cycle(gh, rl, tuple(torch.zeros_like(t) for t in rl),
                           True)
            xv = tuple(p + q.to(torch.float64) for p, q in zip(xv, z))
            r = tuple(p - q for p, q in zip(bv, self.A64.matvec(xv)))
            res = self._norm(r)
            resvec.append(res)
            iters += 1
        x_np = self.from_fields(xv, squeeze).cpu().numpy()
        return x_np, {"iters": iters, "relres": res / res0,
                      "resvec": np.array(resvec)}


def make_sharded_systems_solver(state, comm,
                                device=None) -> ShardedSystemsSolver:
    """The sharded end-to-end refined solver of a systems MGState on this
    rank."""
    return ShardedSystemsSolver(state, comm, device=device)
