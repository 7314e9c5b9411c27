"""The flat (ELL/DIA) engine over the ranks of a torch.distributed group,
rows split and vectors replicated (mgtpu/parallel/sharded_amg.py): the
multi-device tier of SA-AMG and classical-AMG hierarchies.

mgtpu splits every level's ELL rows (indices and values), its transfer
rows and its smoother diagonals over a 1D device mesh, keeps the iterates
replicated and lets GSPMD insert the one all-gather that re-replicates a
row-split product.  torch has no such partitioner, so the collective is
written out here:

 * every level's row count pads up to a multiple of the rank count R; a
   pad row is index 0 / value 0 and the pad entries of a vector stay zero
   through relaxation, residual, transfers and the coarse correction
   (`pad_flat_hierarchy`: mgtpu's arrays).  A DIA level becomes ELL first,
   as in mgtpu: the gather form is the layout that splits by rows (a banded
   sharded path would be speed work, not porting);
 * a level operator (`ShardedELL`) keeps this rank's rows, with column
   indices into the replicated vector; its product is `ell_matvec` on those
   rows (plain torch, as mgtpu's is XLA), then `RankGrid.all_gather` back
   to the replicated padded vector;
 * pointwise smoother diagonals (`DiagRelax`, `ChebyshevRelax`) are padded
   and kept whole: the smoother's update is elementwise on replicated
   vectors, so each rank computes it for every row, which needs no
   collective (mgtpu splits them and GSPMD re-gathers);
 * the coarsest solver (`DenseLU`, `IterativeCoarse`, a host
   `SparseLUCoarse`) stays replicated behind a slice-and-pad adapter
   (`PaddedCoarse`): every rank solves the same system on the same data.

The cycle is the port's unchanged `recursive_cycle` (cycle/cycle.py) on the
sharded hierarchy.  Vectors are replicated, so every inner product (a
K-cycle's FGMRES, the norms) is already global and the same on every rank:
V, W, F and K cycles run without a reduce hook.  Only the pointwise
smoothers of SA-AMG.jl:27-31 are taken.  Drivers: `ShardedAMGSolver`'s
`cycle`, `solve_refined` (native float64 residual) and `solve_fgmres`.
The loops run eagerly: gloo's calls cannot be recorded.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import torch_dtype
from ..cycle.coarse import DenseLU, IterativeCoarse, SparseLUCoarse
from ..cycle.cycle import recursive_cycle
from ..cycle.relax import ChebyshevRelax, DiagRelax
from ..ops.dia import DIA
from ..ops.ell import ELL, ell_from_scipy, ell_matvec
from ..setup.hierarchy import Hierarchy, Level
from .comm import rank_device

__all__ = ["ShardedELL", "PaddedCoarse", "pad_flat_hierarchy",
           "shard_padded_hierarchy", "shard_flat_hierarchy",
           "ShardedAMGSolver", "POINTWISE_RELAX"]

POINTWISE_RELAX = ("jacobi", "spai", "chebyshev", "chebyshev4")


def _pad_rows(a: torch.Tensor, rows: int) -> torch.Tensor:
    extra = rows - a.shape[0]
    if not extra:
        return a
    return torch.cat([a, a.new_zeros((extra,) + tuple(a.shape[1:]))])


def _pad_n(n: int, R: int) -> int:
    return -(-int(n) // R) * R


@dataclass(frozen=True, eq=False)
class PaddedCoarse:
    """The replicated coarsest solve on row-padded vectors: the true `nc`
    rows solved, the pad rows zero (mgtpu's _PaddedCoarse)."""
    inner: object
    nc: int

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        return _pad_rows(self.inner.solve(b[:self.nc]), b.shape[0])


@dataclass(frozen=True, eq=False)
class ShardedELL:
    """This rank's rows of a row-padded ELL matrix; `shape` the padded
    extents (the cycle sizes its coarse zeros from R.shape[0])."""
    indices: torch.Tensor       # (rows of this rank, K) int32
    values: torch.Tensor        # (rows of this rank, K)
    shape: tuple[int, int]
    comm: object

    @property
    def dtype(self):
        return self.values.dtype

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x for a replicated x (n_cols,) or (n_cols, m): this rank's
        rows, then all_gather to the replicated padded y."""
        y = ell_matvec(self.indices, self.values, x)
        return torch.cat(list(self.comm.all_gather(y)))


def _padded_ell(op, rows: int, cols: int) -> ELL:
    """A level operator as a row-padded ELL (a DIA one converted first)."""
    if isinstance(op, DIA):
        op = ell_from_scipy(op.to_scipy(), dtype=np.dtype(
            str(op.dtype).split(".")[-1]), device=op.data.device)
    if not isinstance(op, ELL):
        raise ValueError(f"cannot shard operator type {type(op).__name__}")
    return ELL(_pad_rows(op.indices, rows), _pad_rows(op.values, rows),
               (rows, cols))


def pad_flat_hierarchy(hier: Hierarchy, R: int) -> Hierarchy:
    """The row-padded embedding of a flat hierarchy for R ranks (mgtpu's
    shard_flat_hierarchy arrays, whole): every level's rows (and the
    columns of P and R) padded to a multiple of R, DIA levels as ELL,
    pointwise smoother diagonals padded, the coarsest behind
    `PaddedCoarse`.  Raises for another smoother."""
    def relax(rx, rows):
        if rx is None:
            return None
        if isinstance(rx, ChebyshevRelax):
            return ChebyshevRelax(_pad_rows(rx.d, rows), rx.lam_max)
        if isinstance(rx, DiagRelax):
            return DiagRelax(_pad_rows(rx.d, rows))
        raise ValueError(
            f"the sharded flat engine takes pointwise relaxations only, got "
            f"{type(rx).__name__} (the reference's SA-AMG restriction, "
            "SA-AMG.jl:27-31)")

    levels = []
    for lv in hier.levels:
        n = _pad_n(lv.A.shape[0], R)
        P = R_ = None
        if lv.P is not None:
            nc = _pad_n(lv.P.shape[1], R)
            P = _padded_ell(lv.P, n, nc)
            R_ = _padded_ell(lv.R, nc, n)
        levels.append(Level(_padded_ell(lv.A, n, n), P, R_,
                            relax(lv.relax, n)))
    return Hierarchy(tuple(levels),
                     PaddedCoarse(hier.coarse, hier.levels[-1].A.shape[0]))


def _rows_of(op: ELL, comm, device) -> ShardedELL:
    R, k = comm.axis_size(0), comm.axis_index(0)
    s = op.shape[0] // R
    return ShardedELL(op.indices[k * s:(k + 1) * s].contiguous().to(device),
                      op.values[k * s:(k + 1) * s].contiguous().to(device),
                      op.shape, comm)


def _to(obj, device):
    """A coarsest solver's or smoother's state on `device` (a host SuperLU
    factor stays on the host)."""
    t = lambda a: a.to(device)
    if isinstance(obj, DenseLU):
        return DenseLU(t(obj.lu), t(obj.piv))
    if isinstance(obj, IterativeCoarse):
        return IterativeCoarse(t(obj.d), t(obj.ell_idx), t(obj.ell_val),
                               obj.inner)
    if isinstance(obj, ChebyshevRelax):
        return ChebyshevRelax(t(obj.d), obj.lam_max)
    if isinstance(obj, DiagRelax):
        return DiagRelax(t(obj.d))
    if obj is None or isinstance(obj, SparseLUCoarse):
        return obj
    raise ValueError(f"the sharded flat engine cannot place "
                     f"{type(obj).__name__}")


def shard_padded_hierarchy(hier_pad: Hierarchy, comm,
                           device) -> Hierarchy:
    """This rank's part of a row-padded flat hierarchy, on `device`."""
    if len(comm.shape) != 1:
        raise ValueError("the sharded flat engine splits rows over a 1D "
                         "rank grid")
    levels = tuple(Level(_rows_of(lv.A, comm, device),
                         None if lv.P is None else _rows_of(lv.P, comm,
                                                            device),
                         None if lv.R is None else _rows_of(lv.R, comm,
                                                            device),
                         _to(lv.relax, device))
                   for lv in hier_pad.levels)
    c = hier_pad.coarse
    return Hierarchy(levels, PaddedCoarse(_to(c.inner, device), c.nc))


def shard_flat_hierarchy(hier: Hierarchy, comm, device=None) -> Hierarchy:
    """This rank's row-sharded, row-padded flat hierarchy (mgtpu's
    shard_flat_hierarchy), on `device` (default the rank's card)."""
    return shard_padded_hierarchy(pad_flat_hierarchy(hier, comm.axis_size(0)),
                                  comm, rank_device(device))


class ShardedAMGSolver:
    """Sharded end-to-end solves over one flat (AMG) hierarchy: an MGState
    of the flat engine (`sa_amg_setup` without a mesh,
    `classical_amg_setup`), a float32 hierarchy as in mgtpu, built once a
    (state, rank grid) on every rank, on `device` (default the rank's
    card).  Every rank returns the whole x."""

    def __init__(self, state, comm, device=None):
        from ..cycle.grid_cycle import GridHierarchy
        from ..cycle.systems_grid import SystemsGridHierarchy
        cfg = state.config
        if isinstance(state.hier, GridHierarchy):
            raise ValueError("state uses the structured grid engine: use "
                             "ShardedGridSolver (parallel/sharded_solve.py)")
        if isinstance(state.hier, SystemsGridHierarchy):
            raise ValueError("state uses the systems grid engine: use "
                             "ShardedSystemsSolver "
                             "(parallel/sharded_solve.py)")
        if np.dtype(cfg.dtype) != np.float32:
            raise ValueError("the sharded AMG solver takes a float32 "
                             "hierarchy (its residual is float64)")
        if cfg.relax_type not in POINTWISE_RELAX:
            raise ValueError(
                f"relax_type {cfg.relax_type!r}: the sharded flat engine "
                f"takes the pointwise smoothers {POINTWISE_RELAX} only (the "
                "reference's SA-AMG restriction, SA-AMG.jl:27-31)")
        self.state, self.cfg, self.comm = state, cfg, comm
        self.device = rank_device(device)
        self.hier = shard_flat_hierarchy(state.hier, comm, self.device)
        self.n_true = int(state.hier.levels[0].A.shape[0])
        self.n_pad = self.hier.levels[0].A.shape[0]
        A_hi = state.A_input if state.A_input is not None else state.As[0]
        self.A64 = _rows_of(_padded_ell(
            ell_from_scipy(A_hi, dtype=np.float64), self.n_pad, self.n_pad),
            comm, self.device)

    def to_vec(self, v, dtype=None):
        """(replicated padded (n_pad, m) tensor, squeeze) of (n,) or (n, m)
        columns."""
        t = torch.as_tensor(np.asarray(v)).to(
            device=self.device,
            dtype=torch_dtype(self.cfg.dtype) if dtype is None else dtype)
        squeeze = t.ndim == 1
        return _pad_rows(t[:, None] if squeeze else t, self.n_pad), squeeze

    def from_vec(self, v, squeeze):
        x = v[:self.n_true].cpu().numpy()
        return x[:, 0] if squeeze else x

    def cycle(self, b, x=None):
        """One multigrid cycle of the state's configuration on replicated
        (n,) or (n, m) operands."""
        b2, squeeze = self.to_vec(b)
        x2 = torch.zeros_like(b2) if x is None else self.to_vec(x)[0]
        return self.from_vec(recursive_cycle(self.cfg, self.hier, b2, x2),
                             squeeze)

    def solve_refined(self, b, x=None, tol: float = 1e-8,
                      max_iter: int | None = None):
        """Refinement to a true float64 relative residual below `tol` (at
        most `max_iter`, default max_outer_iter, corrections; each one cycle
        from zero in the hierarchy's type); stops once the residual exceeds
        1e3 ||b||.  Returns (x float64 numpy, info)."""
        cfg = self.cfg
        max_iter = cfg.max_outer_iter if max_iter is None else max_iter
        cd = torch_dtype(cfg.dtype)
        bv, squeeze = self.to_vec(b, torch.float64)
        xv = (torch.zeros_like(bv) if x is None
              else self.to_vec(x, torch.float64)[0])
        norm = lambda v: float(torch.linalg.vector_norm(v))
        res0 = max(norm(bv), 1e-300)
        r = bv - self.A64.matvec(xv)
        res = norm(r)
        resvec = [res]
        iters = 0
        while iters < max_iter and tol * res0 <= res < 1e3 * res0:
            rl = r.to(cd)
            z = recursive_cycle(cfg, self.hier, rl, torch.zeros_like(rl),
                                x_zero=True)
            xv = xv + z.to(torch.float64)
            r = bv - self.A64.matvec(xv)
            res = norm(r)
            resvec.append(res)
            iters += 1
        return self.from_vec(xv, squeeze), {
            "iters": iters, "relres": res / res0, "resvec": np.array(resvec)}

    def solve_fgmres(self, b, tol: float = 1e-8, max_iter: int = 30,
                     restart: int | None = None):
        """MG-preconditioned FGMRES in the hierarchy's type on replicated
        operands (restart 10 unless given): (x numpy, info)."""
        from ..krylov.fgmres import fgmres
        bv, squeeze = self.to_vec(b)
        A = self.hier.levels[0].A

        def prec(v):
            z = recursive_cycle(self.cfg, self.hier, v.T,
                                torch.zeros_like(v.T), x_zero=True)
            return z.T

        x, info = fgmres(lambda v: A.matvec(v.T).T, bv.T.contiguous(),
                         restart=restart or 10, prec=prec, tol=tol,
                         max_iter=max_iter, device_loop=False)
        return self.from_vec(x.T, squeeze), info
