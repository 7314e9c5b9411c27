"""The scalar grid engine's cycle over the ranks of a torch.distributed group
(mgtpu/parallel/grid_sharded.py): slab (one rank axis) or pencil (two).

mgtpu shards its single-device hierarchy (cycle/grid_cycle.py) with
`NamedSharding` annotations and lets GSPMD insert the collectives; torch
has no such partitioner, so this module writes out what XLA inferred and
runs the unchanged `grid_cycle` on it:

 * the hierarchy is mgtpu's zero-padded embedding (`pad_grid_hierarchy`):
   each sharded grid axis rounds up to a multiple of its rank count, the
   pad's coefficients, diagonals and transfer rows are zero, so the pad
   stays zero through the cycle; constant-interior levels are expanded to
   the dense form;
 * level applies and residuals (`ShardedGridStencil`): each rank's block
   reads a halo of the stencil's radius along each sharded axis, one
   launch of kernel D's halo form reading the neighbours' planes where
   they arrived (the pencil in two phases: the axis-0 planes catted to the
   block, whose axis-1 exchange then carries the corners the 9- and
   27-point stencils read);
 * transfers (`ShardedTransfer`): the per-axis factors (fine x coarse) are
   contracted over a sharded axis in GSPMD's form — restriction as a local
   partial product, then `reduce_scatter` to the coarse blocks;
   prolongation as an `all_gather` of the coarse field along that axis,
   then this rank's fine rows;
 * the coarsest (`ShardedCoarse`): the dense inverse applied replicated to
   the gathered field, then sliced.

Jac-GMRES smoothing and K-cycles run with the hierarchy's reduce hook
(`GridHierarchy.reduce` = `RankGrid.psum`): each rank's FGMRES Gram
products cover its own block, the zero pad adds exact zeros, and their sum
over the ranks is the single device's projection.

As in mgtpu the sums over a sharded axis run in another order than on one
device, so iterates agree to rounding, not bitwise.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..cycle.grid_cycle import (DenseInverse, GridHierarchy, GridLevel,
                                _axis_matmul, grid_cycle)
from ..ops.grid_stencil import (ConstGridStencil, GridStencil, flat_to_grid,
                                grid_to_flat)
from .comm import rank_device

__all__ = ["PaddedDenseInverse", "pad_grid_hierarchy", "ShardedGridStencil",
           "ShardedTransfer", "ShardedCoarse", "shard_grid_hierarchy",
           "make_grid_sharded_cycle", "SHARDED_RELAX"]

SHARDED_RELAX = ("jacobi", "spai", "chebyshev", "chebyshev4", "jac-gmres")


def _pad_to(a: torch.Tensor, targets, axes) -> torch.Tensor:
    """a zero-padded at the end of each of `axes` to its target extent."""
    for t, ax in zip(targets, axes):
        extra = int(t) - a.shape[ax]
        if extra:
            a = torch.cat([a, a.new_zeros(a.shape[:ax] + (extra,)
                                          + a.shape[ax + 1:])], dim=ax)
    return a


@dataclass(frozen=True, eq=False)
class PaddedDenseInverse:
    """The dense coarsest solve on the unpadded embedding of a padded
    field (m, *pad_grid)."""
    inner: DenseInverse
    pad_grid: tuple

    def solve(self, bg):
        sl = bg[(slice(None),) + tuple(slice(0, e) for e in self.inner.grid)]
        xg = self.inner.solve(sl.contiguous())
        return _pad_to(xg, self.pad_grid, range(1, xg.ndim))


def pad_grid_hierarchy(gh: GridHierarchy, divs) -> GridHierarchy:
    """Zero-padded embedding: grid axis a of every level rounds up to a
    multiple of divs[a] (1: an axis that is not sharded)."""
    def pad_extents(grid):
        return tuple(-(-g // d) * d for g, d in zip(grid, divs))

    if not isinstance(gh.coarse, DenseInverse):
        raise ValueError("the sharded grid engine needs the dense coarsest "
                         "inverse")
    levels = []
    for l, lvl in enumerate(gh.levels):
        A = lvl.A
        if isinstance(A, ConstGridStencil):
            A = A.to_dense_stencil()
        pg = pad_extents(A.grid)
        g = len(pg)
        Ap = GridStencil(_pad_to(torch.as_tensor(A.coeff), pg,
                                 range(1, g + 1)), A.offsets, pg)
        d = _pad_to(lvl.d, pg, range(g)) if lvl.d is not None else None
        P1 = None
        if lvl.P1 is not None:
            if not isinstance(lvl.P1, tuple) or any(W is None
                                                    for W in lvl.P1):
                raise ValueError("the sharded grid engine needs per-axis "
                                 "full-weighting factors")
            pgc = pad_extents(gh.levels[l + 1].A.grid)
            # per-axis factors are (fine, coarse): zero rows/cols in the pad
            P1 = tuple(_pad_to(W, (pf, pc), (0, 1))
                       for W, pf, pc in zip(lvl.P1, pg, pgc))
        levels.append(GridLevel(Ap, d, P1, lvl.lam))
    coarse = PaddedDenseInverse(gh.coarse, pad_extents(gh.coarse.grid))
    return GridHierarchy(tuple(levels), coarse)


def _local(full: torch.Tensor, comm, shard, lead: int) -> torch.Tensor:
    """This rank's block of a padded field: along each sharded grid axis
    (`shard`: (grid axis, rank axis) pairs) the rank's equal slice."""
    for ga, ra in shard:
        n, P = full.shape[lead + ga], comm.axis_size(ra)
        s = n // P
        full = full.narrow(lead + ga, comm.axis_index(ra) * s, s)
    return full.contiguous()


def _gather(x: torch.Tensor, comm, shard, lead: int) -> torch.Tensor:
    """The whole padded field from the blocks: all_gather along each
    sharded axis in turn."""
    for ga, ra in shard:
        x = torch.cat(list(comm.all_gather(x, ra)), dim=lead + ga)
    return x


@dataclass(frozen=True, eq=False)
class ShardedGridStencil:
    """A level operator's block on this rank: coeff (nd, *grid), grid the
    block's extents; `radius` the halo width along each sharded axis."""
    coeff: torch.Tensor
    offsets: tuple
    grid: tuple
    comm: object
    shard: tuple
    radius: tuple

    @property
    def dtype(self):
        return self.coeff.dtype

    def _apply(self, x: torch.Tensor, b=None) -> torch.Tensor:
        """One launch of kernel D's halo form on this rank's block x (...,
        *grid): along the last sharded axis its neighbours' planes are
        read where they arrived (none at an end of the axis); on the
        pencil the first axis's planes are catted first, since the second
        exchange must carry the corners the 9- and 27-point stencils
        read."""
        from ..ops.cuda.stencil import halo_stencil
        g = len(self.grid)
        x = x.contiguous()
        halos = [(ga, ra, r) for (ga, ra), r in zip(self.shard, self.radius)
                 if r]
        shift = [0] * g
        for ga, ra, r in halos[:-1]:
            x = self.comm.exchange_halo(x, ra, r, dim=x.ndim - g + ga)
            shift[ga] = r
        left = right = None
        axis = halos[-1][0] if halos else 0
        if halos:
            ga, ra, r = halos[-1]
            left, right = self.comm.post_halo(x, ra, r, dim=x.ndim - g + ga,
                                              zeros=False).wait()
        taps = tuple(tuple(d + s for d, s in zip(off, shift))
                     for off in self.offsets)
        return halo_stencil(self.coeff, taps, x, left, right, axis,
                            b=None if b is None else b.contiguous())

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x on this rank's block x (..., *grid)."""
        return self._apply(x)

    def residual(self, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """b - A x on this rank's block, in the same launch."""
        return self._apply(x, b)


@dataclass(frozen=True, eq=False)
class ShardedTransfer:
    """Per-axis full-weighting factors on this rank: for a sharded grid
    axis the rank's fine rows of the padded factor (fine_block, coarse),
    for another the whole factor."""
    factors: tuple
    comm: object
    shard: tuple

    def _rank_axis(self, a: int):
        return dict(self.shard).get(a)

    def restrict(self, rg: torch.Tensor) -> torch.Tensor:
        """R r = 0.5^c P^T r; over a sharded axis a partial product, then
        reduce_scatter to the coarse blocks."""
        y = rg
        for a, W in enumerate(self.factors):
            y = _axis_matmul(y, W, 1 + a)
            ra = self._rank_axis(a)
            if ra is not None:
                y = self.comm.reduce_scatter(y, ra, dim=1 + a)
        return ((0.5 ** len(self.factors)) * y).contiguous()

    def prolong(self, xc: torch.Tensor) -> torch.Tensor:
        """P xc; over a sharded axis the coarse field is gathered first."""
        y = xc
        for a, W in enumerate(self.factors):
            ra = self._rank_axis(a)
            if ra is not None:
                y = torch.cat(list(self.comm.all_gather(y, ra)), dim=1 + a)
            y = _axis_matmul(y, W.T, 1 + a)
        return y.contiguous()


@dataclass(frozen=True, eq=False)
class ShardedCoarse:
    """The coarsest solve: gather, the replicated dense inverse, slice."""
    inner: PaddedDenseInverse
    comm: object
    shard: tuple

    def solve(self, bg: torch.Tensor) -> torch.Tensor:
        full = _gather(bg, self.comm, self.shard, 1)
        return _local(self.inner.solve(full), self.comm, self.shard, 1)


def _radius(offsets, ga: int) -> int:
    return max(abs(int(off[ga])) for off in offsets)


def shard_grid_hierarchy(gh_pad: GridHierarchy, comm, shard,
                         device) -> GridHierarchy:
    """This rank's part of a padded hierarchy, on `device`."""
    levels = []
    for lvl in gh_pad.levels:
        A = lvl.A
        coeff = _local(torch.as_tensor(A.coeff), comm, shard, 1).to(device)
        grid = tuple(coeff.shape[1:])
        radius = tuple(_radius(A.offsets, ga) for ga, _ in shard)
        for (ga, _), r in zip(shard, radius):
            if r > grid[ga]:
                raise ValueError(f"a block of {grid[ga]} planes along axis "
                                 f"{ga} is thinner than the stencil's "
                                 f"radius {r}")
        As = ShardedGridStencil(coeff, A.offsets, grid, comm, shard, radius)
        d = (None if lvl.d is None
             else _local(lvl.d, comm, shard, 0).to(device))
        P1 = None
        if lvl.P1 is not None:
            rows = dict(shard)
            P1 = ShardedTransfer(tuple(
                (_local(W, comm, ((0, rows[a]),), 0) if a in rows
                 else W.contiguous()).to(device)
                for a, W in enumerate(lvl.P1)), comm, shard)
        levels.append(GridLevel(As, d, P1, lvl.lam))
    inner = gh_pad.coarse.inner
    coarse = ShardedCoarse(PaddedDenseInverse(
        DenseInverse(inner.inv.to(device), inner.grid),
        gh_pad.coarse.pad_grid), comm, shard)
    return GridHierarchy(tuple(levels), coarse, comm.psum)


def make_grid_sharded_cycle(state, comm, axes=(0,), device=None):
    """(gh_sharded, cycle_fn, to_grid, from_grid) for a scalar grid MGState
    on this rank (mgtpu's make_grid_sharded_cycle).

    `axes` names the rank-grid axes that shard the leading grid axes (one:
    slab, two: pencil).  cycle_fn(gh, b, x, x_zero=False) runs one cycle
    on this rank's blocks (m, *block).  to_grid takes a flat (n,) or (n, m)
    array (every rank holds all of it) to this rank's padded block;
    from_grid gathers the blocks back to the flat (n, m) field, on every
    rank.  Blocks live on `device` (default the rank's card)."""
    cfg = state.config
    gh = state.hier
    if not isinstance(gh, GridHierarchy):
        raise ValueError("state does not use the scalar grid engine")
    if cfg.relax_type not in SHARDED_RELAX:
        raise NotImplementedError(
            f"relax_type {cfg.relax_type!r} on the sharded grid engine: its "
            f"smoothers are {SHARDED_RELAX}")
    dev = rank_device(device)
    g = len(gh.fine_grid)
    axes = tuple(int(a) for a in axes)
    if len(axes) > g:
        raise ValueError(f"{len(axes)} sharded axes on a {g}D grid")
    shard = tuple((k, ra) for k, ra in enumerate(axes))
    divs = tuple(comm.axis_size(a) for a in axes) + (1,) * (g - len(axes))
    gh_pad = pad_grid_hierarchy(gh, divs)
    gh_sh = shard_grid_hierarchy(gh_pad, comm, shard, dev)
    true_grid = tuple(gh.fine_grid)
    pad_grid = gh_pad.levels[0].A.grid
    dt = gh_sh.levels[0].A.dtype

    def to_grid(b2, dtype=None):
        b = torch.as_tensor(b2).to(device=dev,
                                   dtype=dt if dtype is None else dtype)
        b = b[:, None] if b.ndim == 1 else b
        full = _pad_to(flat_to_grid(b, true_grid), pad_grid, range(1, g + 1))
        return _local(full, comm, shard, 1)

    def from_grid(xg):
        full = _gather(xg, comm, shard, 1)
        sl = full[(slice(None),) + tuple(slice(0, e) for e in true_grid)]
        return grid_to_flat(sl.contiguous())

    def cycle(gh_, b, x, x_zero=False):
        return grid_cycle(cfg, gh_, b, x, x_zero=x_zero)

    return gh_sh, cycle, to_grid, from_grid
