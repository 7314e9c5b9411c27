"""The face-staggered systems engine over the ranks of a torch.distributed
group (mgtpu/parallel/systems_sharded.py).

mgtpu shards every component field and every grid-shaped leaf of the
systems hierarchy (cycle/systems_grid.py) along grid axis 0, the slowest,
and lets GSPMD insert the collectives.  torch has no such partitioner, so
this module writes out what XLA inferred and runs the port's unchanged
`systems_grid_cycle` on the pieces, which the cycle dispatches to:

 * the hierarchy is mgtpu's zero-padded embedding (`pad_systems_hierarchy`,
   the same arrays): cell extents along grid axis 0 round up to C, a
   multiple of the rank count D, the face extent of the component staggered
   along that axis to C + D; the pad's coefficients, diagonals, Vanka
   inverses and colour masks are zero and the axis-0 transfer factors have
   zero rows and columns, so the pad stays zero through the cycle;
 * the layout is cell-aligned, not GSPMD's even split: rank k owns the
   cells [kS, (k+1)S), S = C / D, and of every component the planes of
   those cells; the axis-0 face component also the face above them, so its
   block has S + 1 planes.  On ranks below the last that top plane is a
   dead slot: it stands for one of the D - 1 pad faces past C, holds zero,
   and the face it would be, (k+1)S, is the next rank's first plane; the
   last rank's top plane is the top face C.  The padded face extent C + D
   is exactly D blocks of S + 1, so a block is a slice of the padded array
   in this order (`stacked_order`).  Every component's block then starts at
   the same global plane kS, so a block operator's taps shift by the halo
   width alone, as in the square case, and a cell's Vanka window is local
   but for its top face;
 * level operators (`ShardedBlockOperator`): each input component that a
   block reads off-plane is extended once by its neighbours' planes
   (`RankGrid.post_halo`, the radius of its widest block; a block thinner
   than that radius takes the gathered component instead) and the level's
   apply, or its residual b - A x, is one launch of kernel D's block form
   with every block's taps shifted by that width; each output component
   sums its blocks in the order of the single-device
   `BlockGridOperator.matvec`;
 * the Vanka sweep (`ShardedVanka`): per colour r = b - A x, the upper plane
   of r's axis-0 face component from the next rank (`RankGrid.shift`), the
   windows, the block inverses and the window adds on this rank's cells;
   the add of the top cell's upper window lands in the dead slot and goes
   to the next rank, which adds it to its first plane after its own adds,
   the order of the single device (low window, then high);
 * transfers (`ShardedSystemsTransfer`): per component the per-axis
   factors; over axis 0 restriction is a local partial product and a
   `reduce_scatter` to the coarse blocks, prolongation an `all_gather` of
   the coarse block and this rank's fine rows (grid_sharded.py's
   `ShardedTransfer` form, once a component);
 * the coarsest (`ShardedBlockCoarse`): each component gathered, mgtpu's
   `PaddedBlockCoarse` (the replicated dense inverse on the true grids),
   this rank's blocks sliced back.

K-cycles run with the hierarchy's reduce hook (`SystemsGridHierarchy.
reduce` = `RankGrid.psum`): the K-cycle's FGMRES works on the rows view of
this rank's blocks (`ShardedBlockOperator.to_rows` / `from_rows`: the owned
planes only, so the dead slots are outside every Krylov vector and every
Gram sum, and come back zero), and its Gram products are summed over the
ranks.  As on one device the E-2d form (SPAI diagonals) is pointwise on
each rank.  Sums over axis 0 (the transfers) run in another order than on
one device, so iterates agree to rounding; the block applies and the Vanka
windows are the single device's arithmetic.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..cycle.systems_grid import (BlockDenseInverse, BlockGridOperator,
                                  GridVanka, SystemsGridHierarchy,
                                  SystemsGridLevel, _axis_matmul, _window,
                                  block_to_fields, fields_to_block,
                                  systems_grid_cycle)
from ..ops.cross_stencil import CrossGridStencil
from .comm import rank_device
from .grid_sharded import _pad_to

__all__ = ["pad_systems_hierarchy", "PaddedBlockCoarse", "padded_grids",
           "pad_block_operator", "stacked_order",
           "ShardedBlockOperator", "ShardedVanka", "ShardedSystemsTransfer",
           "ShardedBlockCoarse", "shard_systems_hierarchy",
           "shard_block_operator", "make_systems_sharded_cycle"]


def _cell_grid_of(grids) -> tuple:
    """Cell extents per grid axis: the least over the components (a face
    component adds one along its own axis)."""
    return tuple(min(g[k] for g in grids) for k in range(len(grids[0])))


def _pad_axis(a, new: int, axis: int):
    """a zero-padded at the end of `axis` to `new` (numpy or torch)."""
    if isinstance(a, np.ndarray):
        pad = [(0, 0)] * a.ndim
        pad[axis] = (0, new - a.shape[axis])
        return np.pad(a, pad) if new != a.shape[axis] else a
    return _pad_to(a, (new,), (axis,))


@dataclass(frozen=True, eq=False)
class PaddedBlockCoarse:
    """The replicated dense coarsest solve on the unpadded embedding of
    padded fields (mgtpu's PaddedBlockCoarse)."""
    inner: BlockDenseInverse
    pad_grids: tuple
    true_grids: tuple

    def solve(self, bs_field):
        sl = [b[(slice(None),) + tuple(slice(0, e) for e in g)].contiguous()
              for b, g in zip(bs_field, self.true_grids)]
        xs = self.inner.solve(tuple(sl))
        return tuple(_pad_axis(x, pg[0], 1)
                     for x, pg in zip(xs, self.pad_grids))

    def to(self, device) -> "PaddedBlockCoarse":
        return PaddedBlockCoarse(
            BlockDenseInverse(torch.as_tensor(self.inner.inv, device=device),
                              self.inner.grids),
            self.pad_grids, self.true_grids)


def padded_grids(grids, D: int) -> tuple:
    """The components' grids with grid axis 0 padded for D ranks: the cell
    extent to C, the next multiple of D, the axis-0 faces to C + D."""
    cg0 = _cell_grid_of(grids)[0]
    C = -(-cg0 // D) * D
    return tuple((C if g[0] == cg0 else C + D,) + tuple(g[1:])
                 for g in grids)


def pad_block_operator(op: BlockGridOperator,
                       pgrids) -> BlockGridOperator:
    """A block operator on the padded grids `pgrids`: every block's
    coefficients zero-padded along grid axis 0 (the pad rows apply to
    nothing and read nothing)."""
    return BlockGridOperator(tuple(
        CrossGridStencil(_pad_axis(s.coeff, pgrids[ci][0], 1), s.offsets,
                         pgrids[ci], pgrids[cj])
        for (ci, cj), s in zip(op.pairs, op.stencils)), op.pairs, pgrids)


def pad_systems_hierarchy(gh: SystemsGridHierarchy, D: int
                          ) -> tuple[SystemsGridHierarchy, tuple]:
    """Zero-padded embedding of a systems hierarchy with every component's
    grid-axis-0 extent divisible by D: cells to C (a multiple of D), the
    axis-0 face component to C + D; the arrays are mgtpu's.  Returns
    (padded hierarchy, padded fine grids)."""
    def pad_level(lvl: SystemsGridLevel, pgrids, pgrids_c):
        A = pad_block_operator(lvl.A, pgrids)
        d = (None if lvl.d is None else
             tuple(_pad_axis(di, pg[0], 0) for di, pg in zip(lvl.d, pgrids)))
        vanka = None
        if lvl.vanka is not None:
            gv = lvl.vanka
            cells = min(pg[0] for pg in pgrids)
            vanka = GridVanka(_pad_axis(gv.dinv, cells, 2),
                              _pad_axis(gv.masks, cells, 1), gv.slots,
                              (cells,) + tuple(gv.cell_grid[1:]), gv.variant)
        P1 = R1 = None
        if lvl.P1 is not None:
            # axis-0 factors act on this component's padded extents at the
            # fine and coarse levels: P (fine, coarse), R (coarse, fine)
            P1 = tuple((_pad_axis(_pad_axis(p[0], pgrids[c][0], 0),
                                  pgrids_c[c][0], 1),) + tuple(p[1:])
                       for c, p in enumerate(lvl.P1))
            R1 = tuple((_pad_axis(_pad_axis(r[0], pgrids_c[c][0], 0),
                                  pgrids[c][0], 1),) + tuple(r[1:])
                       for c, r in enumerate(lvl.R1))
        return SystemsGridLevel(A, d, vanka, P1, R1)

    pads = [padded_grids(lvl.A.grids, D) for lvl in gh.levels]
    levels = tuple(pad_level(lvl, pads[l],
                             pads[l + 1] if l + 1 < len(pads) else None)
                   for l, lvl in enumerate(gh.levels))
    coarse = PaddedBlockCoarse(gh.coarse, pads[-1], gh.levels[-1].A.grids)
    return SystemsGridHierarchy(levels, coarse), pads[0]


# ---------------------------------------------------------------------------
# the cell-aligned layout
# ---------------------------------------------------------------------------

def stacked_order(E: int, C: int, D: int) -> np.ndarray:
    """The padded axis-0 planes of a component of padded extent E (C for
    cells, C + D for the axis-0 faces) in rank-block order: block k (length
    E / D) is planes [kS, (k+1)S) of the cells, and for the faces one more,
    the top face C on the last rank and the pad face C + 1 + k (a dead
    slot, zero) on the others."""
    S = C // D
    if E == C:
        return np.arange(C)
    if E != C + D:
        raise ValueError(f"axis-0 extent {E} is neither {C} nor {C + D}")
    order = np.empty(C + D, dtype=np.int64)
    for k in range(D):
        order[k * (S + 1):k * (S + 1) + S] = k * S + np.arange(S)
        order[k * (S + 1) + S] = C if k == D - 1 else C + 1 + k
    return order


@dataclass(frozen=True, eq=False)
class _Layout:
    """One level's layout on this rank: S cells a rank, per component its
    stacked order, block planes W and owned planes (W less a dead slot)."""
    D: int
    k: int
    S: int
    orders: tuple
    widths: tuple
    owned: tuple

    @classmethod
    def of(cls, grids, comm) -> "_Layout":
        D, k = comm.axis_size(0), comm.axis_index(0)
        C = min(g[0] for g in grids)
        orders = tuple(stacked_order(g[0], C, D) for g in grids)
        widths = tuple(g[0] // D for g in grids)
        owned = tuple(w - (1 if w > C // D and k < D - 1 else 0)
                      for w in widths)
        return cls(D, k, C // D, orders, widths, owned)

    def rows(self, c: int) -> torch.Tensor:
        """The padded planes of component c's block on this rank."""
        w = self.widths[c]
        return torch.as_tensor(self.orders[c][self.k * w:(self.k + 1) * w])

    def local(self, a: torch.Tensor, c: int, dim: int) -> torch.Tensor:
        """This rank's block of a padded array (axis 0 of the grid at
        `dim`)."""
        return a.index_select(dim, self.rows(c).to(a.device)).contiguous()

    def gather(self, x: torch.Tensor, c: int, comm) -> torch.Tensor:
        """The padded field (m, E, ...) of component c from the blocks."""
        st = torch.cat(list(comm.all_gather(x)), dim=1)
        inv = torch.as_tensor(np.argsort(self.orders[c]), device=x.device)
        return st.index_select(1, inv)


def _extend(x, c: int, r: int, lay: _Layout, comm) -> torch.Tensor:
    """Component c's block x (m, W, ...) with r planes of its neighbours on
    each side along axis 0 (zeros past the ends): its owned planes between
    the halos.  A block thinner than r takes the gathered component."""
    own = x.narrow(1, 0, lay.owned[c])
    if r <= lay.S:
        left, right = comm.post_halo(x.narrow(1, 0, lay.S), 0, r,
                                     dim=1).wait()
        return torch.cat([left, own, right], dim=1)
    full = lay.gather(x, c, comm)
    lo = lay.k * lay.S - r
    full = torch.cat([full.new_zeros(full.shape[:1] + (r,) + full.shape[2:]),
                      full,
                      full.new_zeros(full.shape[:1] + (lay.S + r + 1,)
                                     + full.shape[2:])], dim=1)
    return full.narrow(1, lo + r, own.shape[1] + 2 * r).contiguous()


# ---------------------------------------------------------------------------
# the sharded level objects
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class ShardedBlockOperator:
    """A block operator on this rank: per stored block its coefficients
    (nd, *out_block) and taps (global shifts); `grids` the components'
    blocks; `radius` per component the halo width its readers take."""
    coeffs: tuple
    offsets: tuple
    pairs: tuple
    grids: tuple
    radius: tuple
    layout: _Layout
    comm: object

    @property
    def dtype(self):
        return self.coeffs[0].dtype

    @property
    def block_coeffs(self) -> tuple:
        return self.coeffs

    @functools.cached_property
    def block_offsets(self) -> tuple:
        """Each block's taps on the extended field it reads: shifted by its
        input's halo width along axis 0."""
        return tuple(tuple((int(o[0]) + self.radius[cj],)
                           + tuple(int(v) for v in o[1:]) for o in offs)
                     for (_, cj), offs in zip(self.pairs, self.offsets))

    @functools.cached_property
    def in_grids(self) -> tuple:
        """The field each component's readers take: its owned planes and a
        halo of its radius on each side (the block itself at radius 0)."""
        return tuple(((self.layout.owned[j] + 2 * r,) + tuple(g[1:])
                      if r else tuple(g))
                     for j, (r, g) in enumerate(zip(self.radius,
                                                    self.grids)))

    @functools.cached_property
    def block_table(self) -> np.ndarray:
        """Kernel D's block table (ops/cuda/stencil.py::block_table) of
        this rank's blocks on the extended inputs."""
        from ..ops.cuda.stencil import block_table
        return block_table(tuple(tuple(int(v) for v in g)
                                 for g in self.grids), self.in_grids,
                           tuple(map(tuple, self.pairs)), self.block_offsets)

    def extend(self, xs) -> tuple:
        """The inputs of the blocks: each component a block reads off-plane
        extended by its radius (`_extend`), the others as they are."""
        read = {cj for _, cj in self.pairs}
        return tuple(_extend(x, j, r, self.layout, self.comm)
                     if r and j in read else x
                     for j, (x, r) in enumerate(zip(xs, self.radius)))

    def matvec(self, xs):
        """xs: this rank's blocks (m, *block_c) -> A xs: the inputs
        extended, then every output component summed over its blocks in
        the single-device block order, in one launch of kernel D's block
        form on the card (the blocks' plain cross applies on the CPU)."""
        from ..ops.cuda.stencil import block_apply
        return block_apply(self, self.extend(xs))

    def residual(self, bs, xs):
        """b - A xs on this rank's blocks, in one launch on the card; a
        dead slot of b (zero) stays zero."""
        from ..ops.cuda.stencil import block_apply
        return block_apply(self, self.extend(xs), bs)

    def to_rows(self, xs) -> torch.Tensor:
        """This rank's rows of block fields (m, *block_c): every
        component's owned planes (a dead slot left out), flattened and
        concatenated, (m, N_rank)."""
        m = xs[0].shape[0]
        return torch.cat([x.narrow(1, 0, w).reshape(m, -1)
                          for x, w in zip(xs, self.layout.owned)], dim=1)

    def from_rows(self, v: torch.Tensor):
        """The block fields of `to_rows`'s rows, a dead slot zero."""
        m, out, off = v.shape[0], [], 0
        for g, w in zip(self.grids, self.layout.owned):
            size = w * int(np.prod(g[1:]))
            x = v[:, off:off + size].reshape((m, w) + tuple(g[1:]))
            out.append(_pad_axis(x, g[0], 1).contiguous())
            off += size
        return tuple(out)

    def rows_matvec(self, v: torch.Tensor) -> torch.Tensor:
        return self.to_rows(self.matvec(self.from_rows(v)))


def shard_block_operator(op: BlockGridOperator, comm,
                         device) -> ShardedBlockOperator:
    """This rank's part of a padded block operator, on `device`."""
    lay = _Layout.of(op.grids, comm)
    radius = [0] * len(op.grids)
    for (_, cj), s in zip(op.pairs, op.stencils):
        radius[cj] = max(radius[cj], max(abs(int(o[0])) for o in s.offsets))
    coeffs = tuple(lay.local(torch.as_tensor(s.coeff), ci, 1).to(device)
                   for (ci, _), s in zip(op.pairs, op.stencils))
    grids = tuple((w,) + tuple(g[1:]) for w, g in zip(lay.widths, op.grids))
    return ShardedBlockOperator(coeffs, tuple(s.offsets for s in op.stencils),
                                op.pairs, grids, tuple(radius), lay, comm)


@dataclass(frozen=True, eq=False)
class ShardedVanka:
    """The grid Vanka of a level on this rank's cells: block inverses and
    colour masks of its cells; `up` the components a slot reads one plane
    above the cell along axis 0 (the axis-0 faces)."""
    dinv: torch.Tensor
    masks: torch.Tensor
    slots: tuple
    cell_grid: tuple
    variant: str
    up: tuple
    layout: _Layout
    comm: object

    def sweep(self, op, xs, bs_field, num_it: int):
        """`grid_vanka_sweep` on this rank's blocks: per colour the
        residual, the next rank's first plane of r for the top windows,
        the block corrections, the window adds in slot order, and the top
        window's add handed to the next rank."""
        lay, comm = self.layout, self.comm
        S, last = lay.S, lay.k == lay.D - 1
        cg = self.cell_grid
        dinv = self.dinv.to(xs[0].dtype)
        for _ in range(num_it):
            for c in range(self.masks.shape[0]):
                r = list(op.residual(bs_field, xs))
                for comp in self.up:
                    top = comm.shift(r[comp].narrow(1, 0, 1).contiguous(),
                                     step=-1)
                    if not last:
                        r[comp] = torch.cat([r[comp].narrow(1, 0, S), top],
                                            dim=1)
                rs = torch.stack([r[comp][_window(off, cg)]
                                  for comp, off in self.slots], dim=1)
                u = (dinv.unsqueeze(0) * rs.unsqueeze(1)).sum(dim=2) \
                    * self.masks[c]
                xs = list(xs)
                fresh = set()
                for s, (comp, off) in enumerate(self.slots):
                    if comp not in fresh:
                        xs[comp] = xs[comp].clone()
                        fresh.add(comp)
                    xs[comp][_window(off, cg)] += u[:, s]
                for comp in self.up:
                    x = xs[comp]
                    inc = comm.shift(x.narrow(1, S, 1).contiguous(), step=1)
                    if not last:            # the dead slot held the add
                        x.narrow(1, S, 1).zero_()
                    if lay.k > 0:
                        x.narrow(1, 0, 1).add_(inc)
                xs = tuple(xs)
        return xs


@dataclass(frozen=True, eq=False)
class ShardedSystemsTransfer:
    """Per component its per-axis factors on this rank: along axis 0 the
    padded factor in block order, P's fine rows of this rank (W_f, D W_c)
    and R's fine columns (D W_c, W_f); the other axes whole."""
    P1: tuple
    R1: tuple
    comm: object

    def restrict(self, rs):
        """R r per component: over axis 0 a partial product of this rank's
        fine planes, the other axes, then reduce_scatter to the coarse
        blocks; scaled 0.5^dim."""
        out = []
        dim = len(self.R1[0])
        for r, facs in zip(rs, self.R1):
            y = r
            for a, W in enumerate(facs):
                y = _axis_matmul(y, W.T, 1 + a)
            y = self.comm.reduce_scatter(y, 0, dim=1)
            out.append(((0.5 ** dim) * y).contiguous())
        return tuple(out)

    def prolong(self, xcs):
        """P xc per component: the coarse blocks gathered along axis 0,
        then every axis's factor."""
        out = []
        for xc, facs in zip(xcs, self.P1):
            y = torch.cat(list(self.comm.all_gather(xc)), dim=1)
            for a, W in enumerate(facs):
                y = _axis_matmul(y, W.T, 1 + a)
            out.append(y.contiguous())
        return tuple(out)


@dataclass(frozen=True, eq=False)
class ShardedBlockCoarse:
    """The coarsest solve: each component gathered, the padded replicated
    dense inverse, this rank's blocks sliced back."""
    inner: PaddedBlockCoarse
    layout: _Layout
    comm: object

    def solve(self, bs_field):
        full = tuple(self.layout.gather(b, c, self.comm)
                     for c, b in enumerate(bs_field))
        xs = self.inner.solve(full)
        return tuple(self.layout.local(x, c, 1) for c, x in enumerate(xs))


def _blocked_factor(W: torch.Tensor, rows, cols) -> torch.Tensor:
    """W with its rows and columns in the given (stacked) orders."""
    W = torch.as_tensor(W)
    at = lambda idx: torch.as_tensor(idx, device=W.device)
    return W.index_select(0, at(rows)).index_select(1, at(cols))


def shard_systems_hierarchy(gh_pad: SystemsGridHierarchy, comm,
                            device) -> SystemsGridHierarchy:
    """This rank's part of a padded systems hierarchy, on `device`."""
    if len(comm.shape) != 1:
        raise ValueError("the systems tier shards grid axis 0 over a 1D "
                         "rank grid")
    lays = [_Layout.of(lvl.A.grids, comm) for lvl in gh_pad.levels]
    levels = []
    for l, lvl in enumerate(gh_pad.levels):
        lay = lays[l]
        A = shard_block_operator(lvl.A, comm, device)
        d = (None if lvl.d is None else tuple(
            lay.local(torch.as_tensor(di), c, 0).to(device)
            for c, di in enumerate(lvl.d)))
        vanka = None
        if lvl.vanka is not None:
            gv = lvl.vanka
            cells = slice(lay.k * lay.S, (lay.k + 1) * lay.S)
            up = tuple(sorted({comp for comp, off in gv.slots if off[0]}))
            if any(off[0] not in (0, 1) for _, off in gv.slots) or any(
                    lay.widths[c] != lay.S + 1 for c in up):
                raise ValueError("a Vanka slot reads past the cell's upper "
                                 "face along grid axis 0")
            vanka = ShardedVanka(
                torch.as_tensor(gv.dinv)[:, :, cells].contiguous().to(device),
                torch.as_tensor(gv.masks)[:, cells].contiguous().to(device),
                gv.slots, (lay.S,) + tuple(gv.cell_grid[1:]), gv.variant, up,
                lay, comm)
        T = None
        if lvl.P1 is not None:
            lc = lays[l + 1]
            k = lay.k
            P1, R1 = [], []
            for c, (pf, rf) in enumerate(zip(lvl.P1, lvl.R1)):
                wf = lay.widths[c]
                mine = lay.orders[c][k * wf:(k + 1) * wf]
                P1.append((_blocked_factor(pf[0], mine, lc.orders[c])
                           .contiguous().to(device),)
                          + tuple(torch.as_tensor(W).to(device)
                                  for W in pf[1:]))
                R1.append((_blocked_factor(rf[0], lc.orders[c], mine)
                           .contiguous().to(device),)
                          + tuple(torch.as_tensor(W).to(device)
                                  for W in rf[1:]))
            T = ShardedSystemsTransfer(tuple(P1), tuple(R1), comm)
        levels.append(SystemsGridLevel(A, d, vanka, T, T))
    coarse = ShardedBlockCoarse(gh_pad.coarse.to(device), lays[-1], comm)
    return SystemsGridHierarchy(tuple(levels), coarse, comm.psum)


def make_systems_sharded_cycle(state, comm, device=None):
    """(gh_sharded, cycle_fn, to_fields, from_fields) for a systems MGState
    on this rank (mgtpu's make_systems_sharded_cycle).

    cycle_fn(gh, b_fields, x_fields, x_zero=False) runs one cycle on this
    rank's blocks; to_fields takes flat (n,) or (n, m) columns (every rank
    holds all of them) to this rank's padded blocks (m, *block_c);
    from_fields gathers the blocks back to flat (n, m) columns on every
    rank.  Blocks live on `device` (default the rank's card)."""
    cfg = state.config
    gh = state.hier
    if not isinstance(gh, SystemsGridHierarchy):
        raise ValueError("state does not use the systems grid engine")
    dev = rank_device(device)
    gh_pad, pgrids = pad_systems_hierarchy(gh, comm.axis_size(0))
    gh_sh = shard_systems_hierarchy(gh_pad, comm, dev)
    true_grids = gh.fine_grids
    lay = gh_sh.levels[0].A.layout
    dt = gh_sh.levels[0].A.dtype

    def to_fields(b2, dtype=None):
        b = torch.as_tensor(b2).to(device=dev,
                                   dtype=dt if dtype is None else dtype)
        b = b[:, None] if b.ndim == 1 else b
        return tuple(lay.local(_pad_axis(f, pg[0], 1), c, 1)
                     for c, (f, pg) in enumerate(
                         zip(block_to_fields(b, true_grids), pgrids)))

    def from_fields(xs):
        full = [lay.gather(x, c, comm) for c, x in enumerate(xs)]
        return fields_to_block(tuple(
            f[(slice(None),) + tuple(slice(0, e) for e in g)]
            for f, g in zip(full, true_grids)))

    def cycle(gh_, b, x, x_zero=False):
        return systems_grid_cycle(cfg, gh_, b, x, x_zero=x_zero)

    return gh_sh, cycle, to_fields, from_fields
