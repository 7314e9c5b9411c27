"""Grid-form multigrid engine for face-staggered systems (elasticity/Stokes).

Counterpart of mgtpu/cycle/systems_grid.py.  The system keeps its block
structure: each unknown component (face-j displacements, the optional
cell-centered pressure) lives on its own node grid; operator blocks are
`CrossGridStencil`s (ops/cross_stencil.py), a level's whole operator
applied on the card in one launch of kernel D's block form, its residual
b - A x too (`BlockGridOperator.matvec` / `residual`); transfers are
per-component per-axis dense 1D matmuls (the Systems.jl composites,
reference src/Multigrid/Systems.jl:33-76, checked block by block against
the assembled operators at setup); and the
cell-wise Vanka smoother is window arithmetic: every block slot of every
cell is a +-1 window of a component field, so gathering block residuals,
applying the batched block inverses and adding the corrections are
windowed tensor ops, no gathers.

Fields.  Inside a cycle a field is a tuple of per-component (m, *grid_c)
tensors, mgtpu's "block fields".  The solve loops, the Krylov methods and
the recorded programs take one tensor: (m, N) rows, the right-hand sides
first and in each row the components one after the other (`fields_to_rows`
/ `rows_to_fields`).  For one right-hand side the components are
contiguous views of the row, which kernel D reads as they are; for several
they are copied out once per conversion.  Flat (n, m) columns convert to
rows once at the loop boundary.

Cycle types V, W, F and K (a `kcycle_inner`-step FGMRES on the coarse
level, preconditioned by the next level's cycle).  `systems_grid_cycle_jit`
runs one cycle as a recorded program (capture.py): a CUDA graph on the
card.
"""
from __future__ import annotations

import functools
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import scipy.sparse as sp
import torch

from ..config import full_fp32, single_variant, torch_dtype
from ..ops.cross_stencil import cross_stencil_from_csr
from .capture import run, static_config
from .grid_cycle import _axis_matmul, _checked_inverse
from .relax import fgmres_relaxation

__all__ = [
    "BlockGridOperator", "SystemsGridLevel", "SystemsGridHierarchy",
    "GridVanka", "BlockDenseInverse", "face_component_grids",
    "block_operator_from_csr", "vanka_slots", "grid_vanka_sweep",
    "build_grid_vanka", "systems_restrict", "systems_prolong",
    "systems_grid_cycle", "systems_grid_cycle_jit",
    "systems_grid_cycle_flat", "build_systems_grid_hierarchy",
    "block_to_fields", "fields_to_block", "rows_to_fields",
    "fields_to_rows",
]


# ---------------------------------------------------------------------------
# component geometry and field layouts
# ---------------------------------------------------------------------------

def face_component_grids(n, with_pressure: bool):
    """Per-component grid shapes (grid-axis order) for face-staggered fields
    on an n-cell mesh, plus the flat offsets of each component block."""
    n = [int(v) for v in np.asarray(n).ravel()]
    dim = len(n)
    grids = []
    for j in range(dim):
        s = list(n)
        s[j] += 1
        grids.append(tuple(reversed(s)))
    if with_pressure:
        grids.append(tuple(reversed(n)))
    sizes = [int(np.prod(g)) for g in grids]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    return tuple(grids), offsets


def block_to_fields(x2, grids):
    """(n, m) flat columns -> tuple of (m, *grid_c) component fields."""
    out = []
    off = 0
    for g in grids:
        sz = int(np.prod(g))
        out.append(x2[off:off + sz].T.reshape((x2.shape[1],) + tuple(g)))
        off += sz
    return tuple(out)


def fields_to_block(xs):
    """tuple of (m, *grid_c) -> (n, m) flat columns."""
    return fields_to_rows(xs).T


def rows_to_fields(v: torch.Tensor, grids):
    """(m, N) rows -> tuple of contiguous (m, *grid_c) component fields:
    views of v for m = 1, copies otherwise."""
    m = v.shape[0]
    out = []
    off = 0
    for g in grids:
        sz = int(np.prod(g))
        out.append(v[:, off:off + sz].reshape((m,) + tuple(g)).contiguous())
        off += sz
    return tuple(out)


def fields_to_rows(xs) -> torch.Tensor:
    """tuple of (m, *grid_c) -> (m, N) rows."""
    m = xs[0].shape[0]
    return torch.cat([x.reshape(m, -1) for x in xs], dim=1)


def _tadd(a, b):
    return tuple(x + y for x, y in zip(a, b))


def _tzeros(a):
    return tuple(torch.zeros_like(x) for x in a)


# ---------------------------------------------------------------------------
# block operator
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class BlockGridOperator:
    stencils: tuple                     # CrossGridStencil per stored block
    pairs: tuple                        # (ci, cj) per stored block
    grids: tuple                        # per-component grid shapes

    @property
    def dtype(self):
        return self.stencils[0].dtype

    @property
    def shape(self):
        nt = sum(int(np.prod(g)) for g in self.grids)
        return (nt, nt)

    @property
    def nnz(self) -> int:
        return sum(s.nnz for s in self.stencils)

    @property
    def block_coeffs(self) -> tuple:
        return tuple(S.coeff for S in self.stencils)

    @property
    def block_offsets(self) -> tuple:
        return tuple(S.offsets for S in self.stencils)

    @functools.cached_property
    def block_table(self) -> np.ndarray:
        """Kernel D's block table of this operator (ops/cuda/stencil.py::
        block_table), made on its first apply on the card: boxes, taps and
        splits, no pointer."""
        from ..ops.cuda.stencil import block_table
        for (ci, cj), S in zip(self.pairs, self.stencils):
            if (tuple(S.out_grid), tuple(S.in_grid)) != (
                    tuple(self.grids[ci]), tuple(self.grids[cj])):
                raise ValueError(f"block {(ci, cj)} maps {S.in_grid} to "
                                 f"{S.out_grid}, not the components' grids")
        grids = tuple(tuple(int(v) for v in g) for g in self.grids)
        return block_table(grids, grids, tuple(map(tuple, self.pairs)),
                           tuple(tuple(map(tuple, o))
                                 for o in self.block_offsets))

    def matvec(self, xs):
        """xs: tuple of (m, *grid_c) -> the same structure: each output
        component summed over its blocks in block order, in one launch of
        kernel D's block form on the card (the blocks' plain cross applies
        on the CPU)."""
        from ..ops.cuda.stencil import block_apply
        return block_apply(self, xs)

    def residual(self, bs, xs):
        """b - A x on block fields, in one launch on the card: the bits of
        each b less `matvec`'s component."""
        from ..ops.cuda.stencil import block_apply
        return block_apply(self, xs, bs)

    def to_rows(self, xs) -> torch.Tensor:
        """Block fields as the (m, N) rows the Krylov algebra runs on."""
        return fields_to_rows(xs)

    def from_rows(self, v: torch.Tensor):
        return rows_to_fields(v, self.grids)

    def rows_matvec(self, v: torch.Tensor) -> torch.Tensor:
        """The apply on (m, N) rows."""
        return fields_to_rows(self.matvec(rows_to_fields(v, self.grids)))

    def to(self, device) -> "BlockGridOperator":
        return BlockGridOperator(tuple(s.to(device) for s in self.stencils),
                                 self.pairs, self.grids)


def _component_nodes(n, with_pressure: bool):
    dim = len(n)
    nodes = []
    for j in range(dim):
        s = list(n)
        s[j] += 1
        nodes.append(s)
    if with_pressure:
        nodes.append(list(n))
    return nodes


def block_operator_from_csr(A: sp.spmatrix, n_cells, with_pressure: bool,
                            dtype=None, device=None) -> BlockGridOperator:
    """Split A into component blocks and extract each as a cross stencil;
    on the host (numpy) unless `device` is given."""
    n = [int(v) for v in np.asarray(n_cells).ravel()]
    grids, offs = face_component_grids(n, with_pressure)
    if A.shape[0] != offs[-1]:
        raise ValueError("operator size does not match the staggered layout")
    A = A.tocsr()
    nodes = _component_nodes(n, with_pressure)
    pairs, stencils = [], []
    for ci in range(len(grids)):
        Ai = A[offs[ci]:offs[ci + 1]].tocsc()
        for cj in range(len(grids)):
            blk = Ai[:, offs[cj]:offs[cj + 1]].tocsr()
            if blk.nnz == 0:
                continue
            S = cross_stencil_from_csr(blk, nodes[ci], nodes[cj], dtype=dtype)
            pairs.append((ci, cj))
            stencils.append(S)
    op = BlockGridOperator(tuple(stencils), tuple(pairs), grids)
    return op if device is None else op.to(device)


# ---------------------------------------------------------------------------
# grid-form Vanka smoother
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class GridVanka:
    """Cell-wise Vanka in grid form.

    dinv:  (bs, bs, *cell_grid) weighted block inverses (single precision,
           reference Vanka.jl:296).
    masks: (ncolors, *cell_grid) 0/1 color masks (per-axis cell parity,
           reference cellColor Vanka.c:34-83); one all-ones "color" for the
           additive variant.
    slots: per block slot, (component index, per-grid-axis window offset) —
           slot s of cell r is component comp[s] at node r + off[s]."""
    dinv: torch.Tensor
    masks: torch.Tensor
    slots: tuple
    cell_grid: tuple
    variant: str


def vanka_slots(dim: int, with_pressure: bool):
    """Slot table matching vanka_cell_indices' ordering: (low_j, high_j) per
    axis j, then pressure.  Offsets are in grid-axis order."""
    slots = []
    for j in range(dim):
        off_hi = [0] * dim
        off_hi[dim - 1 - j] = 1         # +1 along mesh axis j = grid axis
        slots.append((j, (0,) * dim))
        slots.append((j, tuple(off_hi)))
    if with_pressure:
        slots.append((dim, (0,) * dim))
    return tuple(slots)


def _window(off, size):
    """The index of x[:, off_a : off_a + size_a per grid axis]."""
    return (slice(None),) + tuple(slice(o, o + z) for o, z in zip(off, size))


def grid_vanka_sweep(op: BlockGridOperator, gv: GridVanka, xs, bs_field,
                     num_it: int):
    """num_it colored (or additive) Vanka sweeps on block fields.  The
    windows of one component are added in slot order (the low and the
    high face of the additive variant overlap: a fixed order).  A smoother
    that is not a `GridVanka` (the multi-device tier's
    parallel/systems_sharded.py::ShardedVanka) sweeps itself."""
    if not isinstance(gv, GridVanka):
        return gv.sweep(op, xs, bs_field, num_it)
    cg = gv.cell_grid
    dinv = gv.dinv.to(xs[0].dtype)
    for _ in range(num_it):
        for c in range(gv.masks.shape[0]):
            r = op.residual(bs_field, xs)
            rs = torch.stack([r[comp][_window(off, cg)]
                              for comp, off in gv.slots], dim=1)
            # u[:, i] = sum_j dinv[i, j] rs[:, j]: a broadcast product and
            # a sum (as an einsum, torch runs a batched gemv per cell)
            u = (dinv.unsqueeze(0) * rs.unsqueeze(1)).sum(dim=2) \
                * gv.masks[c]
            xs = list(xs)
            fresh = set()
            for s, (comp, off) in enumerate(gv.slots):
                if comp not in fresh:
                    xs[comp] = xs[comp].clone()
                    fresh.add(comp)
                xs[comp][_window(off, cg)] += u[:, s]
            xs = tuple(xs)
    return xs


def build_grid_vanka(A, mesh, w, with_pressure, variant, dtype, prec_dtype,
                     device="cpu") -> GridVanka:
    """The grid-form Vanka of one level on `device` (the host block
    inverses of setup/smoothers.py in the cell-grid layout)."""
    from ..setup.smoothers import vanka_block_inverses
    if variant not in ("vanka", "econ-vanka", "vanka-add"):
        raise ValueError(f"grid Vanka does not support variant {variant}")
    I, colors, dinv = vanka_block_inverses(A, mesh, w, with_pressure,
                                           variant, dtype=dtype)
    n = [int(v) for v in np.asarray(mesh.n).ravel()]
    dim = mesh.dim
    cell_grid = tuple(reversed(n))
    ncells, bsz = I.shape
    # (ncells, bs, bs) -> (bs, bs, *cell_grid); flat cell index is dim-0
    # fastest, i.e. C-order on the reversed grid
    dinv_g = np.transpose(dinv, (1, 2, 0)).reshape((bsz, bsz) + cell_grid)
    if variant == "vanka-add":
        masks = np.ones((1,) + cell_grid, dtype=prec_dtype)
    else:
        ncolors = 2 ** dim
        masks = np.zeros((ncolors,) + cell_grid, dtype=prec_dtype)
        colors_g = colors.reshape(cell_grid)
        for c in range(ncolors):
            masks[c] = (colors_g == c)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    return GridVanka(t(dinv_g.astype(prec_dtype)), t(masks),
                     vanka_slots(dim, with_pressure), cell_grid, variant)


# ---------------------------------------------------------------------------
# hierarchy + cycle
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class SystemsGridLevel:
    A: BlockGridOperator
    d: tuple | None          # per-component pointwise relax diagonals
    vanka: GridVanka | None
    P1: tuple | None         # per component: per-axis dense (f_a, c_a)
    R1: tuple | None         # per component: per-axis dense (c_a, f_a)


@dataclass(frozen=True, eq=False)
class BlockDenseInverse:
    inv: torch.Tensor
    grids: tuple

    def solve(self, bs_field):
        """One dense matmul on the fields' rows, in full float32."""
        with full_fp32():
            x = fields_to_rows(bs_field) @ self.inv.T
        return rows_to_fields(x, self.grids)


@dataclass(frozen=True, eq=False)
class SystemsGridHierarchy:
    """The systems engine's device hierarchy.  `reduce` sums a tensor over
    the ranks when the fields are this rank's blocks
    (parallel/systems_sharded.py): the K-cycle's FGMRES projections pass it
    to `fgmres_relaxation`; None on one device."""
    levels: tuple
    coarse: BlockDenseInverse
    reduce: Any = None

    @property
    def fine_grids(self) -> tuple:
        return self.levels[0].A.grids


def systems_restrict(rs, R1):
    """R r per component: per-axis 1D restriction matmuls, scaled 0.5^dim.
    A transfer that is not a tuple of factors (the multi-device tier's
    parallel/systems_sharded.py::ShardedSystemsTransfer) applies itself."""
    if not isinstance(R1, tuple):
        return R1.restrict(rs)
    out = []
    dim = len(R1[0])
    for r, facs in zip(rs, R1):
        y = r
        for a, W in enumerate(facs):
            y = _axis_matmul(y, W.T, 1 + a)
        out.append(((0.5 ** dim) * y).contiguous())
    return tuple(out)


def systems_prolong(xcs, P1):
    """P xc per component (a transfer object prolongs itself)."""
    if not isinstance(P1, tuple):
        return P1.prolong(xcs)
    out = []
    for xc, facs in zip(xcs, P1):
        y = xc
        for a, W in enumerate(facs):
            y = _axis_matmul(y, W.T, 1 + a)
        out.append(y.contiguous())
    return tuple(out)


def _systems_smooth(cfg, lvl: SystemsGridLevel, r, xs, bs_field, nu: int):
    if nu <= 0:
        return xs
    if lvl.vanka is not None:
        return grid_vanka_sweep(lvl.A, lvl.vanka, xs, bs_field, nu)
    for _ in range(nu - 1):
        xs = _tadd(xs, tuple(d * ri for d, ri in zip(lvl.d, r)))
        r = lvl.A.residual(bs_field, xs)
    return _tadd(xs, tuple(d * ri for d, ri in zip(lvl.d, r)))


def _fields_fgmres(A, prec, b, inner: int, reduce=None):
    """`fgmres_relaxation` from zero on block fields, through the rows view
    of the operator (`to_rows` / `from_rows`: every row on one device, this
    rank's owned rows of a sharded operator)."""
    b2 = A.to_rows(b)
    x2 = fgmres_relaxation(A.rows_matvec,
                           lambda v: A.to_rows(prec(A.from_rows(v))),
                           b2, torch.zeros_like(b2), inner, reduce)
    return A.from_rows(x2)


def systems_grid_cycle(cfg, gh: SystemsGridHierarchy, b, x, level: int = 0,
                       ctype: str | None = None, x_zero: bool = False):
    """One cycle on block fields b, x (tuples of (m, *grid_c)).

    `x_zero`: the incoming iterate is exactly zero (coarse-level entries)
    — the r = b - A*0 matvec is skipped (see grid_cycle)."""
    ctype = cfg.cycle_type if ctype is None else ctype
    if ctype not in ("V", "W", "F", "K"):
        raise NotImplementedError(f"cycle type {ctype!r} not yet ported")
    nlev = len(gh.levels)
    if level == nlev - 1:
        return gh.coarse.solve(b)

    lvl = gh.levels[level]
    r = b if x_zero else lvl.A.residual(b, x)
    x = _systems_smooth(cfg, lvl, r, x, b, cfg.nu_pre[level])
    r = (lvl.A.residual(b, x)
         if cfg.nu_pre[level] > 0 or not x_zero else b)
    bc = systems_restrict(r, lvl.R1)
    if level == nlev - 2:
        xc = gh.coarse.solve(bc)
    elif ctype == "K":
        # K-cycle: FGMRES on the coarse level preconditioned by the
        # recursive cycle (reference MGcycle.jl:72-76)
        prec = lambda v: systems_grid_cycle(cfg, gh, v, _tzeros(v),
                                            level + 1, "K", x_zero=True)
        xc = _fields_fgmres(gh.levels[level + 1].A, prec, bc,
                            cfg.kcycle_inner, gh.reduce)
    else:
        xc = systems_grid_cycle(cfg, gh, bc, _tzeros(bc), level + 1, ctype,
                                x_zero=True)
        if ctype == "W":
            xc = systems_grid_cycle(cfg, gh, bc, xc, level + 1, "W")
        elif ctype == "F":
            xc = systems_grid_cycle(cfg, gh, bc, xc, level + 1, "V")

    x = _tadd(x, systems_prolong(xc, lvl.P1))
    r = lvl.A.residual(b, x)
    return _systems_smooth(cfg, lvl, r, x, b, cfg.nu_post[level])


def _systems_cycle_program(ctx, *bx):
    cfg, gh, x_zero = ctx
    k = len(bx) // 2
    return systems_grid_cycle(cfg, gh, bx[:k], bx[k:], x_zero=x_zero)


def systems_grid_cycle_jit(cfg, gh: SystemsGridHierarchy, b, x,
                           x_zero: bool = False):
    """One cycle on block fields as a recorded program (mgtpu's jitted
    cycle): a CUDA graph replayed on the card, recorded on first use per
    field shapes, dtype and `x_zero`; `systems_grid_cycle` on the CPU."""
    out = run(gh, ("systems_cycle", static_config(cfg), bool(x_zero)),
              _systems_cycle_program, (cfg, gh, bool(x_zero)), *b, *x)
    return tuple(out)


def systems_grid_cycle_flat(cfg, gh: SystemsGridHierarchy, b2, x2,
                            ctype: str | None = None, x_zero: bool = False):
    """systems_grid_cycle on flat (n, m) columns: the flat engine's form."""
    grids = gh.fine_grids
    xg = systems_grid_cycle(cfg, gh, block_to_fields(b2, grids),
                            block_to_fields(x2, grids), 0, ctype,
                            x_zero=x_zero)
    return fields_to_block(xg)


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------

SYS_RELAX = ("jacobi", "spai", "vanka", "econ-vanka", "vanka-add")
DENSE_INV_MAX = 16384


def _component_transfer_factors(n, with_pressure, dtype, device):
    """Per-component per-grid-axis dense 1D P and R factors on `device`,
    and their kron composites (reference Systems.jl:33-76) for the check
    against the assembled hierarchy."""
    from ..setup import transfers as tr
    n = [int(v) for v in np.asarray(n).ravel()]
    dim = len(n)
    comps = []
    for j in range(dim):
        facs = []
        for k in range(dim):        # mesh axis order
            if k == j:
                P1, _ = tr.prolongation_nodes_1d(n[k])
                R1, _ = tr.node_fw_restriction_1d(n[k])
            else:
                P1, _ = tr.prolongation_cells_1d(n[k])
                R1, _ = tr.restriction_cells_1d(n[k])
            facs.append((P1, R1))
        comps.append(facs)
    if with_pressure:
        facs = []
        for k in range(dim):
            P1, _ = tr.prolongation_cells_1d(n[k])
            R1, _ = tr.restriction_cells_1d(n[k])
            facs.append((P1, R1))
        comps.append(facs)
    t = lambda f: torch.as_tensor(np.asarray(f.todense(), dtype=dtype),
                                  device=device)
    P1s, R1s, Pkron, Rkron = [], [], [], []
    for facs in comps:
        pk, rk = facs[0][0], facs[0][1]
        for P1, R1 in facs[1:]:
            pk = sp.kron(P1, pk, format="csr")
            rk = sp.kron(R1, rk, format="csr")
        Pkron.append(pk)
        Rkron.append(rk)
        # grid-axis order = reversed mesh axes
        P1s.append(tuple(t(f[0]) for f in reversed(facs)))
        R1s.append(tuple(t(f[1]) for f in reversed(facs)))
    return tuple(P1s), tuple(R1s), Pkron, Rkron


def _stage(times: dict, key: str, t0: float) -> float:
    """Add the seconds since t0 to times[key]; returns the clock."""
    now = time.perf_counter()
    times[key] = times.get(key, 0.0) + now - t0
    return now


def build_systems_grid_hierarchy(state, relax_states,
                                 device) -> SystemsGridHierarchy:
    """Build the systems grid engine on `device` when eligible; ValueError
    otherwise (the caller may hand the hierarchy to the flat engine).  The
    host seconds of each stage add to `state.setup_times` (cross_stencils,
    smoother, transfers, coarse)."""
    from ..setup.hierarchy import _per_level_relax_param, _resolve_relax

    cfg = state.config
    if cfg.transfer_type not in ("systems-faces", "systems-faces-mixed"):
        raise ValueError("systems grid engine needs staggered transfers")
    if cfg.relax_type not in SYS_RELAX:
        raise ValueError(f"systems grid engine: unsupported relaxation "
                         f"{cfg.relax_type}")
    if not state.meshes or len(state.meshes) < state.num_levels:
        raise ValueError("systems grid engine needs per-level meshes")
    if cfg.coarse_solve != "lu" or state.coarse_solver is not None:
        raise ValueError("systems grid engine supports the lu coarsest only")
    A_c = state.As[-1]
    if A_c.shape[0] > DENSE_INV_MAX:
        raise ValueError("coarsest system too large for a dense inverse")

    times = state.setup_times
    dt = torch_dtype(cfg.dtype)
    with_p = cfg.mixed
    rp_arr = _per_level_relax_param(state.relax_param, state.num_levels)
    levels = []
    for l in range(state.num_levels):
        t0 = time.perf_counter()
        mesh = state.meshes[l]
        n = [int(v) for v in np.asarray(mesh.n).ravel()]
        A = block_operator_from_csr(state.As[l], n, with_p, dtype=cfg.dtype,
                                    device=device)
        t0 = _stage(times, "cross_stencils", t0)
        d = vanka = P1 = R1 = None
        if l < state.num_levels - 1:
            if cfg.relax_type in ("jacobi", "spai"):
                rs = _resolve_relax(relax_states[l])
                grids, offs = face_component_grids(n, with_p)
                dd = np.asarray(rs.d)
                d = tuple(torch.as_tensor(dd[offs[c]:offs[c + 1]].reshape(g),
                                          device=device).to(dt)
                          for c, g in enumerate(grids))
            else:
                vanka = build_grid_vanka(
                    state.As[l], mesh, rp_arr[l], with_p, cfg.relax_type,
                    np.dtype(cfg.dtype), single_variant(np.dtype(cfg.dtype)),
                    device)
            t0 = _stage(times, "smoother", t0)
            P1, R1, Pk, Rk = _component_transfer_factors(n, with_p,
                                                         cfg.dtype, device)
            # the factored transfers must BE the assembled hierarchy's
            Pfull = sp.block_diag(Pk, format="csr")
            Rfull = sp.block_diag(Rk, format="csr")
            if (Pfull != state.Ps[l]).nnz != 0:
                raise ValueError("hierarchy P is not the Systems.jl factored "
                                 "composite")
            if ((0.5 ** mesh.dim) * Rfull != state.Rs[l]).nnz != 0:
                raise ValueError("hierarchy R is not the Systems.jl factored "
                                 "composite")
            _stage(times, "transfers", t0)
        levels.append(SystemsGridLevel(A, d, vanka, P1, R1))

    t0 = time.perf_counter()
    Ad = np.asarray(A_c.astype(
        np.complex128 if np.iscomplexobj(A_c.data) else np.float64).todense())
    if A_c.shape[0] <= 4096:
        inv = _checked_inverse(Ad)
    else:
        shift = 1e-8 * np.abs(Ad).sum(axis=0).max()
        inv = np.linalg.inv(Ad + shift * np.eye(Ad.shape[0], dtype=Ad.dtype))
    coarse = BlockDenseInverse(
        torch.as_tensor(inv.astype(cfg.dtype), device=device),
        levels[-1].A.grids)
    _stage(times, "coarse", t0)
    return SystemsGridHierarchy(tuple(levels), coarse)
