"""Build the port's hierarchies from plain arrays.

A hierarchy exported as numpy arrays — for example the leaves of an mgtpu
`GridHierarchy` or flat `Hierarchy`, taken with ``np.asarray`` — becomes
one of this package, so a cycle can run on exactly the reference's
operators, diagonals (Jacobi, SPAI and Jac-GMRES levels), line states,
Vanka tables and block inverses, hybrid-Kaczmarz tables, transfers
(per-axis factors or stride-2 stencils) and coarsest solve (dense or
batched LU factors, a Schwarz state, a Schur solver) and be compared node
for node; the systems
engine's hierarchy (cross stencils, grid Vanka, per-component factors,
dense coarsest inverse) comes across by `systems_hierarchy_from_arrays`.
One rank's part of mgtpu's padded multi-device hierarchies comes across by
`sharded_systems_from_arrays` (systems tier) and `sharded_flat_from_arrays`
(row-sharded flat tier), and of its partitioned flat tier's plan arrays by
`partitioned_flat_from_arrays`.

LU pivots are taken as scipy's and JAX's ``lu_factor`` give them, 0-based;
torch's `lu_solve` reads LAPACK's 1-based pivots, so they gain one here.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import torch_dtype

from .cycle.coarse import DenseLU, IterativeCoarse
from .cycle.kaczmarz import KaczmarzRelax
from .cycle.grid_cycle import (DenseInverse, GridHierarchy,
                               GridIterativeCoarse, GridLevel, line_state_to)
from .cycle.relax import AltLineRelax, ChebyshevRelax, DiagRelax, LineRelax
from .cycle.systems_grid import (BlockDenseInverse, BlockGridOperator,
                                 GridVanka, SystemsGridHierarchy,
                                 SystemsGridLevel)
from .cycle.vanka import VankaRelax
from .ops.cross_stencil import CrossGridStencil
from .ops.dia import DIA
from .ops.ell import ELL
from .ops.grid_stencil import (ConstGridStencil, GridStencil,
                               Stride2Transfer, pack_stride2)
from .dd.parallel import ShardedSchwarz, shard_schwarz
from .dd.schwarz import SchwarzState, _SchwarzCoarse
from .setup.hierarchy import Hierarchy, Level
from .solvers.direct import BatchedDenseLU
from .solvers.schur import KaczmarzFGMRESSolver, SchurCoarse

__all__ = ["grid_hierarchy_from_arrays", "flat_hierarchy_from_arrays",
           "matrix_from_arrays", "dense_lu_from_arrays",
           "batched_lu_from_arrays", "stride2_from_arrays",
           "vanka_relax_from_arrays", "kaczmarz_relax_from_arrays",
           "schwarz_state_from_arrays", "schur_coarse_from_arrays",
           "systems_hierarchy_from_arrays", "sharded_mg_from_arrays",
           "sharded_schwarz_from_arrays", "sharded_systems_from_arrays",
           "sharded_flat_from_arrays", "partitioned_flat_from_arrays"]


def _as_tensor(a, device):
    return None if a is None else torch.tensor(np.asarray(a), device=device)


def _line_state(spec):
    """A mapping {alpha, pivot, cprime, axis, omega}, or a tuple of them
    (alternating lines), as a host LineRelax / AltLineRelax."""
    if isinstance(spec, (tuple, list)):
        return AltLineRelax(tuple(_line_state(s) for s in spec))
    return LineRelax(*(np.asarray(spec[k]) for k in
                       ("alpha", "pivot", "cprime")),
                     int(spec["axis"]), float(spec["omega"]))


def stride2_from_arrays(spec, device) -> Stride2Transfer:
    """A mapping {``coeff``, ``offsets``, ``fine_grid``, ``coarse_grid``}
    (mgtpu's Stride2Transfer less its selection matrices) as a
    Stride2Transfer on `device`, packed for kernel D (`pack_stride2`)."""
    return pack_stride2(np.asarray(spec["coeff"]), spec["offsets"],
                        spec["fine_grid"], spec["coarse_grid"], device)


def matrix_from_arrays(spec, device):
    """An ELL ({``indices``, ``values``, ``shape``}) or DIA ({``data``,
    ``offsets``, ``shape``}) matrix on `device`."""
    shape = tuple(int(v) for v in spec["shape"])
    if "indices" in spec:
        return ELL(_as_tensor(spec["indices"], device),
                   _as_tensor(spec["values"], device), shape)
    return DIA(_as_tensor(spec["data"], device),
               tuple(int(o) for o in spec["offsets"]), shape)


def dense_lu_from_arrays(lu, piv, device) -> DenseLU:
    """DenseLU from packed LU factors and 0-based pivots."""
    return DenseLU(_as_tensor(lu, device),
                   torch.tensor(np.asarray(piv).astype(np.int32) + 1,
                                device=device))


def vanka_relax_from_arrays(spec, n: int, dtype, device) -> VankaRelax:
    """A mapping {``idx``, ``dinv``, ``rows_idx``, ``rows_val``,
    ``variant``} (mgtpu's VankaRelax) as the port's on `device`, with the
    scatter tables its overlapping variants add through (built as
    setup/smoothers.py's `setup_vanka` builds them; n: the level's size)."""
    from .setup.smoothers import vanka_scatter
    idx, rows_idx, rows_val = (np.asarray(spec[k]) for k in
                               ("idx", "rows_idx", "rows_val"))
    variant = str(spec["variant"])
    return VankaRelax(idx.astype(np.int32), np.asarray(spec["dinv"]),
                      rows_idx.astype(np.int32), rows_val, variant,
                      vanka_scatter(variant, idx, rows_idx, rows_val, n)
                      ).to(dtype, device)


def batched_lu_from_arrays(lu, piv, device) -> BatchedDenseLU:
    """BatchedDenseLU from packed (nb, k, k) factors and 0-based pivots."""
    from .solvers.direct import pivots_to_permutation
    piv1 = np.asarray(piv).astype(np.int64) + 1
    perm = pivots_to_permutation(piv1)
    return BatchedDenseLU(_as_tensor(lu, device),
                          torch.tensor(piv1.astype(np.int32), device=device),
                          torch.tensor(perm, device=device),
                          torch.tensor(np.argsort(perm, axis=1),
                                       device=device))


def kaczmarz_relax_from_arrays(spec, device) -> KaczmarzRelax:
    """A mapping {``arr``, ``mask``, ``invd``, ``ell_idx``, ``ell_val``,
    ``num_domains``, ``num_it``, ``omega``} (mgtpu's KaczmarzRelax) as the
    port's on `device`, with kernel F's link table (a row's stored count
    taken as the position of its last nonzero plus one) and its plan."""
    from .ops.cuda.kaczmarz import kaczmarz_links, kaczmarz_plan
    arr, mask, invd, idx, val = (np.asarray(spec[k]) for k in
                                 ("arr", "mask", "invd", "ell_idx",
                                  "ell_val"))
    nz = val != 0
    counts = np.where(nz.any(axis=1),
                      val.shape[1] - np.argmax(nz[:, ::-1], axis=1), 0)
    link = kaczmarz_links(arr, mask, idx, counts)
    kz = KaczmarzRelax(arr.astype(np.int32), mask, invd,
                       idx.astype(np.int32), val, link,
                       tuple(int(d) for d in spec["num_domains"]),
                       int(spec["num_it"]), float(spec["omega"]),
                       kaczmarz_plan(arr, mask, idx, link))
    return kz.to(torch_dtype(val.dtype), device)


def schwarz_state_from_arrays(spec, device) -> SchwarzState:
    """A mapping {``idx``, ``mask``, ``rows_idx``, ``rows_val``, ``lu``,
    ``piv`` (0-based), ``colors``} (mgtpu's SchwarzState) as the port's."""
    t = lambda k, dt=None: torch.tensor(
        np.asarray(spec[k]) if dt is None else np.asarray(spec[k], dt),
        device=device)
    lu = batched_lu_from_arrays(spec["lu"], spec["piv"], device)
    colors = tuple(tuple(int(d) for d in g) for g in spec["colors"])
    return SchwarzState(t("idx", np.int64), t("mask"),
                        t("rows_idx", np.int64), t("rows_val"), lu.lu,
                        lu.piv, colors,
                        tuple(torch.tensor(g, dtype=torch.int64,
                                           device=device) for g in colors),
                        lu.perm, lu.iperm)


def sharded_mg_from_arrays(spec, num_ranks: int, rank: int, *,
                           device):
    """Rank `rank`'s part (of `num_ranks`) of mgtpu's `ShardedMG` (built
    for num_ranks devices), given as a mapping {``levels``: per level
    {``coeff`` (nd, NJp, NI), ``d``, ``masks``, ``ds_map``, ``di``, ``dj``,
    ``plan`` (a mapping of TransferPlan's fields), ``slab``}, ``lu``,
    ``piv`` (0-based), ``nu_pre``, ``nu_post``, ``coarse_nj``,
    ``n_nodes0``}, as the port's `ShardedMG` shard on `device`."""
    from .parallel.sharded import ShardedMG, level_from_arrays
    from .parallel.stencil import TransferPlan
    levels = []
    for lv in spec["levels"]:
        pl = lv["plan"]
        plan = TransferPlan(tuple((int(o), float(w)) for o, w in
                                  pl["offsets"]),
                            *(int(pl[k]) for k in ("NI", "NIc", "NJ", "NJc",
                                                   "dim")))
        coeff = np.asarray(lv["coeff"])
        levels.append(level_from_arrays(
            coeff, lv["d"], lv["masks"], lv["ds_map"], lv["di"], lv["dj"],
            plan, int(lv["slab"]), rank, device, coeff.dtype))
    lu = dense_lu_from_arrays(spec["lu"], spec["piv"], device)
    return ShardedMG(tuple(levels), lu.lu, lu.piv,
                     tuple(int(v) for v in spec["nu_pre"]),
                     tuple(int(v) for v in spec["nu_post"]),
                     int(spec["coarse_nj"]),
                     tuple(int(v) for v in spec["n_nodes0"]))


def sharded_schwarz_from_arrays(spec, num_ranks: int, rank: int, *,
                                device) -> ShardedSchwarz:
    """Rank `rank`'s slice of mgtpu's `ShardedSchwarz` (colour-major
    (ncolors, L, ...) arrays {``idx``, ``mask``, ``rows_idx``,
    ``rows_val``, ``lu``, ``piv`` (0-based), ``ncolors``}) as the port's,
    on `device`; the pivots become 1-based with their row orders."""
    from .solvers.direct import pivots_to_permutation
    piv = np.asarray(spec["piv"]).astype(np.int64) + 1
    shape = piv.shape
    perm = pivots_to_permutation(piv.reshape(-1, shape[-1])).reshape(shape)
    arrays = tuple(np.asarray(spec[k]) for k in ("idx", "mask", "rows_idx",
                                                 "rows_val", "lu"))
    arrays = (arrays[0].astype(np.int64),) + arrays[1:2] + (
        arrays[2].astype(np.int64),) + arrays[3:] + (
        piv.astype(np.int32), perm, np.argsort(perm, axis=-1))
    return shard_schwarz(arrays, int(spec["ncolors"]), num_ranks, rank,
                         device)


def schur_coarse_from_arrays(spec, device) -> SchurCoarse:
    """A mapping {``B``, ``CT`` (ELL mappings), ``Dinv``, ``n_cut`` and
    ``lu``, ``piv`` (a dense S factor, 0-based pivots) or ``kaczmarz``
    (a `kaczmarz_relax_from_arrays` mapping) with ``ell`` (S's ELL) and
    ``inner``} (mgtpu's SchurCoarse) as the port's."""
    if "lu" in spec:
        s_solver = dense_lu_from_arrays(spec["lu"], spec["piv"], device)
    else:
        s_solver = KaczmarzFGMRESSolver(
            kaczmarz_relax_from_arrays(spec["kaczmarz"], device),
            matrix_from_arrays(spec["ell"], device), int(spec["inner"]))
    return SchurCoarse(matrix_from_arrays(spec["B"], device),
                       matrix_from_arrays(spec["CT"], device),
                       _as_tensor(spec["Dinv"], device), s_solver,
                       int(spec["n_cut"]))


def flat_hierarchy_from_arrays(levels, coarse, *, device) -> Hierarchy:
    """levels: one mapping per level with ``A`` (a `matrix_from_arrays`
    mapping), and below the coarsest ``P`` and ``R`` (ELL mappings) and
    ``d`` (the smoother diagonal) with ``lam_max`` for a Chebyshev level,
    or ``vanka`` (a `vanka_relax_from_arrays` mapping).
    or ``kaczmarz`` (a `kaczmarz_relax_from_arrays` mapping).
    coarse: {``lu``, ``piv``} (0-based pivots) for `DenseLU`,
    {``d``, ``ell_idx``, ``ell_val``, ``inner``} for `IterativeCoarse`,
    {``schwarz``: a `schwarz_state_from_arrays` mapping} for a DD
    coarsest, or {``schur``: a `schur_coarse_from_arrays` mapping}."""
    out = []
    for lv in levels:
        A = matrix_from_arrays(lv["A"], device)
        if lv.get("P") is None:
            out.append(Level(A, None, None, None))
            continue
        if lv.get("vanka") is not None:
            relax = vanka_relax_from_arrays(lv["vanka"], A.shape[0],
                                            A.dtype, device)
        elif lv.get("kaczmarz") is not None:
            relax = kaczmarz_relax_from_arrays(lv["kaczmarz"], device)
        else:
            d = _as_tensor(lv["d"], device)
            relax = (DiagRelax(d) if lv.get("lam_max") is None
                     else ChebyshevRelax(d, float(lv["lam_max"])))
        out.append(Level(A, matrix_from_arrays(lv["P"], device),
                         matrix_from_arrays(lv["R"], device), relax))
    if "lu" in coarse:
        solver = dense_lu_from_arrays(coarse["lu"], coarse["piv"], device)
    elif "schwarz" in coarse:
        solver = _SchwarzCoarse(schwarz_state_from_arrays(coarse["schwarz"],
                                                          device))
    elif "schur" in coarse:
        solver = schur_coarse_from_arrays(coarse["schur"], device)
    else:
        solver = IterativeCoarse(_as_tensor(coarse["d"], device),
                                 _as_tensor(coarse["ell_idx"], device),
                                 _as_tensor(coarse["ell_val"], device),
                                 int(coarse["inner"]))
    return Hierarchy(tuple(out), solver)


def grid_hierarchy_from_arrays(levels, coarse_inv, coarse_grid, *,
                               device) -> GridHierarchy:
    """levels: one mapping per level with
         ``offsets``, ``grid`` and either ``const``, ``strips``, ``boxes``
         (a constant-interior stencil) or ``coeff`` (a dense stencil) —
         or no ``offsets`` at all for an SA coarsest level that only its
         solver reads; ``d`` (grid-shaped diagonal) or ``line`` (a
         line-Jacobi state: a mapping of alpha, pivot, cprime, axis,
         omega, or a tuple of them for alternating lines), ``P1``
         (per-grid-axis 1D prolongation factors, None for an axis that
         does not coarsen, or a `stride2_from_arrays` mapping) and
         ``lam`` (spectral bound) — None on the coarsest level.
    coarse_inv: (nc, nc) dense inverse of the coarsest operator, or a
         mapping {``d``, ``inner``} for the FGMRES coarsest solve
         (`GridIterativeCoarse` on the last level's operator: grid-shaped
         damped inverse diagonal, projection steps);
    coarse_grid: its node grid."""
    out = []
    for lv in levels:
        if lv.get("offsets") is None:
            out.append(GridLevel(None, None, None))
            continue
        offsets = tuple(tuple(int(v) for v in o) for o in lv["offsets"])
        grid = tuple(int(v) for v in lv["grid"])
        if "const" in lv:
            A = ConstGridStencil.from_arrays(lv["const"], lv["strips"],
                                             offsets, grid, lv["boxes"],
                                             device=device)
        else:
            A = GridStencil(_as_tensor(lv["coeff"], device), offsets, grid)
        P1 = lv.get("P1")
        if isinstance(P1, dict):
            P1 = stride2_from_arrays(P1, device)
        elif P1 is not None:
            P1 = tuple(_as_tensor(p, device) for p in P1)
        lam = lv.get("lam")
        line = lv.get("line")
        if line is not None:
            line = line_state_to(_line_state(line), A.dtype, device)
        out.append(GridLevel(A, _as_tensor(lv.get("d"), device), P1,
                             None if lam is None else float(lam), line))
    if isinstance(coarse_inv, dict):
        coarse = GridIterativeCoarse(out[-1].A,
                                     _as_tensor(coarse_inv["d"], device),
                                     int(coarse_inv["inner"]))
    else:
        coarse = DenseInverse(_as_tensor(coarse_inv, device),
                              tuple(int(v) for v in coarse_grid))
    return GridHierarchy(tuple(out), coarse)


def systems_hierarchy_from_arrays(levels, coarse_inv, *,
                                  device) -> SystemsGridHierarchy:
    """levels: one mapping per level of mgtpu's systems hierarchy with
         ``stencils`` (per stored block a mapping {``coeff``,
         ``offsets``, ``in_grid``}: coeff (nd, *out_grid)), ``pairs``
         ((ci, cj) per block) and ``grids`` (per-component grid shapes);
         below the coarsest ``d`` (per-component diagonals) or ``vanka``
         ({``dinv``, ``masks``, ``slots``, ``cell_grid``, ``variant``}),
         and ``P1``, ``R1`` (per component, per grid axis, the dense 1D
         factors);
    coarse_inv: the dense inverse of the coarsest operator (on the last
         level's grids)."""
    out = []
    for lv in levels:
        sts = tuple(CrossGridStencil(
            _as_tensor(st["coeff"], device),
            tuple(tuple(int(v) for v in o) for o in st["offsets"]),
            tuple(int(v) for v in np.asarray(st["coeff"]).shape[1:]),
            tuple(int(v) for v in st["in_grid"])) for st in lv["stencils"])
        A = BlockGridOperator(sts, tuple(tuple(int(c) for c in p)
                                         for p in lv["pairs"]),
                              tuple(tuple(int(v) for v in g)
                                    for g in lv["grids"]))
        fac = lambda k: (None if lv.get(k) is None else tuple(
            tuple(_as_tensor(f, device) for f in comp) for comp in lv[k]))
        d = (None if lv.get("d") is None
             else tuple(_as_tensor(c, device) for c in lv["d"]))
        vk = lv.get("vanka")
        if vk is not None:
            vk = GridVanka(_as_tensor(vk["dinv"], device),
                           _as_tensor(vk["masks"], device),
                           tuple((int(c), tuple(int(v) for v in o))
                                 for c, o in vk["slots"]),
                           tuple(int(v) for v in vk["cell_grid"]),
                           str(vk["variant"]))
        out.append(SystemsGridLevel(A, d, vk, fac("P1"), fac("R1")))
    return SystemsGridHierarchy(tuple(out), BlockDenseInverse(
        _as_tensor(coarse_inv, device), out[-1].A.grids))


def sharded_systems_from_arrays(levels, coarse_inv, true_grids, comm, *,
                                device) -> SystemsGridHierarchy:
    """This rank's part of mgtpu's `pad_systems_hierarchy(gh, D)` output
    (D = the rank count): `levels` the padded levels as
    `systems_hierarchy_from_arrays` takes them, `coarse_inv` the dense
    inverse of its `PaddedBlockCoarse` (on the true coarsest grids
    `true_grids`), sharded over `comm` on `device` in the layout of
    parallel/systems_sharded.py."""
    from .parallel.comm import rank_device
    from .parallel.systems_sharded import (PaddedBlockCoarse,
                                           shard_systems_hierarchy)
    gh = systems_hierarchy_from_arrays(levels, coarse_inv, device="cpu")
    true_grids = tuple(tuple(int(v) for v in g) for g in true_grids)
    coarse = PaddedBlockCoarse(BlockDenseInverse(gh.coarse.inv, true_grids),
                               gh.levels[-1].A.grids, true_grids)
    return shard_systems_hierarchy(SystemsGridHierarchy(gh.levels, coarse),
                                   comm, rank_device(device))


def sharded_flat_from_arrays(levels, coarse, nc: int, comm, *,
                             device) -> Hierarchy:
    """This rank's part of mgtpu's `shard_flat_hierarchy` (built for as
    many devices as `comm` has ranks): `levels` and `coarse` its row-padded
    arrays as `flat_hierarchy_from_arrays` takes them (ELL levels,
    padded smoother diagonals; the coarsest solver's own arrays), `nc` the
    coarsest's true size (its `_PaddedCoarse`), row-sharded over `comm` on
    `device` as parallel/sharded_amg.py shards it."""
    from .parallel.comm import rank_device
    from .parallel.sharded_amg import PaddedCoarse, shard_padded_hierarchy
    hier = flat_hierarchy_from_arrays(levels, coarse, device="cpu")
    return shard_padded_hierarchy(
        Hierarchy(hier.levels, PaddedCoarse(hier.coarse, int(nc))), comm,
        rank_device(device))


def partitioned_flat_from_arrays(levels, coarse, comm, *,
                                 device) -> Hierarchy:
    """This rank's partitioned hierarchy (parallel/part_amg.py) from the
    plan arrays of mgtpu's PartitionedAMGSolver, built for as many devices
    as `comm` has ranks.

    levels: one mapping per level with ``A`` (below the coarsest also
         ``P`` and ``R``), each a mapping {``indices`` (ndev, p_rows, K)
         remapped, ``values``, ``sends`` (per ring distance (ndev, S_d)),
         ``dists``, ``shape`` (p_rows, p_cols + H)} as `partition_plan`
         returns them and mgtpu's PartELL holds them; below the coarsest
         ``d`` (ndev, p) the smoother's diagonal blocks and, for a
         Chebyshev smoother, ``lam_max``;
    coarse: {``lu``, ``piv`` (0-based), ``nc``} for the dense LU,
         {``matrix`` (scipy), ``nc``} for the host SuperLU (factored on
         rank 0 only), or {``d`` (ndev, p), ``inner``} for the iterative
         coarsest on the last level's A."""
    from .cycle.coarse import sparse_lu_from_scipy
    from .parallel.comm import rank_device
    from .parallel.part_amg import (PartDenseLU, PartIterativeCoarse,
                                    PartSparseLU, part_ell)
    dev = rank_device(device)
    k = comm.axis_index(0)

    def op(m):
        return part_ell(np.asarray(m["indices"]), np.asarray(m["values"]),
                        m["dists"], [np.asarray(s) for s in m["sends"]],
                        m["shape"], comm, dev)

    out = []
    for lv in levels:
        relax = None
        if lv.get("d") is not None:
            d = torch.tensor(np.asarray(lv["d"])[k], device=dev)
            relax = (DiagRelax(d) if lv.get("lam_max") is None
                     else ChebyshevRelax(d, float(lv["lam_max"])))
        out.append(Level(op(lv["A"]), None if lv.get("P") is None
                         else op(lv["P"]), None if lv.get("R") is None
                         else op(lv["R"]), relax))
    p = out[-1].A.shape[0]
    if "lu" in coarse:
        solver = PartDenseLU(dense_lu_from_arrays(coarse["lu"], coarse["piv"],
                                                  dev), int(coarse["nc"]), p,
                             comm)
    elif "matrix" in coarse:
        solver = PartSparseLU(
            sparse_lu_from_scipy(coarse["matrix"]) if comm.rank == 0
            else None, int(coarse["nc"]), p, comm)
    else:
        solver = PartIterativeCoarse(
            out[-1].A, torch.tensor(np.asarray(coarse["d"])[k], device=dev),
            int(coarse["inner"]), comm.psum)
    return Hierarchy(tuple(out), solver, comm.psum)
