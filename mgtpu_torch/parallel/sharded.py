"""Slab-sharded geometric multigrid over the ranks of a torch.distributed
group (mgtpu/parallel/sharded.py).

Every non-coarsest level is split into slabs along the last grid dimension
(the J axis of parallel/stencil.py), one a rank; halo planes move between
neighbours (comm.py), the interior apply overlapping the exchange
(`stencil_matvec_overlapped`, kernel D); the transfers stay slab-local
(coarse slab = half the fine slab, one halo plane); the coarsest level is
gathered once (`all_gather`) and solved with the replicated dense LU on
every rank, each taking back its slice (`axis_index`).  Norms use `psum`.

Scope, as mgtpu's: scalar full-weighting GMG hierarchies with damped-Jacobi
relaxation on odd node counts (2^k + 1 grids), built from a host MGState so
that the sharded cycle is the single-device hierarchy.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import full_fp32, torch_dtype
from .comm import rank_device
from .stencil import (TransferPlan, exchange_halo, make_transfer_plan,
                      prolong_local, restrict_local, stencil_from_banded,
                      stencil_matvec_overlapped)

__all__ = ["ShardedLevel", "ShardedMG", "build_sharded_mg", "slab_sizes",
           "make_sharded_cycle", "make_sharded_solver"]


@dataclass(frozen=True, eq=False)
class ShardedLevel:
    """One level's slab on this rank."""
    coeff: torch.Tensor     # (nd, S, NI): rows [rank S, (rank + 1) S)
    d: torch.Tensor         # (S, NI) damped-Jacobi inverse diagonal
    masks: torch.Tensor     # (noffs, NI) in-plane validity, replicated
    ds_map: torch.Tensor    # (NIc,) int64 I-axis downsample map
    di: tuple
    dj: tuple
    plan: TransferPlan
    slab: int               # S, rows a rank at this level


@dataclass(frozen=True, eq=False)
class ShardedMG:
    levels: tuple           # ShardedLevel per non-coarsest level
    lu: torch.Tensor        # replicated dense LU of the coarsest operator
    piv: torch.Tensor       # its 1-based (LAPACK) pivots
    nu_pre: tuple
    nu_post: tuple
    coarse_nj: int          # true J extent of the coarsest grid
    n_nodes0: tuple         # fine-grid node counts


def slab_sizes(njs, num_ranks: int) -> list:
    """Rows a rank per non-coarsest level: the COARSEST grid's J extent
    sets the padding, and each finer level's slab doubles, so that the
    transfers stay slab-aligned."""
    nlev = len(njs)
    slabs = [0] * (nlev - 1)
    slabs[nlev - 2] = 2 * int(-(-njs[-1] // num_ranks))
    for l in range(nlev - 3, -1, -1):
        slabs[l] = 2 * slabs[l + 1]
    for l in range(nlev - 1):
        if slabs[l] * num_ranks < njs[l]:
            raise ValueError(f"slab {slabs[l]} x {num_ranks} ranks does not "
                             f"cover J = {njs[l]} at level {l}")
    return slabs


def level_from_arrays(coeff, d, masks, ds_map, di, dj, plan, slab, rank,
                      device, dtype) -> ShardedLevel:
    """This rank's slab of a level from its padded global arrays (coeff
    (nd, NJp, NI), d (NJp, NI), masks, ds_map) and transfer plan: the rows
    [rank slab, (rank + 1) slab)."""
    dt = torch_dtype(dtype)
    rows = slice(rank * slab, (rank + 1) * slab)
    t = lambda a, typ=dt: torch.tensor(np.ascontiguousarray(a), dtype=typ,
                                       device=device)
    coeff = t(np.asarray(coeff)[:, rows])
    return ShardedLevel(coeff, t(np.asarray(d)[rows]), t(masks),
                        t(ds_map, torch.int64),
                        tuple(int(v) for v in di), tuple(int(v) for v in dj),
                        plan, int(slab))


def build_sharded_mg(state, num_ranks: int, rank: int, dtype=np.float32,
                     device=None) -> ShardedMG:
    """Rank `rank`'s part (of `num_ranks`) of a host GMG hierarchy in slab
    stencil form, on `device` (default the rank's card)."""
    cfg = state.config
    if cfg.transfer_type != "full-weighting":
        raise ValueError("the slab tier covers scalar full-weighting "
                         "hierarchies")
    dev = rank_device(device)
    nlev = state.num_levels
    rp = state.relax_param if np.isscalar(state.relax_param) else 1.0
    n_nodes = [tuple(int(v) + 1 for v in np.asarray(m.n).ravel())
               for m in state.meshes]
    njs = [nn[-1] for nn in n_nodes]
    slabs = slab_sizes(njs, num_ranks)
    levels = []
    for l in range(nlev - 1):
        st = stencil_from_banded(state.As[l], n_nodes[l], rp, dtype=dtype)
        pad = slabs[l] * num_ranks - st.shape[0]
        coeff = np.pad(st.coeff, ((0, 0), (0, pad), (0, 0)))
        d = np.pad(st.d, ((0, pad), (0, 0)))
        plan, masks, ds_map = make_transfer_plan(n_nodes[l])
        levels.append(level_from_arrays(coeff, d, masks, ds_map, st.di,
                                        st.dj, plan, slabs[l], rank, dev,
                                        dtype))
    A_c = np.asarray(state.As[-1].todense()).astype(dtype)
    with full_fp32():
        lu, piv = torch.linalg.lu_factor(torch.tensor(A_c, device=dev))
    return ShardedMG(tuple(levels), lu, piv, tuple(cfg.nu_pre),
                     tuple(cfg.nu_post), njs[-1], n_nodes[0])


def _residual(lvl: ShardedLevel, b, x, comm, axis):
    """b - A x: kernel D's halo form, interior and edge rows."""
    return stencil_matvec_overlapped(lvl.coeff, lvl.di, lvl.dj, x, comm,
                                     axis, b)


def _relax(lvl: ShardedLevel, x, b, nu: int, comm, axis):
    """nu damped-Jacobi sweeps x + d * (b - A x), each one halo form
    launch for the interior rows and one for both edge rows."""
    for _ in range(nu):
        x = stencil_matvec_overlapped(lvl.coeff, lvl.di, lvl.dj, x, comm,
                                      axis, b, lvl.d)
    return x


def _coarsest(mg: ShardedMG, bc, comm, axis):
    """Gather the coarsest system, solve it replicated, keep this rank's
    slice (mgtpu's sharded.py:127-141)."""
    P, Sc = comm.axis_size(axis), bc.shape[-2]
    m, NIc = bc.shape[0], bc.shape[-1]
    gathered = comm.all_gather(bc, axis)                # (P, m, Sc, NIc)
    flat = gathered.movedim(0, 1).reshape(m, P * Sc, NIc)[:, :mg.coarse_nj]
    with full_fp32():
        xc = torch.linalg.lu_solve(mg.lu, mg.piv,
                                   flat.reshape(m, -1).T.contiguous())
    grid = torch.cat([xc.T.reshape(m, mg.coarse_nj, NIc),
                      xc.new_zeros((m, P * Sc - mg.coarse_nj, NIc))], dim=1)
    k = comm.axis_index(axis)
    return grid[:, k * Sc:(k + 1) * Sc].contiguous()


def _sharded_vcycle(mg: ShardedMG, b, x, level: int, comm, axis):
    lvl = mg.levels[level]
    x = _relax(lvl, x, b, mg.nu_pre[level], comm, axis)
    r = _residual(lvl, b, x, comm, axis)
    Sc = lvl.slab // 2
    bc = restrict_local(exchange_halo(r, comm, axis), lvl.plan, lvl.masks,
                        lvl.ds_map, Sc)
    if level == len(mg.levels) - 1:
        xc = _coarsest(mg, bc, comm, axis)
    else:
        xc = _sharded_vcycle(mg, bc, torch.zeros_like(bc), level + 1, comm,
                             axis)
    x = x + prolong_local(xc, lvl.plan, lvl.masks, lvl.ds_map, comm,
                          lvl.slab, axis)
    return _relax(lvl, x, b, mg.nu_post[level], comm, axis)


def make_sharded_cycle(comm, axis: int = 0):
    """The slab V-cycle: (ShardedMG, b, x) -> x on this rank's slabs
    (m, S, NI), over the ranks of `axis` of `comm`."""
    def cycle(mg, b, x):
        return _sharded_vcycle(mg, b, x, 0, comm, axis)
    return cycle


def make_sharded_solver(state, comm, axis: int = 0, dtype=np.float32,
                        device=None):
    """(mg, step_fn, to_grid, from_grid) for this rank (mgtpu's
    make_sharded_solver).

    step_fn(mg, b, x) runs one V-cycle and returns x and the psum-reduced
    residual norm (a 0-dim tensor).  to_grid takes a flat (n,) or (n, m)
    array (every rank holds all of it) to this rank's padded slab (m, S,
    NI); from_grid gathers the slabs back to the flat (n, m) field, on
    every rank."""
    P, k = comm.axis_size(axis), comm.axis_index(axis)
    mg = build_sharded_mg(state, P, k, dtype=dtype, device=device)
    lvl0 = mg.levels[0]
    NI, S = lvl0.plan.NI, lvl0.slab
    NJ = mg.n_nodes0[-1]
    cycle = make_sharded_cycle(comm, axis)

    def to_grid(v_flat):
        v = torch.as_tensor(v_flat).to(device=lvl0.d.device,
                                       dtype=lvl0.d.dtype)
        v = v[:, None] if v.ndim == 1 else v
        g = v.T.reshape(v.shape[1], NJ, NI)
        g = torch.cat([g, g.new_zeros((g.shape[0], P * S - NJ, NI))], dim=1)
        return g[:, k * S:(k + 1) * S].contiguous()

    def from_grid(g):
        full = comm.all_gather(g, axis).movedim(0, 1)       # (m, P, S, NI)
        full = full.reshape(g.shape[0], P * S, NI)[:, :NJ]
        return full.reshape(g.shape[0], NJ * NI).T

    def step_fn(mg, b, x):
        x = cycle(mg, b, x)
        r = _residual(mg.levels[0], b, x, comm, axis)
        return x, torch.sqrt(comm.psum(torch.sum(torch.abs(r) ** 2)))

    return mg, step_fn, to_grid, from_grid
