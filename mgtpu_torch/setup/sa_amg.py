"""Smoothed-aggregation AMG setup (host side).

Counterpart of mgtpu/setup/sa_amg.py (the reference's SA-AMG.jl: standard
smoothed aggregation with Galerkin RAP, after Treister & Yavneh SISC 37(1)
2015):

 * strength of connection: rows of -A scaled by their largest
   off-diagonal, unit diagonal, thresholded, symmetrised (SA-AMG.jl:88-116);
 * greedy neighborhood aggregation in three passes with hub-node deferral
   and affinity-scored adoption of leftover nodes (SA-AMG.jl:119-211), by
   the host C++ kernel (setup/native.py; numpy as its plain version), or
   MIS-2 aggregation on the device (setup/device_agg.py, MGTPU_AGG=device);
 * with a regular `mesh`: structured block-2^dim aggregates instead, so
   every level stays a grid stencil and the smoothed transfers stay
   stride-2 stencils — the hierarchy runs on the grid engine;
 * tentative P0 -> smoothed P = (I - (4/3 / rho) D A) P0, D the level's
   smoother diagonal, rho = min(opnorm_1, opnorm_inf) (SA-AMG.jl:44-47);
 * R = P^T, Galerkin RAP (or the sparsified non-Galerkin operators),
   coarsest Tikhonov shift 1e-8 ||A||_inf (SA-AMG.jl:50,63).

The device hierarchy lands on the state's device ("cuda" unless the caller
asks for the CPU).
"""
from __future__ import annotations

import os
import time
from dataclasses import replace

import numpy as np
import scipy.sparse as sp
import torch

from ..config import resolve_device
from . import native
from . import smoothers as sm
from .device_agg import device_aggregation
from .hierarchy import (MGConfig, MGState, _check_ported,
                        _per_level_relax_param, _RelaxThunk,
                        build_device_hierarchy)

__all__ = ["sa_amg_setup", "get_aggregation", "strength_matrix",
           "neighborhood_aggregation", "aggregation_to_tentative_p",
           "structured_tentative_p", "sparsify_non_galerkin"]

_SA_RELAX = ("jacobi", "jac-gmres", "spai", "chebyshev", "chebyshev4")


def strength_matrix(A: sp.spmatrix, theta: float) -> sp.csr_matrix:
    """Symmetrised strength-of-connection matrix (values thresholded,
    pattern kept)."""
    S = (-A).tocsr().astype(np.float64)
    S.sum_duplicates()
    mm = 1e-16 * max(S.data.max(), 1e-300) if S.nnz else 1e-16
    n = S.shape[0]
    counts = np.diff(S.indptr)
    rows = np.repeat(np.arange(n), counts)
    rowmax = np.full(n, mm)
    np.maximum.at(rowmax, rows, S.data)
    S.data = S.data / rowmax[rows]
    S.setdiag(1.0)
    S.data[S.data < theta] = 0.0
    return (S + S.T).tocsr()


def neighborhood_aggregation(S: sp.csr_matrix, tau: float = 3.0) -> np.ndarray:
    """Greedy neighborhood aggregation; returns aggr[i] = root node of i's
    aggregate (SA-AMG.jl:119-211, 0-based); the plain version of
    `native.aggregate`."""
    native.PLAIN_CALLS["aggregate"] += 1
    n = S.shape[0]
    indptr, indices, data = S.indptr, S.indices, S.data
    aggr = np.zeros(n, dtype=np.int64) - 1        # -1: unaggregated
    counts = np.diff(indptr)
    avg = counts.mean() if n else 0.0
    hub = counts > tau * avg
    agg_size = np.zeros(n, dtype=np.int64)

    # pass 1: seed aggregates at non-hub nodes with fully free neighborhoods
    for k in range(n):
        if hub[k]:
            continue
        nbrs = indices[indptr[k]:indptr[k + 1]]
        if np.any(aggr[nbrs] >= 0):
            continue
        sel = nbrs[~hub[nbrs]]
        aggr[sel] = k
        agg_size[k] = len(sel)

    # pass 2: hubs with untouched neighborhoods seed their own aggregates
    for k in range(n):
        if not hub[k]:
            continue
        nbrs = indices[indptr[k]:indptr[k + 1]]
        if np.any(aggr[nbrs] >= 0):
            continue
        aggr[nbrs] = k
        agg_size[k] = len(nbrs)

    # pass 3: leftover nodes adopt the neighboring aggregate with the best
    # mean affinity (sum of strength values into it / its size)
    for k in range(n):
        if aggr[k] >= 0:
            continue
        lo, hi = indptr[k], indptr[k + 1]
        nbrs = indices[lo:hi]
        vals = data[lo:hi]
        roots = aggr[nbrs]
        ok = roots >= 0
        if not np.any(ok):
            aggr[k] = k                  # isolated: a singleton aggregate
            agg_size[k] += 1
            continue
        scores = {}
        for r, v in zip(roots[ok], vals[ok]):
            scores[r] = scores.get(r, 0.0) + v
        aggr[k] = max(scores, key=lambda r: scores[r] / max(agg_size[r], 1))
    return aggr


def aggregation_to_tentative_p(aggr: np.ndarray) -> sp.csr_matrix:
    """Unit tentative prolongator from an aggregate-root labelling
    (reference aggrArray2P, SA-AMG.jl:213-224)."""
    n = len(aggr)
    roots = np.unique(aggr)
    root2col = -np.ones(n, dtype=np.int64)
    root2col[roots] = np.arange(len(roots))
    cols = root2col[aggr]
    if np.any(cols < 0):
        raise RuntimeError("nodes without aggregates")
    return sp.csr_matrix((np.ones(n), (np.arange(n), cols)),
                         shape=(n, len(roots)))


def get_aggregation(A: sp.spmatrix, theta: float, method: str = "auto",
                    device=None) -> sp.csr_matrix:
    """P0, or the identity when the level is too small to coarsen
    (SA-AMG.jl:78-86: n <= 100 stops).

    method "auto"/"greedy": the greedy sweep, by the host C++ kernel
    (`native.aggregate`, the same aggregates as `neighborhood_aggregation`);
    "device": MIS-2 aggregation (`device_agg.device_aggregation`) on
    `device` ("cuda" unless the caller asks for the CPU).  MGTPU_AGG in the
    environment overrides `method`, as in mgtpu."""
    n = A.shape[0]
    if n <= 100:
        return sp.identity(n, format="csr")
    method = os.environ.get("MGTPU_AGG", method).lower()
    if method not in ("auto", "greedy", "device"):
        raise ValueError(f"unknown aggregation method {method!r}")
    S = strength_matrix(A, theta)
    if method == "device":
        aggr = device_aggregation(S, device=device)
    else:
        aggr = native.aggregate(S)
    return aggregation_to_tentative_p(aggr)


def structured_tentative_p(node_counts):
    """Block-2^dim tentative prolongator on a node grid: aggregates are
    per-axis index pairs {2c, 2c+1} (a trailing singleton on odd extents).
    Returns (P0, coarse_counts)."""
    node_counts = [int(v) for v in np.asarray(node_counts).ravel()]
    ncs = [(nn + 1) // 2 for nn in node_counts]
    strides_c = np.concatenate([[1], np.cumprod(ncs[:-1])]).astype(np.int64)
    n = int(np.prod(node_counts))
    idx = np.arange(n)
    cols = np.zeros(n, dtype=np.int64)
    rem = idx
    for a, nn in enumerate(node_counts):
        coord = rem % nn
        rem = rem // nn
        cols += (coord // 2) * strides_c[a]
    P0 = sp.csr_matrix((np.ones(n), (idx, cols)),
                       shape=(n, int(np.prod(ncs))))
    return P0, ncs


def _rho_estimate(M: sp.spmatrix) -> float:
    """Cheap spectral-radius bound: min of the operator 1- and inf-norms."""
    Mabs = abs(M)
    return float(min(Mabs.sum(axis=0).max(), Mabs.sum(axis=1).max()))


def sparsify_non_galerkin(A_g: sp.csr_matrix, A_fine: sp.csr_matrix,
                          P0: sp.csr_matrix, filtering_param: float = 0.0,
                          pattern_distance: int = 1) -> sp.csr_matrix:
    """Sparsified non-Galerkin coarse operator (Treister & Yavneh, SISC
    37(1) 2015): keep the entries of the Galerkin product whose aggregates
    touch in the tentative pattern P0^T |A| P0 (distance `pattern_distance`
    in the aggregate graph), optionally drop kept entries with
    |a_ij| < filtering_param sqrt(|a_ii a_jj|), and lump every removed
    entry into its row's diagonal (row sums, the action on constants, are
    kept)."""
    A_g = A_g.tocsr()
    pat = (abs(P0).T @ abs(A_fine) @ abs(P0)).tocsr()
    pat.data[:] = 1.0
    for _ in range(pattern_distance - 1):
        pat = (pat @ pat).tocsr()
        pat.data[:] = 1.0

    keep = A_g.multiply(pat).tocsr()
    removed = (A_g - keep).tocsr()

    if filtering_param > 0.0:
        d = np.abs(keep.diagonal())
        coo = keep.tocoo()
        weak = (np.abs(coo.data) <
                filtering_param * np.sqrt(d[coo.row] * d[coo.col]))
        weak &= coo.row != coo.col
        if weak.any():
            removed = (removed + sp.coo_matrix(
                (coo.data[weak], (coo.row[weak], coo.col[weak])),
                shape=A_g.shape)).tocsr()
            coo.data[weak] = 0.0
            keep = sp.coo_matrix((coo.data, (coo.row, coo.col)),
                                 shape=A_g.shape).tocsr()
            keep.eliminate_zeros()

    lump = np.asarray(removed.sum(axis=1)).ravel()
    return (keep + sp.diags(lump)).tocsr()


def sa_amg_setup(A: sp.spmatrix, cfg: MGConfig, relax_param=1.0,
                 verbose: bool = False, non_galerkin: bool = False,
                 mesh=None, device=None) -> MGState:
    """Build a smoothed-aggregation hierarchy (reference SA_AMGsetup,
    SA-AMG.jl:8-76) on `device` ("cuda" unless the caller asks for the
    CPU; raises when no card is present).

    With the matrix's regular `mesh` (nodal or cell-centered sizes) and
    ``cfg.engine`` "auto" or "grid", aggregation is structured and the
    hierarchy runs on the grid engine; without a mesh, greedy aggregation
    and the flat ELL/DIA engine.  non_galerkin=True (or a pattern
    distance) sparsifies the coarse operators, filtered by
    cfg.filtering_param."""
    t_all = time.perf_counter()
    dev = resolve_device(device)
    if cfg.relax_type not in _SA_RELAX:
        raise ValueError("SA-AMG supports pointwise relaxations only "
                         "(same as the reference, SA-AMG.jl:27-31); "
                         "chebyshev counts — it is diagonal-based")
    _check_ported(cfg)
    # the original-precision operator: the refined solve certifies against it
    A_orig = sp.csr_matrix(A)
    A = A_orig.astype(cfg.dtype)
    structured_nodes = None
    if mesh is not None and cfg.engine in ("auto", "grid"):
        ncells = [int(v) for v in np.asarray(mesh.n).ravel()]
        for nodes in ([v + 1 for v in ncells], ncells):
            if int(np.prod(nodes)) == A.shape[0]:
                structured_nodes = nodes
                break
    rp_arr = _per_level_relax_param(relax_param, cfg.levels)
    As, Ps, Rs, relax_states = [A], [], [], []
    host_diags = []
    nn_levels = [structured_nodes]
    cop = A.nnz
    levels = cfg.levels
    for l in range(cfg.levels - 1):
        t0 = time.perf_counter()
        A_l = As[l]
        if structured_nodes is not None:
            if A_l.shape[0] <= 100:
                P0 = sp.identity(A_l.shape[0], format="csr")
            else:
                P0, nc_nodes = structured_tentative_p(nn_levels[l])
        else:
            P0 = get_aggregation(A_l, cfg.strong_conn_param, device=dev)
        if P0.shape[0] == P0.shape[1]:
            if verbose:
                print(f"sa_amg_setup: stopped coarsening at level {l}")
            levels = l + 1
            break
        relax_states.append(_RelaxThunk(A_l, cfg, rp_arr[l], None))
        # prolongator-smoothing diagonal, from the host matrix
        if cfg.relax_type == "spai":
            d = sm.spai_diag(A_l, rp_arr[l]).astype(cfg.dtype)
        else:
            d = sm.jacobi_diag(A_l, rp_arr[l]).astype(cfg.dtype)
        host_diags.append(d)
        DA = sp.diags(d) @ A_l
        c = (4.0 / 3.0) / max(_rho_estimate(DA), 1e-300)
        P = (P0 - c * (DA @ P0)).tocsr()
        R = P.conj().T.tocsr()
        Ps.append(P)
        Rs.append(R)
        if structured_nodes is not None:
            nn_levels.append(nc_nodes)
        A_c = (R @ A_l @ P).tocsr().astype(cfg.dtype)
        if non_galerkin:
            # an int non_galerkin is the aggregate-graph pattern distance
            A_c = sparsify_non_galerkin(A_c, A_l, P0, cfg.filtering_param,
                                        pattern_distance=int(non_galerkin))
        As.append(A_c)
        cop += A_c.nnz
        if verbose:
            print(f"sa_amg_setup: level {l} ({A_l.shape[0]} dofs -> "
                  f"{A_c.shape[0]}) took {time.perf_counter() - t0:.3f}s")
    cfg = replace(cfg, levels=levels, nu_pre=cfg.nu_pre[:levels],
                  nu_post=cfg.nu_post[:levels])
    if verbose:
        print(f"sa_amg_setup: operator complexity = {cop / As[0].nnz:.3f}")
    # coarsest-level Tikhonov regularisation (reference SA-AMG.jl:63)
    shift = 1e-8 * abs(As[-1]).sum(axis=1).max()
    As[-1] = (As[-1] + shift * sp.identity(As[-1].shape[0])).tocsr()

    state = MGState(cfg, relax_param, As, Ps, Rs,
                    meshes=([mesh] if mesh is not None else []), device=dev,
                    A_input=A_orig)
    state.hier = None
    if structured_nodes is not None:
        try:
            state.hier = _structured_sa_hierarchy(state, nn_levels,
                                                  relax_states, verbose)
        except ValueError:
            # tiny coarse grids can defeat the stencil decomposition; the
            # matrices are still valid — the flat engine takes them
            pass
    if state.hier is None:
        state.hier = build_device_hierarchy(state, relax_states, verbose)
    state.time_setup += time.perf_counter() - t_all
    return state


def _structured_sa_hierarchy(state: MGState, nn_levels, relax_states,
                             verbose: bool = False):
    """GridHierarchy of the structured-aggregation SA path: grid-stencil
    level operators and stride-2 smoothed-prolongator transfers.

    The smoother states are the configuration's own (`_setup_relax`), so a
    Chebyshev level carries its undamped diagonal and spectral bound;
    mgtpu's structured path gives it the damped Jacobi diagonal and no
    bound, and its cycle then fails (ROADMAP, queue 3, F7)."""
    from ..cycle.grid_cycle import GridHierarchy, GridLevel, grid_coarsest
    from ..ops.grid_stencil import (make_grid_stencil,
                                    stride2_transfer_from_scipy)
    from .hierarchy import _resolve_relax

    cfg, dev = state.config, state.device
    nlev = state.num_levels
    levels = []
    for l in range(nlev):
        # SA coarse stencils widen with depth (about one node of radius a
        # level); the extractor escalates within what the grid can tell apart
        radius = min(2 + l, (min(nn_levels[l]) - 1) // 2, 6)
        try:
            A_st = make_grid_stencil(state.As[l], nn_levels[l],
                                     dtype=cfg.dtype,
                                     max_shift=max(radius, 1), device=dev)
        except ValueError:
            # with a dense coarsest and V/W/F cycles nothing applies the
            # coarsest operator's stencil
            if (l == nlev - 1 and cfg.coarse_solve == "lu"
                    and cfg.cycle_type != "K"):
                levels.append(GridLevel(None, None, None))
                continue
            raise
        d = P1 = lam = None
        if l < nlev - 1:
            rs = _resolve_relax(relax_states[l])
            d = torch.as_tensor(np.asarray(rs.d, dtype=cfg.dtype),
                                device=dev).reshape(A_st.grid)
            lam = getattr(rs, "lam_max", None)
            P1 = stride2_transfer_from_scipy(
                state.Ps[l], nn_levels[l], nn_levels[l + 1], dtype=cfg.dtype,
                max_delta=max(radius + 1, 3), device=dev)
        levels.append(GridLevel(A_st, d, P1, lam))
    grid_c = tuple(reversed([int(v) for v in nn_levels[nlev - 1]]))
    # mgtpu's SA path inverts a small coarsest with pinv outright
    coarse = grid_coarsest(state, levels[-1].A, grid_c, dev,
                           host_inverse=lambda Ad: np.linalg.pinv(
                               Ad, rcond=1e-12))
    if verbose:
        print("sa_amg_setup: structured aggregation on the grid engine")
    return GridHierarchy(tuple(levels), coarse)
