"""Classical (Ruge-Stueben) AMG setup.

Counterpart of mgtpu/setup/classical_amg.py (the reference's
ClassicalAMG.jl, coloring.jl and interpolation.jl):

 * strength matrix with symmetrisation and structural dropping
   (ClassicalAMG.jl:84-112);
 * two-pass C/F coloring: a greedy max-influence independent set, then
   the F-F common-C enforcement (coloring.jl:13-122), by the host C++
   kernels (setup/native.py; the numpy passes here are their plain
   versions); the min-coarse second pass (coloring.jl:169-257); or PMIS on
   the device followed by `enforce_common_c` (setup/device_agg.py);
 * direct interpolation with positive/negative splitting
   (interpolation.jl:44-97) or textbook standard interpolation
   (interpolation.jl:167-230);
 * R = P^T, Galerkin RAP and the coarsest Tikhonov shift of SA-AMG.

The host algebra is mgtpu's, so every product equals mgtpu's bit for bit.
The hierarchy runs on the flat ELL/DIA engine on the state's device
("cuda" unless the caller asks for the CPU).
"""
from __future__ import annotations

import heapq
import time
from dataclasses import replace

import numpy as np
import scipy.sparse as sp

from ..config import resolve_device
from . import native
from .device_agg import enforce_common_c, pmis_coloring
from .hierarchy import (MGConfig, MGState, _check_ported,
                        _per_level_relax_param, _RelaxThunk,
                        build_device_hierarchy)

__all__ = ["classical_amg_setup", "strength_matrix_classical",
           "cf_coloring_first", "cf_coloring_second", "cf_coloring_second_s",
           "direct_interpolation", "standard_interpolation"]


def strength_matrix_classical(A: sp.spmatrix, theta: float) -> sp.csr_matrix:
    """Strength matrix with weak entries structurally dropped
    (reference ClassicalAMG.jl:84-112: threshold, diag := 1, (S+S')/2,
    dropzeros)."""
    S = (sp.csr_matrix(-A.real)
         if np.iscomplexobj(A.data if hasattr(A, "data") else A)
         else (-A).tocsr())
    S = S.astype(np.float64)
    S.sum_duplicates()
    mm = 1e-16 * max(S.data.max(), 1e-300) if S.nnz else 1e-16
    n = S.shape[0]
    counts = np.diff(S.indptr)
    rows = np.repeat(np.arange(n), counts)
    rowmax = np.full(n, mm)
    np.maximum.at(rowmax, rows, S.data)
    S.data = S.data / rowmax[rows]
    S.data[S.data < theta] = 0.0
    S.setdiag(1.0)
    S = ((S + S.T) * 0.5).tocsr()
    S.eliminate_zeros()
    return S


def cf_coloring_first(S: sp.csr_matrix) -> np.ndarray:
    """Greedy max-degree independent-set C/F split (reference
    coloring.jl:13-97).

    Uses a lazy max-heap over dynamic "influence" counts: repeatedly promote
    the most-connected undecided node to C, demote its strong neighbors to F,
    and bump the counts of their other undecided neighbors.
    Returns coloring: 1 = coarse, 0 = fine.  The plain version of
    `native.cf_coloring_first`.
    """
    native.PLAIN_CALLS["cf_coloring_first"] += 1
    n = S.shape[0]
    indptr, indices = S.indptr, S.indices
    lam = np.diff(indptr).astype(np.int64)
    coloring = np.zeros(n, dtype=np.int8)
    decided = lam <= 1          # only a diagonal: leave fine
    heap = [(-lam[i], i) for i in range(n) if not decided[i]]
    heapq.heapify(heap)
    while heap:
        neg, cur = heapq.heappop(heap)
        if decided[cur] or -neg != lam[cur]:
            continue            # stale heap entry
        coloring[cur] = 1
        decided[cur] = True
        nbrs = indices[indptr[cur]:indptr[cur + 1]]
        for j in nbrs:
            if decided[j]:
                continue
            decided[j] = True   # strong neighbor of a C point -> F
            coloring[j] = 0
            for k in indices[indptr[j]:indptr[j + 1]]:
                if not decided[k]:
                    lam[k] += 1
                    heapq.heappush(heap, (-lam[k], k))
    return coloring


def cf_coloring_second(S: sp.csr_matrix, coloring: np.ndarray) -> np.ndarray:
    """Enforce: every strong F-F pair shares a strong C neighbor; otherwise
    promote (reference coloring.jl:104-122).  After `cf_coloring_first`,
    the plain version of `native.cf_coloring`."""
    native.PLAIN_CALLS["cf_coloring"] += 1
    n = S.shape[0]
    indptr, indices = S.indptr, S.indices
    nbr_sets = [set(indices[indptr[i]:indptr[i + 1]]) for i in range(n)]
    for i in range(n):
        if coloring[i] == 1:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        cconn = {j for j in nbrs if j != i and coloring[j] == 1}
        for j in nbrs:
            if j == i or coloring[j] == 1:
                continue
            # common strong C neighbor of i and j?
            if not any(coloring[k] == 1 and k in cconn
                       for k in nbr_sets[j] if k != i):
                coloring[i] = 1
                break
    return coloring


def cf_coloring_second_s(S: sp.csr_matrix, coloring: np.ndarray) -> np.ndarray:
    """Alternative pass 2 minimising the coarse set (reference
    coloring.jl:169-257): instead of promoting the first endpoint of every
    uncovered strong F-F pair, repeatedly promote the F node covering the
    MOST uncovered pairs until none remain.

    Precondition: S is structurally SYMMETRIC (strength_matrix_classical
    guarantees this).  The incremental pair-count bookkeeping assumes
    i in fconn[j] <=> j in fconn[i]; membership guards below keep the
    counts consistent even if a caller passes an asymmetric S, at the cost
    of treating one-directional pairs as covered early (ADVICE r2)."""
    n = S.shape[0]
    indptr, indices = S.indptr, S.indices
    coloring = np.asarray(coloring).copy()
    fconn = [set() for _ in range(n)]
    cconn = [set() for _ in range(n)]
    for i in range(n):
        if coloring[i] == 1:
            continue
        for j in indices[indptr[i]:indptr[i + 1]]:
            if j == i:
                continue
            (cconn[i] if coloring[j] == 1 else fconn[i]).add(int(j))

    # one full covered-pair sweep up front; afterwards coverage changes are
    # LOCAL to the promoted node's neighborhood, so maintain incremental
    # uncovered-pair counts in a lazy max-heap instead of rescanning all sets
    # after every promotion
    for i in range(n):
        for j in list(fconn[i]):
            if j > i and cconn[i] & cconn[j]:
                fconn[i].discard(j)
                fconn[j].discard(i)
    counts = np.array([len(s) for s in fconn], dtype=np.int64)

    def push(h, i):
        if counts[i] > 0:
            heapq.heappush(h, (-int(counts[i]), i))

    heap = []
    for i in range(n):
        push(heap, i)
    while heap:
        negc, best = heapq.heappop(heap)
        if coloring[best] == 1 or -negc != counts[best] or counts[best] == 0:
            continue            # stale entry
        coloring[best] = 1
        for j in list(fconn[best]):
            if best in fconn[j]:
                fconn[j].discard(best)
                counts[j] -= 1
                push(heap, j)
        fconn[best].clear()
        counts[best] = 0
        # best is now a strong C neighbor of every F node in its row; pairs
        # among those neighbors become covered through best
        nbrs = [int(j) for j in indices[indptr[best]:indptr[best + 1]]
                if j != best and coloring[j] == 0]
        nbrset = set(nbrs)
        for j in nbrs:
            cconn[j].add(best)
        for i2 in nbrs:
            for j2 in list(fconn[i2] & nbrset):
                fconn[i2].discard(j2)
                counts[i2] -= 1
                push(heap, i2)
                if i2 in fconn[j2]:       # asymmetric-S guard (ADVICE r2)
                    fconn[j2].discard(i2)
                    counts[j2] -= 1
                    push(heap, j2)
    return coloring


def standard_interpolation(A: sp.csr_matrix, S: sp.csr_matrix,
                           coloring: np.ndarray) -> sp.csr_matrix:
    """Textbook standard interpolation ("A Multigrid Tutorial"; reference
    interpolation.jl:167-230): F-point weights distribute strong-F-neighbor
    contributions through their shared strong C neighbors,
      w_ij = -(a_ij + sum_m a_im a_mj / sum_{k in Cs_i ∩ S_m} a_mk) / denom,
    denom = a_ii + sum of weak connections.

    Like the reference (where getInterpolation2 exists but getInterpolation
    dispatches to the direct variant, interpolation.jl:13), this formula
    assumes an M-matrix fine operator; Galerkin coarse levels grow positive
    off-diagonals that direct interpolation's pos/neg splitting handles but
    this textbook form does not — use it for two-level or re-discretized
    hierarchies."""
    A = A.tocsr()
    n = A.shape[0]
    Sv = S.copy()
    Sv.data = np.ones_like(Sv.data)
    Sv = Sv.multiply(A).tocsr()
    coarse_index = np.cumsum(coloring) - 1

    rows, cols, vals = [], [], []
    for i in range(n):
        if coloring[i] == 1:
            rows.append(i)
            cols.append(coarse_index[i])
            vals.append(1.0)
            continue
        slo, shi = Sv.indptr[i], Sv.indptr[i + 1]
        s_idx = Sv.indices[slo:shi]
        s_val = Sv.data[slo:shi]
        off = s_idx != i
        alo, ahi = A.indptr[i], A.indptr[i + 1]
        a_row_idx = A.indices[alo:ahi]
        a_row_val = A.data[alo:ahi]
        # denominator: full row sum minus strong off-diagonal connections
        # (a_ii + weak sums, reference getDenominator interpolation.jl:101-113)
        denom = a_row_val.sum() - s_val[off].sum()
        if denom == 0:
            denom = a_row_val[a_row_idx == i].sum()
        strongC_idx = s_idx[off & (coloring[s_idx] == 1)]
        strongF_idx = s_idx[off & (coloring[s_idx] == 0)]
        sv_of = dict(zip(s_idx.tolist(), s_val.tolist()))
        # accumulate per strong-C column j: s_ij plus the through-F
        # contributions; sweep each F-neighbor row ONCE (its inner sum is
        # independent of j), scattering a_mj into the j accumulators — no
        # scalar sparse indexing
        contrib = {int(j): sv_of[int(j)] for j in strongC_idx}
        for m in strongF_idx:
            mlo, mhi = Sv.indptr[m], Sv.indptr[m + 1]
            inner = Sv.data[mlo:mhi][
                np.isin(Sv.indices[mlo:mhi], strongC_idx)].sum()
            if inner == 0:
                continue
            scale = sv_of[int(m)] / inner
            m_alo, m_ahi = A.indptr[m], A.indptr[m + 1]
            for j, a_mj in zip(A.indices[m_alo:m_ahi].tolist(),
                               A.data[m_alo:m_ahi].tolist()):
                if a_mj != 0 and j in contrib:
                    contrib[j] += scale * a_mj
        for j in strongC_idx:
            rows.append(i)
            cols.append(coarse_index[int(j)])
            vals.append(-contrib[int(j)] / denom)
    nc = int(np.sum(coloring))
    return sp.csr_matrix((vals, (rows, cols)), shape=(n, nc))


def direct_interpolation(A: sp.csr_matrix, S: sp.csr_matrix,
                         coloring: np.ndarray) -> sp.csr_matrix:
    """Direct interpolation P (n x nc) with pos/neg splitting
    (reference interpolation.jl:44-97, after the hypre/PyAMG scheme)."""
    n = A.shape[0]
    # values of A on the strong pattern
    Sv = S.copy()
    Sv.data = np.ones_like(Sv.data)
    Sv = Sv.multiply(A).tocsr()
    coarse_index = np.cumsum(coloring) - 1   # C-point -> coarse column

    rows, cols, vals = [], [], []
    for i in range(n):
        if coloring[i] == 1:
            rows.append(i)
            cols.append(coarse_index[i])
            vals.append(1.0)
            continue
        slo, shi = Sv.indptr[i], Sv.indptr[i + 1]
        s_idx = Sv.indices[slo:shi]
        s_val = Sv.data[slo:shi]
        strongC = (coloring[s_idx] == 1) & (s_idx != i)
        sum_strong_pos = s_val[strongC & (s_val > 0)].sum()
        sum_strong_neg = s_val[strongC & (s_val <= 0)].sum()

        alo, ahi = A.indptr[i], A.indptr[i + 1]
        a_idx = A.indices[alo:ahi]
        a_val = A.data[alo:ahi]
        diag = a_val[a_idx == i].sum()
        off = a_idx != i
        sum_all_pos = a_val[off & (a_val > 0)].sum()
        sum_all_neg = a_val[off & (a_val < 0)].sum()

        alpha = sum_all_neg / sum_strong_neg if sum_strong_neg != 0 else 0.0
        if sum_strong_pos == 0:
            diag = diag + sum_all_pos
            beta = 0.0
        else:
            beta = sum_all_pos / sum_strong_pos
        neg_w = -alpha / diag
        pos_w = -beta / diag
        for j, v in zip(s_idx[strongC], s_val[strongC]):
            rows.append(i)
            cols.append(coarse_index[j])
            vals.append((pos_w if v > 0 else neg_w) * v)
    nc = int(coloring.sum())
    return sp.csr_matrix((vals, (rows, cols)), shape=(n, nc))


_INTERPOLATION = {"direct": direct_interpolation,
                  "standard": standard_interpolation}
_COARSENING = ("common-c", "min-coarse", "pmis")


def classical_amg_setup(A: sp.spmatrix, cfg: MGConfig, relax_param=1.0,
                        verbose: bool = False, interpolation: str = "direct",
                        coarsening: str = "common-c",
                        device=None) -> MGState:
    """Build a classical-AMG hierarchy (reference ClassicalAMGsetup,
    ClassicalAMG.jl:5-82) on `device` ("cuda" unless the caller asks for
    the CPU; raises when no card is present).

    interpolation: "direct" (interpolation.jl:44-97) or "standard"
    (interpolation.jl:167-230).  coarsening: "common-c" (coloring.jl:13-122
    by the C++ kernels), "min-coarse" (the C++ first pass, then
    coloring.jl:169-257) or "pmis" (PMIS on `device`, then
    `enforce_common_c`: direct interpolation needs every strong F-F pair to
    share a C neighbor, which PMIS alone does not give).  Coarsening stops
    at 100 dofs or when P is square."""
    t_all = time.perf_counter()
    dev = resolve_device(device)
    if cfg.relax_type not in ("jacobi", "jac-gmres", "spai"):
        raise ValueError("classical AMG supports pointwise relaxations only")
    if interpolation not in _INTERPOLATION:
        raise ValueError(f"unknown interpolation {interpolation!r}")
    if coarsening not in _COARSENING:
        raise ValueError(f"unknown coarsening {coarsening!r}")
    _check_ported(cfg)
    # the original-precision operator: the refined solve certifies against it
    A_orig = sp.csr_matrix(A)
    A = A_orig.astype(cfg.dtype)
    rp_arr = _per_level_relax_param(relax_param, cfg.levels)
    As, Ps, Rs, relax_states = [A], [], [], []
    cop = A.nnz
    levels = cfg.levels
    for l in range(cfg.levels - 1):
        t0 = time.perf_counter()
        A_l = As[l]
        if A_l.shape[0] <= 100:
            if verbose:
                print(f"classical_amg_setup: stopped at level {l}")
            levels = l + 1
            break
        S = strength_matrix_classical(A_l, cfg.strong_conn_param)
        if coarsening == "pmis":
            coloring = enforce_common_c(S, pmis_coloring(S, device=dev))
        elif coarsening == "common-c":
            coloring = native.cf_coloring(S)
        else:
            coloring = cf_coloring_second_s(S, native.cf_coloring_first(S))
        P = _INTERPOLATION[interpolation](A_l.tocsr(), S, coloring)
        if P.shape[0] == P.shape[1]:
            if verbose:
                print(f"classical_amg_setup: stopped at level {l}")
            levels = l + 1
            break
        relax_states.append(_RelaxThunk(A_l, cfg, rp_arr[l], None))
        R = P.conj().T.tocsr()
        Ps.append(P.tocsr())
        Rs.append(R)
        A_c = (R @ A_l @ P).tocsr().astype(cfg.dtype)
        As.append(A_c)
        cop += A_c.nnz
        if verbose:
            print(f"classical_amg_setup: level {l} ({A_l.shape[0]} -> "
                  f"{A_c.shape[0]}) took {time.perf_counter() - t0:.3f}s")
    cfg = replace(cfg, levels=levels, nu_pre=cfg.nu_pre[:levels],
                  nu_post=cfg.nu_post[:levels])
    if verbose:
        print(f"classical_amg_setup: operator complexity = "
              f"{cop / As[0].nnz:.3f}")
    # coarsest-level Tikhonov regularisation (as SA-AMG.jl:63)
    shift = 1e-8 * abs(As[-1]).sum(axis=1).max()
    As[-1] = (As[-1] + shift * sp.identity(As[-1].shape[0])).tocsr()

    state = MGState(cfg, relax_param, As, Ps, Rs, meshes=[], device=dev,
                    A_input=A_orig)
    state.hier = build_device_hierarchy(state, relax_states, verbose)
    state.time_setup += time.perf_counter() - t_all
    return state
