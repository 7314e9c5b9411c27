"""Overlapping Schwarz domain decomposition, serial tier.

Counterpart of mgtpu/dd/schwarz.py (the reference's DomainDecomposition
module: DomainDecomposition.jl, DDSerial.jl): an overlapping box
decomposition of the mesh (dd/indices.py), subdomain operators extracted
from A (or re-discretized with a Dirichlet interface mass), factored once,
then swept as a multiplicative Schwarz iteration over the 2^dim box colors
— as a solver, as an FGMRES preconditioner, or as a hierarchy's coarsest
solver (`setup_coarse`).

 * All subdomains are factored as ONE `BatchedDenseLU` (padded to the
   largest box with identity rows) on the device.
 * One color is one batched step: the domains' block residuals from their
   pre-gathered ELL rows, the batched triangular solves, and one
   `index_add` of the corrections (disjoint within a color; padding adds
   exact zeros, so the order of the adds does not change x).

The multi-device sweep (mgtpu's dd/parallel.py) is dd/parallel.py.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import scipy.sparse as sp
import torch

from ..config import resolve_device, torch_dtype
from ..models.mesh import RegularMesh, cs2loc
from ..ops.ell import ell_from_scipy
from ..solvers.direct import batched_dense_lu, lu_solve_batched
from . import indices as ddi

__all__ = ["SchwarzState", "block_solve", "schwarz_sweep", "DDSolver",
           "DDOperatorConstructor"]


@dataclass(frozen=True, eq=False)
class SchwarzState:
    """Device state: per-domain index sets, gathered operator rows, and the
    batched subdomain factors; `colors` holds the domain ids of each
    Schwarz color."""
    idx: torch.Tensor        # (nd, k) int64 global indices (0 where padded)
    mask: torch.Tensor       # (nd, k) {0, 1} in the value type
    rows_idx: torch.Tensor   # (nd, k, K) ELL columns of the domain rows
    rows_val: torch.Tensor   # (nd, k, K) ELL values
    lu: torch.Tensor         # (nd, k, k) batched LU factors
    piv: torch.Tensor        # (nd, k) LAPACK's 1-based int32 pivots
    colors: tuple            # per color, its domain ids
    color_ids: tuple = ()    # the same as int64 tensors on the device
    perm: torch.Tensor | None = None    # (nd, k) the pivots' row order
    iperm: torch.Tensor | None = None   # and its inverse

    @property
    def num_domains(self) -> int:
        return self.idx.shape[0]

    @property
    def dtype(self):
        return self.rows_val.dtype


def block_solve(idx, mask, ri, rv, lu, perm, iperm, x, b):
    """Batched block residual and solve, the Schwarz correction.

    idx / mask (L, k); ri / rv (L, k, K); lu (L, k, k) with its pivots'
    row order perm / iperm (L, k).  Returns the masked corrections
    t (L, k, m)."""
    L, k, K = ri.shape
    m = x.shape[1]
    xg = x[ri.reshape(-1)].reshape(L, k, K, m)
    ax = torch.einsum("lkq,lkqm->lkm", rv, xg)
    r = (b[idx.reshape(-1)].reshape(L, k, m) - ax) * mask[..., None]
    return lu_solve_batched(lu, perm, iperm, r) * mask[..., None]


def _domain_correction(st: SchwarzState, c: int, x, b):
    """Block residuals and solves of the domains of color c."""
    ids = st.color_ids[c]
    pick = lambda t: t.index_select(0, ids)
    idx = pick(st.idx)
    return idx, block_solve(idx, pick(st.mask), pick(st.rows_idx),
                            pick(st.rows_val), pick(st.lu), pick(st.perm),
                            pick(st.iperm), x, b)


def schwarz_sweep(st: SchwarzState, x, b, num_it: int = 1,
                  symmetric: bool = False):
    """Multiplicative colored Schwarz sweeps (reference solveDDSerial,
    DDSerial.jl:108-139); symmetric= adds the colors backwards after each
    forward pass (solveGSDDSerial).  x, b (n, m)."""
    orders = [tuple(range(len(st.colors)))]
    if symmetric:
        orders.append(tuple(reversed(orders[0])))
    for _ in range(num_it):
        for order in orders:
            for c in order:
                idx, t = _domain_correction(st, c, x, b)
                x = x.index_add(0, idx.reshape(-1), t.reshape(-1, x.shape[1]))
    return x


@dataclass
class DDOperatorConstructor:
    """Per-subdomain re-discretization (reference
    DomainDecompositionOperatorConstructor, DomainDecomposition.jl:49-54):
    get_sub_params(problem_param, mesh, i, num_domains, overlap) -> params;
    get_operator(params, sub_mesh) -> scipy matrix;
    get_dirichlet_mass(i, num_domains, overlap, nc) -> the diagonal
    interface mass added to the subdomain operator (artificial Dirichlet
    cuts)."""
    problem_param: object
    get_sub_params: Callable
    get_operator: Callable
    get_dirichlet_mass: Callable | None = None


_LAYOUTS = {
    "cells": ddi.cell_centered_indices_of_box,
    "nodal": ddi.nodal_indices_of_box,
    "faces": ddi.faces_staggered_indices_of_box_no_pressure,
    "faces-pressure": ddi.faces_staggered_indices_of_box,
}


class DDSolver:
    """Schwarz solver handle (reference DomainDecompositionParam surface:
    setup / solve / preconditioner closure / coarse-solver plug), on
    `device` ("cuda" unless the caller asks for the CPU)."""

    def __init__(self, mesh: RegularMesh, num_domains, overlap,
                 layout: str | Callable = "nodal", dtype=np.float64,
                 device=None):
        self.mesh = mesh
        self.num_domains = np.asarray(num_domains, dtype=np.int64)
        self.overlap = np.asarray(overlap, dtype=np.int64)
        self.index_fn = _LAYOUTS[layout] if isinstance(layout, str) \
            else layout
        self.dtype = np.dtype(dtype).type
        self.device = device
        self.state: SchwarzState | None = None
        self.n_fac = 0
        self.fac_time = 0.0
        self.n_solve = 0
        self.solve_time = 0.0

    # -- setup (reference setupDDSerial, DDSerial.jl:81-106) ----------------
    def _blocks(self, A, ctor):
        """Index sets, dense subdomain blocks (extracted from A, or
        re-discretized by ctor) and box colors."""
        nd = int(np.prod(self.num_domains))
        nc = np.asarray(self.mesh.n)
        index_lists, blocks, colors = [], [], []
        for ic in range(nd):
            i = cs2loc(ic, self.num_domains)
            I = self.index_fn(self.num_domains, self.overlap, i, nc)
            index_lists.append(I)
            colors.append(ddi.box_color(i))
            if ctor is None:
                blocks.append(np.asarray(A[np.ix_(I, I)].todense()))
                continue
            sub_mesh = ddi.sub_mesh_of_box(self.num_domains, self.overlap,
                                           i, self.mesh)
            params = ctor.get_sub_params(ctor.problem_param, self.mesh, i,
                                         self.num_domains, self.overlap)
            AI = sp.csr_matrix(ctor.get_operator(params, sub_mesh))
            if ctor.get_dirichlet_mass is not None:
                mass = ctor.get_dirichlet_mass(i, self.num_domains,
                                               self.overlap, nc)
                AI = AI + sp.diags(np.asarray(mass).ravel())
            blocks.append(np.asarray(AI.todense()).astype(self.dtype))
        return index_lists, blocks, colors

    def setup(self, A_or_ctor) -> "DDSolver":
        t0 = time.perf_counter()
        if isinstance(A_or_ctor, DDOperatorConstructor):
            raise ValueError(
                "constructor setup needs the global operator for residuals; "
                "call setup_with_operator(ctor, A_global)")
        A = sp.csr_matrix(A_or_ctor).astype(self.dtype)
        self._finalize(A, *self._blocks(A, None))
        self.n_fac += 1
        self.fac_time += time.perf_counter() - t0
        return self

    def setup_with_operator(self, ctor: DDOperatorConstructor,
                            A_global: sp.spmatrix) -> "DDSolver":
        """Re-discretization setup: subdomain operators from `ctor` (with
        the Dirichlet interface mass), residuals from the global
        operator."""
        t0 = time.perf_counter()
        A = sp.csr_matrix(A_global).astype(self.dtype)
        self._finalize(A, *self._blocks(A, ctor))
        self.n_fac += 1
        self.fac_time += time.perf_counter() - t0
        return self

    def _finalize(self, A, index_lists, blocks, colors):
        nd = len(blocks)
        k = max(b.shape[0] for b in blocks)
        idx = np.zeros((nd, k), dtype=np.int64)
        mask = np.zeros((nd, k), dtype=self.dtype)
        Bp = np.tile(np.eye(k, dtype=self.dtype)[None], (nd, 1, 1))
        for d, (I, Bd) in enumerate(zip(index_lists, blocks)):
            kk = len(I)
            idx[d, :kk] = I
            mask[d, :kk] = 1
            Bp[d, :kk, :kk] = Bd
        dev = resolve_device(self.device)
        E = ell_from_scipy(A, dtype=self.dtype, device=dev)
        ell_idx, ell_val = E.indices.cpu().numpy(), E.values.cpu().numpy()
        rows_idx = ell_idx[idx].astype(np.int64)            # (nd, k, K)
        rows_val = ell_val[idx] * mask[:, :, None]
        lu = batched_dense_lu(Bp, device=dev)
        ncolors = 2 ** self.mesh.dim
        groups = tuple(tuple(d for d in range(nd) if colors[d] == c)
                       for c in range(ncolors))
        groups = tuple(g for g in groups if g)
        t = lambda a: torch.as_tensor(a, device=dev)
        self.state = SchwarzState(
            t(idx), t(mask), t(rows_idx), t(rows_val), lu.lu, lu.piv,
            groups, tuple(t(np.asarray(g, dtype=np.int64)) for g in groups),
            lu.perm, lu.iperm)
        self._ell = E

    @property
    def is_setup(self) -> bool:
        return self.state is not None

    # -- apply ---------------------------------------------------------------
    def sweep(self, x, b, num_it: int = 1, symmetric: bool = False):
        """Schwarz sweeps from x on b, (n,) or (n, m) arrays or tensors."""
        dev, dt = self.state.idx.device, torch_dtype(self.dtype)
        b2 = torch.as_tensor(b, device=dev).to(dt)
        x2 = torch.as_tensor(x, device=dev).to(dt)
        squeeze = b2.ndim == 1
        if squeeze:
            b2, x2 = b2[:, None], x2[:, None]
        x2 = schwarz_sweep(self.state, x2, b2, num_it, symmetric)
        return x2[:, 0] if squeeze else x2

    def preconditioner(self):
        """One-sweep-from-zero closure (reference getDDpreconditioner,
        DomainDecomposition.jl:136-146)."""
        def prec(r):
            return self.sweep(torch.zeros_like(torch.as_tensor(r)), r, 1)
        return prec

    def solve_linear_system(self, A, b, x=None, tol: float = 1e-6,
                            max_iter: int = 10, restart: int = 5,
                            verbose: bool = False, device_loop: bool = True):
        """FGMRES wrapped around the Schwarz preconditioner (reference
        solveLinearSystem!, DomainDecomposition.jl:99-134); each restart
        a recorded program kept with the Schwarz state.  b (n,) or (n, m);
        returns (x, info)."""
        from ..krylov.fgmres import fgmres
        t0 = time.perf_counter()
        if not self.is_setup:
            self.setup(A)
        dev, dt = self.state.idx.device, torch_dtype(self.dtype)
        rows = lambda v: (v[:, None] if v.ndim == 1 else v).T.contiguous()
        bt = torch.as_tensor(b, device=dev).to(dt)
        squeeze = bt.ndim == 1
        B = rows(bt)                                  # (m, n) rows
        X0 = None if x is None else rows(torch.as_tensor(x, device=dev)
                                         .to(dt))
        ell, st = self._ell, self.state
        mv = lambda v: ell.matvec(v.T).T
        prec = lambda v: schwarz_sweep(st, torch.zeros_like(v.T), v.T).T
        X, info = fgmres(mv, B, restart=restart, prec=prec, x0=X0, tol=tol,
                         max_iter=max_iter, verbose=verbose,
                         device_loop=device_loop,
                         cache=(st, ("dd", id(ell)), (ell,)))
        self.n_solve += 1
        self.solve_time += time.perf_counter() - t0
        X = X.T
        return (X[:, 0] if squeeze else X.contiguous()), info

    # -- the MG coarsest-solver protocol (reference MGsetup.jl:324-326) ------
    def setup_coarse(self, A: sp.spmatrix, mesh=None, device=None):
        if mesh is not None:
            self.mesh = mesh
        if device is not None:
            self.device = device
        self.setup(A)
        return _SchwarzCoarse(self.state)

    def copy(self) -> "DDSolver":
        return DDSolver(self.mesh, self.num_domains, self.overlap,
                        self.index_fn, self.dtype, self.device)

    def clear(self) -> None:
        self.state = None


@dataclass(frozen=True, eq=False)
class _SchwarzCoarse:
    """One multiplicative sweep from zero as the coarsest-level solve, in
    the Schwarz state's precision (b's type in and out)."""
    st: SchwarzState

    def solve(self, b):
        squeeze = b.ndim == 1
        bb = (b[:, None] if squeeze else b).to(self.st.dtype)
        x = schwarz_sweep(self.st, torch.zeros_like(bb), bb, 1).to(b.dtype)
        return x[:, 0] if squeeze else x
