"""Schur-complement solver for mixed 2x2 block systems with a diagonal
(2,2) block.

Counterpart of mgtpu/solvers/schur.py (the reference's SchurCompSolver,
src/Multigrid/SchurCompSolver.jl): for A_full = [[A, B], [C^T, D]] with D
diagonal (mixed elasticity / Stokes), eliminate the pressure block:
    S  = A - B D^{-1} C^T
    u1 = S^{-1} (q1 - B D^{-1} q2)
    u2 = D^{-1} (q2 - C^T u1)
S is solved by a dense LU on the device (inner="dense", the factor made
there with `torch.linalg.lu_factor`) or by fixed-step FGMRES
preconditioned by hybrid Kaczmarz sweeps (inner="kaczmarz", kernel F; the
reference's hybridKaczmarz option, SchurCompSolver.jl:37-40, 77-84).  The
device state's `solve` runs inside the recorded cycle, so it serves as a
hierarchy's coarsest solver (`setup_coarse`, reference
MGsetup.jl:327-331).  The split point is n_cut = n_total - num_cells
(pressure unknowns are cells), as SchurCompSolver.jl:28.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from ..config import full_fp32, resolve_device
from ..cycle.coarse import DenseLU
from ..ops.ell import ELL, ell_from_scipy

__all__ = ["KaczmarzFGMRESSolver", "SchurCoarse", "SchurComplementSolver"]


@dataclass(frozen=True, eq=False)
class KaczmarzFGMRESSolver:
    """Fixed-step FGMRES preconditioned by hybrid Kaczmarz sweeps."""
    kz: object          # KaczmarzRelax (tensors)
    ell: ELL
    inner: int

    def solve(self, b):
        from ..cycle.kaczmarz import kaczmarz_sweep
        from ..cycle.relax import fgmres_relaxation
        squeeze = b.ndim == 1
        bb = b[:, None] if squeeze else b
        prec = lambda r: kaczmarz_sweep(torch.zeros_like(r), r, self.kz)
        x = fgmres_relaxation(self.ell.matvec, prec, bb,
                              torch.zeros_like(bb), self.inner)
        return x[:, 0] if squeeze else x


@dataclass(frozen=True, eq=False)
class SchurCoarse:
    """The pressure-eliminated solve on the device."""
    B: ELL
    CT: ELL
    Dinv: torch.Tensor
    s_solver: object       # DenseLU | KaczmarzFGMRESSolver
    n_cut: int

    def solve(self, b):
        squeeze = b.ndim == 1
        bb = b[:, None] if squeeze else b
        q1, q2 = bb[: self.n_cut], bb[self.n_cut:]
        dinv = self.Dinv[:, None]
        u1 = self.s_solver.solve(q1 - self.B.matvec(dinv * q2))
        u2 = dinv * (q2 - self.CT.matvec(u1))
        x = torch.cat([u1, u2], dim=0)
        return x[:, 0] if squeeze else x


class SchurComplementSolver:
    """Handle with the lifecycle and the counters (reference
    SchurCompSolver.jl:3-51 surface: setup / solve / copy / clear,
    fac / solve timers), on `device` ("cuda" unless the caller asks for
    the CPU)."""

    def __init__(self, inner: str = "dense", dtype=None,
                 kaczmarz_opts: dict | None = None, device=None):
        self.inner = inner
        self.dtype = dtype
        self.kaczmarz_opts = kaczmarz_opts or {}
        self.device = device
        self.mesh = None
        self.dev: SchurCoarse | None = None
        self.n_fac = 0
        self.fac_time = 0.0
        self.n_solve = 0
        self.solve_time = 0.0

    def setup(self, A_full: sp.spmatrix, mesh) -> "SchurComplementSolver":
        t0 = time.perf_counter()
        dev = resolve_device(self.device)
        A_full = sp.csr_matrix(A_full)
        if self.dtype is not None:
            A_full = A_full.astype(self.dtype)
        n_cut = A_full.shape[0] - int(np.prod(mesh.n))
        A = A_full[:n_cut, :n_cut].tocsr()
        B = A_full[:n_cut, n_cut:].tocsr()
        CT = A_full[n_cut:, :n_cut].tocsr()
        Dinv = 1.0 / A_full[n_cut:, n_cut:].diagonal()
        S = (A - B @ sp.diags(Dinv) @ CT).tocsr()

        if self.inner == "dense":
            with full_fp32():
                s_solver = DenseLU(*torch.linalg.lu_factor(torch.as_tensor(
                    np.asarray(S.todense()), device=dev)))
        elif self.inner == "kaczmarz":
            from ..cycle.kaczmarz import setup_hybrid_kaczmarz
            from ..dd.indices import faces_staggered_indices_of_box_no_pressure
            opts = self.kaczmarz_opts
            kz = setup_hybrid_kaczmarz(
                S, mesh, opts.get("num_domains", [2] * mesh.dim),
                opts.get("index_fn",
                         faces_staggered_indices_of_box_no_pressure),
                opts.get("omega", 0.5), opts.get("num_it", 2),
                dtype=self.dtype)
            E = ell_from_scipy(S, dtype=self.dtype, device=dev)
            s_solver = KaczmarzFGMRESSolver(kz.to(E.values.dtype, dev), E,
                                            opts.get("inner", 10))
        else:
            raise ValueError("inner must be 'dense' or 'kaczmarz'")

        self.dev = SchurCoarse(ell_from_scipy(B, dtype=self.dtype,
                                              device=dev),
                               ell_from_scipy(CT, dtype=self.dtype,
                                              device=dev),
                               torch.as_tensor(Dinv, device=dev), s_solver,
                               int(n_cut))
        self.mesh = mesh
        self.n_fac += 1
        self.fac_time += time.perf_counter() - t0
        return self

    @property
    def is_setup(self) -> bool:
        return self.dev is not None

    def solve(self, b):
        t0 = time.perf_counter()
        x = self.dev.solve(torch.as_tensor(b, device=self.dev.Dinv.device))
        self.n_solve += 1
        self.solve_time += time.perf_counter() - t0
        return x

    def solve_linear_system(self, A_full, b, mesh=None, x=None):
        """Lazy-setup solve (reference solveLinearSystem!,
        SchurCompSolver.jl:55-93)."""
        if not self.is_setup:
            self.setup(A_full, mesh if mesh is not None else self.mesh)
        return self.solve(b)

    # the coarse-solver protocol: the MG coarsest solve (MGsetup.jl:327-331)
    def setup_coarse(self, A_full: sp.spmatrix, mesh, device=None):
        if device is not None:
            self.device = device
        self.setup(A_full, mesh)
        return self.dev

    def copy(self) -> "SchurComplementSolver":
        return SchurComplementSolver(self.inner, self.dtype,
                                     self.kaczmarz_opts, self.device)

    def clear(self) -> None:
        self.dev = None
