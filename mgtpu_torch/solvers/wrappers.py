"""Solver façades: the reference's AbstractSolver adapter layer.

Counterpart of mgtpu/solvers/wrappers.py (MGWrapper.jl's MGsolver and
SAAMGWrapper.jl's SA_AMGsolver): the hierarchy is set up lazily on the
first solve, an adjoint solve transposes it (`transpose_hierarchy`) when
the system is not symmetric, a Krylov switch picks GMRES / PCG / BiCGSTAB
or stand-alone cycles, and the setup and solve seconds and the iterations
accumulate (reference MGWrapper.jl:6-104, SAAMGWrapper.jl:6-95).  The
hierarchy lives on `device` ("cuda" unless the caller asks for the CPU);
solves return tensors there.
"""
from __future__ import annotations

import torch

from ..setup.classical_amg import classical_amg_setup
from ..setup.hierarchy import (MGConfig, MGState, clear as _clear_state,
                               hierarchy_exists, mg_setup,
                               transpose_hierarchy)
from ..setup.sa_amg import sa_amg_setup
from .mg_solver import (solve_bicgstab_mg, solve_cg_mg, solve_gmres_mg,
                        solve_mg)

__all__ = ["MGSolver", "SAAMGSolver", "ClassicalAMGSolver"]


class MGSolver:
    """Geometric-MG AbstractSolver adapter.

    sym: 1 = SPD (an adjoint solve is a solve), 0 / 2 = general (the
    hierarchy is transposed when the requested transpose state differs,
    reference MGWrapper.jl:50-64)."""

    setup_fn = staticmethod(mg_setup)
    needs_mesh = True

    def __init__(self, cfg: MGConfig, relax_param, mesh=None, sym: int = 1,
                 krylov: str = "gmres", out: int = -1, gmres_inner: int = 5,
                 device=None):
        self.cfg = cfg
        self.relax_param = relax_param
        self.mesh = mesh
        self.sym = sym
        self.krylov = krylov.lower()
        self.out = out
        self.gmres_inner = gmres_inner
        self.device = device
        self.state: MGState | None = None
        self.n_iter = 0
        self.time_setup = 0.0
        self.time_solve = 0.0
        self._do_transpose = 0

    # -- setup -------------------------------------------------------------
    def _ensure_setup(self, A, transpose: bool):
        verbose = self.out > 0
        if not hierarchy_exists(self.state):
            if self.needs_mesh:
                self.state = self.setup_fn(A, self.mesh, self.cfg,
                                           self.relax_param, verbose=verbose,
                                           device=self.device)
            else:
                self.state = self.setup_fn(A, self.cfg, self.relax_param,
                                           verbose=verbose,
                                           device=self.device)
            self._do_transpose = 0
        want = int(transpose)
        if self.sym != 1 and want != self._do_transpose:
            transpose_hierarchy(self.state)
            self._do_transpose = want
        self.time_setup = self.state.time_setup

    def setup_solver(self, A):
        self._ensure_setup(A, transpose=False)
        return self

    # -- solve (reference solveLinearSystem!, MGWrapper.jl:27-86) ------------
    def solve_linear_system(self, A, B, X=None, transpose: bool = False):
        """X with A X = B (A^H X = B when `transpose`); B (n,) or (n, m),
        an array or a tensor."""
        Bt = torch.as_tensor(B)
        if Bt.numel() and float(torch.linalg.vector_norm(Bt)) == 0.0:
            return torch.zeros_like(Bt)
        self._ensure_setup(A, transpose)
        verbose = self.out > 0
        if self.krylov == "bicgstab":
            X, info = solve_bicgstab_mg(self.state, B, X, verbose=verbose)
        elif self.krylov in ("gmres", "fgmres"):
            X, info = solve_gmres_mg(self.state, B, X,
                                     inner=self.gmres_inner, verbose=verbose)
        elif self.krylov in ("pcg", "cg"):
            X, info = solve_cg_mg(self.state, B, X, verbose=verbose)
        else:
            X, info = solve_mg(self.state, B, X, verbose=verbose)
        self.n_iter += int(info["iters"]) * (Bt.shape[1] if Bt.ndim == 2
                                             else 1)
        self.time_solve = self.state.time_solve
        return X

    # -- lifecycle -----------------------------------------------------------
    def copy(self):
        return type(self)(self.cfg, self.relax_param, self.mesh, self.sym,
                          self.krylov, self.out, self.gmres_inner,
                          self.device)

    def clear(self):
        if self.state is not None:
            _clear_state(self.state)
        self.state = None


class SAAMGSolver(MGSolver):
    """SA-AMG AbstractSolver adapter (reference SAAMGWrapper.jl; symmetric
    systems, as the SA setup requires)."""

    setup_fn = staticmethod(sa_amg_setup)
    needs_mesh = False


class ClassicalAMGSolver(MGSolver):
    """Classical-AMG AbstractSolver adapter (the same façade over
    classical_amg_setup)."""

    setup_fn = staticmethod(classical_amg_setup)
    needs_mesh = False
