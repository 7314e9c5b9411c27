"""Direct solver tier (the reference's ParallelJuliaSolver equivalent).

Counterpart of mgtpu/solvers/direct.py:

 * `DirectSolver` — one system, factor once / solve many, A and A^H
   solves, float32, float64, complex64 and complex128, with the
   counters n_fac, fac_time, n_solve and solve_time:
     - backend "dense": a dense LU on the device (`torch.linalg.lu_factor`,
       getrf) and its triangular solves (`lu_solve`, `adjoint=` for A^H) —
       mgtpu computes these in XLA, not in a Pallas kernel, so the library
       calls stay;
     - backend "host": scipy's SuperLU on the host for matrices too large
       to densify; A^H x = b through the conjugate of an A^T solve.
 * `BatchedDenseLU` — many equally sized systems factored and solved as
   one batched call (the reference's OpenMP loop over num_LUs x num_rhs,
   parLU.cpp:122-190); the Schwarz subdomains' factors (dd/schwarz.py).

The dense backend runs on `device` ("cuda" unless the caller asks for the
CPU; raises without a card).  `setup_coarse` plugs the dense backend in as
a hierarchy's coarsest solver (mg_setup's `coarse_solver=`).
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from ..config import full_fp32, resolve_device, torch_dtype

__all__ = ["DirectSolver", "BatchedDenseLU", "batched_dense_lu"]


class DirectSolver:
    """Factor-once / solve-many direct solver with counters (reference
    AbstractSolver surface: setup / solve / clear / copy, nFac / facTime /
    nSolve / solveTime, parallelJuliaSolver.jl:48-60, 89-105)."""

    def __init__(self, backend: str = "dense", dtype=None,
                 dense_limit: int = 8192, device=None):
        if backend not in ("dense", "host"):
            raise ValueError("backend must be 'dense' or 'host'")
        self.backend = backend
        self.dtype = dtype
        self.dense_limit = dense_limit
        self.device = device
        self.factor = None
        self.n_fac = 0
        self.fac_time = 0.0
        self.n_solve = 0
        self.solve_time = 0.0

    # -- lifecycle ---------------------------------------------------------
    def setup(self, A: sp.spmatrix) -> "DirectSolver":
        t0 = time.perf_counter()
        A = sp.csr_matrix(A)
        if self.dtype is not None:
            A = A.astype(self.dtype)
        if self.backend == "dense":
            if A.shape[0] > self.dense_limit:
                raise ValueError(
                    f"dense backend refuses n={A.shape[0]} > dense_limit="
                    f"{self.dense_limit}; use backend='host'")
            dev = resolve_device(self.device)
            with full_fp32():
                self.factor = torch.linalg.lu_factor(torch.as_tensor(
                    np.asarray(A.todense()), device=dev))
        else:
            self.factor = spla.splu(A.tocsc())
        self.n_fac += 1
        self.fac_time += time.perf_counter() - t0
        return self

    def clear(self) -> None:
        self.factor = None

    def copy(self) -> "DirectSolver":
        return DirectSolver(self.backend, self.dtype, self.dense_limit,
                            self.device)

    @property
    def is_setup(self) -> bool:
        return self.factor is not None

    # -- solves ------------------------------------------------------------
    def solve(self, b, transpose: bool = False) -> torch.Tensor:
        """x with A x = b, or A^H x = b when `transpose` (the reference's
        doTranspose).  b (n,) or (n, m), an array or a tensor; x comes
        back on the factor's device (the host backend's on the CPU)."""
        t0 = time.perf_counter()
        if self.backend == "dense":
            lu, piv = self.factor
            bt = torch.as_tensor(b, device=lu.device).to(lu.dtype)
            b2 = bt[:, None] if bt.ndim == 1 else bt
            with full_fp32():
                x = torch.linalg.lu_solve(lu, piv, b2, adjoint=transpose)
            x = x[:, 0] if bt.ndim == 1 else x
        else:
            bh = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) \
                else np.asarray(b)
            if not transpose:
                xh = self.factor.solve(bh)
            else:
                # A^H x = b  <=>  A^T conj(x) = conj(b)
                xh = np.conj(self.factor.solve(np.conj(bh), trans="T"))
            x = torch.from_numpy(np.ascontiguousarray(xh))
        self.n_solve += 1
        self.solve_time += time.perf_counter() - t0
        return x

    def solve_linear_system(self, A, b, x=None, transpose: bool = False):
        """Lazy-setup solve (reference solveLinearSystem!,
        parallelJuliaSolver.jl:89-105)."""
        if not self.is_setup:
            self.setup(A)
        return self.solve(b, transpose)

    # -- coarse-solver protocol (plugs into the recorded cycle) ------------
    def setup_coarse(self, A: sp.spmatrix, mesh=None, device=None):
        """Factor A (the hierarchy's coarsest operator) on `device` (the
        hierarchy's) and return the port's `DenseLU` of it."""
        if self.backend != "dense":
            raise ValueError("only the dense backend can run inside the "
                             "recorded cycle")
        if device is not None:
            self.device = device
        self.setup(A)
        from ..cycle.coarse import DenseLU
        return DenseLU(*self.factor)


@dataclass(frozen=True, eq=False)
class BatchedDenseLU:
    """LU of a batch of equally sized dense systems, solved in one call:
    lu (nb, k, k) packed L\\U, LAPACK's 1-based int32 pivots (nb, k), and
    the row order they apply (perm: (P^T b)[i] = b[perm[i]]) with its
    inverse.  The solves are two batched triangular solves
    (`solve_triangular`, cuBLAS trsm on the card) around a gather, which a
    CUDA graph records."""
    lu: torch.Tensor
    piv: torch.Tensor
    perm: torch.Tensor
    iperm: torch.Tensor

    def solve(self, B: torch.Tensor) -> torch.Tensor:
        """B (nb, k, m) -> X (nb, k, m)."""
        return lu_solve_batched(self.lu, self.perm, self.iperm, B)

    def solve_adjoint(self, B: torch.Tensor) -> torch.Tensor:
        return lu_solve_batched(self.lu, self.perm, self.iperm, B,
                                adjoint=True)


def _rows(B: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """B (nb, k, m) with its rows taken in `order` (nb, k)."""
    return torch.gather(B, 1, order[:, :, None].expand(-1, -1, B.shape[2]))


def lu_solve_batched(lu, perm, iperm, B, adjoint: bool = False):
    """X with A X = B (A^H X = B when `adjoint`) from A's packed LU."""
    tri = torch.linalg.solve_triangular
    with full_fp32():
        if not adjoint:
            y = tri(lu, _rows(B, perm), upper=False, unitriangular=True)
            return tri(lu, y, upper=True)
        luh = lu.mH
        z = tri(luh, B, upper=False)
        return _rows(tri(luh, z, upper=True, unitriangular=True), iperm)


def pivots_to_permutation(piv: np.ndarray) -> np.ndarray:
    """The row order LAPACK's 1-based sequential swaps apply, (nb, k)."""
    nb, k = piv.shape
    perm = np.tile(np.arange(k), (nb, 1))
    rows = np.arange(nb)
    for i in range(k):
        j = piv[:, i] - 1
        a, b = perm[rows, i].copy(), perm[rows, j].copy()
        perm[rows, i], perm[rows, j] = b, a
    return perm


def batched_dense_lu(blocks, dtype=None, device=None) -> BatchedDenseLU:
    """Factor (nb, k, k) dense blocks (an array or a tensor) on `device`."""
    dev = resolve_device(device)
    A = torch.as_tensor(np.asarray(blocks) if not isinstance(
        blocks, torch.Tensor) else blocks, device=dev)
    if dtype is not None:
        A = A.to(torch_dtype(dtype))
    with full_fp32():
        lu, piv = torch.linalg.lu_factor(A)
    perm = pivots_to_permutation(piv.cpu().numpy().astype(np.int64))
    return BatchedDenseLU(lu, piv, torch.as_tensor(perm, device=dev),
                          torch.as_tensor(np.argsort(perm, axis=1),
                                          device=dev))
