"""Coarsest-grid solvers of the flat engine.

Counterpart of mgtpu/cycle/coarse.py.  Vectors are flat columns, (n,) or
(n, m):

 * `DenseLU` — LU factors computed on the host (LAPACK getrf through
   scipy, in the hierarchy's precision), solved on the device as mgtpu's
   `lu_solve` does: the pivots' row order taken by a gather, then two
   triangular solves (`solve_triangular`, cuBLAS trsm on the card; no
   library workspace is allocated inside a recording, so a recorded loop
   around it can take the device-side while form).  scipy's pivots are
   0-based row swaps; LAPACK's, which torch takes, are 1-based:
   `dense_lu_from_scipy` adds one.
 * `IterativeCoarse` — one-shot Jacobi-preconditioned FGMRES on the ELL
   form of the coarsest operator (the reference's MGcycle.jl:152-168
   escape hatch).
 * `SparseLUCoarse` — SuperLU on the host for coarsest levels beyond the
   replicated-dense budget: each solve takes b to the host, solves there
   and brings x back.  That round trip is mgtpu's own design point for
   this case (a host callback there); setup says so when verbose.  It is a
   host step (capture.host_step): a recorded cycle splits around it.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from ..config import double_variant
from ..ops.ell import ell_from_scipy, ell_matvec
from .capture import host_step
from .relax import fgmres_relaxation

__all__ = ["DenseLU", "IterativeCoarse", "SparseLUCoarse",
           "dense_lu_from_scipy", "iterative_coarse_from_scipy",
           "sparse_lu_from_scipy"]


@dataclass(frozen=True, eq=False)
class DenseLU:
    """Replicated dense LU of the coarsest operator: packed L\\U, LAPACK's
    1-based int32 pivots, and the row order they apply (perm: (P^T b)[i] =
    b[perm[i]]) with its inverse, made from the pivots where not given.
    The factors are kept in row-major order whatever order they came in
    (scipy's are column-major), so that every copy of one factorisation
    solves to the same bits."""
    lu: torch.Tensor
    piv: torch.Tensor
    perm: torch.Tensor | None = None
    iperm: torch.Tensor | None = None

    def __post_init__(self):
        object.__setattr__(self, "lu", self.lu.contiguous())
        if self.perm is None:
            from ..solvers.direct import pivots_to_permutation
            perm = pivots_to_permutation(
                self.piv.cpu().numpy().astype(np.int64)[None])[0]
            dev = self.lu.device
            object.__setattr__(self, "perm", torch.as_tensor(perm, device=dev))
            object.__setattr__(self, "iperm", torch.as_tensor(
                np.argsort(perm), device=dev))

    def _solve(self, b, adjoint: bool):
        from ..solvers.direct import lu_solve_batched
        b2 = b[:, None] if b.ndim == 1 else b
        lu = self.lu
        if lu.dtype.itemsize < 4:
            # a bfloat16 cycle: torch has no triangular solve below float32,
            # so the bfloat16 factors are solved in float32 arithmetic
            lu, b2 = lu.float(), b2.float()
        x = lu_solve_batched(lu[None], self.perm[None], self.iperm[None],
                             b2[None], adjoint=adjoint)[0]
        x = x.to(b.dtype)
        return x[:, 0] if b.ndim == 1 else x

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        return self._solve(b, False)

    def solve_adjoint(self, b: torch.Tensor) -> torch.Tensor:
        return self._solve(b, True)


@dataclass(frozen=True, eq=False)
class IterativeCoarse:
    """One-shot Jacobi-preconditioned FGMRES coarsest solve: `inner`
    projection steps from zero."""
    d: torch.Tensor
    ell_idx: torch.Tensor
    ell_val: torch.Tensor
    inner: int

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        squeeze = b.ndim == 1
        bb = b[:, None] if squeeze else b
        dcol = self.d[:, None]
        x = fgmres_relaxation(
            lambda v: ell_matvec(self.ell_idx, self.ell_val, v),
            lambda r: dcol * r, bb, torch.zeros_like(bb), self.inner)
        return x[:, 0] if squeeze else x

    def solve_adjoint(self, b: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError("transpose the hierarchy instead")


@dataclass(frozen=True, eq=False)
class SparseLUCoarse:
    """Host SuperLU coarsest solve (float64 or complex128 factor); b is
    (n,) or (n, m) on any device and x comes back on b's device in b's
    type."""
    factor: object          # scipy.sparse.linalg.SuperLU
    n: int
    dtype_name: str

    def _host(self, bh: torch.Tensor, trans: str) -> torch.Tensor:
        out = self.factor.solve(bh.numpy().astype(self.factor.U.dtype),
                                trans=trans)
        return torch.from_numpy(out).to(bh.dtype)

    def _solve_n(self, bh):
        return self._host(bh, "N")

    def _solve_h(self, bh):
        return self._host(bh, "H")

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """A host step (capture.host_step): inside a recorded program the
        program splits around it."""
        return host_step(self._solve_n, b)

    def solve_adjoint(self, b: torch.Tensor) -> torch.Tensor:
        return host_step(self._solve_h, b)


def sparse_lu_from_scipy(A: sp.spmatrix, dtype=None) -> SparseLUCoarse:
    """SuperLU (COLAMD ordering, partial pivoting) of A on the host, in
    float64 or complex128 (scipy's splu types)."""
    from scipy.sparse.linalg import splu
    fac = splu(A.tocsc().astype(double_variant(A.dtype)))
    return SparseLUCoarse(fac, int(A.shape[0]),
                          str(np.dtype(dtype or A.dtype)))


def dense_lu_from_scipy(A: sp.spmatrix, dtype=None,
                        device="cpu") -> DenseLU:
    """LU factors of A (getrf on the host, in `dtype`) on `device`."""
    import scipy.linalg as sla
    n = A.shape[0]
    if n > 70000:
        raise ValueError(
            f"coarsest grid has {n} unknowns — too large for a replicated "
            "dense LU. Use more levels, or coarse_solve='gmres'.")
    Ad = np.asarray(A.todense())
    if dtype is not None:
        Ad = Ad.astype(dtype)
    lu, piv = sla.lu_factor(Ad)
    return DenseLU(torch.as_tensor(lu, device=device),
                   torch.as_tensor(piv.astype(np.int32) + 1, device=device))


def iterative_coarse_from_scipy(A: sp.spmatrix, omega, inner: int = 10,
                                dtype=None, device="cpu") -> IterativeCoarse:
    d = np.asarray(omega / A.diagonal())
    if dtype is not None:
        d = d.astype(dtype)
    E = ell_from_scipy(A.tocsr(), dtype=dtype, device=device)
    return IterativeCoarse(torch.as_tensor(d, device=device), E.indices,
                           E.values, int(inner))
