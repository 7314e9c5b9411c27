"""Build the port's hierarchies from plain arrays.

A hierarchy exported as numpy arrays — for example the leaves of an mgtpu
`GridHierarchy` or flat `Hierarchy`, taken with ``np.asarray`` — becomes
one of this package, so a cycle can run on exactly the reference's
operators, diagonals (Jacobi, SPAI and Jac-GMRES levels), line states,
transfers (per-axis factors or stride-2 stencils) and coarsest solve and
be compared node for node.

LU pivots are taken as scipy's and JAX's ``lu_factor`` give them, 0-based;
torch's `lu_solve` reads LAPACK's 1-based pivots, so they gain one here.
"""
from __future__ import annotations

import numpy as np
import torch

from .cycle.coarse import DenseLU, IterativeCoarse
from .cycle.grid_cycle import (DenseInverse, GridHierarchy,
                               GridIterativeCoarse, GridLevel, line_state_to)
from .cycle.relax import AltLineRelax, ChebyshevRelax, DiagRelax, LineRelax
from .ops.dia import DIA
from .ops.ell import ELL
from .ops.grid_stencil import (ConstGridStencil, GridStencil,
                               Stride2Transfer, _shift_np)
from .setup.hierarchy import Hierarchy, Level

__all__ = ["grid_hierarchy_from_arrays", "flat_hierarchy_from_arrays",
           "matrix_from_arrays", "dense_lu_from_arrays",
           "stride2_from_arrays"]


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
    Stride2Transfer on `device`."""
    coeff = np.asarray(spec["coeff"])
    offsets = tuple(tuple(int(v) for v in o) for o in spec["offsets"])
    coeff_r = np.stack([_shift_np(coeff[k], o)
                        for k, o in enumerate(offsets)])
    return Stride2Transfer(torch.tensor(coeff, device=device),
                           torch.tensor(coeff_r, device=device), offsets,
                           tuple(int(v) for v in spec["fine_grid"]),
                           tuple(int(v) for v in spec["coarse_grid"]))


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


def flat_hierarchy_from_arrays(levels, coarse, *, device) -> Hierarchy:
    """levels: one mapping per level with ``A`` (a `matrix_from_arrays`
    mapping), and below the coarsest ``P`` and ``R`` (ELL mappings) and
    ``d`` (the smoother diagonal) with ``lam_max`` for a Chebyshev level.
    coarse: {``lu``, ``piv``} (0-based pivots) for `DenseLU`, or
    {``d``, ``ell_idx``, ``ell_val``, ``inner``} for `IterativeCoarse`."""
    out = []
    for lv in levels:
        A = matrix_from_arrays(lv["A"], device)
        if lv.get("P") is None:
            out.append(Level(A, None, None, None))
            continue
        d = _as_tensor(lv["d"], device)
        relax = (DiagRelax(d) if lv.get("lam_max") is None
                 else ChebyshevRelax(d, float(lv["lam_max"])))
        out.append(Level(A, matrix_from_arrays(lv["P"], device),
                         matrix_from_arrays(lv["R"], device), relax))
    if "lu" in coarse:
        solver = dense_lu_from_arrays(coarse["lu"], coarse["piv"], device)
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
