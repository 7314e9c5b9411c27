"""Build the port's grid hierarchy from plain arrays.

A hierarchy exported as numpy arrays — for example the leaves of an mgtpu
`GridHierarchy`, taken with ``np.asarray`` — becomes a `GridHierarchy` of
this package, so a cycle can run on exactly the reference's operators,
diagonals (Jacobi, SPAI and Jac-GMRES levels), line states, transfers and
coarsest solve (dense inverse or FGMRES) and be compared node for node.
"""
from __future__ import annotations

import numpy as np
import torch

from .cycle.grid_cycle import (DenseInverse, GridHierarchy,
                               GridIterativeCoarse, GridLevel, line_state_to)
from .cycle.relax import AltLineRelax, LineRelax
from .ops.grid_stencil import ConstGridStencil, GridStencil

__all__ = ["grid_hierarchy_from_arrays"]


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


def grid_hierarchy_from_arrays(levels, coarse_inv, coarse_grid, *,
                               device) -> GridHierarchy:
    """levels: one mapping per level with
         ``offsets``, ``grid`` and either ``const``, ``strips``, ``boxes``
         (a constant-interior stencil) or ``coeff`` (a dense stencil);
         ``d`` (grid-shaped diagonal) or ``line`` (a line-Jacobi state:
         a mapping of alpha, pivot, cprime, axis, omega, or a tuple of
         them for alternating lines), ``P1`` (per-grid-axis 1D
         prolongation factors, None for an axis that does not coarsen) and
         ``lam`` (spectral bound) — None on the coarsest level.
    coarse_inv: (nc, nc) dense inverse of the coarsest operator, or a
         mapping {``d``, ``inner``} for the FGMRES coarsest solve
         (`GridIterativeCoarse` on the last level's operator: grid-shaped
         damped inverse diagonal, projection steps);
    coarse_grid: its node grid."""
    out = []
    for lv in levels:
        offsets = tuple(tuple(int(v) for v in o) for o in lv["offsets"])
        grid = tuple(int(v) for v in lv["grid"])
        if "const" in lv:
            A = ConstGridStencil.from_arrays(lv["const"], lv["strips"],
                                             offsets, grid, lv["boxes"],
                                             device=device)
        else:
            A = GridStencil(_as_tensor(lv["coeff"], device), offsets, grid)
        P1 = lv.get("P1")
        if P1 is not None:
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
