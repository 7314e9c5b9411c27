"""Build the port's grid hierarchy from plain arrays.

A hierarchy exported as numpy arrays — for example the leaves of an mgtpu
`GridHierarchy`, taken with ``np.asarray`` — becomes a `GridHierarchy` of
this package, so a cycle can run on exactly the reference's operators,
diagonals and transfers and be compared node for node.
"""
from __future__ import annotations

import numpy as np
import torch

from .cycle.grid_cycle import DenseInverse, GridHierarchy, GridLevel
from .ops.grid_stencil import ConstGridStencil, GridStencil

__all__ = ["grid_hierarchy_from_arrays"]


def _as_tensor(a, device):
    return None if a is None else torch.tensor(np.asarray(a), device=device)


def grid_hierarchy_from_arrays(levels, coarse_inv, coarse_grid, *,
                               device) -> GridHierarchy:
    """levels: one mapping per level with
         ``offsets``, ``grid`` and either ``const``, ``strips``, ``boxes``
         (a constant-interior stencil) or ``coeff`` (a dense stencil);
         ``d`` (grid-shaped diagonal), ``P1`` (per-grid-axis 1D
         prolongation factors) and ``lam`` (spectral bound) — None on the
         coarsest level.
    coarse_inv: (nc, nc) dense inverse of the coarsest operator;
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
        out.append(GridLevel(A, _as_tensor(lv.get("d"), device), P1,
                             None if lam is None else float(lam)))
    return GridHierarchy(tuple(out), DenseInverse(
        _as_tensor(coarse_inv, device), tuple(int(v) for v in coarse_grid)))
