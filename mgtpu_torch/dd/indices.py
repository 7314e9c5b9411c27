"""Overlapping box decomposition of a regular mesh (host-side index geometry).

The port's own copy of mgtpu/dd/indices.py (importing that module would
load mgtpu/__init__.py and with it JAX), the counterpart of the
reference's DDIndices.jl / DDService.jl: split the cell grid into
numDomains boxes, extend each box by `overlap` cells clipped at the domain
boundary, and produce per-subdomain index lists for each variable layout:
cell-centered, nodal, face-staggered with and without a pressure block.

These index sets drive the Schwarz solvers (dd/schwarz.py), the hybrid
Kaczmarz smoother's domains (cycle/kaczmarz.py) and the DD coarsest-level
solver.  All indices are 0-based with dim-0 fastest linearisation; numpy
only, bit for bit mgtpu's.
"""
from __future__ import annotations

import numpy as np

from ..models.mesh import RegularMesh, get_regular_mesh, cs2loc

__all__ = [
    "bounding_box_cells",
    "box_with_overlap",
    "cell_centered_indices_of_box",
    "nodal_indices_of_box",
    "faces_staggered_indices_of_box",
    "faces_staggered_indices_of_box_no_pressure",
    "sub_mesh_of_box",
    "dirichlet_mass_nodal",
    "indices_of_cells_array",
    "box_color",
]


def bounding_box_cells(num_domains, i, nc):
    """Cell bounding box (inclusive lo, hi) of subdomain `i` (0-based coords).

    The last subdomain along each axis absorbs the remainder cells.
    """
    num_domains = np.asarray(num_domains)
    i = np.asarray(i)
    nc = np.asarray(nc)
    size = nc // num_domains
    lo = i * size
    hi = lo + size - 1
    hi = np.where(i == num_domains - 1, nc - 1, hi)
    return lo, hi


def box_with_overlap(lo, hi, limit, overlap):
    """Extend [lo, hi] by `overlap`, clipped to [0, limit-1]."""
    lo = np.asarray(lo).copy()
    hi = np.asarray(hi).copy()
    limit = np.asarray(limit)
    overlap = np.asarray(overlap)
    lo = np.where(lo > 0, np.maximum(lo - overlap, 0), lo)
    hi = np.where(hi < limit - 1, np.minimum(hi + overlap, limit - 1), hi)
    return lo, hi


def _box_linear_indices(lo, hi, grid_shape):
    """Linear indices (dim-0 fastest) of all points in the inclusive box."""
    axes = [np.arange(lo[d], hi[d] + 1) for d in range(len(grid_shape))]
    grids = np.meshgrid(*axes, indexing="ij")
    strides = np.concatenate([[1], np.cumprod(np.asarray(grid_shape)[:-1])])
    idx = sum(g.ravel(order="F") * s for g, s in zip(grids, strides))
    return idx.astype(np.int64)


def cell_centered_indices_of_box(num_domains, overlap, i, nc):
    lo, hi = bounding_box_cells(num_domains, i, nc)
    lo, hi = box_with_overlap(lo, hi, np.asarray(nc), overlap)
    return _box_linear_indices(lo, hi, list(nc))


def nodal_indices_of_box(num_domains, overlap, i, nc):
    nc = np.asarray(nc)
    lo, hi = bounding_box_cells(num_domains, i, nc)
    # nodes: the box owns nodes [lo, hi+1] before overlap
    lo, hi = box_with_overlap(lo, hi + 1, nc + 1, overlap)
    return _box_linear_indices(lo, hi, list(nc + 1))


def _face_grid(nc, j):
    nc = np.asarray(nc)
    s = nc.copy()
    s[j] += 1
    return s


def faces_staggered_indices_of_box(num_domains, overlap, i, nc):
    """Indices of all face variables + pressure owned by box i (with overlap)."""
    nc = np.asarray(nc)
    dim = len(nc)
    lo0, hi0 = bounding_box_cells(num_domains, i, nc)
    parts = []
    offset = 0
    for j in range(dim):
        gshape = _face_grid(nc, j)
        hi_j = hi0.copy()
        hi_j[j] += 1  # faces: one extra layer along the normal axis
        lo, hi = box_with_overlap(lo0, hi_j, gshape, overlap)
        parts.append(_box_linear_indices(lo, hi, list(gshape)) + offset)
        offset += int(np.prod(gshape))
    lo, hi = box_with_overlap(lo0, hi0, nc, overlap)
    parts.append(_box_linear_indices(lo, hi, list(nc)) + offset)
    return np.concatenate(parts)


def faces_staggered_indices_of_box_no_pressure(num_domains, overlap, i, nc):
    nc = np.asarray(nc)
    dim = len(nc)
    lo0, hi0 = bounding_box_cells(num_domains, i, nc)
    parts = []
    offset = 0
    for j in range(dim):
        gshape = _face_grid(nc, j)
        hi_j = hi0.copy()
        hi_j[j] += 1
        lo, hi = box_with_overlap(lo0, hi_j, gshape, overlap)
        parts.append(_box_linear_indices(lo, hi, list(gshape)) + offset)
        offset += int(np.prod(gshape))
    return np.concatenate(parts)


def sub_mesh_of_box(num_domains, overlap, i, mesh: RegularMesh) -> RegularMesh:
    """Physical sub-mesh covered by box i (with overlap)."""
    nc = np.asarray(mesh.n)
    lo, hi = bounding_box_cells(num_domains, i, nc)
    lo, hi = box_with_overlap(lo, hi, nc, overlap)
    dom = list(mesh.domain)
    for d in range(mesh.dim):
        dom[2 * d] = mesh.domain[2 * d] + lo[d] * mesh.h[d]
        dom[2 * d + 1] = mesh.domain[2 * d + 1] - (nc[d] - 1 - hi[d]) * mesh.h[d]
    return get_regular_mesh(dom, hi - lo + 1)


def dirichlet_mass_nodal(num_domains, overlap, i, nc):
    """Nodal interface mass: 1 on internal (artificial) boundaries of box i.

    Used when subdomain operators are re-discretized rather than extracted —
    Dirichlet conditions are imposed on the cuts (reference DDIndices.jl:165-193,
    test/DomainDecomposition/DDPoissonFuncs.jl:13-17). Works in 2D and 3D.
    """
    nc = np.asarray(nc)
    lo, hi = bounding_box_cells(num_domains, i, nc)
    lo, hi = box_with_overlap(lo, hi + 1, nc + 1, overlap)
    shape = tuple(hi - lo + 1)
    mass = np.zeros(shape)
    for d in range(len(nc)):
        if lo[d] > 0:
            sl = [slice(None)] * len(nc)
            sl[d] = 0
            mass[tuple(sl)] = 1.0
        if hi[d] < nc[d]:
            sl = [slice(None)] * len(nc)
            sl[d] = shape[d] - 1
            mass[tuple(sl)] = 1.0
    return mass.ravel(order="F")


def box_color(i) -> int:
    """2^dim multiplicative-Schwarz color of box i (parity per axis)."""
    i = np.asarray(i)
    return int(sum((i[d] % 2) << d for d in range(len(i))))


def indices_of_cells_array(mesh: RegularMesh, overlap, num_domains,
                           index_fn) -> np.ndarray:
    """(max_len, num_domains) padded table of per-domain index lists.

    Padding entries are -1 (the reference pads with 0 in 1-based indexing and
    skips them in the native kernel — parRelax.h:20-21; we mask instead).
    """
    nc = np.asarray(mesh.n)
    num_domains = np.asarray(num_domains)
    nd = int(np.prod(num_domains))
    lists = []
    for ic in range(nd):
        i = cs2loc(ic, num_domains)
        lists.append(index_fn(num_domains, np.asarray(overlap), i, nc))
    max_len = max(len(l) for l in lists)
    out = -np.ones((max_len, nd), dtype=np.int64)
    for ic, l in enumerate(lists):
        out[: len(l), ic] = l
    return out
