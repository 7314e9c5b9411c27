"""Regular (tensor-product) mesh — host-side, numpy only.

The port's own copy of mgtpu/models/mesh.py (importing that module would
load mgtpu/__init__.py and with it JAX).  A mesh is a tiny immutable object:
`n` (cells per dimension), `domain` ([x1min,x1max,x2min,x2max,...]) and `h`
(cell widths).

Index conventions: 0-based indices and "dim-0 fastest" linearisation
(Fortran order over (n1,n2[,n3]) grids); `loc2cs` / `cs2loc` convert
between linear and per-dimension indices.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class RegularMesh:
    n: tuple[int, ...]          # number of CELLS per dimension
    domain: tuple[float, ...]   # (x1min, x1max, x2min, x2max, ...)
    h: tuple[float, ...] = field(default=())

    def __post_init__(self):
        n = tuple(int(v) for v in self.n)
        domain = tuple(float(v) for v in self.domain)
        if len(domain) != 2 * len(n):
            raise ValueError("domain must have 2*dim entries")
        h = tuple((domain[2 * i + 1] - domain[2 * i]) / n[i] for i in range(len(n)))
        object.__setattr__(self, "n", n)
        object.__setattr__(self, "domain", domain)
        object.__setattr__(self, "h", h)

    @property
    def dim(self) -> int:
        return len(self.n)

    @property
    def num_cells(self) -> int:
        return int(np.prod(self.n))

    @property
    def num_nodes(self) -> int:
        return int(np.prod([ni + 1 for ni in self.n]))


def get_regular_mesh(domain, n) -> RegularMesh:
    """Constructor mirroring jInv's getRegularMesh(domain, n)."""
    return RegularMesh(tuple(int(v) for v in np.asarray(n).ravel()),
                       tuple(float(v) for v in np.asarray(domain).ravel()))


def get_cell_centered_grid(mesh: RegularMesh) -> np.ndarray:
    """(num_cells, dim) coordinates of cell centers, dim-0 fastest (jInv's
    getCellCenteredGrid)."""
    axes = [mesh.domain[2 * i] + (np.arange(mesh.n[i]) + 0.5) * mesh.h[i]
            for i in range(mesh.dim)]
    grids = np.meshgrid(*axes, indexing="ij")
    return np.stack([g.ravel(order="F") for g in grids], axis=1)


def get_nodal_grid(mesh: RegularMesh) -> np.ndarray:
    """(num_nodes, dim) coordinates of mesh nodes, dim-0 fastest."""
    axes = [mesh.domain[2 * i] + np.arange(mesh.n[i] + 1) * mesh.h[i]
            for i in range(mesh.dim)]
    grids = np.meshgrid(*axes, indexing="ij")
    return np.stack([g.ravel(order="F") for g in grids], axis=1)


def loc2cs(loc, n) -> np.ndarray:
    """Cartesian (0-based, per-dim) -> linear, dim-0 fastest. Vectorised."""
    loc = np.asarray(loc)
    n = np.asarray(n)
    strides = np.concatenate([[1], np.cumprod(n[:-1])])
    return (loc * strides).sum(axis=-1)


def cs2loc(cs, n) -> np.ndarray:
    """Linear (0-based) -> cartesian (..., dim), dim-0 fastest. Vectorised."""
    cs = np.asarray(cs)
    n = np.asarray(n)
    out = np.empty(cs.shape + (len(n),), dtype=np.int64)
    rem = cs
    for d in range(len(n)):
        out[..., d] = rem % n[d]
        rem = rem // n[d]
    return out
