"""Regular (tensor-product) mesh — host-side, numpy only.

The port's own copy of mgtpu/models/mesh.py (importing that module would
load mgtpu/__init__.py and with it JAX).  A mesh is a tiny immutable object:
`n` (cells per dimension), `domain` ([x1min,x1max,x2min,x2max,...]) and `h`
(cell widths).

Index conventions: 0-based indices and "dim-0 fastest" linearisation
(Fortran order over (n1,n2[,n3]) grids).
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
