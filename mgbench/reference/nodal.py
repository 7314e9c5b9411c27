"""The nodal operators of the reference, matrix-free in float64 on any
torch device, and the check of a grid hierarchy's level operators against
their Galerkin coarsening under full weighting.

A mesh of cells (n_0, ..., n_{d-1}) (mesh axis 0 fastest) has node fields
(..., N_{d-1}, ..., N_0), N_a = n_a + 1, on the unit cube (h_a = 1 / n_a).
The operator is sum_a D_a^T (s_a * D_a u) + shift u, with D_a the forward
difference along mesh axis a divided by h_a (nodes -> edges) and s_a the
edge conductivities (1 for the Laplacian).
"""
from __future__ import annotations

import numpy as np
import torch

from mgbench.reference import grid as g


def _avg_clamped(s: torch.Tensor, axis: int) -> torch.Tensor:
    """Cells -> nodes along `axis`: the mean of the two cells around an
    interior node, the one cell at either end."""
    s = torch.movedim(s, axis, 0)
    out = s.new_empty((s.shape[0] + 1,) + tuple(s.shape[1:]))
    out[0], out[-1] = s[0], s[-1]
    out[1:-1] = 0.5 * (s[:-1] + s[1:])
    return torch.movedim(out, 0, axis)


class NodalOperator:
    """A nodal DivSigGrad on cell conductivities `sigma` (None: the
    Laplacian)."""

    def __init__(self, cells, sigma, shift_rel: float, device):
        self.cells = [int(n) for n in cells]
        self.dim = len(self.cells)
        self.grid = tuple(n + 1 for n in reversed(self.cells))
        self.h = [1.0 / n for n in self.cells]
        self.device = torch.device(device)
        self.edges = []           # per mesh axis: edge conductivities
        for a in range(self.dim):
            axis = self.dim - 1 - a          # its tensor axis
            if sigma is None:
                self.edges.append(None)
                continue
            s = torch.as_tensor(np.asarray(sigma, dtype=np.float64),
                                device=self.device)
            for k in range(self.dim):
                if k != axis:
                    s = _avg_clamped(s, k)
            self.edges.append(s)
        self.shift = 0.0
        self.shift = float(shift_rel) * float(self.abs_row_sums().max())

    @property
    def n(self) -> int:
        return int(np.prod(self.grid))

    def _diff(self, u, a):
        axis = u.ndim - self.dim + (self.dim - 1 - a)
        return torch.diff(u, dim=axis) / self.h[a]

    def _diff_t(self, e, a):
        axis = e.ndim - self.dim + (self.dim - 1 - a)
        e = torch.movedim(e, axis, 0)
        out = e.new_zeros((e.shape[0] + 1,) + tuple(e.shape[1:]))
        out[1:] += e
        out[:-1] -= e
        return torch.movedim(out / self.h[a], 0, axis)

    def apply_field(self, u: torch.Tensor) -> torch.Tensor:
        """A u on node fields (..., *grid), float64."""
        y = self.shift * u
        for a in range(self.dim):
            e = self._diff(u, a)
            if self.edges[a] is not None:
                e = e * self.edges[a]
            y = y + self._diff_t(e, a)
        return y

    def abs_row_sums(self) -> torch.Tensor:
        """sum_j |A_ij| without the shift: 2 s_e / h_a^2 over the edges at
        node i (every term of a row has the diagonal's sign pattern)."""
        y = torch.zeros(self.grid, dtype=torch.float64, device=self.device)
        for a in range(self.dim):
            axis = self.dim - 1 - a
            eshape = list(self.grid)
            eshape[axis] -= 1
            w = torch.full(eshape, 2.0 / self.h[a] ** 2,
                           dtype=torch.float64, device=self.device)
            if self.edges[a] is not None:
                w = w * self.edges[a]
            w = torch.movedim(w, axis, 0)
            s = w.new_zeros((w.shape[0] + 1,) + tuple(w.shape[1:]))
            s[1:] += w
            s[:-1] += w
            y = y + torch.movedim(s, 0, axis)
        return y + self.shift

    def to_field(self, x: torch.Tensor) -> torch.Tensor:
        """Flat (n,) or (n, m) in the mesh's order -> (m, *grid)."""
        x2 = x.reshape(self.n, -1)
        return x2.T.reshape((x2.shape[1],) + self.grid)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """A x on flat (n,) or (n, m) vectors, float64."""
        y = self.apply_field(self.to_field(x.to(torch.float64)))
        y = y.reshape(y.shape[0], -1).T
        return y.reshape(x.shape)

    def galerkin_apply(self, level: int, v: torch.Tensor) -> torch.Tensor:
        """R^l A P^l v: the level-l Galerkin operator under full weighting,
        applied to a field v (..., *level grid)."""
        u = v
        for _ in range(level):
            u = g.prolong(u, self.dim)
        u = self.apply_field(u)
        for _ in range(level):
            u = g.restrict(u, self.dim)
        return u

    def level_grid(self, level: int) -> tuple[int, ...]:
        grid = self.grid
        for _ in range(level):
            grid = g.coarse_grid(grid)
        return grid


def level_errors(op: NodalOperator, levels, seed: int) -> list[float]:
    """For each program level l given as (coeff, offsets): the relative gap
    ||A_l v - R^l A P^l v|| / ||R^l A P^l v|| on a field v in [-1, 1)
    drawn from the seed, A_l applied from the program's coefficients in
    float64.  A level whose grid is not the l-th full-weighting coarsening
    of the mesh reads inf."""
    gen = torch.Generator(device=op.device)
    gen.manual_seed(int(seed) % (2 ** 63))
    out = []
    for l, (coeff, offsets) in enumerate(levels):
        grid = op.level_grid(l)
        if tuple(coeff.shape[1:]) != grid:
            out.append(float("inf"))
            continue
        v = torch.rand(grid, generator=gen, dtype=torch.float64,
                       device=op.device) * 2 - 1
        want = op.galerkin_apply(l, v)
        got = g.stencil_apply(coeff.to(op.device, torch.float64), offsets, v)
        out.append(float(torch.linalg.vector_norm(got - want)
                         / torch.linalg.vector_norm(want)))
    return out
