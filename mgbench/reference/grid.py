"""Node-grid arithmetic of the reference: full-weighting transfers and the
apply of a stencil given as per-node coefficients.

Fields are torch tensors (..., *grid) with the slowest mesh axis first
(the mesh's dim-0-fastest linearisation read in C order).  Full weighting
on odd node counts: P interpolates linearly (coarse node I sits on fine
node 2I), R = 0.5^dim P^T.
"""
from __future__ import annotations

import torch


def prolong_axis(c: torch.Tensor, axis: int) -> torch.Tensor:
    """Linear interpolation along `axis`: n coarse nodes -> 2n - 1 fine."""
    c = torch.movedim(c, axis, 0)
    n = c.shape[0]
    f = c.new_zeros((2 * n - 1,) + tuple(c.shape[1:]))
    f[0::2] = c
    f[1::2] = 0.5 * (c[:-1] + c[1:])
    return torch.movedim(f, 0, axis)


def interp_transpose_axis(f: torch.Tensor, axis: int) -> torch.Tensor:
    """P^T along `axis`: 2n - 1 fine nodes -> n coarse."""
    f = torch.movedim(f, axis, 0)
    if f.shape[0] % 2 == 0:
        raise ValueError("full weighting needs an odd node count")
    c = f[0::2].clone()
    c[:-1] += 0.5 * f[1::2]
    c[1:] += 0.5 * f[1::2]
    return torch.movedim(c, 0, axis)


def prolong(c: torch.Tensor, dim: int) -> torch.Tensor:
    """P c on the last `dim` axes."""
    for a in range(c.ndim - dim, c.ndim):
        c = prolong_axis(c, a)
    return c


def restrict(f: torch.Tensor, dim: int) -> torch.Tensor:
    """R f = 0.5^dim P^T f on the last `dim` axes."""
    for a in range(f.ndim - dim, f.ndim):
        f = interp_transpose_axis(f, a)
    return f * 0.5 ** dim


def coarse_grid(grid) -> tuple[int, ...]:
    return tuple((n - 1) // 2 + 1 for n in grid)


def stencil_apply(coeff: torch.Tensor, offsets, x: torch.Tensor):
    """y[i] = sum_k coeff[k, i] x[i + offsets[k]] (zero outside the grid);
    coeff (taps, *grid), x (..., *grid)."""
    grid = tuple(coeff.shape[1:])
    g = len(grid)
    reach = max(abs(d) for off in offsets for d in off)
    pad = []
    for _ in range(g):
        pad += [reach, reach]
    xp = torch.nn.functional.pad(x, pad)
    lead = (slice(None),) * (x.ndim - g)
    y = torch.zeros_like(x)
    for k, off in enumerate(offsets):
        sl = lead + tuple(slice(reach + d, reach + d + n)
                          for d, n in zip(off, grid))
        y += coeff[k] * xp[sl]
    return y
