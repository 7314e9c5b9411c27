"""Right-hand side "hpgmg": HPGMG-FV's manufactured problem (problem.fv.c,
the Poisson case a = 0, b = 1 with Dirichlet boundaries):

    u(x, y, z) = X(x) X(y) X(z),  X(t) = 2 t^6 - 6 t^5 + 5 t^4 - t^2,
    beta(r) = c1 + c2 tanh(c3 (r - radius)),  r = |(x, y, z) - centre|,
    f = -(beta lap(u) + grad(beta) . grad(u)),

beta the reference's (reference/hpgmg.py) from the configuration's
`beta`, sampled at the mesh's nodes on the unit cube.  It is one vector:
HPGMG times repeated solves of it, so every call of the pool is the same
and the seed changes nothing.
"""
from __future__ import annotations

import torch

from mgbench.reference.hpgmg import beta_grad


def _poly(t):
    """X, X', X'' of HPGMG's one-dimensional factor."""
    x = 2 * t ** 6 - 6 * t ** 5 + 5 * t ** 4 - t ** 2
    dx = 12 * t ** 5 - 30 * t ** 4 + 20 * t ** 3 - 2 * t
    ddx = 60 * t ** 4 - 120 * t ** 3 + 60 * t ** 2 - 2
    return x, dx, ddx


def make(mix: dict, cfg: dict, seed: int, device) -> torch.Tensor:
    cells = [int(n) for n in cfg["cells"]]          # x, y, z (x fastest)
    axes = [torch.arange(n + 1, dtype=torch.float64, device=device) / n
            for n in cells]
    # node fields (z, y, x): the mesh's x-fastest order read in C order
    x = axes[0][None, None, :]
    y = axes[1][None, :, None]
    z = axes[2][:, None, None]
    (X, Xd, Xdd), (Y, Yd, Ydd), (Z, Zd, Zdd) = _poly(x), _poly(y), _poly(z)
    beta, (bx, by, bz) = beta_grad(cfg, (x, y, z))
    lap = Xdd * Y * Z + X * Ydd * Z + X * Y * Zdd
    f = -(beta * lap + bx * Xd * Y * Z + by * X * Yd * Z + bz * X * Y * Zd)
    f = f.reshape(-1)
    return f[None, :, None].expand(int(mix["pool"]), f.numel(),
                                   int(mix["columns"])).contiguous()
