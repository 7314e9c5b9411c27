"""Reference for operator "hpgmg": HPGMG-FV's variable coefficient as the
nodal G^T diag(s) G, with the cell conductivities s = beta at the cell
centres,

    beta(r) = c1 + c2 tanh(c3 (r - radius)),  r = |(x, y, z) - centre|,
    c1 = (max + min) / 2,  c2 = (max - min) / 2,  c3 = sharpness

(the configuration's `beta`; HPGMG-FV's problem.fv.c evaluateBeta), on the
unit cube, averaged to the edges, plus shift_rel times the largest
absolute row sum on the diagonal; matrix-free in float64.  Nothing is
drawn from the seed.
"""
from __future__ import annotations

import numpy as np
import torch

from mgbench.reference import nodal

level_errors = nodal.level_errors


def beta_grad(cfg: dict, coords):
    """beta and its gradient at points (x, y, z) (broadcasting float64
    tensors)."""
    b = cfg["beta"]
    c1 = (b["max"] + b["min"]) / 2
    c2 = (b["max"] - b["min"]) / 2
    d = [c - float(o) for c, o in zip(coords, b["centre"])]
    r = torch.sqrt(d[0] ** 2 + d[1] ** 2 + d[2] ** 2)
    th = torch.tanh(b["sharpness"] * (r - b["radius"]))
    dr = c2 * b["sharpness"] * (1 - th ** 2)
    safe = torch.where(r > 0, r, torch.ones_like(r))
    grad = [torch.where(r > 0, dr * di / safe, torch.zeros_like(r))
            for di in d]
    return c1 + c2 * th, grad


def inputs(cfg: dict, seed: int) -> dict:
    """Cell beta, (cells along z, y, x): the mesh's x-fastest cell order
    read in C order."""
    cells = [int(n) for n in cfg["cells"]]
    x, y, z = ((torch.arange(n, dtype=torch.float64) + 0.5) / n
               for n in cells)
    beta, _ = beta_grad(cfg, (x[None, None, :], y[None, :, None],
                              z[:, None, None]))
    return {"sigma": np.ascontiguousarray(beta.numpy())}


def operator(cfg: dict, inputs: dict, device) -> "nodal.NodalOperator":
    return nodal.NodalOperator(cfg["cells"], inputs["sigma"],
                               float(cfg["shift_rel"]), device)
