"""Reference for operator "divsig": the nodal DivSigGrad G^T diag(s) G,
with cell conductivities sigma = exp(N(0, 1)) drawn from the
configuration's `sigma_seed` (one conductivity model: the sources change
from run to run, the model does not, so every run seed asks the same
work) and averaged to the edges (two-point averages across the cells
around an edge, taken as the nearest cell at the boundary), plus
shift_rel times its largest absolute row sum on the diagonal; matrix-free
in float64.
"""
from __future__ import annotations

import numpy as np

from mgbench.reference import nodal

level_errors = nodal.level_errors


def inputs(cfg: dict, seed: int) -> dict:
    """Cell sigma, (cells along the slowest axis, ..., along the fastest),
    from one draw of numpy's PCG64 on the configuration's sigma_seed (the
    run's seed draws the sources)."""
    cells = [int(n) for n in cfg["cells"]]
    rng = np.random.default_rng(int(cfg["sigma_seed"]))
    sigma = np.exp(rng.standard_normal(int(np.prod(cells))))
    return {"sigma": sigma.reshape(tuple(reversed(cells)))}


def operator(cfg: dict, inputs: dict, device) -> "nodal.NodalOperator":
    return nodal.NodalOperator(cfg["cells"], inputs["sigma"],
                               float(cfg["shift_rel"]), device)
