"""The program's set-up of a nodal DivSigGrad on the cell conductivities
the benchmark drew (`inputs["sigma"]`, cells along the slowest axis
first), and the level operators of its grid hierarchy as the reference's
`level_errors` reads them.  Operator kinds on the program's nodal
DivSigGrad (operators/divsig.py, operators/hpgmg.py) take both from here.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch


def mg_param(cfg: dict):
    from mgtpu_torch import get_mg_param
    mg = dict(cfg["mg"])
    mg["dtype"] = np.dtype(mg["dtype"]).type
    return get_mg_param(**mg)


def program_matrix(cfg: dict, inputs: dict):
    """The mesh and the program's DivSigGrad plus shift_rel times its
    largest absolute column sum, as a scipy CSR matrix."""
    from mgtpu_torch import get_regular_mesh
    from mgtpu_torch.models.operators import nodal_div_sig_grad_matrix
    cells = [int(n) for n in cfg["cells"]]
    mesh = get_regular_mesh([0.0, 1.0] * len(cells), cells)
    # the (slowest, ..., fastest) cell array in the mesh's dim-0-fastest
    # order
    sigma = np.ascontiguousarray(inputs["sigma"]).reshape(-1)
    A = nodal_div_sig_grad_matrix(mesh, sigma)
    shift = float(cfg["shift_rel"]) * abs(A).sum(axis=0).max()
    return mesh, (A + shift * sp.identity(A.shape[0])).tocsr()


def setup(cfg: dict, inputs: dict, device, spans):
    """The program's state: assembly (span setup.operator), then
    `mg_setup` onto the device (span setup.hierarchy)."""
    from mgtpu_torch import mg_setup
    with spans.span("setup.operator"):
        mesh, A = program_matrix(cfg, inputs)
    with spans.span("setup.hierarchy"):
        mgcfg, rp = mg_param(cfg)
        state = mg_setup(A, mesh, mgcfg, rp, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return state


def levels(state, dtype=None) -> list:
    """(coeff, offsets) of each level operator of the grid hierarchy, the
    coefficients per node (a constant-interior stencil filled in);
    `dtype`: those of the program's copy of the hierarchy in that type
    (`cast_hierarchy`)."""
    hier = state.hier
    if dtype is not None:
        from mgtpu_torch.solvers.mg_solver import cast_hierarchy
        hier = cast_hierarchy(hier, dtype)
    out = []
    for lv in hier.levels:
        A = lv.A
        if A is None:
            break
        if hasattr(A, "coeff"):
            coeff = A.coeff
        else:
            nd = len(A.offsets)
            coeff = A.const.reshape((nd,) + (1,) * len(A.grid)).expand(
                (nd,) + tuple(A.grid)).clone()
            for (start, size), strip in zip(A.boxes, A.strips):
                sl = tuple(slice(s, s + z) for s, z in zip(start, size))
                coeff[(slice(None),) + sl] = strip
        out.append((coeff, A.offsets))
    return out
