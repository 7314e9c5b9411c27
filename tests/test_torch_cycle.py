"""Cycle parity: the PyTorch port's grid_cycle on mgtpu's own hierarchy,
carried across as plain arrays (mgtpu_torch/convert.py), against
mgtpu.cycle.grid_cycle.grid_cycle, on the CPU."""
import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

import mgtpu
from mgtpu.cycle.grid_cycle import grid_cycle as cycle_ref
from mgtpu.models.operators import nodal_laplacian_matrix

import mgtpu_torch as mt
from mgtpu_torch.convert import grid_hierarchy_from_arrays
from mgtpu_torch.cycle.grid_cycle import grid_cycle as cycle_port

SETTINGS = {"jacobi": dict(relax_type="jacobi", relax_param=0.8, nu_pre=1,
                           nu_post=1),
            "chebyshev": dict(relax_type="chebyshev", cheby_degree=3,
                              nu_pre=1, nu_post=0)}


def hierarchy_arrays(gh):
    """Plain numpy arrays of an mgtpu GridHierarchy (np.asarray on leaves)."""
    levels = []
    for lv in gh.levels:
        A = lv.A
        if hasattr(A, "const"):
            spec = dict(const=np.asarray(A.const),
                        strips=[np.asarray(s) for s in A.strips],
                        boxes=A.boxes)
        else:
            spec = dict(coeff=np.asarray(A.coeff))
        spec.update(offsets=A.offsets, grid=A.grid,
                    d=None if lv.d is None else np.asarray(lv.d),
                    P1=None if lv.P1 is None
                    else [np.asarray(p) for p in lv.P1],
                    lam=lv.lam)
        levels.append(spec)
    return levels, np.asarray(gh.coarse.inv), gh.coarse.grid


def _setup(dims, levels, relax):
    M = mgtpu.get_regular_mesh([0.0, 1.0] * len(dims), dims)
    L = nodal_laplacian_matrix(M)
    L = (L + 1e-4 * abs(L).sum(0).max() * sp.identity(L.shape[0])).tocsr()
    kw = dict(levels=levels, dtype=np.float32, **SETTINGS[relax])
    st = mgtpu.mg_setup(L, M, *mgtpu.get_mg_param(**kw))
    return st, kw


@pytest.mark.parametrize("dims,levels", [([24, 24, 24], 3), ([64, 64], 4)])
@pytest.mark.parametrize("relax", ["jacobi", "chebyshev"])
@pytest.mark.parametrize("ctype", ["V", "W", "F"])
@pytest.mark.parametrize("x_zero", [False, True])
def test_grid_cycle_matches_reference(dims, levels, relax, ctype, x_zero):
    st, kw = _setup(dims, levels, relax)
    cfg_r, _ = mgtpu.get_mg_param(cycle_type=ctype, **kw)
    cfg_p, _ = mt.get_mg_param(cycle_type=ctype, **kw)
    gh_p = grid_hierarchy_from_arrays(*hierarchy_arrays(st.hier),
                                      device="cpu")
    grid = st.hier.fine_grid
    rng = np.random.RandomState(levels + len(dims))
    b = rng.rand(2, *grid).astype(np.float32)
    x = np.zeros_like(b)
    if not x_zero:
        # a realistic non-zero iterate: the reference's first cycle
        x = np.array(cycle_ref(cfg_r, st.hier, jnp.asarray(b),
                               jnp.asarray(x)))
    y_ref = np.asarray(cycle_ref(cfg_r, st.hier, jnp.asarray(b),
                                 jnp.asarray(x), x_zero=x_zero))
    y = cycle_port(cfg_p, gh_p, torch.from_numpy(b), torch.from_numpy(x),
                   x_zero=x_zero).numpy()
    assert y.shape == y_ref.shape and y.dtype == np.float32
    err = np.abs(y.astype(np.float64) - y_ref).max() / np.abs(y_ref).max()
    assert err < 1e-5, err


def test_x_zero_matches_explicit_zero_start():
    """x_zero=True is the same cycle as a zero iterate (test_xzero.py's
    contract on the port: float32-equivalent on the fused 3D branch)."""
    st, kw = _setup([24, 24, 24], 3, "jacobi")
    cfg, _ = mt.get_mg_param(**kw)
    gh = grid_hierarchy_from_arrays(*hierarchy_arrays(st.hier), device="cpu")
    b = torch.from_numpy(np.random.RandomState(3).rand(
        1, *gh.fine_grid).astype(np.float32))
    y0 = cycle_port(cfg, gh, b, torch.zeros_like(b))
    y1 = cycle_port(cfg, gh, b, torch.zeros_like(b), x_zero=True)
    assert float((y0 - y1).abs().max() / y0.abs().max()) < 1e-5


@pytest.mark.parametrize("fn", ["relax_diag", "chebyshev_smooth",
                                "chebyshev4_smooth"])
def test_relax_functions_match_reference(fn):
    """The smoother kernels of cycle/relax.py on flat (n, m) columns with an
    SPD matrix, against mgtpu.cycle.relax on the same inputs (float32)."""
    import mgtpu.cycle.relax as ref
    import mgtpu_torch.cycle.relax as port
    rng = np.random.RandomState(5)
    n, m = 40, 2
    B = rng.rand(n, n).astype(np.float32)
    A = (B @ B.T / n + np.eye(n, dtype=np.float32)).astype(np.float32)
    b, x = rng.rand(n, m).astype(np.float32), rng.rand(n, m).astype(np.float32)
    dvec = (0.8 / np.diag(A)).astype(np.float32)
    lam = float(np.abs(np.linalg.eigvals(dvec[:, None] * A)).max()) * 1.05
    Aj, At = jnp.asarray(A), torch.from_numpy(A)
    r = b - A @ x
    if fn == "relax_diag":
        want = ref.relax_diag(lambda v: Aj @ v, jnp.asarray(r), jnp.asarray(x),
                              jnp.asarray(b), jnp.asarray(dvec), 3)
        got = port.relax_diag(lambda v: At @ v, torch.from_numpy(r),
                              torch.from_numpy(x), torch.from_numpy(b),
                              torch.from_numpy(dvec), 3)
    elif fn == "chebyshev_smooth":
        d2 = dvec[:, None]
        want = ref.chebyshev_smooth(lambda v: Aj @ v, jnp.asarray(d2), lam, 3,
                                    0.25, jnp.asarray(r), jnp.asarray(x),
                                    jnp.asarray(b))
        got = port.chebyshev_smooth(lambda v: At @ v, torch.from_numpy(d2),
                                    lam, 3, 0.25, torch.from_numpy(r),
                                    torch.from_numpy(x), torch.from_numpy(b))
    else:
        d2 = dvec[:, None]
        want = ref.chebyshev4_smooth(lambda v: Aj @ v, jnp.asarray(d2), lam, 4,
                                     jnp.asarray(r), jnp.asarray(x))
        got = port.chebyshev4_smooth(lambda v: At @ v, torch.from_numpy(d2),
                                     lam, 4, torch.from_numpy(r),
                                     torch.from_numpy(x))
    want = np.asarray(want)
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() < 1e-5
