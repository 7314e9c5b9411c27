"""Solve drivers of the PyTorch port against mgtpu and the reference's
testGMG contract, on the CPU."""
import numpy as np
import jax  # noqa: F401  (conftest pins JAX to the CPU with x64 on)
import pytest
import scipy.sparse as sp

import mgtpu
import mgtpu_torch as mt
from mgtpu_torch.models.operators import nodal_laplacian_matrix

SETTINGS = {"jacobi": dict(relax_type="jacobi", relax_param=0.8, nu_pre=1,
                           nu_post=1),
            "chebyshev": dict(relax_type="chebyshev", cheby_degree=3,
                              nu_pre=1, nu_post=0)}


def _problem(dims, shift=True):
    M = mt.get_regular_mesh([0.0, 1.0] * len(dims), dims)
    L = nodal_laplacian_matrix(M)
    if shift:
        L = (L + 1e-4 * abs(L).sum(0).max()
             * sp.identity(L.shape[0])).tocsr()
    b = L @ np.random.RandomState(0).rand(L.shape[0])
    return M, L, b / np.linalg.norm(b)


def _true_relres(L, b, x):
    x = x.numpy().astype(np.float64)
    assert x.shape == b.shape and np.isfinite(x).all()
    return float(np.linalg.norm(b - L @ x) / np.linalg.norm(b))


def test_gmg_poisson_contract():
    """testGMG: 128^2 Poisson, 4 levels, Jacobi 0.8 V(1,1) — relative
    residual below 5e-3 within 5 cycles."""
    M, L, b = _problem([128, 128], shift=False)
    cfg, rp = mt.get_mg_param(levels=4, max_outer_iter=5, relax_type="jacobi",
                              relax_param=0.8, nu_pre=1, nu_post=1)
    st = mt.mg_setup(L, M, cfg, rp, device="cpu")
    x, info = mt.solve_mg(st, b)
    assert info["iters"] <= 5
    assert info["relres"] < 5e-3
    assert _true_relres(L, b, x) < 5e-3
    assert len(info["resvec"]) == info["iters"] + 1


def _states(relax):
    M, L, b = _problem([32, 32, 32])
    kw = dict(levels=4, dtype=np.float32, **SETTINGS[relax])
    Mr = mgtpu.get_regular_mesh([0.0, 1.0] * 3, [32, 32, 32])
    st_r = mgtpu.mg_setup(L, Mr, *mgtpu.get_mg_param(**kw))
    st_p = mt.mg_setup(L, M, *mt.get_mg_param(**kw), device="cpu")
    return L, b, st_r, st_p


def test_solve_mg_matches_reference():
    L, b, st_r, st_p = _states("jacobi")
    _, info_r = mgtpu.solve_mg(st_r, b)
    x, info_p = mt.solve_mg(st_p, b)
    assert abs(info_p["iters"] - info_r["iters"]) <= 1
    assert info_p["relres"] < st_p.config.relative_tol
    assert _true_relres(L, b, x) < 2 * st_p.config.relative_tol


@pytest.mark.parametrize("relax", ["jacobi", "chebyshev"])
def test_solve_mg_refined_matches_reference(relax):
    L, b, st_r, st_p = _states(relax)
    _, info_r = mgtpu.solve_mg_refined(st_r, b, tol=1e-8, max_iter=40)
    x, info_p = mt.solve_mg_refined(st_p, b, tol=1e-8, max_iter=40)
    assert x.dtype.is_floating_point and x.dtype.itemsize == 8
    assert abs(info_p["iters"] - info_r["iters"]) <= 1, (info_p["iters"],
                                                          info_r["iters"])
    assert info_p["relres"] < 1e-8
    assert _true_relres(L, b, x) < 1e-8


def test_solve_mg_multiple_rhs():
    """(n, m) right-hand sides solve together as (m, *grid) fields."""
    M, L, b = _problem([16, 16, 16])
    b2 = L @ np.random.RandomState(1).rand(L.shape[0])
    B = np.stack([b, b2 / np.linalg.norm(b2)], axis=1)
    cfg, rp = mt.get_mg_param(levels=3, dtype=np.float32,
                              **SETTINGS["jacobi"])
    st = mt.mg_setup(L, M, cfg, rp, device="cpu")
    X, info = mt.solve_mg_refined(st, B, tol=1e-8, max_iter=60)
    assert info["relres"] < 1e-8
    assert tuple(X.shape) == B.shape
    for j in range(2):
        rr = np.linalg.norm(B[:, j] - L @ X[:, j].numpy())
        assert rr < 1e-8 * np.sqrt(2)     # the stop is on ||R||_F / ||B||_F
