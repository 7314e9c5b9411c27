"""Semicoarsening in the PyTorch port against mgtpu, on the CPU: level
grids and coarse operators, the transfers with a missing factor, one cycle
on mgtpu's own semicoarsened line-smoothed hierarchy, and the contracts of
tests/test_semicoarsening.py at n = 64."""
import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

import mgtpu
from mgtpu.cycle.grid_cycle import grid_cycle as cycle_ref
from mgtpu.cycle.grid_cycle import grid_prolong as prolong_ref
from mgtpu.cycle.grid_cycle import grid_restrict as restrict_ref

import mgtpu_torch as mt
from mgtpu_torch.convert import grid_hierarchy_from_arrays
from mgtpu_torch.cycle.grid_cycle import grid_cycle as cycle_port
from mgtpu_torch.cycle.grid_cycle import grid_prolong, grid_restrict

from test_torch_line import hierarchy_arrays


def _aniso(n, eps_x, shift=1e-2, mesh_mod=mt):
    """eps_x * u_xx + u_yy + shift on an n x n mesh (mesh dim 0 = x
    fastest), as tests/test_semicoarsening.py::_aniso."""
    M = mesh_mod.get_regular_mesh([0.0, 1.0, 0.0, 1.0], [n, n])
    nn = n + 1
    ex = np.ones(nn)
    T = sp.diags([-ex[:-1], 2 * ex, -ex[:-1]], [-1, 0, 1])
    eye = sp.identity(nn)
    A = (eps_x * sp.kron(eye, T) + sp.kron(T, eye)) * (n ** 2)
    return M, (A + shift * sp.identity(nn * nn)).tocsr()


def _both(eps, relax="jacobi", rp=0.8, levels=5, dtype=np.float64, n=64):
    kw = dict(levels=levels, relax_type=relax, relax_param=rp, nu_pre=2,
              nu_post=2, transfer_type="semicoarsening", dtype=dtype,
              relative_tol=1e-8, max_outer_iter=25)
    M, A = _aniso(n, eps)
    Mr, _ = _aniso(n, eps, mesh_mod=mgtpu)
    cfg_r, rp_r = mgtpu.get_mg_param(**kw)
    cfg_p, rp_p = mt.get_mg_param(**kw)
    return A, mgtpu.mg_setup(A, Mr, cfg_r, rp_r), \
        mt.mg_setup(A, M, cfg_p, rp_p, device="cpu")


@pytest.mark.parametrize("eps", [100.0, 0.01])
def test_levels_and_coarse_operators_match_reference(eps):
    A, st_r, st_p = _both(eps)
    grids_r = [tuple(lv.A.grid) for lv in st_r.hier.levels]
    grids_p = [tuple(lv.A.grid) for lv in st_p.hier.levels]
    assert grids_p == grids_r
    strong = 1 if eps > 1 else 0                     # grid axes (y, x)
    assert grids_p[1][strong] < grids_p[0][strong]
    assert grids_p[1][1 - strong] == grids_p[0][1 - strong]
    assert len(st_p.As) == len(st_r.As)
    for Ap, Ar in zip(st_p.As, st_r.As):
        assert Ap.shape == Ar.shape
        d = abs(Ap - Ar).max()
        assert d <= 1e-13 * abs(Ar).max(), d
    # transfers: a None factor on every axis that keeps its extent
    for l, lv in enumerate(st_p.hier.levels[:-1]):
        fine, coarse = lv.A.grid, st_p.hier.levels[l + 1].A.grid
        for a, W in enumerate(lv.P1):
            assert (W is None) == (fine[a] == coarse[a])


def test_transfers_with_missing_factor_match_reference():
    _, st_r, st_p = _both(0.01, levels=3)
    rng = np.random.RandomState(0)
    for l in range(2):
        P1r = st_r.hier.levels[l].P1
        P1p = st_p.hier.levels[l].P1
        assert [p is None for p in P1r] == [p is None for p in P1p]
        assert any(p is None for p in P1p)
        fine = st_p.hier.levels[l].A.grid
        coarse = st_p.hier.levels[l + 1].A.grid
        r = rng.rand(2, *fine)
        xc = rng.rand(2, *coarse)
        np.testing.assert_allclose(
            grid_restrict(torch.from_numpy(r), P1p).numpy(),
            np.asarray(restrict_ref(jnp.asarray(r), P1r)), rtol=1e-13,
            atol=1e-15)
        np.testing.assert_allclose(
            grid_prolong(torch.from_numpy(xc), P1p).numpy(),
            np.asarray(prolong_ref(jnp.asarray(xc), P1r)), rtol=1e-13,
            atol=1e-15)


@pytest.mark.parametrize("rp", [0.9, {"axis": "alt", "omega": 0.9}])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_semicoarsened_line_cycle_matches_reference(rp, dtype):
    Mr, A = _aniso(32, 0.01, mesh_mod=mgtpu)
    kw = dict(levels=3, relax_type="line-jacobi", relax_param=rp, nu_pre=2,
              nu_post=2, transfer_type="semicoarsening", dtype=dtype)
    cfg_r, rp_r = mgtpu.get_mg_param(**kw)
    cfg_p, _ = mt.get_mg_param(**kw)
    st_r = mgtpu.mg_setup(A, Mr, cfg_r, rp_r)
    gh = grid_hierarchy_from_arrays(*hierarchy_arrays(st_r.hier),
                                    device="cpu")
    assert any(W is None for W in gh.levels[0].P1)
    b = np.random.RandomState(1).rand(2, *st_r.hier.fine_grid).astype(dtype)
    x = np.array(cycle_ref(cfg_r, st_r.hier, jnp.asarray(b),
                           jnp.zeros_like(jnp.asarray(b))))
    want = np.asarray(cycle_ref(cfg_r, st_r.hier, jnp.asarray(b),
                                jnp.asarray(x)))
    got = cycle_port(cfg_p, gh, torch.from_numpy(b),
                     torch.from_numpy(x)).numpy()
    tol = 1e-12 if dtype == np.float64 else 1e-5
    assert got.dtype == dtype
    assert np.abs(got - want).max() / np.abs(want).max() < tol


def test_semicoarsened_line_refined_matches_reference():
    """eps = 0.01, semicoarsening + line Jacobi 0.9 V(1,1), f32 cycles:
    the refined solve takes mgtpu's iteration count and certifies 1e-8."""
    M, A = _aniso(64, 0.01, shift=0.0)
    Mr, _ = _aniso(64, 0.01, shift=0.0, mesh_mod=mgtpu)
    kw = dict(levels=5, relax_type="line-jacobi", relax_param=0.9,
              nu_pre=1, nu_post=1, transfer_type="semicoarsening",
              dtype=np.float32)
    st_r = mgtpu.mg_setup(A, Mr, *mgtpu.get_mg_param(**kw))
    st_p = mt.mg_setup(A, M, *mt.get_mg_param(**kw), device="cpu")
    b = A @ np.random.RandomState(0).rand(A.shape[0])
    b /= np.linalg.norm(b)
    _, i_r = mgtpu.solve_mg_refined(st_r, b, tol=1e-8, max_iter=40)
    x, i_p = mt.solve_mg_refined(st_p, b, tol=1e-8, max_iter=40)
    assert abs(i_p["iters"] - i_r["iters"]) <= 1
    assert np.linalg.norm(b - A @ x.numpy()) < 1e-8


# ---------------------------------------------------------------------------
# contracts of tests/test_semicoarsening.py on the port (n = 64, CPU)
# ---------------------------------------------------------------------------

def test_isotropic_reduces_to_full_coarsening():
    M, A = _aniso(64, 1.0)
    kw = dict(levels=4, relax_type="jacobi", relax_param=0.8, nu_pre=2,
              nu_post=2, dtype=np.float64, relative_tol=1e-8,
              max_outer_iter=30)
    cfg_s, rp = mt.get_mg_param(transfer_type="semicoarsening", **kw)
    cfg_f, _ = mt.get_mg_param(**kw)
    st_s = mt.mg_setup(A, M, cfg_s, rp, device="cpu")
    st_f = mt.mg_setup(A, M, cfg_f, rp, device="cpu")
    assert [tuple(l.A.grid) for l in st_s.hier.levels] == \
           [tuple(l.A.grid) for l in st_f.hier.levels]
    b = A @ np.random.RandomState(0).rand(A.shape[0])
    b /= np.linalg.norm(b)
    _, i_s = mt.solve_mg(st_s, b)
    _, i_f = mt.solve_mg(st_f, b)
    assert i_s["iters"] == i_f["iters"]


@pytest.mark.parametrize("eps", [100.0, 0.01])
def test_strong_anisotropy_converges_with_point_jacobi(eps):
    M, A = _aniso(64, eps)
    cfg, rp = mt.get_mg_param(levels=5, relax_type="jacobi", relax_param=0.8,
                              nu_pre=2, nu_post=2,
                              transfer_type="semicoarsening",
                              dtype=np.float64, relative_tol=1e-8,
                              max_outer_iter=25)
    st = mt.mg_setup(A, M, cfg, rp, device="cpu")
    grids = [tuple(l.A.grid) for l in st.hier.levels]
    strong_axis = 1 if eps > 1 else 0
    assert grids[1][strong_axis] < grids[0][strong_axis]
    assert grids[1][1 - strong_axis] == grids[0][1 - strong_axis]
    b = A @ np.random.RandomState(1).rand(A.shape[0])
    b /= np.linalg.norm(b)
    _, info = mt.solve_mg(st, b)
    assert info["relres"] < 1e-8
    assert info["iters"] <= 15
