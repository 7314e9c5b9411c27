"""Krylov methods, FGMRES smoothing, K-cycles and the MG-preconditioned
solves of the PyTorch port against mgtpu, on the CPU.

The Krylov methods run on the problems of tests/test_krylov.py and
tests/test_block_krylov.py in mgtpu's leading-batch layout (the port's
only layout) for a fixed number of iterations, so the iterates themselves
are compared (f64, 1e-8 relative).  The cycles run on mgtpu's own rough-
sigma DivSigGrad hierarchies carried across as plain arrays (f64 1e-9, f32
1e-5); the solves take mgtpu's iteration count +- 1 on a 64^2 rough-sigma
DivSigGrad problem."""
from dataclasses import replace

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

import mgtpu
from mgtpu.cycle.grid_cycle import grid_cycle as cycle_ref
from mgtpu.cycle.relax import fgmres_relaxation as fgmres_relax_ref
from mgtpu.krylov import (bicgstab as bicgstab_ref,
                          block_bicgstab as block_bicgstab_ref,
                          block_fgmres as block_fgmres_ref,
                          block_pcg as block_pcg_ref, fgmres as fgmres_ref,
                          pcg as pcg_ref)
from mgtpu.models.operators import nodal_div_sig_grad_matrix

import mgtpu_torch as mt
from mgtpu_torch import krylov
from mgtpu_torch.convert import grid_hierarchy_from_arrays
from mgtpu_torch.cycle.grid_cycle import GridIterativeCoarse
from mgtpu_torch.cycle.grid_cycle import grid_cycle as cycle_port
from mgtpu_torch.cycle.relax import fgmres_relaxation
from mgtpu_torch.ops.cuda import stencil


# ---------------------------------------------------------------------------
# Krylov methods on the problems of tests/test_krylov.py
# ---------------------------------------------------------------------------

def _spd(n, shift, density, seed):
    A = sp.random(n, n, density=density, format="csr", random_state=seed)
    return (A @ A.T + shift * sp.identity(n)).tocsr()


def _nonsym(n, seed):
    A = sp.random(n, n, density=0.05, format="csr", random_state=seed)
    return (A + n * sp.identity(n)).tocsr()


PROBLEMS = {
    # name: (matrix, right-hand sides, Jacobi-preconditioned)
    "spd": (lambda: _spd(200, 1e-1, 0.03, 5), 3, False),
    "spd_jacobi": (lambda: _spd(200, 1e-1, 0.03, 5), 1, True),
    "nonsym": (lambda: _nonsym(150, 7), 2, True),
    "nonsym_bicg": (lambda: _nonsym(150, 9), 2, False),
}

METHODS = {
    # name: (reference, port, problems, extra keywords)
    "pcg": (pcg_ref, krylov.pcg, ("spd", "spd_jacobi"), {}),
    "bicgstab": (bicgstab_ref, krylov.bicgstab, ("nonsym", "nonsym_bicg"),
                 {}),
    "fgmres": (fgmres_ref, krylov.fgmres, ("nonsym",), dict(restart=6)),
    "gmres_right": (fgmres_ref, krylov.fgmres, ("nonsym",),
                    dict(restart=6, flexible=False)),
    "block_fgmres": (block_fgmres_ref, krylov.block_fgmres, ("spd",),
                     dict(restart=6)),
    "block_pcg": (block_pcg_ref, krylov.block_pcg, ("spd",), {}),
    "block_bicgstab": (block_bicgstab_ref, krylov.block_bicgstab,
                       ("nonsym_bicg",), {}),
}


@pytest.mark.parametrize("method", sorted(METHODS))
def test_krylov_iterates_match_reference(method):
    """A few iterations (tol 0, so neither side stops early) give the same
    iterate and residual history as mgtpu's, f64, 1e-8 relative."""
    ref, port, problems, kw = METHODS[method]
    iters = 3 if "gmres" in method else 12
    for name in problems:
        make, m, jac = PROBLEMS[name]
        A = make()
        Ad = A.toarray()
        B = np.random.RandomState(m).randn(m, A.shape[0])   # (m, n) fields
        d = 1.0 / A.diagonal()
        Aj, At = jnp.asarray(Ad), torch.from_numpy(Ad)
        pj = (lambda r: jnp.asarray(d) * r) if jac else None
        pt = (lambda r: torch.from_numpy(d) * r) if jac else None
        xr, ir = ref(lambda V: (Aj @ V.T).T, jnp.asarray(B), prec=pj,
                     tol=0.0, max_iter=iters, batch_leading=True, **kw)
        xp, ip = port(lambda V: (At @ V.T).T, torch.from_numpy(B), prec=pt,
                      tol=0.0, max_iter=iters, **kw)
        xr = np.asarray(xr)
        assert int(ip["iters"]) == int(ir["iters"]) == iters
        assert xp.dtype == torch.float64 and tuple(xp.shape) == xr.shape
        err = np.abs(xp.numpy() - xr).max() / np.abs(xr).max()
        assert err < 1e-8, (name, err)
        rv_r, rv_p = np.asarray(ir["resvec"]), np.asarray(ip["resvec"])
        np.testing.assert_allclose(rv_p, rv_r, rtol=1e-8, atol=1e-14)


@pytest.mark.parametrize("method", ["pcg", "bicgstab", "fgmres",
                                    "block_pcg"])
def test_krylov_converges_like_reference(method):
    """Run to tol: the same iteration count and a true residual below it."""
    ref, port, problems, kw = METHODS[method]
    make, m, jac = PROBLEMS[problems[0]]
    A = make()
    Ad = A.toarray()
    B = np.random.RandomState(1).randn(m, A.shape[0])
    d = 1.0 / A.diagonal()
    Aj, At = jnp.asarray(Ad), torch.from_numpy(Ad)
    pj = (lambda r: jnp.asarray(d) * r) if jac else None
    pt = (lambda r: torch.from_numpy(d) * r) if jac else None
    max_iter = 30 if "gmres" in method else 400
    _, ir = ref(lambda V: (Aj @ V.T).T, jnp.asarray(B), prec=pj, tol=1e-10,
                max_iter=max_iter, batch_leading=True, **kw)
    xp, ip = port(lambda V: (At @ V.T).T, torch.from_numpy(B), prec=pt,
                  tol=1e-10, max_iter=max_iter, **kw)
    assert abs(int(ip["iters"]) - int(ir["iters"])) <= 1
    res = np.linalg.norm(B - (Ad @ xp.numpy().T).T, axis=1)
    assert np.all(res / np.linalg.norm(B, axis=1) < 1e-8)


# ---------------------------------------------------------------------------
# FGMRES smoothing, K-cycles and the FGMRES coarsest on mgtpu's hierarchies
# ---------------------------------------------------------------------------

def _divsig(n, shift=1e-8, seed=3):
    """Rough-sigma DivSigGrad + shift * (max column sum) I on n^2 cells."""
    M = mgtpu.get_regular_mesh([0.0, 1.0, 0.0, 1.0], [n, n])
    sig = np.exp(np.random.RandomState(seed).randn(M.num_cells))
    A = nodal_div_sig_grad_matrix(M, sig)
    A = (A + shift * abs(A).sum(0).max() * sp.identity(A.shape[0])).tocsr()
    return M, A


def hierarchy_arrays(gh):
    """Plain numpy arrays of an mgtpu GridHierarchy of variable stencils
    with a dense-inverse or FGMRES coarsest."""
    levels = [dict(coeff=np.array(lv.A.coeff), offsets=lv.A.offsets,
                   grid=lv.A.grid,
                   d=None if lv.d is None else np.array(lv.d),
                   P1=None if lv.P1 is None else [np.array(p) for p in lv.P1],
                   lam=lv.lam) for lv in gh.levels]
    if hasattr(gh.coarse, "inv"):
        return levels, np.array(gh.coarse.inv), gh.coarse.grid
    return levels, dict(d=np.array(gh.coarse.d),
                        inner=gh.coarse.inner), gh.levels[-1].A.grid


KCYCLE = dict(relax_type="jac-gmres", relax_param=1.0, cycle_type="K",
              nu_pre=1, nu_post=1)


def _setups(dtype, coarse_solve="lu", n=32, levels=3, coarse_inner=None,
            **kw):
    """Both packages on one hierarchy.  The shift is 1e-2 here: with the
    solves' 1e-8 the float32 rounding of b - A x on an iterate with a large
    near-null component is amplified by ~1e8 in the next correction, on
    both sides alike, which would swamp the comparison."""
    M, A = _divsig(n, shift=1e-2)
    opts = dict(levels=levels, dtype=dtype, coarse_solve=coarse_solve,
                **(kw or KCYCLE))
    cfg_r, rp = mgtpu.get_mg_param(**opts)
    cfg_p, _ = mt.get_mg_param(**opts)
    if coarse_inner is not None:
        cfg_r = replace(cfg_r, gmres_coarse_inner=coarse_inner)
        cfg_p = replace(cfg_p, gmres_coarse_inner=coarse_inner)
    st_r = mgtpu.mg_setup(A, M, cfg_r, rp)
    gh_p = grid_hierarchy_from_arrays(*hierarchy_arrays(st_r.hier),
                                      device="cpu")
    return A, st_r, cfg_p, gh_p


TOL = {np.float64: 1e-9, np.float32: 1e-5}
# The FGMRES projections solve Gram normal equations G t = c.  Summation
# order (BLAS against XLA) changes G in its last bits and the solve
# amplifies that by cond(G): in float64 far below 1e-9, but in float32 the
# 2x2 K-cycle Gram blocks take the 1e-5 of a Jacobi cycle to 2.8e-5
# (measured), so float32 projection results are held to 1e-4.
TOL_PROJ = {np.float64: 1e-9, np.float32: 1e-4}


def _rel(got, want):
    got = got.numpy().astype(np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fgmres_relaxation_matches_reference(dtype):
    """The Jac-GMRES smoother alone: x0 + argmin over 3 preconditioned
    directions, two right-hand sides sharing the space."""
    A, st_r, _, gh = _setups(dtype)
    lv_r, lv_p = st_r.hier.levels[0], gh.levels[0]
    rng = np.random.RandomState(2)
    r, x = (rng.rand(2, *lv_p.A.grid).astype(dtype) for _ in range(2))
    want = fgmres_relax_ref(lv_r.A.matvec, lambda v: lv_r.d * v,
                            jnp.asarray(r), jnp.asarray(x), 3)
    got = fgmres_relaxation(lv_p.A.matvec, lambda v: lv_p.d * v,
                            torch.from_numpy(r), torch.from_numpy(x), 3)
    assert got.dtype == torch.from_numpy(r).dtype
    assert _rel(got, want) < TOL_PROJ[dtype]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("ctype", ["V", "K"])
def test_jac_gmres_cycle_matches_reference(dtype, ctype):
    """One Jac-GMRES V-cycle and one K-cycle iterate (from a zero guess and
    from the reference's first iterate) on mgtpu's hierarchy."""
    kw = dict(KCYCLE, cycle_type=ctype)
    A, st_r, cfg_p, gh = _setups(dtype, **kw)
    cfg_r = st_r.config
    b = np.random.RandomState(4).rand(2, *gh.fine_grid).astype(dtype)
    x0 = np.zeros_like(b)
    x1 = np.asarray(cycle_ref(cfg_r, st_r.hier, jnp.asarray(b),
                              jnp.asarray(x0), x_zero=True))
    got1 = cycle_port(cfg_p, gh, torch.from_numpy(b), torch.from_numpy(x0),
                      x_zero=True)
    assert _rel(got1, x1) < TOL_PROJ[dtype]
    x2 = np.asarray(cycle_ref(cfg_r, st_r.hier, jnp.asarray(b),
                              jnp.asarray(x1)))
    got2 = cycle_port(cfg_p, gh, torch.from_numpy(b),
                      torch.from_numpy(np.array(x1)))
    assert _rel(got2, x2) < TOL_PROJ[dtype]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_iterative_coarse_matches_reference(dtype):
    """The FGMRES coarsest solve (coarse_solve="GMRES") on its own and in a
    K-cycle, against mgtpu's GridIterativeCoarse.  Three projection steps:
    the default ten build a monomial Krylov basis whose Gram matrix has
    cond ~1e17 on this 9^2 coarsest grid (measured), where both packages'
    results are set by rounding and agree only to ~1e-7 (f64) and ~1e-4
    (f32); mg_setup's default of ten is checked in
    test_mg_setup_builds_the_krylov_options."""
    A, st_r, cfg_p, gh = _setups(dtype, coarse_solve="GMRES", coarse_inner=3)
    assert isinstance(gh.coarse, GridIterativeCoarse)
    assert gh.coarse.inner == st_r.hier.coarse.inner == 3
    bc = np.random.RandomState(5).rand(1, *gh.levels[-1].A.grid).astype(dtype)
    want = st_r.hier.coarse.solve(jnp.asarray(bc))
    got = gh.coarse.solve(torch.from_numpy(bc))
    assert _rel(got, want) < TOL_PROJ[dtype]
    b = np.random.RandomState(6).rand(1, *gh.fine_grid).astype(dtype)
    want = cycle_ref(st_r.config, st_r.hier, jnp.asarray(b),
                     jnp.zeros_like(jnp.asarray(b)), x_zero=True)
    got = cycle_port(cfg_p, gh, torch.from_numpy(b),
                     torch.zeros((1,) + gh.fine_grid, dtype=got.dtype),
                     x_zero=True)
    assert _rel(got, want) < TOL_PROJ[dtype]


def test_mg_setup_builds_the_krylov_options():
    """mg_setup builds the Jac-GMRES / K-cycle / FGMRES-coarsest hierarchy
    with the reference's diagonals and coarsest diagonal."""
    M, A = _divsig(16)
    opts = dict(levels=3, dtype=np.float64, coarse_solve="GMRES", **KCYCLE)
    st_r = mgtpu.mg_setup(A, M, *mgtpu.get_mg_param(**opts))
    st_p = mt.mg_setup(A, mt.get_regular_mesh([0.0, 1.0] * 2, [16, 16]),
                       *mt.get_mg_param(**opts), device="cpu")
    cfg = st_p.config
    assert (cfg.relax_type, cfg.cycle_type, cfg.coarse_solve) == (
        "jac-gmres", "K", "gmres")
    assert (cfg.kcycle_inner, cfg.gmres_coarse_inner) == (2, 10)
    for lr, lp in zip(st_r.hier.levels[:-1], st_p.hier.levels[:-1]):
        assert np.array_equal(np.asarray(lr.d), lp.d.numpy())
    assert np.array_equal(np.asarray(st_r.hier.coarse.d),
                          st_p.hier.coarse.d.numpy())


# ---------------------------------------------------------------------------
# MG-preconditioned solves on a 64^2 rough-sigma DivSigGrad problem
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def divsig64():
    """Both packages' f32 hierarchies (Jacobi 0.8 V(1,1), and Jac-GMRES
    K-cycles), f64 right-hand sides as in the reference's runs."""
    M, A = _divsig(64)
    Mp = mt.get_regular_mesh([0.0, 1.0, 0.0, 1.0], [64, 64])
    base = dict(levels=4, max_outer_iter=100, relative_tol=1e-8, nu_pre=1,
                nu_post=1, dtype=np.float32)
    states = {}
    # the K-cycle at 3 levels keeps mgtpu's unrolled trace short
    for key, kw in (("jacobi", dict(relax_type="jacobi", relax_param=0.8)),
                    ("kcycle", dict(KCYCLE, levels=3))):
        opts = dict(base, **kw)
        states[key] = (mgtpu.mg_setup(A, M, *mgtpu.get_mg_param(**opts)),
                       mt.mg_setup(A, Mp, *mt.get_mg_param(**opts),
                                   device="cpu"))
    b = A @ np.random.RandomState(4).rand(A.shape[0])
    B = np.random.RandomState(4).rand(A.shape[0], 4)
    return A, states, b / np.linalg.norm(b), B / np.linalg.norm(B, axis=0)


SOLVES = {
    "cg": ("jacobi", "solve_cg_mg", {}, False),
    "bicgstab": ("jacobi", "solve_bicgstab_mg", {}, False),
    "cg_block": ("jacobi", "solve_cg_mg", dict(block=True), True),
    "gmres_kcycle": ("kcycle", "solve_gmres_mg", dict(inner=5), False),
    "gmres_block": ("jacobi", "solve_gmres_mg", dict(inner=5, block=True),
                    True),
}


@pytest.mark.parametrize("solve", sorted(SOLVES))
def test_mg_krylov_solves_match_reference(divsig64, solve):
    A, states, b, B = divsig64
    key, fn, kw, multi = SOLVES[solve]
    st_r, st_p = states[key]
    rhs = B if multi else b
    _, info_r = getattr(mgtpu, fn)(st_r, rhs, **kw)
    n0 = dict(stencil.PLAIN_CALLS)
    x, info_p = getattr(mt, fn)(st_p, rhs, **kw)
    assert abs(int(info_p["iters"]) - int(info_r["iters"])) <= 1, (
        int(info_p["iters"]), int(info_r["iters"]))
    assert x.dtype == torch.float64 and tuple(x.shape) == rhs.shape
    xh = x.numpy()
    res = np.linalg.norm(rhs - A @ xh, axis=0) / np.linalg.norm(rhs, axis=0)
    assert np.all(res < 1e-8 * (2 if multi else 1)), res
    # the f32 cycles and the f64 outer operator both applied through
    # kernel D's wrapper (its plain version, on the CPU)
    assert stencil.PLAIN_CALLS["float32"] > n0["float32"]
    assert stencil.PLAIN_CALLS["float64"] > n0["float64"]


def test_preconditioner_and_afun(divsig64):
    """get_mg_preconditioner on flat vectors is one float32 cycle from zero,
    returned in r's precision; get_afun is the operator's matvec."""
    A, states, b, _ = divsig64
    _, st_p = states["jacobi"]
    gh = st_p.hier
    z = mt.get_mg_preconditioner(st_p)(torch.from_numpy(b))
    assert z.dtype == torch.float64 and tuple(z.shape) == b.shape
    bg = torch.from_numpy(b.astype(np.float32)).reshape((1,) + gh.fine_grid)
    want = cycle_port(st_p.config, gh, bg, torch.zeros_like(bg), x_zero=True)
    assert torch.equal(z, want.reshape(-1).double())
    afun = mt.get_afun(gh.levels[0].A)
    y = afun(torch.from_numpy(b.astype(np.float32)))
    assert _rel(y, (st_p.As[0] @ b.astype(np.float32))) < 1e-5


@pytest.mark.parametrize("fn", ["solve_cg_mg", "solve_bicgstab_mg"])
def test_block_solves_match_reference_in_f64(fn):
    """Block CG / Bl-BiCGSTAB on nearly parallel right-hand sides amplify
    the cycle's rounding through their small Gram solves, so over float32
    cycles the two packages' counts may differ by one.  With float64
    hierarchies both sides do the same arithmetic: the same iteration
    count, residual histories to 1e-6 relative plus 1e-12 absolute (the
    columns of B have unit norm) and iterates to 1e-9."""
    M, A = _divsig(64)
    opts = dict(levels=4, max_outer_iter=100, relative_tol=1e-8, nu_pre=1,
                nu_post=1, relax_type="jacobi", relax_param=0.8,
                dtype=np.float64)
    st_r = mgtpu.mg_setup(A, M, *mgtpu.get_mg_param(**opts))
    st_p = mt.mg_setup(A, mt.get_regular_mesh([0.0, 1.0] * 2, [64, 64]),
                       *mt.get_mg_param(**opts), device="cpu")
    B = np.random.RandomState(4).rand(A.shape[0], 4)
    B /= np.linalg.norm(B, axis=0)
    xr, ir = getattr(mgtpu, fn)(st_r, B, block=True)
    xp, ip = getattr(mt, fn)(st_p, B, block=True)
    k = int(ir["iters"])
    assert int(ip["iters"]) == k
    np.testing.assert_allclose(ip["resvec"].numpy()[:k + 1],
                               np.asarray(ir["resvec"])[:k + 1], rtol=1e-6,
                               atol=1e-12)
    assert _rel(xp, xr) < 1e-9
