"""Flat-engine parity of the PyTorch port (mgtpu_torch) with mgtpu, on the
CPU: the ELL and DIA formats, the engine choice, the recursive cycle, the
coarsest solvers (flat and grid) and the solves on a flat hierarchy.
Both packages get the same numpy inputs; float64 results agree to 1e-13
(products) or 1e-9 (cycles, BASELINE.md:70)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import mgtpu
from mgtpu.cycle.cycle import recursive_cycle as cycle_ref
from mgtpu.models.operators import nodal_div_sig_grad_matrix as dsg_ref
from mgtpu.models.operators import nodal_laplacian_matrix as lap_ref

import mgtpu_torch as mt
from mgtpu_torch.cycle.cycle import make_cycle_fn
from mgtpu_torch.cycle.cycle import recursive_cycle as cycle_port
from mgtpu_torch.ops.cuda import stencil


def _np(t):
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _rel(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _divsig(n, dim=2, shift=1e-6, seed=3):
    M = mgtpu.get_regular_mesh([0.0, 1.0] * dim, [n] * dim)
    sig = np.exp(np.random.RandomState(seed).randn(M.num_cells))
    A = dsg_ref(M, sig)
    A = (A + shift * abs(A).sum(0).max() * sp.identity(A.shape[0])).tocsr()
    return [n] * dim, A


def _long_range(n=16):
    """test_grid_engine_fallback_and_force's matrix: a Laplacian with one
    long-range coupling, which no grid stencil represents."""
    M = mgtpu.get_regular_mesh([0.0, 1.0, 0.0, 1.0], [n, n])
    L = (lap_ref(M) + 0.01 * sp.identity((n + 1) ** 2)).tolil()
    L[0, L.shape[0] // 2] = 0.3
    L[L.shape[0] // 2, 0] = 0.3
    return [n, n], L.tocsr()


def _random_sparse(n=57, m=43, seed=0):
    rng = np.random.RandomState(seed)
    A = sp.random(n, m, density=0.12, random_state=rng, format="csr")
    A.data = rng.randn(A.nnz)
    return A


# ---------------------------------------------------------------------------
# formats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ncols", [None, 3])
def test_ell_matvec_matches_scipy_and_reference(ncols):
    from mgtpu.ops.ell import ell_arrays_from_scipy as arrays_ref
    from mgtpu.ops.ell import ell_from_scipy as ell_ref
    from mgtpu_torch.ops.ell import ell_arrays_from_scipy, ell_from_scipy
    A = _random_sparse()
    for a, b in zip(arrays_ref(A), ell_arrays_from_scipy(A)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    E = ell_from_scipy(A)
    assert E.indices.dtype == torch.int32 and E.indices.shape[1] % 4 == 0
    x = np.random.RandomState(1).rand(*((A.shape[1],) if ncols is None
                                        else (A.shape[1], ncols)))
    y = E.matvec(torch.from_numpy(x))
    assert _rel(y, A @ x) < 1e-13
    assert _rel(y, ell_ref(A).matvec(jnp.asarray(x))) < 1e-13
    assert abs(E.to_scipy() - A).max() == 0


def test_ell_rows():
    from mgtpu_torch.ops.ell import ell_from_scipy, ell_rows
    A = _random_sparse()
    E = ell_from_scipy(A)
    rows = torch.tensor([3, 0, 11])
    idx, val = ell_rows(E.indices, E.values, rows)
    assert torch.equal(idx, E.indices[rows]) and torch.equal(val,
                                                            E.values[rows])


@pytest.mark.parametrize("ncols", [None, 2])
def test_dia_matvec_matches_scipy_and_reference(ncols):
    """The DIA apply on the CPU is the counted plain version of kernel D's
    DIA form, equal to scipy and to mgtpu's dia_matvec."""
    from mgtpu.ops.dia import dia_from_scipy as dia_ref
    from mgtpu_torch.ops.dia import dia_from_scipy
    _, A = _divsig(12)
    D, Dr = dia_from_scipy(A), dia_ref(A)
    assert D.offsets == Dr.offsets
    assert np.array_equal(_np(D.data), np.asarray(Dr.data))
    x = np.random.RandomState(2).rand(*((A.shape[0],) if ncols is None
                                        else (A.shape[0], ncols)))
    n0 = stencil.PLAIN_CALLS["float64"]
    y = D.matvec(torch.from_numpy(x))
    assert stencil.PLAIN_CALLS["float64"] == n0 + 1
    assert _rel(y, A @ x) < 1e-13
    assert _rel(y, Dr.matvec(jnp.asarray(x))) < 1e-13
    assert abs(D.to_scipy() - A).max() < 1e-15 * abs(A).max()
    assert dia_from_scipy(_random_sparse(), max_diags=64) is None


def _matrices():
    """(label, matrix): banded ones that take DIA, a Galerkin SA level and
    a random matrix that take ELL, one with too many diagonals."""
    _, A = _divsig(16)
    cfg, rp = mgtpu.get_mg_param(levels=2, relax_type="spai")
    from mgtpu.setup.sa_amg import sa_amg_setup
    st = sa_amg_setup(A, cfg, rp)
    band = sp.diags([np.ones(90), np.ones(100), np.ones(90)], [-10, 0, 10])
    wide = sp.diags([np.ones(100 - abs(k)) for k in range(-25, 26)],
                    list(range(-25, 26)))
    return [("divsig", A), ("sa level 1", st.As[1]),
            ("random", _random_sparse(60, 60)), ("band", band.tocsr()),
            ("wide", wide.tocsr())]


def test_to_device_matrix_picks_as_reference():
    from mgtpu.setup.hierarchy import _to_device_matrix as pick_ref
    from mgtpu_torch.setup.hierarchy import _to_device_matrix
    picked = {}
    for label, A in _matrices():
        for prefer in (True, False):
            r = pick_ref(A, np.float64, prefer)
            p = _to_device_matrix(A, np.float64, prefer)
            assert type(r).__name__ == type(p).__name__, (label, prefer)
            picked[(label, prefer)] = type(p).__name__
    assert picked[("divsig", True)] == "DIA"
    assert picked[("wide", True)] == "ELL"
    assert picked[("divsig", False)] == "ELL"


# ---------------------------------------------------------------------------
# engine choice
# ---------------------------------------------------------------------------

def _states(A, dims, engine, **kw):
    kw = dict(dict(levels=3, relax_type="jacobi", relax_param=0.8,
                   nu_pre=1, nu_post=1, dtype=np.float64), **kw)
    M = mgtpu.get_regular_mesh([0.0, 1.0] * len(dims), dims)
    st_r = mgtpu.mg_setup(A, M, *mgtpu.get_mg_param(engine=engine, **kw))
    st_p = mt.mg_setup(A, mt.get_regular_mesh([0.0, 1.0] * len(dims), dims),
                       *mt.get_mg_param(engine=engine, **kw), device="cpu")
    return st_r, st_p


def test_engine_auto_falls_back_to_flat_as_reference():
    """A matrix that is no grid stencil: "auto" takes the flat engine in
    both packages, "grid" raises ValueError, "flat" is flat."""
    from mgtpu.setup.hierarchy import Hierarchy as HierRef
    from mgtpu_torch.setup.hierarchy import Hierarchy
    dims, L = _long_range()
    st_r, st_p = _states(L, dims, "auto", levels=2)
    assert isinstance(st_r.hier, HierRef) and isinstance(st_p.hier,
                                                         Hierarchy)
    with pytest.raises(ValueError, match="engine='grid'"):
        _states(L, dims, "grid", levels=2)
    dims, A = _divsig(16)
    st_r, st_p = _states(A, dims, "flat")
    assert isinstance(st_r.hier, HierRef) and isinstance(st_p.hier,
                                                         Hierarchy)
    st_r, st_p = _states(A, dims, "auto")
    assert type(st_r.hier).__name__ == type(st_p.hier).__name__ \
        == "GridHierarchy"


@pytest.mark.parametrize("engine", ["auto", "flat"])
@pytest.mark.parametrize("kw", [
    dict(dtype=np.complex128, transfer_type="SystemsFacesLinear"),
    dict(dtype=np.complex64, aggregation="device")])
def test_unported_options_raise_on_every_engine(engine, kw, monkeypatch):
    """Options that raised until they were ported set up on every engine as
    mgtpu's: complex staggered systems (mg_setup on a complex-shifted
    elasticity operator: the engine mgtpu takes, the same levels) and
    complex device aggregation (sa_amg_setup under MGTPU_AGG=device: the
    same levels)."""
    from mgtpu.models.operators import linear_elasticity_operator as el_ref
    kw = dict(kw)
    device_agg = kw.pop("aggregation", None) == "device"
    cfg, rp = mt.get_mg_param(levels=2, engine=engine, **kw)
    cfg_r, _ = mgtpu.get_mg_param(levels=2, engine=engine, **kw)
    if device_agg:
        _, A = _divsig(8)
        A = (A + (1e-2 + 1e-2j) * abs(A).sum(0).max()
             * sp.identity(A.shape[0])).tocsr()
        monkeypatch.setenv("MGTPU_AGG", "device")
        st = mt.sa_amg_setup(A, cfg, rp, device="cpu")
        st_r = mgtpu.sa_amg_setup(A, cfg_r, rp)
    else:
        dims = [8, 8]
        M = mgtpu.get_regular_mesh([0.0, 1.0] * 2, dims)
        mu = np.ones(M.num_cells)
        A = el_ref(M, mu, mu)
        A = (A + (1e-3 + 1e-3j) * abs(A).sum(0).max()
             * sp.identity(A.shape[0])).tocsr()
        st = mt.mg_setup(A, mt.get_regular_mesh([0.0, 1.0] * 2, dims), cfg,
                         rp, device="cpu")
        st_r = mgtpu.mg_setup(A, M, cfg_r, rp)
    assert type(st.hier).__name__ == type(st_r.hier).__name__
    assert len(st.As) == len(st_r.As)
    for a, b in zip(st.As, st_r.As):
        assert a.dtype == b.dtype and np.iscomplexobj(a.data)
        assert (a != b).nnz == 0


def test_state_transfers_and_complexity_match_reference():
    """Ps, Rs (made lazily), nnz_per_level and operator_complexity."""
    dims, A = _divsig(16)
    st_r, st_p = _states(A, dims, "flat")
    assert len(st_p.Ps) == len(st_p.Rs) == 2
    for P_r, P_p, R_r, R_p in zip(st_r.Ps, st_p.Ps, st_r.Rs, st_p.Rs):
        assert (P_r != P_p).nnz == 0 and (R_r != R_p).nnz == 0
    assert st_p.nnz_per_level == [a.nnz for a in st_r.As]
    assert st_p.operator_complexity() == st_r.operator_complexity()


# ---------------------------------------------------------------------------
# the recursive cycle
# ---------------------------------------------------------------------------

RELAX = {"jacobi": dict(relax_type="jacobi", relax_param=0.8),
         "spai": dict(relax_type="spai", relax_param=1.0),
         "chebyshev": dict(relax_type="chebyshev", nu_post=0),
         "jac-gmres": dict(relax_type="jac-gmres", relax_param=1.0)}


@pytest.mark.parametrize("relax", list(RELAX))
@pytest.mark.parametrize("ctype", ["V", "W", "F", "K"])
def test_recursive_cycle_matches_reference(relax, ctype):
    """One flat cycle of each package on its own hierarchy of the same
    matrix, from the same b and x (and from zero with x_zero): 1e-9."""
    dims, A = _divsig(16)
    st_r, st_p = _states(A, dims, "flat", cycle_type=ctype, **RELAX[relax])
    assert type(st_p.hier.levels[0].A).__name__ == (
        "DIA" if relax != "chebyshev" else "ELL")
    rng = np.random.RandomState(5)
    b, x = rng.rand(A.shape[0], 2), rng.rand(A.shape[0], 2)
    for x0, xz in ((x, False), (np.zeros_like(x), True)):
        y_r = cycle_ref(st_r.config, st_r.hier, jnp.asarray(b),
                        jnp.asarray(x0), x_zero=xz)
        y_p = cycle_port(st_p.config, st_p.hier, torch.from_numpy(b),
                         torch.from_numpy(x0), x_zero=xz)
        assert _rel(y_p, y_r) < 1e-9, xz
        y_m = make_cycle_fn(st_p.config)(st_p.hier, torch.from_numpy(b),
                                         torch.from_numpy(x0), xz)
        assert torch.equal(y_m, y_p)


@pytest.mark.parametrize("relax", ["jacobi", "chebyshev"])
@pytest.mark.parametrize("ctype", ["V", "W"])
def test_flat_and_grid_engines_conform(relax, ctype):
    """The port's flat and grid engines on the same matrices give the same
    cycle to 1e-9 in f64 (BASELINE.md:70)."""
    dims, A = _divsig(32)
    kw = dict(dict(levels=3, nu_pre=1, nu_post=1, dtype=np.float64,
                   cycle_type=ctype), **RELAX[relax])
    M = mt.get_regular_mesh([0.0, 1.0] * 2, dims)
    st_g = mt.mg_setup(A, M, *mt.get_mg_param(engine="grid", **kw),
                       device="cpu")
    st_f = mt.mg_setup(A, M, *mt.get_mg_param(engine="flat", **kw),
                       device="cpu")
    assert type(st_g.hier).__name__ == "GridHierarchy"
    b = torch.from_numpy(np.random.RandomState(6).rand(A.shape[0], 2))
    y_g = cycle_port(st_g.config, st_g.hier, b, torch.zeros_like(b))
    y_f = cycle_port(st_f.config, st_f.hier, b, torch.zeros_like(b))
    assert _rel(y_f, y_g) < 1e-9


def test_flat_cycle_refuses_line_smoothing():
    dims, L = _long_range(8)
    cfg, rp = mt.get_mg_param(levels=2, relax_type="line-jacobi",
                              engine="flat")
    with pytest.raises(ValueError):
        st = mt.mg_setup(L, mt.get_regular_mesh([0.0, 1.0] * 2, dims), cfg,
                         rp, device="cpu")
        b = torch.ones(L.shape[0], 1, dtype=torch.float64)
        cycle_port(st.config, st.hier, b, torch.zeros_like(b))


# ---------------------------------------------------------------------------
# coarsest solvers
# ---------------------------------------------------------------------------

def test_dense_lu_matches_reference():
    """Host LU factors bitwise mgtpu's, pivots one higher (LAPACK's base),
    solve and adjoint solve equal to mgtpu's and to scipy."""
    from mgtpu.cycle.coarse import dense_lu_from_scipy as lu_ref
    from mgtpu_torch.cycle.coarse import dense_lu_from_scipy
    A = (_random_sparse(40, 40) + 4 * sp.identity(40)).tocsr()
    for dtype, tol in ((np.float64, 1e-12), (np.float32, 1e-5)):
        r, p = lu_ref(A, dtype=dtype), dense_lu_from_scipy(A, dtype=dtype)
        assert np.array_equal(np.asarray(r.lu), _np(p.lu))
        assert np.array_equal(np.asarray(r.piv) + 1, _np(p.piv))
        b = np.random.RandomState(0).rand(40, 3).astype(dtype)
        for solve in ("solve", "solve_adjoint"):
            y_p = getattr(p, solve)(torch.from_numpy(b))
            y_r = getattr(r, solve)(jnp.asarray(b))
            assert _rel(y_p, y_r) < tol, (dtype, solve)
        want = np.linalg.solve(A.toarray(), b.astype(np.float64))
        assert _rel(p.solve(torch.from_numpy(b[:, 0])), want[:, 0]) < tol



@pytest.mark.parametrize("solver", ["DenseLU", "DenseInverse"])
def test_coarsest_solve_keeps_the_callers_matmul_precision(solver):
    """A coarsest solve runs its products in full float32 and leaves the
    caller's matmul precision ("medium" here) as it found it."""
    from mgtpu_torch.cycle.coarse import dense_lu_from_scipy
    from mgtpu_torch.cycle.grid_cycle import DenseInverse
    A = (_random_sparse(16, 16) + 4 * sp.identity(16)).tocsr()
    b = np.random.RandomState(1).rand(16, 2).astype(np.float32)
    if solver == "DenseLU":
        run = lambda: dense_lu_from_scipy(A, dtype=np.float32).solve(
            torch.from_numpy(b))
    else:
        inv = torch.from_numpy(np.linalg.inv(A.toarray()).astype(np.float32))
        run = lambda: DenseInverse(inv, (4, 4)).solve(
            torch.from_numpy(b.T.reshape(2, 4, 4).copy())).reshape(2, 16).T
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        y = run()
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prev)
    want = np.linalg.solve(A.toarray(), b.astype(np.float64))
    assert _rel(y, want) < 1e-5

def test_iterative_and_sparse_lu_coarse_match_reference():
    from mgtpu.cycle import coarse as co_ref
    from mgtpu_torch.convert import flat_hierarchy_from_arrays
    from mgtpu_torch.cycle import coarse as co
    _, A = _divsig(8)
    b = np.random.RandomState(1).rand(A.shape[0], 2)
    it_r = co_ref.iterative_coarse_from_scipy(A, 0.8, inner=6)
    it_p = co.iterative_coarse_from_scipy(A, 0.8, inner=6)
    assert np.array_equal(np.asarray(it_r.ell_val), _np(it_p.ell_val))
    # and carried across from mgtpu's arrays (the coarse of a converted
    # flat hierarchy)
    it_c = flat_hierarchy_from_arrays(
        [dict(A=dict(indices=np.asarray(it_r.ell_idx),
                     values=np.asarray(it_r.ell_val), shape=A.shape))],
        dict(d=np.asarray(it_r.d), ell_idx=np.asarray(it_r.ell_idx),
             ell_val=np.asarray(it_r.ell_val), inner=it_r.inner),
        device="cpu").coarse
    for it in (it_p, it_c):
        assert _rel(it.solve(torch.from_numpy(b)),
                    it_r.solve(jnp.asarray(b))) < 1e-9
    lu_r, lu_p = co_ref.sparse_lu_from_scipy(A), co.sparse_lu_from_scipy(A)
    for solve in ("solve", "solve_adjoint"):
        y = getattr(lu_p, solve)(torch.from_numpy(b))
        assert y.dtype == torch.float64
        assert _rel(y, getattr(lu_r, solve)(jnp.asarray(b))) < 1e-12
    assert _rel(lu_p.solve(torch.from_numpy(b)),
                np.linalg.solve(A.toarray(), b)) < 1e-10


def test_flat_coarsest_choice_matches_reference(monkeypatch):
    """gmres -> IterativeCoarse, small -> DenseLU, above the dense budget ->
    SparseLUCoarse, as in mgtpu."""
    import mgtpu.setup.hierarchy as h_ref
    import mgtpu_torch.cycle.grid_cycle as gc
    dims, A = _divsig(16)
    for kw, want in ((dict(coarse_solve="gmres"), "IterativeCoarse"),
                     ({}, "DenseLU")):
        st_r, st_p = _states(A, dims, "flat", levels=2, **kw)
        assert type(st_r.hier.coarse).__name__ == \
            type(st_p.hier.coarse).__name__ == want
    monkeypatch.setattr(h_ref, "_DENSE_COARSE_MAX", 16)
    monkeypatch.setattr(gc, "DENSE_LU_MAX", 16)
    st_r, st_p = _states(A, dims, "flat", levels=2)
    assert type(st_r.hier.coarse).__name__ == \
        type(st_p.hier.coarse).__name__ == "SparseLUCoarse"
    b = np.random.RandomState(2).rand(A.shape[0], 1)
    y_r = cycle_ref(st_r.config, st_r.hier, jnp.asarray(b),
                    jnp.zeros_like(jnp.asarray(b)), x_zero=True)
    y_p = cycle_port(st_p.config, st_p.hier, torch.from_numpy(b),
                     torch.zeros(b.shape, dtype=torch.float64), x_zero=True)
    assert _rel(y_p, y_r) < 1e-9


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_grid_dense_inverse_matches_reference(dtype):
    """A 2-level 129^2 Laplacian: its 65^2 = 4225-dof coarsest is above the
    host inverse's 4096 and gets the dense inverse built on the device (the
    CPU here), as mgtpu's; f64 within 1e-9 of mgtpu's, f32 within
    eps * cond."""
    from mgtpu.cycle.grid_cycle import DenseInverse as InvRef
    from mgtpu_torch.cycle.grid_cycle import DenseInverse
    M = mgtpu.get_regular_mesh([0.0, 1.0, 0.0, 1.0], [128, 128])
    L = lap_ref(M)
    L = (L + 1e-4 * abs(L).sum(0).max() * sp.identity(L.shape[0])).tocsr()
    kw = dict(levels=2, relax_type="jacobi", relax_param=0.8, dtype=dtype)
    st_r = mgtpu.mg_setup(L, M, *mgtpu.get_mg_param(**kw))
    st_p = mt.mg_setup(L, mt.get_regular_mesh([0.0, 1.0] * 2, [128, 128]),
                       *mt.get_mg_param(**kw), device="cpu")
    assert isinstance(st_r.hier.coarse, InvRef)
    assert isinstance(st_p.hier.coarse, DenseInverse)
    inv_p = _np(st_p.hier.coarse.inv)
    assert inv_p.shape == (4225, 4225) and inv_p.dtype == dtype
    Ac = st_p.As[-1].astype(np.float64)
    cond = abs(Ac).sum(0).max() * np.abs(inv_p).sum(0).max()
    cols = np.arange(0, 4225, 17)            # a column sample of A inv - I
    err = np.abs(Ac @ inv_p[:, cols].astype(np.float64)
                 - np.eye(4225)[:, cols]).max()
    assert err < 10 * np.finfo(dtype).eps * cond
    tol = 1e-9 if dtype == np.float64 else 10 * np.finfo(dtype).eps * cond
    assert _rel(inv_p, st_r.hier.coarse.inv) < tol


def test_grid_sparse_lu_above_the_dense_budget(monkeypatch):
    """Above DENSE_LU_MAX the grid engine's coarsest is host SuperLU, equal
    to mgtpu's GridSparseLU."""
    import mgtpu.cycle.grid_cycle as gc_ref
    import mgtpu_torch.cycle.grid_cycle as gc
    monkeypatch.setattr(gc_ref, "_HOST_INV_MAX", 16)
    monkeypatch.setattr(gc_ref, "_DENSE_LU_MAX", 32)
    monkeypatch.setattr(gc, "HOST_INV_MAX", 16)
    monkeypatch.setattr(gc, "DENSE_LU_MAX", 32)
    dims, A = _divsig(16)
    st_r, st_p = _states(A, dims, "auto", levels=2)
    assert type(st_r.hier.coarse).__name__ == \
        type(st_p.hier.coarse).__name__ == "GridSparseLU"
    bg = np.random.RandomState(3).rand(2, 9, 9)
    assert _rel(st_p.hier.coarse.solve(torch.from_numpy(bg)),
                st_r.hier.coarse.solve(jnp.asarray(bg))) < 1e-12


# ---------------------------------------------------------------------------
# solves on the flat engine
# ---------------------------------------------------------------------------

def test_flat_solves_match_reference():
    """solve_mg, solve_mg_refined and solve_cg_mg on a flat f32 hierarchy:
    iteration counts within one of mgtpu's, true relres reached."""
    from mgtpu.solvers.mg_solver import solve_mg_refined as refined_ref
    dims, A = _divsig(32, shift=1e-8)
    kw = dict(levels=3, relax_type="jacobi", relax_param=0.8, nu_pre=1,
              nu_post=1, dtype=np.float32, max_outer_iter=60,
              relative_tol=1e-6)
    st_r, st_p = _states(A, dims, "flat", **kw)
    b = A @ np.random.RandomState(4).rand(A.shape[0])
    b /= np.linalg.norm(b)
    x_r, i_r = mgtpu.solve_mg(st_r, b)
    x_p, i_p = mt.solve_mg(st_p, b)
    assert abs(i_p["iters"] - i_r["iters"]) <= 1
    x_r, i_r = refined_ref(st_r, b, tol=1e-8, max_iter=60)
    x_p, i_p = mt.solve_mg_refined(st_p, b, tol=1e-8, max_iter=60)
    assert abs(i_p["iters"] - i_r["iters"]) <= 1
    assert x_p.dtype == torch.float64 and tuple(x_p.shape) == b.shape
    assert np.linalg.norm(b - A @ _np(x_p)) < 1e-8
    x_c, i_c = mt.solve_cg_mg(st_p, b)
    x_c2, i_c2 = mgtpu.solve_cg_mg(st_r, b)
    assert abs(int(i_c["iters"]) - int(i_c2["iters"])) <= 1
    assert np.linalg.norm(b - A @ _np(x_c)) < 1e-5
    z = mt.get_mg_preconditioner(st_p)(torch.from_numpy(b))
    assert tuple(z.shape) == b.shape and z.dtype == torch.float64
    # FMG on a flat hierarchy: a solve from zero, as mgtpu's
    x_f, i_f = mt.solve_mg_refined(st_p, b, tol=1e-8, max_iter=60, fmg=True)
    x_r, i_r = refined_ref(st_r, b, tol=1e-8, max_iter=60, fmg=True)
    assert abs(i_f["iters"] - i_r["iters"]) <= 1
    assert torch.equal(x_f, x_p) and i_f["resvec"][0] == pytest.approx(1.0)


def test_flat_refinement_uses_the_f64_dia_operator():
    """The refined solve's residual on a flat hierarchy is the float64 DIA
    of A_input (kernel D's DIA form on the card; its plain version here)."""
    from mgtpu_torch.ops.dia import DIA
    from mgtpu_torch.solvers.mg_solver import high_precision_fine_operator
    dims, A = _divsig(16)
    _, st_p = _states(A, dims, "flat", dtype=np.float32)
    op = high_precision_fine_operator(st_p)
    assert isinstance(op, DIA) and op.dtype == torch.float64
    n0 = stencil.PLAIN_CALLS["float64"]
    mt.solve_mg_refined(st_p, A @ np.ones(A.shape[0]), max_iter=2)
    assert stencil.PLAIN_CALLS["float64"] >= n0 + 3


def test_convert_carries_a_flat_hierarchy():
    """mgtpu's flat hierarchy as arrays (0-based LU pivots) runs the port's
    cycle to 1e-9 of mgtpu's."""
    from mgtpu_torch.convert import flat_hierarchy_from_arrays

    def mat(E):
        if hasattr(E, "indices"):
            return dict(indices=np.asarray(E.indices),
                        values=np.asarray(E.values), shape=E.shape)
        return dict(data=np.asarray(E.data), offsets=E.offsets,
                    shape=E.shape)

    dims, A = _divsig(16)
    for kw in (dict(relax_type="spai"), dict(relax_type="chebyshev")):
        st_r, _ = _states(A, dims, "flat", **kw)
        levels = [dict(A=mat(lv.A),
                       P=None if lv.P is None else mat(lv.P),
                       R=None if lv.R is None else mat(lv.R),
                       d=None if lv.relax is None else np.asarray(lv.relax.d),
                       lam_max=getattr(lv.relax, "lam_max", None))
                  for lv in st_r.hier.levels]
        c = st_r.hier.coarse
        h = flat_hierarchy_from_arrays(
            levels, dict(lu=np.asarray(c.lu), piv=np.asarray(c.piv)),
            device="cpu")
        b = np.random.RandomState(7).rand(A.shape[0], 2)
        y_r = cycle_ref(st_r.config, st_r.hier, jnp.asarray(b),
                        jnp.zeros_like(jnp.asarray(b)), x_zero=True)
        cfg_p, _ = mt.get_mg_param(**{
            f.name: getattr(st_r.config, f.name)
            for f in dataclasses.fields(st_r.config)
            if f.name in ("levels", "relax_type", "nu_pre", "nu_post",
                          "cycle_type", "coarse_solve", "dtype")})
        y_p = cycle_port(cfg_p, h, torch.from_numpy(b),
                         torch.zeros(b.shape, dtype=torch.float64),
                         x_zero=True)
        assert _rel(y_p, y_r) < 1e-9, kw
