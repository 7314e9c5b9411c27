"""Smoothed-aggregation AMG parity of the PyTorch port (mgtpu_torch) with
mgtpu, on the CPU: host setup products equal mgtpu's exactly (both sides
compute them in numpy/scipy), the stride-2 transfers equal P and P^T, SA
cycles equal mgtpu's to 1e-9 in f64, and refined iteration counts at 64^2
equal mgtpu's within one (tests/test_amg.py:186-273 are the models)."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import mgtpu
from mgtpu.cycle.cycle import recursive_cycle as cycle_ref
from mgtpu.models.operators import nodal_div_sig_grad_matrix as dsg_ref
from mgtpu.ops.grid_stencil import stride2_transfer_from_scipy as s2_ref
from mgtpu.setup import sa_amg as sa_ref
from mgtpu.solvers.mg_solver import solve_mg_refined as refined_ref

import mgtpu_torch as mt
from mgtpu_torch.cycle.cycle import recursive_cycle as cycle_port
from mgtpu_torch.ops.cuda import stencil
from mgtpu_torch.ops.grid_stencil import pack_stride2
from mgtpu_torch.ops.grid_stencil import stride2_transfer_from_scipy as s2_port
from mgtpu_torch.setup import sa_amg as sa_port


def _np(t):
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _rel(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _same(A, B):
    """Two scipy matrices with the same pattern and the same values."""
    A, B = sp.csr_matrix(A), sp.csr_matrix(B)
    return A.shape == B.shape and A.dtype == B.dtype and (A != B).nnz == 0


def _divsig(n, dim=2, shift=1e-8, seed=3):
    """bench.py:540-544's operator: nodal DivSigGrad with sigma =
    exp(randn) plus shift * (max column sum) * I."""
    M = mgtpu.get_regular_mesh([0.0, 1.0] * dim, [n] * dim)
    sig = np.exp(np.random.RandomState(seed).randn(M.num_cells))
    A = dsg_ref(M, sig)
    A = (A + shift * abs(A).sum(0).max() * sp.identity(A.shape[0])).tocsr()
    return M, mt.get_regular_mesh([0.0, 1.0] * dim, [n] * dim), A


def _setups(n, structured: bool, dim=2, non_galerkin=False, **kw):
    Mr, Mp, A = _divsig(n, dim)
    kw = dict(dict(levels=4, relax_type="spai", dtype=np.float64), **kw)
    st_r = sa_ref.sa_amg_setup(A, *mgtpu.get_mg_param(**kw),
                               non_galerkin=non_galerkin,
                               mesh=Mr if structured else None)
    st_p = mt.sa_amg_setup(A, *mt.get_mg_param(**kw),
                           non_galerkin=non_galerkin,
                           mesh=Mp if structured else None, device="cpu")
    return A, st_r, st_p


# ---------------------------------------------------------------------------
# host products
# ---------------------------------------------------------------------------

def test_strength_and_aggregation_bitwise():
    _, _, A = _divsig(20)
    S_r, S_p = sa_ref.strength_matrix(A, 0.4), sa_port.strength_matrix(A, 0.4)
    assert _same(S_r, S_p)
    S_p.sort_indices()
    ag_r = sa_ref.neighborhood_aggregation(S_p)
    ag_p = sa_port.neighborhood_aggregation(S_p)
    assert np.array_equal(ag_r, ag_p)
    assert _same(sa_ref.aggregation_to_tentative_p(ag_r),
                 sa_port.aggregation_to_tentative_p(ag_p))
    # get_aggregation: mgtpu's native kernel or numpy, identical outputs
    assert _same(sa_ref.get_aggregation(A, 0.4),
                 sa_port.get_aggregation(A, 0.4))
    assert _same(sa_port.get_aggregation(A[:90, :90], 0.4),
                 sp.identity(90, format="csr"))
    P0_r, nc_r = sa_ref.structured_tentative_p([21, 21])
    P0_p, nc_p = sa_port.structured_tentative_p([21, 21])
    assert nc_r == nc_p and _same(P0_r, P0_p)
    assert sa_ref._rho_estimate(A) == sa_port._rho_estimate(A)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("structured", [False, True])
def test_sa_host_products_bitwise(structured, dtype):
    """Every level's A, P and R, the operator complexity and the engine."""
    A, st_r, st_p = _setups(32, structured, dtype=dtype)
    assert st_p.num_levels == st_r.num_levels == 3      # 100 dofs stop
    for l in range(st_r.num_levels):
        assert _same(st_r.As[l], st_p.As[l]), l
    for l in range(st_r.num_levels - 1):
        assert _same(st_r.Ps[l], st_p.Ps[l]) and _same(st_r.Rs[l],
                                                       st_p.Rs[l]), l
    assert st_p.operator_complexity() == st_r.operator_complexity()
    assert (st_p.A_input != A).nnz == 0 and st_p.A_input.dtype == np.float64
    assert type(st_p.hier).__name__ == type(st_r.hier).__name__ == (
        "GridHierarchy" if structured else "Hierarchy")


def test_greedy_sa_flat_hierarchy_matches_reference():
    """Level formats (DIA fine level, ELL below), P/R and the DenseLU
    coarsest (LU bitwise, pivots one higher)."""
    _, st_r, st_p = _setups(32, False, dtype=np.float32)
    for lr, lp in zip(st_r.hier.levels, st_p.hier.levels):
        assert type(lr.A).__name__ == type(lp.A).__name__
        if lr.P is not None:
            assert np.array_equal(np.asarray(lr.P.values), _np(lp.P.values))
            assert np.array_equal(np.asarray(lr.R.indices),
                                  _np(lp.R.indices))
            assert np.array_equal(np.asarray(lr.relax.d), _np(lp.relax.d))
    assert type(st_p.hier.levels[0].A).__name__ == "DIA"
    assert np.array_equal(np.asarray(st_r.hier.coarse.lu),
                          _np(st_p.hier.coarse.lu))
    assert np.array_equal(np.asarray(st_r.hier.coarse.piv) + 1,
                          _np(st_p.hier.coarse.piv))


@pytest.mark.parametrize("dim,n", [(2, 32), (3, 16)])
def test_structured_sa_grid_hierarchy_matches_reference(dim, n):
    """Level stencils (offsets, coefficients), diagonals and the coarsest
    inverse equal mgtpu's; each stride-2 transfer equals mgtpu's
    stencil-form transfer packed for kernel D (prolong classes, class
    table, restriction coefficients)."""
    _, st_r, st_p = _setups(n, True, dim=dim, levels=3)
    for lr, lp in zip(st_r.hier.levels, st_p.hier.levels):
        assert (lr.A is None) == (lp.A is None)
        if lr.A is None:
            continue
        assert type(lr.A).__name__ == type(lp.A).__name__
        assert tuple(lr.A.offsets) == tuple(lp.A.offsets)
        assert tuple(lr.A.grid) == tuple(lp.A.grid)
        if hasattr(lr.A, "coeff"):
            assert np.array_equal(np.asarray(lr.A.coeff), _np(lp.A.coeff))
        if lr.d is None:
            continue
        assert np.array_equal(np.asarray(lr.d), _np(lp.d))
        Tr, Tp = lr.P1, lp.P1
        assert Tr.offsets == Tp.offsets and Tr.fine_grid == Tp.fine_grid
        assert Tr.coarse_grid == Tp.coarse_grid
        Tw = pack_stride2(np.asarray(Tr.coeff), Tr.offsets, Tr.fine_grid,
                          Tr.coarse_grid)
        assert Tw.classes == Tp.classes
        for f in ("pcoeff", "ptab", "rcoeff"):
            assert np.array_equal(_np(getattr(Tw, f)), _np(getattr(Tp, f)))
    assert np.array_equal(np.asarray(st_r.hier.coarse.inv),
                          _np(st_p.hier.coarse.inv))


def test_sparsify_non_galerkin_bitwise():
    _, st_r, st_p = _setups(32, False, non_galerkin=True, levels=3,
                            filtering_param=0.02)
    for l in range(st_r.num_levels):
        assert _same(st_r.As[l], st_p.As[l]), l
    _, _, A = _divsig(20)
    P0 = sa_ref.get_aggregation(A, 0.4)
    Ag = (P0.T @ A @ P0).tocsr()
    for dist, theta in ((1, 0.0), (2, 0.05)):
        assert _same(sa_ref.sparsify_non_galerkin(Ag, A, P0, theta, dist),
                     sa_port.sparsify_non_galerkin(Ag, A, P0, theta, dist))


# ---------------------------------------------------------------------------
# stride-2 transfers and cycles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim,n", [(2, 32), (3, 8)])
def test_stride2_applies_equal_p_and_reference(dim, n):
    """prolong = P @ x and restrict = P^T @ r (1e-12), equal to mgtpu's
    Stride2Transfer; each apply is one call of kernel D's plain version
    on the CPU."""
    _, st_r, st_p = _setups(n, True, dim=dim, levels=3)
    for l in range(st_p.num_levels - 1):
        Tr, Tp = st_r.hier.levels[l].P1, st_p.hier.levels[l].P1
        P = st_p.Ps[l]
        rng = np.random.RandomState(l)
        xc, r = rng.rand(2, P.shape[1]), rng.rand(2, P.shape[0])
        n0 = stencil.PLAIN_CALLS["float64"]
        y = Tp.prolong(torch.from_numpy(xc.reshape((2,) + Tp.coarse_grid)))
        rc = Tp.restrict(torch.from_numpy(r.reshape((2,) + Tp.fine_grid)))
        assert stencil.PLAIN_CALLS["float64"] == n0 + 2
        assert _rel(y.reshape(2, -1).T, P @ xc.T) < 1e-12
        assert _rel(rc.reshape(2, -1).T, P.T @ r.T) < 1e-12
        assert _rel(y, Tr.prolong(jnp.asarray(
            xc.reshape((2,) + Tp.coarse_grid)))) < 1e-13
        assert _rel(rc, Tr.restrict(jnp.asarray(
            r.reshape((2,) + Tp.fine_grid)))) < 1e-13


def _random_stride2(fine, seed):
    """A random stride-2 prolongation on a fine node grid (slowest axis
    first) onto ceil(fine / 2): entries P[f, c] at f = 2c + d for a random
    half of the offsets d in [-3, 3]^dim."""
    rng = np.random.RandomState(seed)
    coarse = tuple((f + 1) // 2 for f in fine)
    offs = [d for d in itertools.product(range(-3, 4), repeat=len(fine))
            if rng.rand() < 0.5]
    rows, cols = [], []
    for c in itertools.product(*map(range, coarse)):
        for d in offs:
            f = tuple(2 * ci + di for ci, di in zip(c, d))
            if all(0 <= fi < F for fi, F in zip(f, fine)):
                rows.append(np.ravel_multi_index(f, fine))
                cols.append(np.ravel_multi_index(c, coarse))
    P = sp.csr_matrix((rng.rand(len(rows)) + 0.5, (rows, cols)),
                      shape=(int(np.prod(fine)), int(np.prod(coarse))))
    return P, coarse


@pytest.mark.parametrize("fine", [(9, 11), (10, 12), (7, 8, 9), (6, 5, 4)])
def test_packed_stride2_on_odd_and_even_extents(fine):
    """The packed prolong and restrict (kernel D's plain versions on the
    CPU, one counted call each) equal P @ x, P^T @ r and mgtpu's
    Stride2Transfer to 1e-12 (f64), odd and even extents, m = 1 and 2;
    each parity class keeps only taps of its parity."""
    P, coarse = _random_stride2(fine, seed=len(fine) + fine[0])
    nodes = lambda g: list(reversed(g))
    Tr = s2_ref(P, nodes(fine), nodes(coarse), dtype=np.float64)
    Tp = s2_port(P, nodes(fine), nodes(coarse), dtype=np.float64)
    g = len(fine)
    for q, offs in enumerate(Tp.classes):
        assert all(((d & 1) << (g - 1 - a)) == (q & (1 << (g - 1 - a)))
                   for off in offs for a, d in enumerate(off))
    assert sum(map(len, Tp.classes)) == len(Tp.offsets)
    assert Tp.pcoeff.shape[0] == max(map(len, Tp.classes))
    assert Tp.rcoeff.shape == (len(Tp.offsets),) + coarse
    for m in (1, 2):
        rng = np.random.RandomState(m)
        xc, r = rng.rand(m, P.shape[1]), rng.rand(m, P.shape[0])
        n0 = stencil.PLAIN_CALLS["float64"]
        y = Tp.prolong(torch.from_numpy(xc.reshape((m,) + coarse)))
        rc = Tp.restrict(torch.from_numpy(r.reshape((m,) + fine)))
        assert stencil.PLAIN_CALLS["float64"] == n0 + 2
        assert _rel(y.reshape(m, -1).T, P @ xc.T) < 1e-12
        assert _rel(rc.reshape(m, -1).T, P.T @ r.T) < 1e-12
        assert _rel(y, Tr.prolong(jnp.asarray(
            xc.reshape((m,) + coarse)))) < 1e-12
        assert _rel(rc, Tr.restrict(jnp.asarray(
            r.reshape((m,) + fine)))) < 1e-12


def test_pack_stride2_refuses_what_is_not_a_stride2_transfer():
    """A nonzero off its parity class, or a coarse grid wider than the
    fine grid's even nodes, raises."""
    coeff = np.zeros((1, 5, 5))
    coeff[0, 1, 2] = 1.0                 # odd y, even x: offset (0, 0)
    with pytest.raises(ValueError, match="parity"):
        pack_stride2(coeff, ((0, 0),), (5, 5), (3, 3))
    with pytest.raises(ValueError, match="subgrid"):
        pack_stride2(np.zeros((1, 5, 5)), ((0, 0),), (5, 5), (4, 3))


SA = {"SA-s": dict(relax_type="spai"),
      "SA-K": dict(relax_type="jac-gmres", relax_param=1.0, nu_pre=1,
                   nu_post=1, cycle_type="K"),
      "SA-W": dict(relax_type="jacobi", relax_param=0.8, cycle_type="W")}


@pytest.mark.parametrize("name", list(SA))
def test_sa_cycles_match_reference(name):
    """One cycle of each package on its own structured SA hierarchy (f64,
    64^2), from b and x and from zero: 1e-9."""
    _, st_r, st_p = _setups(64, True, **SA[name])
    # the K-cycle needs the coarsest stencil, which a 9^2 grid cannot hold
    # at its radius: both packages then take the flat engine
    assert type(st_p.hier).__name__ == type(st_r.hier).__name__ == (
        "Hierarchy" if name == "SA-K" else "GridHierarchy")
    rng = np.random.RandomState(9)
    b, x = rng.rand(st_p.As[0].shape[0], 2), rng.rand(st_p.As[0].shape[0], 2)
    for x0, xz in ((x, False), (np.zeros_like(x), True)):
        y_r = cycle_ref(st_r.config, st_r.hier, jnp.asarray(b),
                        jnp.asarray(x0), x_zero=xz)
        y_p = cycle_port(st_p.config, st_p.hier, torch.from_numpy(b),
                         torch.from_numpy(x0), x_zero=xz)
        assert _rel(y_p, y_r) < 1e-9, xz


def test_convert_carries_an_sa_grid_hierarchy():
    """mgtpu's structured SA hierarchy as arrays (stride-2 transfers less
    their selection matrices) runs the port's grid cycle to 1e-9."""
    from mgtpu_torch.convert import grid_hierarchy_from_arrays
    from mgtpu_torch.cycle.grid_cycle import grid_cycle
    _, st_r, st_p = _setups(32, True)
    levels = []
    for lv in st_r.hier.levels:
        if lv.A is None:
            levels.append(dict(offsets=None))
            continue
        T = lv.P1
        levels.append(dict(
            coeff=np.asarray(lv.A.coeff), offsets=lv.A.offsets,
            grid=lv.A.grid, d=None if lv.d is None else np.asarray(lv.d),
            P1=None if T is None else dict(
                coeff=np.asarray(T.coeff), offsets=T.offsets,
                fine_grid=T.fine_grid, coarse_grid=T.coarse_grid)))
    gh = grid_hierarchy_from_arrays(levels, np.asarray(st_r.hier.coarse.inv),
                                    st_r.hier.coarse.grid, device="cpu")
    # the converted transfers carry the packed forms of the port's own
    for lv, lp in zip(gh.levels, st_p.hier.levels):
        if lp.P1 is not None:
            assert lv.P1.classes == lp.P1.classes
            for f in ("pcoeff", "ptab", "rcoeff"):
                assert np.array_equal(_np(getattr(lv.P1, f)),
                                      _np(getattr(lp.P1, f)))
    bg = np.random.RandomState(2).rand(2, *gh.fine_grid)
    y_r = cycle_ref(st_r.config, st_r.hier,
                    jnp.asarray(bg.reshape(2, -1).T),
                    jnp.zeros((bg[0].size, 2)), x_zero=True)
    y_p = grid_cycle(st_p.config, gh, torch.from_numpy(bg),
                     torch.zeros(bg.shape, dtype=torch.float64), x_zero=True)
    assert _rel(y_p.reshape(2, -1).T, y_r) < 1e-9


@pytest.mark.parametrize("name,structured,max_iter", [
    ("SA-s", True, 60), ("SA-K", True, 70), ("SA-f", False, 60)])
def test_sa_refined_counts_match_reference(name, structured, max_iter):
    """The three SA configurations at 64^2 (f32 hierarchies, bench.py's
    operator and right-hand side): refined iterations within one of
    mgtpu's, each to a true f64 relres below 1e-8."""
    opts = SA["SA-K"] if name == "SA-K" else dict(relax_type="spai")
    A, st_r, st_p = _setups(64, structured, dtype=np.float32, **opts)
    b = A @ np.random.RandomState(4).rand(A.shape[0])
    b /= np.linalg.norm(b)
    _, i_r = refined_ref(st_r, b, tol=1e-8, max_iter=max_iter)
    x, i_p = mt.solve_mg_refined(st_p, b, tol=1e-8, max_iter=max_iter)
    assert abs(i_p["iters"] - i_r["iters"]) <= 1, (i_p["iters"],
                                                   i_r["iters"])
    assert np.linalg.norm(b - A @ _np(x)) / np.linalg.norm(b) < 1e-8


@pytest.mark.parametrize("relax", ["chebyshev", "chebyshev4"])
def test_structured_sa_chebyshev_conforms_to_flat(relax):
    """Structured SA with Chebyshev smoothing carries the smoother's own
    state (undamped diagonal, spectral bound), so its grid cycle equals the
    flat engine's on the same matrices (1e-9) and the solve converges.
    mgtpu's structured path leaves the bound unset and its cycle fails
    (ROADMAP, queue 3, F7)."""
    import dataclasses
    from mgtpu_torch.setup.hierarchy import _RelaxThunk, build_device_hierarchy
    _, Mp, A = _divsig(32, shift=1e-6)
    cfg, rp = mt.get_mg_param(levels=3, relax_type=relax, nu_pre=1,
                              nu_post=1, dtype=np.float64,
                              max_outer_iter=30, relative_tol=1e-8)
    st = mt.sa_amg_setup(A, cfg, rp, mesh=Mp, device="cpu")
    assert type(st.hier).__name__ == "GridHierarchy"
    assert all(lv.lam > 0 for lv in st.hier.levels[:-1])
    flat = dataclasses.replace(st, config=dataclasses.replace(
        st.config, engine="flat"))
    flat.hier = build_device_hierarchy(flat, [
        _RelaxThunk(st.As[l], flat.config, rp, None)
        for l in range(st.num_levels - 1)])
    assert type(flat.hier).__name__ == "Hierarchy"
    b = torch.from_numpy(np.random.RandomState(8).rand(A.shape[0], 2))
    y_g = cycle_port(st.config, st.hier, b, torch.zeros_like(b))
    y_f = cycle_port(flat.config, flat.hier, b, torch.zeros_like(b))
    assert _rel(y_g, y_f) < 1e-9
    x, info = mt.solve_mg(st, b[:, 0].numpy())
    assert info["relres"] < 1e-8


def test_sa_options(monkeypatch):
    _, Mp, A = _divsig(16)
    # MIS-2 aggregation: every node in one aggregate, deterministic
    P0 = sa_port.get_aggregation(A, 0.4, method="device", device="cpu")
    assert P0.shape[0] == A.shape[0] and 1 < P0.shape[1] < A.shape[0]
    assert np.array_equal(P0.sum(axis=1).A.ravel(), np.ones(A.shape[0]))
    assert _same(P0, sa_port.get_aggregation(A, 0.4, method="device",
                                             device="cpu"))
    with pytest.raises(ValueError, match="unknown aggregation"):
        sa_port.get_aggregation(A, 0.4, method="lex")
    cfg, rp = mt.get_mg_param(levels=3, relax_type="line-jacobi")
    with pytest.raises(ValueError, match="pointwise"):
        mt.sa_amg_setup(A, cfg, rp, mesh=Mp, device="cpu")
    cfg, rp = mt.get_mg_param(levels=3, dtype=np.complex128)
    with monkeypatch.context() as mp:
        mp.setenv("MGTPU_AGG", "device")
        # complex device aggregation (strengths of -Re A) sets up as mgtpu's
        st = mt.sa_amg_setup(A, cfg, rp, device="cpu")
        st_r = sa_ref.sa_amg_setup(A, mgtpu.get_mg_param(
            levels=3, dtype=np.complex128)[0], rp)
        assert len(st.As) == len(st_r.As) > 1
        assert all(_same(a, b) for a, b in zip(st.As, st_r.As))
        assert st.As[1].dtype == np.complex128
    # a mesh with engine="flat" takes greedy aggregation
    cfg, rp = mt.get_mg_param(levels=3, engine="flat")
    st = mt.sa_amg_setup(A, cfg, rp, mesh=Mp, device="cpu")
    assert type(st.hier).__name__ == "Hierarchy"
    # engine="grid" without a mesh has no grid hierarchy to build
    cfg, rp = mt.get_mg_param(levels=3, engine="grid")
    with pytest.raises(ValueError, match="engine='grid'"):
        mt.sa_amg_setup(A, cfg, rp, device="cpu")
