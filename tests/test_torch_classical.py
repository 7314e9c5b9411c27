"""Classical (Ruge-Stueben) AMG parity of the PyTorch port (mgtpu_torch)
with mgtpu, on the CPU: the host C++ setup kernels equal their numpy
versions and mgtpu's; strength, colorings, P and every level's A equal
mgtpu's bit for bit for every coarsening and interpolation; classical
cycles equal mgtpu's to 1e-9 in f64; refined counts at 64^2 equal mgtpu's;
and the port passes its versions of mgtpu's classical contracts
(tests/test_amg.py, tests/test_device_agg.py, tests/test_flat_df32.py)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import mgtpu
from mgtpu.cycle.cycle import recursive_cycle as cycle_ref
from mgtpu.models.operators import nodal_div_sig_grad_matrix as dsg_ref
from mgtpu.setup import classical_amg as ca_ref
from mgtpu.setup import sa_amg as sa_ref
from mgtpu.solvers.mg_solver import solve_mg_refined as refined_ref
from mgtpu.utils import native as native_ref

import mgtpu_torch as mt
from mgtpu_torch.cycle.cycle import recursive_cycle as cycle_port
from mgtpu_torch.setup import classical_amg as ca_port
from mgtpu_torch.setup import native
from mgtpu_torch.setup import sa_amg as sa_port

COARSENINGS = ("common-c", "min-coarse", "pmis")


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


def _divsig(cells, shift=1e-8, seed=3):
    """Rough-sigma nodal DivSigGrad, sigma = exp(RandomState(seed).randn),
    + shift * (max column sum) I (bench.py:540-544's operator)."""
    M = mgtpu.get_regular_mesh([0.0, 1.0] * len(cells), list(cells))
    sig = np.exp(np.random.RandomState(seed).randn(M.num_cells))
    A = dsg_ref(M, sig)
    return (A + shift * abs(A).sum(0).max() * sp.identity(A.shape[0])).tocsr()


def _rhs(A, seed=4):
    b = A @ np.random.RandomState(seed).rand(A.shape[0])
    return b / np.linalg.norm(b)


def _setups(A, setup_kw=None, **kw):
    kw = dict(dict(levels=4, relax_type="spai", dtype=np.float64), **kw)
    setup_kw = setup_kw or {}
    st_r = ca_ref.classical_amg_setup(A, *mgtpu.get_mg_param(**kw),
                                      **setup_kw)
    st_p = mt.classical_amg_setup(A, *mt.get_mg_param(**kw), **setup_kw,
                                  device="cpu")
    return st_r, st_p


PROBLEMS = [(40, 40), (64, 64), (16, 16, 12)]


# ---------------------------------------------------------------------------
# the host C++ kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cells", PROBLEMS)
def test_native_kernels_match_plain_versions_and_reference(cells):
    """aggregate, cf_coloring_first and cf_coloring equal the port's numpy
    versions and mgtpu's native kernels; the calls are counted."""
    A = _divsig(cells)
    S = sa_port.strength_matrix(A, 0.4)
    S.sort_indices()
    calls, plain = dict(native.CALLS), dict(native.PLAIN_CALLS)
    ag = native.aggregate(S)
    assert np.array_equal(ag, sa_port.neighborhood_aggregation(S))
    assert np.array_equal(ag, native_ref.aggregate(S))
    Sc = ca_port.strength_matrix_classical(A, 0.4)
    Sc.sort_indices()
    first = native.cf_coloring_first(Sc)
    assert np.array_equal(first, ca_port.cf_coloring_first(Sc))
    col = native.cf_coloring(Sc)
    assert col.dtype == np.int8
    assert np.array_equal(col, ca_port.cf_coloring_second(Sc, first.copy()))
    assert np.array_equal(col, native_ref.cf_coloring(Sc))
    assert {k: native.CALLS[k] - calls[k] for k in calls} == dict(
        aggregate=1, cf_coloring_first=1, cf_coloring=1)
    assert {k: native.PLAIN_CALLS[k] - plain[k] for k in plain} == dict(
        aggregate=1, cf_coloring_first=1, cf_coloring=1)


def test_native_build_failure_raises_with_the_compilers_message(
        tmp_path, monkeypatch):
    """No numpy fallback: a source that does not compile raises with g++'s
    message, and nothing is loaded."""
    bad = tmp_path / "setup_kernels.cpp"
    bad.write_text('extern "C" void mgt_aggregate( { }\n')
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="g[+][+] failed") as e:
        native.aggregate(sp.identity(4, format="csr"))
    assert "error" in str(e.value)
    assert native._LIB is None
    with pytest.raises(ValueError, match="square"):
        native.cf_coloring(sp.csr_matrix((3, 4)))


# ---------------------------------------------------------------------------
# host products
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("theta", [0.25, 0.4])
@pytest.mark.parametrize("cells", PROBLEMS)
def test_strength_colorings_and_interpolation_bitwise(cells, theta):
    """strength_matrix_classical, both coloring passes, the min-coarse
    pass and direct and standard P equal mgtpu's."""
    A = _divsig(cells)
    S_r = ca_ref.strength_matrix_classical(A, theta)
    S = ca_port.strength_matrix_classical(A, theta)
    assert _same(S_r, S)
    first = ca_port.cf_coloring_first(S)
    assert np.array_equal(first, ca_ref.cf_coloring_first(S))
    for second in ("cf_coloring_second", "cf_coloring_second_s"):
        col = getattr(ca_port, second)(S, first.copy())
        assert np.array_equal(col, getattr(ca_ref, second)(S, first.copy()))
        for interp in ("direct_interpolation", "standard_interpolation"):
            P = getattr(ca_port, interp)(A, S, col)
            assert _same(P, getattr(ca_ref, interp)(A, S, col)), (second,
                                                                 interp)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("interpolation", ["direct", "standard"])
@pytest.mark.parametrize("coarsening", COARSENINGS)
def test_classical_levels_bitwise(coarsening, interpolation, dtype):
    """Every level's A, P and R, the operator complexity, A_input and the
    flat engine's level formats equal mgtpu's (48^2, 4 levels)."""
    A = _divsig((48, 48))
    st_r, st_p = _setups(A, dict(coarsening=coarsening,
                                 interpolation=interpolation), dtype=dtype)
    assert st_p.num_levels == st_r.num_levels == 4
    for l in range(st_r.num_levels):
        assert _same(st_r.As[l], st_p.As[l]), l
    for l in range(st_r.num_levels - 1):
        assert _same(st_r.Ps[l], st_p.Ps[l]), l
        assert _same(st_r.Rs[l], st_p.Rs[l]), l
    opc = sum(a.nnz for a in st_r.As) / st_r.As[0].nnz
    assert st_p.operator_complexity() == opc
    assert (st_p.A_input != A).nnz == 0 and st_p.A_input.dtype == np.float64
    assert type(st_p.hier).__name__ == type(st_r.hier).__name__ == "Hierarchy"
    assert ([type(lv.A).__name__ for lv in st_p.hier.levels]
            == [type(lv.A).__name__ for lv in st_r.hier.levels])


def test_classical_flat_hierarchy_matches_reference():
    """Level operators, transfers, smoother diagonals and the DenseLU
    coarsest (LU bitwise, pivots one higher) equal mgtpu's."""
    A = _divsig((48, 48))
    st_r, st_p = _setups(A, dtype=np.float32)
    for lr, lp in zip(st_r.hier.levels, st_p.hier.levels):
        if hasattr(lr.A, "offsets"):
            assert tuple(lr.A.offsets) == tuple(lp.A.offsets)
            assert np.array_equal(np.asarray(lr.A.data), _np(lp.A.data))
        else:
            assert np.array_equal(np.asarray(lr.A.values), _np(lp.A.values))
        if lr.P is not None:
            assert np.array_equal(np.asarray(lr.P.values), _np(lp.P.values))
            assert np.array_equal(np.asarray(lr.R.indices),
                                  _np(lp.R.indices))
            assert np.array_equal(np.asarray(lr.relax.d), _np(lp.relax.d))
    assert np.array_equal(np.asarray(st_r.hier.coarse.lu),
                          _np(st_p.hier.coarse.lu))
    assert np.array_equal(np.asarray(st_r.hier.coarse.piv) + 1,
                          _np(st_p.hier.coarse.piv))


# ---------------------------------------------------------------------------
# cycles and solves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("coarsening", COARSENINGS)
def test_classical_cycle_matches_reference(coarsening):
    """One V(2,2) SPAI cycle on two right-hand sides, f64: the port's
    hierarchy and mgtpu's hierarchy carried over by convert.py both give
    mgtpu's cycle to 1e-9."""
    from mgtpu_torch.convert import flat_hierarchy_from_arrays

    def mat(E):
        if hasattr(E, "indices"):
            return dict(indices=np.asarray(E.indices),
                        values=np.asarray(E.values), shape=E.shape)
        return dict(data=np.asarray(E.data), offsets=E.offsets,
                    shape=E.shape)

    A = _divsig((48, 48))
    st_r, st_p = _setups(A, dict(coarsening=coarsening))
    b = np.random.RandomState(7).rand(A.shape[0], 2)
    y_r = cycle_ref(st_r.config, st_r.hier, jnp.asarray(b),
                    jnp.zeros_like(jnp.asarray(b)), x_zero=True)
    y_p = cycle_port(st_p.config, st_p.hier, torch.from_numpy(b),
                     torch.zeros(b.shape, dtype=torch.float64), x_zero=True)
    assert _rel(y_p, y_r) < 1e-9
    c = st_r.hier.coarse
    h = flat_hierarchy_from_arrays(
        [dict(A=mat(lv.A), P=None if lv.P is None else mat(lv.P),
              R=None if lv.R is None else mat(lv.R),
              d=None if lv.relax is None else np.asarray(lv.relax.d))
         for lv in st_r.hier.levels],
        dict(lu=np.asarray(c.lu), piv=np.asarray(c.piv)), device="cpu")
    cfg_p, _ = mt.get_mg_param(**{
        f.name: getattr(st_r.config, f.name)
        for f in dataclasses.fields(st_r.config)
        if f.name in ("levels", "relax_type", "nu_pre", "nu_post",
                      "cycle_type", "coarse_solve", "dtype")})
    y_c = cycle_port(cfg_p, h, torch.from_numpy(b),
                     torch.zeros(b.shape, dtype=torch.float64), x_zero=True)
    assert _rel(y_c, y_r) < 1e-9


@pytest.mark.parametrize("coarsening", COARSENINGS)
def test_classical_refined_counts_match_reference(coarsening):
    """bench.py's agg_ab operator at 64^2 (sigma seed 5, b seed 6), f32
    hierarchies, SPAI V(2,2), 4 levels: refined iterations equal mgtpu's,
    each to a true f64 relres below 1e-8."""
    A = _divsig((64, 64), seed=5)
    b = _rhs(A, seed=6)
    st_r, st_p = _setups(A, dict(coarsening=coarsening), dtype=np.float32)
    _, i_r = refined_ref(st_r, b, tol=1e-8, max_iter=60)
    x, i_p = mt.solve_mg_refined(st_p, b, tol=1e-8, max_iter=60)
    assert i_p["iters"] == i_r["iters"], (i_p["iters"], i_r["iters"])
    assert np.linalg.norm(b - A @ _np(x)) / np.linalg.norm(b) < 1e-8


def test_classical_amg_standalone_and_cg():
    """tests/test_amg.py::test_classical_amg_standalone_and_cg on the port:
    C-AMG at 50^2, SPAI V(1,1), 3 levels, 5 cycles, then CG: < 0.005
    (reference testSAforDivSigGrad.jl:67-76)."""
    A = _divsig((50, 50), shift=1e-8, seed=0)
    cfg, rp = mt.get_mg_param(levels=3, max_outer_iter=5, relative_tol=1e-4,
                              relax_type="spai", relax_param=1.0, nu_pre=1,
                              nu_post=1)
    st = mt.classical_amg_setup(A, cfg, rp, device="cpu")
    b = _rhs(A, seed=1)
    x, info = mt.solve_mg(st, b)
    assert info["relres"] < 1.0
    x, _ = mt.solve_cg_mg(st, b)
    assert np.linalg.norm(A @ _np(x) - b) < 0.005


def test_amg_3d_classical():
    """tests/test_amg.py::test_amg_3d's classical half on the port: 3D
    32 x 32 x 16 DivSigGrad + 1e-6 shift, SPAI V(1,1), 3 levels, CG on
    three right-hand sides: < 0.005 (testSAforDivSigGrad.jl:93-127)."""
    M = mt.get_regular_mesh([0.0, 1.0] * 3, [32, 32, 16])
    from mgtpu_torch.models.operators import nodal_div_sig_grad_matrix
    A = nodal_div_sig_grad_matrix(
        M, np.exp(np.random.RandomState(0).randn(32 * 32 * 16)))
    A = (A + 1e-6 * abs(A).sum() * sp.identity(A.shape[0])).tocsr()
    cfg, rp = mt.get_mg_param(levels=3, max_outer_iter=5, relative_tol=1e-4,
                              relax_type="spai", relax_param=1.0, nu_pre=1,
                              nu_post=1)
    st = mt.classical_amg_setup(A, cfg, rp, device="cpu")
    B = A @ np.random.RandomState(1).rand(A.shape[0], 3)
    B = B / np.linalg.norm(B)
    X, _ = mt.solve_cg_mg(st, B)
    assert np.linalg.norm(A @ _np(X) - B) < 0.005


def test_classical_amg_variants():
    """tests/test_amg.py::test_classical_amg_variants on the port: the
    min-coarse pass gives a covered coarse set no larger than common-C's,
    and standard interpolation (two levels) and min-coarse coloring
    converge under CG to 0.005."""
    from mgtpu_torch.models.operators import nodal_div_sig_grad_matrix
    M = mt.get_regular_mesh([0.0, 1.0, 0.0, 1.0], [50, 50])
    rng = np.random.RandomState(11)
    A = nodal_div_sig_grad_matrix(M, np.exp(rng.randn(M.num_cells)))
    A = (A + 1e-8 * abs(A).sum(0).max() * sp.identity(A.shape[0])).tocsr()
    S = ca_port.strength_matrix_classical(A, 0.4)
    first = ca_port.cf_coloring_first(S)
    common = ca_port.cf_coloring_second(S, first.copy())
    minc = ca_port.cf_coloring_second_s(S, first.copy())
    assert minc.sum() <= common.sum()
    b = rng.rand(A.shape[0], 2)
    for kw, levels in ((dict(interpolation="standard"), 2),
                       (dict(coarsening="min-coarse"), 3),
                       (dict(interpolation="standard",
                             coarsening="min-coarse"), 2)):
        cfg, rp = mt.get_mg_param(levels=levels, relax_type="spai",
                                  nu_pre=2, nu_post=2, max_outer_iter=5,
                                  relative_tol=1e-10)
        st = mt.classical_amg_setup(A, cfg, rp, device="cpu", **kw)
        x, _ = mt.solve_cg_mg(st, b)
        r = np.linalg.norm(b - A @ _np(x)) / np.linalg.norm(b)
        assert r < 0.005, (kw, r)


@pytest.mark.parametrize("setup", ["sa", "classical"])
def test_flat_refined_certifies_in_native_f64(setup):
    """tests/test_flat_df32.py:44-55's contract without df32: 96^2, f32
    hierarchy, SPAI, 3 levels; the refined solve (native f64 residual of
    A_input) reaches a true relres below 1.5e-8 in mgtpu's iteration count
    (on the CPU with x64: SA 31, classical 14; BASELINE r5, df32 on the
    TPU: 32 and 14)."""
    A = _divsig((96, 96))
    b = _rhs(A)
    kw = dict(levels=3, relax_type="spai", dtype=np.float32)
    ref = sa_ref.sa_amg_setup if setup == "sa" else ca_ref.classical_amg_setup
    port = mt.sa_amg_setup if setup == "sa" else mt.classical_amg_setup
    st_r = ref(A, *mgtpu.get_mg_param(**kw))
    st_p = port(A, *mt.get_mg_param(**kw), device="cpu")
    _, i_r = refined_ref(st_r, b, tol=1e-8, max_iter=80)
    x, i_p = mt.solve_mg_refined(st_p, b, tol=1e-8, max_iter=80)
    assert i_p["iters"] == i_r["iters"]
    assert abs(i_r["iters"] - (32 if setup == "sa" else 14)) <= 1
    assert np.linalg.norm(b - A @ _np(x)) < 1.5e-8


def test_classical_options():
    A = _divsig((16, 16))
    cfg, rp = mt.get_mg_param(levels=3)
    for kw in (dict(interpolation="extended"), dict(coarsening="rs3")):
        with pytest.raises(ValueError, match="unknown"):
            mt.classical_amg_setup(A, cfg, rp, device="cpu", **kw)
    cfg, rp = mt.get_mg_param(levels=3, relax_type="chebyshev")
    with pytest.raises(ValueError, match="pointwise"):
        mt.classical_amg_setup(A, cfg, rp, device="cpu")
    # complex128 with semicoarsening named: classical AMG builds its own
    # transfers and sets up as mgtpu's (it raised until semicoarsening
    # took complex values)
    kw = dict(levels=3, dtype=np.complex128, transfer_type="SemiCoarsening")
    cfg, rp = mt.get_mg_param(**kw)
    st = mt.classical_amg_setup(A, cfg, rp, device="cpu")
    st_r = ca_ref.classical_amg_setup(A, *mgtpu.get_mg_param(**kw))
    assert len(st.As) == len(st_r.As) > 1
    assert all(_same(a, b) for a, b in zip(st.As, st_r.As))
    # no mesh: the grid engine has nothing to build
    cfg, rp = mt.get_mg_param(levels=3, engine="grid")
    with pytest.raises(ValueError, match="engine='grid'"):
        mt.classical_amg_setup(A, cfg, rp, device="cpu")
    # a level of at most 100 dofs stops coarsening
    cfg, rp = mt.get_mg_param(levels=3)
    st = mt.classical_amg_setup(A[:100, :100], cfg, rp, device="cpu")
    assert st.num_levels == 1 and st.config.levels == 1
