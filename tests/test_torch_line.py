"""Line Jacobi in the PyTorch port against mgtpu, on the CPU: the host
pivots (setup/smoothers.py::line_prec), the tridiagonal line solve (the
plain version of the line kernel, ops/cuda/tridiag.py), one cycle on
mgtpu's own line-smoothed hierarchies, the FMG start, and the contracts of
tests/test_line_smoother.py at n = 64."""
import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import mgtpu
from mgtpu.cycle.grid_cycle import grid_cycle as cycle_ref
from mgtpu.cycle.grid_cycle import grid_fmg as fmg_ref
from mgtpu.cycle.relax import AltLineRelax as AltRef
from mgtpu.cycle.relax import LineRelax as LineRef
from mgtpu.cycle.relax import line_solve as line_solve_ref
from mgtpu.setup.smoothers import line_prec as line_prec_ref

import mgtpu_torch as mt
from mgtpu_torch.convert import grid_hierarchy_from_arrays
from mgtpu_torch.cycle import relax as port_relax
from mgtpu_torch.cycle.grid_cycle import grid_cycle as cycle_port
from mgtpu_torch.cycle.grid_cycle import grid_fmg as fmg_port
from mgtpu_torch.ops.cuda import tridiag
from mgtpu_torch.setup.smoothers import line_prec


def aniso2d(n, eps, mesh_mod=mt):
    """eps*u_xx + u_yy on the (n+1)^2 node grid (test_line_smoother.py)."""
    N = n + 1
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(N, N)) * (n ** 2)
    I = sp.identity(N)
    A = eps * sp.kron(I, T) + sp.kron(T, I)
    return mesh_mod.get_regular_mesh([0.0, 1.0, 0.0, 1.0], [n, n]), \
        sp.csr_matrix(A)


def mixed_strength(n, mesh_mod=mt):
    """a(x)*u_xx + u_yy, a = 100 left, 0.01 right, plus a tiny shift
    (test_line_smoother.py::_mixed_strength)."""
    N = n + 1
    a_edge = np.where(np.arange(N - 1) < (N - 1) // 2, 100.0, 0.01)
    D = sp.diags([-1.0, 1.0], [0, 1], shape=(N - 1, N))
    Tx = (D.T @ sp.diags(a_edge) @ D) * (n ** 2)
    Ty = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(N, N)) * (n ** 2)
    A = sp.kron(sp.identity(N), Tx) + sp.kron(Ty, sp.identity(N))
    A = A + 1e-6 * abs(A).sum(0).max() * sp.identity(A.shape[0])
    return mesh_mod.get_regular_mesh([0.0, 1.0, 0.0, 1.0], [n, n]), \
        sp.csr_matrix(A)


def aniso3d(dims, strong, eps=50.0, mesh_mod=mt):
    """eps on grid axis `strong` of a 3D 7-point operator
    (test_line_smoother.py::test_line_jacobi_3d); dims per mesh axis."""
    Ts = [sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(d + 1, d + 1))
          * (d ** 2) for d in reversed(dims)]          # grid axes (z, y, x)
    Is = [sp.identity(d + 1) for d in reversed(dims)]
    A = 0
    for k in range(3):
        mats = list(Is)
        mats[k] = Ts[k]
        w = eps if k == strong else 1.0
        A = A + w * sp.kron(sp.kron(mats[0], mats[1]), mats[2])
    M = mesh_mod.get_regular_mesh([0.0, 1.0] * 3, list(dims))
    return M, sp.csr_matrix(A)


def _line_arrays(lr):
    if isinstance(lr, AltRef):
        return tuple(_line_arrays(c) for c in lr.lines)
    return dict(alpha=np.asarray(lr.alpha), pivot=np.asarray(lr.pivot),
                cprime=np.asarray(lr.cprime), axis=lr.axis, omega=lr.omega)


def hierarchy_arrays(gh):
    """Plain numpy arrays of an mgtpu GridHierarchy, line states and None
    transfer factors included."""
    levels = []
    for lv in gh.levels:
        A = lv.A
        if hasattr(A, "const"):
            spec = dict(const=np.asarray(A.const),
                        strips=[np.asarray(s) for s in A.strips],
                        boxes=A.boxes)
        else:
            spec = dict(coeff=np.asarray(A.coeff))
        spec.update(offsets=A.offsets, grid=A.grid, lam=lv.lam,
                    P1=None if lv.P1 is None else
                    [None if p is None else np.asarray(p) for p in lv.P1])
        if isinstance(lv.d, (LineRef, AltRef)):
            spec["line"] = _line_arrays(lv.d)
        elif lv.d is not None:
            spec["d"] = np.asarray(lv.d)
        levels.append(spec)
    return levels, np.asarray(gh.coarse.inv), gh.coarse.grid


# ---------------------------------------------------------------------------
# host pivots
# ---------------------------------------------------------------------------

def _same_line_state(got, want):
    if isinstance(want, AltRef):
        assert isinstance(got, port_relax.AltLineRelax)
        assert len(got.lines) == len(want.lines)
        for g, w in zip(got.lines, want.lines):
            _same_line_state(g, w)
        return
    assert isinstance(got, port_relax.LineRelax)
    assert (got.axis, got.omega) == (want.axis, want.omega)
    for k in ("alpha", "pivot", "cprime"):
        w = np.asarray(getattr(want, k))
        g = getattr(got, k)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g, w), k


@pytest.mark.parametrize("case", [
    ("2d", 0), ("2d", 1), ("2d", None), ("2d", "alt"), ("2d-dict", None),
    ("3d", 0), ("3d", 1), ("3d", 2), ("3d", None)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_line_prec_matches_reference_bitwise(case, dtype):
    kind, axis = case
    if kind.startswith("2d"):
        M, A = aniso2d(18, 30.0)
        Mr = mgtpu.get_regular_mesh([0.0, 1.0, 0.0, 1.0], [18, 18])
    else:
        M, A = aniso3d([6, 8, 10], strong=1)
        Mr = mgtpu.get_regular_mesh([0.0, 1.0] * 3, [6, 8, 10])
    omega = {"omega": 0.7, "axis": 0} if kind == "2d-dict" else 0.9
    got = line_prec(A, M, omega, dtype=dtype, axis=axis)
    want = line_prec_ref(A, Mr, omega, dtype=dtype, axis=axis)
    _same_line_state(got, want)
    if axis is None and kind == "3d":
        assert got.axis == 1             # the strong axis is detected


# ---------------------------------------------------------------------------
# the line solve (plain version of the kernel) against mgtpu's scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims", [(18, 24), (6, 8, 10)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("lead", [(), (3,)])
def test_line_solve_and_correct_match_reference(dims, dtype, lead):
    if len(dims) == 2:
        # 10 * u_xx + u_yy on a (19 x 25)-node mesh, diagonally dominant
        T = [sp.diags([-1.0, 2.5, -1.0], [-1, 0, 1], shape=(d + 1, d + 1))
             for d in dims]
        A = sp.csr_matrix(sp.kron(T[1], sp.identity(dims[0] + 1))
                          + 10.0 * sp.kron(sp.identity(dims[1] + 1), T[0]))
        M = mt.get_regular_mesh([0.0, 1.0, 0.0, 1.0], list(dims))
        Mr = mgtpu.get_regular_mesh([0.0, 1.0, 0.0, 1.0], list(dims))
    else:
        M, A = aniso3d(list(dims), strong=0)
        Mr = mgtpu.get_regular_mesh([0.0, 1.0] * 3, list(dims))
    grid = tuple(d + 1 for d in reversed(dims))
    tol = 1e-12 if dtype == np.float64 else 2e-5
    rng = np.random.RandomState(len(dims) + len(lead))
    r = rng.rand(*lead, *grid).astype(dtype)
    x = rng.rand(*lead, *grid).astype(dtype)
    for axis in range(len(dims)):
        lr_r = line_prec_ref(A, Mr, 0.8, dtype=dtype, axis=axis)
        lr_p = line_prec(A, M, 0.8, dtype=dtype, axis=axis)
        lr_t = port_relax.LineRelax(*(torch.from_numpy(getattr(lr_p, k))
                                      for k in ("alpha", "pivot", "cprime")),
                                    lr_p.axis, lr_p.omega)
        want = np.asarray(line_solve_ref(lr_r, jnp.asarray(r)))
        n0 = dict(tridiag.PLAIN_CALLS)
        got = port_relax.line_solve(lr_t, torch.from_numpy(r)).numpy()
        got_c = port_relax.line_correct(lr_t, torch.from_numpy(r),
                                        torch.from_numpy(x)).numpy()
        assert tridiag.PLAIN_CALLS["solve"] == n0["solve"] + 1
        assert tridiag.PLAIN_CALLS["correct"] == n0["correct"] + 1
        assert got.dtype == dtype and got.shape == want.shape
        sc = np.abs(want).max()
        assert np.abs(got - want).max() / sc < tol, axis
        want_c = x + 0.8 * want
        assert np.abs(got_c - want_c).max() / np.abs(want_c).max() < tol


def test_line_solve_exact_tridiagonal():
    """T^-1 r == scipy's solve of the pure-line operator (n = 32, f64)."""
    n = 32
    M, A = aniso2d(n, 1.0)
    lr = line_prec(A, M, 1.0, dtype=np.float64, axis=1)
    N = n + 1
    # T: the tridiagonal part of A along grid axis 1 (lines over columns)
    Ac = A.tocoo()
    keep = (Ac.row // N == Ac.col // N) & (abs(Ac.row - Ac.col) <= 1)
    T = sp.csr_matrix((Ac.data[keep], (Ac.row[keep], Ac.col[keep])),
                      shape=A.shape)
    r = np.random.RandomState(0).rand(A.shape[0])
    x_ref = spla.spsolve(T.tocsc(), r)
    lr_t = port_relax.LineRelax(*(torch.from_numpy(getattr(lr, k))
                                  for k in ("alpha", "pivot", "cprime")),
                                lr.axis, lr.omega)
    x = port_relax.line_solve(lr_t, torch.from_numpy(r.reshape(1, N, N)))
    np.testing.assert_allclose(x.numpy().reshape(-1), x_ref, rtol=1e-9,
                               atol=1e-10)


def test_line_smooth_sweeps_and_zero_sweeps():
    """nu == 0 returns x itself; alternating lines take one correction per
    axis per sweep, with the residual refreshed between them."""
    M, A = aniso2d(12, 5.0)
    alt = line_prec(A, M, {"axis": "alt", "omega": 0.9}, dtype=np.float64)
    tl = lambda c: port_relax.LineRelax(
        *(torch.from_numpy(getattr(c, k)) for k in
          ("alpha", "pivot", "cprime")), c.axis, c.omega)
    alt_t = port_relax.AltLineRelax(tuple(tl(c) for c in alt.lines))
    At = torch.from_numpy(A.toarray())
    mv = lambda v: (At @ v.reshape(-1)).reshape(v.shape)
    rng = np.random.RandomState(2)
    b = torch.from_numpy(rng.rand(1, 13, 13))
    x = torch.from_numpy(rng.rand(1, 13, 13))
    r = b - mv(x)
    assert port_relax.line_smooth(mv, alt_t, r, x, b, 0) is x
    y = port_relax.line_smooth(mv, alt_t, r, x, b, 2)
    z = x
    for c in alt_t.lines * 2:
        z = port_relax.line_correct(c, b - mv(z), z)
    assert float((y - z).abs().max()) < 1e-13


# ---------------------------------------------------------------------------
# the kernel's launch plan (ops/cuda/tridiag.py::line_plan)
# ---------------------------------------------------------------------------

# every grid whose lines the main path solves: (a)/(c)/(f) 1025^2 and its
# coarse levels, (d)/(e) 129^3 and its coarse levels, the semicoarsened
# levels of (b)
MAIN_LINE_GRIDS = [(1025, 1025), (513, 513), (257, 257), (129, 129),
                   (65, 65), (33, 33), (513, 1025), (257, 1025),
                   (129, 1025), (65, 513), (33, 257), (17, 129),
                   (129, 129, 129), (65, 65, 65), (33, 33, 33), (17, 17, 17)]


def _line_shape(grid, axis, m):
    inner = int(np.prod(grid[axis + 1:], dtype=np.int64))
    outer = m * int(np.prod(grid[:axis], dtype=np.int64))
    return outer, grid[axis], inner


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("grid", MAIN_LINE_GRIDS,
                         ids=lambda g: "x".join(map(str, g)))
def test_line_plan_on_main_path_shapes(grid, m, itemsize):
    """On every axis of every main-path grid, in both modes, the lines are
    staged: the tile fits in a block's shared memory, a strided tile's rows
    are whole 32-byte sectors, and the blocks cover every line once."""
    for axis in range(len(grid)):
        outer, n, inner = _line_shape(grid, axis, m)
        for mode, arrays in (("solve", 4), ("correct", 5)):
            plan = tridiag.line_plan(outer, n, inner, itemsize, mode)
            assert plan.variant == "staged", (axis, mode, plan)
            assert 0 < plan.smem <= tridiag.MAX_SMEM
            warps = 1 if inner > 1 else 4 if n >= 1024 else 2 if n >= 512 \
                else 1
            assert plan.nchunk == 32 * warps
            assert plan.threads == plan.nchunk * plan.tile <= 1024
            if inner > 1:
                assert plan.tile * itemsize >= 32
                assert plan.smem == arrays * n * (plan.tile + 1) * itemsize
                assert plan.blocks == outer * -(-inner // plan.tile)
            else:
                assert plan.smem == arrays * plan.tile * n * itemsize
                assert (plan.blocks - 1) * plan.tile < outer <= \
                    plan.blocks * plan.tile


@pytest.mark.parametrize("mode", tridiag.MODES)
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("strided", [False, True])
def test_line_plan_streams_exactly_when_a_tile_does_not_fit(strided,
                                                            itemsize, mode):
    """The streamed variant is chosen exactly for the line lengths whose
    smallest staged tile (one contiguous line, or 32 / itemsize strided
    lines with a padded row; four arrays, five in correct mode) exceeds
    the 227 KB a block may hold."""
    tile = 32 // itemsize if strided else 1
    arrays = 5 if mode == "correct" else 4
    row = arrays * ((tile + 1) if strided else 1) * itemsize
    edge = tridiag.MAX_SMEM // row              # the longest staged line
    for n in (2, 3, 1025, 4097, edge - 1, edge, edge + 1, 2 * edge):
        inner = 40 if strided else 1
        plan = tridiag.line_plan(3, n, inner, itemsize, mode)
        fits = n * row <= tridiag.MAX_SMEM
        assert plan.variant == ("staged" if fits else "streamed"), n
        if not fits:
            assert plan.smem == 0 and plan.threads == 256
            assert plan.tile * plan.nchunk == 256 if strided else \
                plan.tile == 8


def test_wrapper_rejects_bad_calls():
    M, A = aniso2d(8, 5.0)
    lr = line_prec(A, M, 0.9, dtype=np.float32, axis=1)
    a, p, c = (torch.from_numpy(getattr(lr, k))
               for k in ("alpha", "pivot", "cprime"))
    r = torch.zeros((1, 9, 9))
    with pytest.raises(ValueError):
        tridiag.line_apply("bogus", a, p, c, 1, r)
    with pytest.raises(ValueError):
        tridiag.line_apply("correct", a, p, c, 1, r)        # needs x
    with pytest.raises(ValueError):
        tridiag.line_apply("solve", a, p, c, 1, r, x=r)     # takes no x


# ---------------------------------------------------------------------------
# cycles and FMG on mgtpu's own hierarchies
# ---------------------------------------------------------------------------

def _line_states(dtype, rp, transfer="full-weighting", levels=3, n=32,
                 eps=30.0):
    M, A = aniso2d(n, eps, mesh_mod=mgtpu)
    kw = dict(levels=levels, relax_type="line-jacobi", relax_param=rp,
              nu_pre=1, nu_post=1, transfer_type=transfer, dtype=dtype)
    st = mgtpu.mg_setup(A, M, *mgtpu.get_mg_param(**kw))
    return st, kw


@pytest.mark.parametrize("rp", [0.8, {"axis": "alt", "omega": 0.9}])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("x_zero", [False, True])
def test_line_cycle_matches_reference(rp, dtype, x_zero):
    st, kw = _line_states(dtype, rp)
    cfg_r, _ = mgtpu.get_mg_param(**kw)
    cfg_p, _ = mt.get_mg_param(**kw)
    gh = grid_hierarchy_from_arrays(*hierarchy_arrays(st.hier), device="cpu")
    assert gh.levels[0].line is not None and gh.levels[0].d is None
    rng = np.random.RandomState(3)
    b = rng.rand(2, *st.hier.fine_grid).astype(dtype)
    x = np.zeros_like(b)
    if not x_zero:
        # a realistic non-zero iterate: the reference's first cycle
        x = np.array(cycle_ref(cfg_r, st.hier, jnp.asarray(b),
                               jnp.asarray(x)))
    want = np.asarray(cycle_ref(cfg_r, st.hier, jnp.asarray(b),
                                jnp.asarray(x), x_zero=x_zero))
    got = cycle_port(cfg_p, gh, torch.from_numpy(b), torch.from_numpy(x),
                     x_zero=x_zero).numpy()
    assert got.dtype == dtype and got.shape == want.shape
    tol = 1e-12 if dtype == np.float64 else 1e-5
    assert np.abs(got - want).max() / np.abs(want).max() < tol


@pytest.mark.parametrize("transfer", ["full-weighting", "semicoarsening"])
def test_grid_fmg_matches_reference(transfer):
    st, kw = _line_states(np.float64, 0.8, transfer=transfer, levels=4,
                          eps=0.01 if transfer == "semicoarsening" else 30.0)
    cfg_r, _ = mgtpu.get_mg_param(**kw)
    cfg_p, _ = mt.get_mg_param(**kw)
    gh = grid_hierarchy_from_arrays(*hierarchy_arrays(st.hier), device="cpu")
    b = np.random.RandomState(4).rand(1, *st.hier.fine_grid)
    want = np.asarray(fmg_ref(cfg_r, st.hier, jnp.asarray(b)))
    got = fmg_port(cfg_p, gh, torch.from_numpy(b)).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-12


def test_fmg_refined_start_matches_reference():
    """solve_mg_refined(fmg=True) on the 2D Chebyshev(3) V(1,0) setting of
    the bench: the same iteration count as mgtpu, one fewer than from zero
    or the same."""
    M, A = aniso2d(64, 1.0)
    A = (A + 1e-4 * abs(A).sum(0).max() * sp.identity(A.shape[0])).tocsr()
    b = A @ np.random.RandomState(0).rand(A.shape[0])
    b /= np.linalg.norm(b)
    kw = dict(levels=4, relax_type="chebyshev", cheby_degree=3, nu_pre=1,
              nu_post=0, dtype=np.float32)
    Mr = mgtpu.get_regular_mesh([0.0, 1.0, 0.0, 1.0], [64, 64])
    st_r = mgtpu.mg_setup(A, Mr, *mgtpu.get_mg_param(**kw))
    st_p = mt.mg_setup(A, M, *mt.get_mg_param(**kw), device="cpu")
    _, i_r = mgtpu.solve_mg_refined(st_r, b, tol=1e-8, fmg=True)
    x, i_p = mt.solve_mg_refined(st_p, b, tol=1e-8, fmg=True)
    _, i_0 = mt.solve_mg_refined(st_p, b, tol=1e-8)
    assert abs(i_p["iters"] - i_r["iters"]) <= 1
    assert i_p["iters"] <= i_0["iters"]
    assert np.linalg.norm(b - A @ x.numpy()) < 1e-8


# ---------------------------------------------------------------------------
# contracts of tests/test_line_smoother.py on the port (n = 64, CPU)
# ---------------------------------------------------------------------------

def test_line_jacobi_beats_point_jacobi_on_anisotropy():
    M, A = aniso2d(64, 100.0)
    b = A @ np.random.RandomState(1).rand(A.shape[0])
    b /= np.linalg.norm(b)
    res = {}
    for rt, rp in (("jacobi", 0.8), ("line-jacobi", 1.0)):
        cfg, rpv = mt.get_mg_param(levels=4, relax_type=rt, relax_param=rp,
                                   nu_pre=1, nu_post=1, max_outer_iter=8,
                                   relative_tol=1e-12)
        st = mt.mg_setup(A, M, cfg, rpv, device="cpu")
        _, info = mt.solve_mg(st, b)
        res[rt] = info["relres"]
    assert res["line-jacobi"] < 5e-3
    assert res["line-jacobi"] < 1e-2 * res["jacobi"]


def test_alternating_lines_mixed_strength_contract():
    M, A = mixed_strength(64)
    b = A @ np.random.RandomState(4).rand(A.shape[0])
    b /= np.linalg.norm(b)
    res = {}
    for key, rt, rp in (("point", "jacobi", 0.8),
                        ("one-axis", "line-jacobi", 0.9),
                        ("alt", "line-jacobi", {"axis": "alt",
                                                "omega": 0.9})):
        cfg, rpv = mt.get_mg_param(levels=4, relax_type=rt, relax_param=rp,
                                   nu_pre=1, nu_post=1, max_outer_iter=14,
                                   relative_tol=1e-12, dtype=np.float64)
        st = mt.mg_setup(A, M, cfg, rpv, device="cpu")
        _, info = mt.solve_mg(st, b)
        res[key] = info["relres"]
    assert res["alt"] < 1e-6
    assert res["alt"] < 1e-2 * res["point"]
    assert res["alt"] < 1e-1 * res["one-axis"]


@pytest.mark.parametrize("strong", [0, 2])
def test_line_jacobi_3d_matches_reference(strong):
    """3D lines on a strided (z) and the contiguous (x) axis: refined
    iterations as mgtpu's, true f64 relres below 1e-8."""
    M, A = aniso3d([16, 16, 16], strong)
    Mr = mgtpu.get_regular_mesh([0.0, 1.0] * 3, [16, 16, 16])
    b = A @ np.random.RandomState(5).rand(A.shape[0])
    b /= np.linalg.norm(b)
    kw = dict(levels=3, relax_type="line-jacobi", relax_param=0.8,
              nu_pre=1, nu_post=1, dtype=np.float32)
    st = mt.mg_setup(A, M, *mt.get_mg_param(**kw), device="cpu")
    assert st.hier.levels[0].line.axis == strong
    st_r = mgtpu.mg_setup(A, Mr, *mgtpu.get_mg_param(**kw))
    _, i_r = mgtpu.solve_mg_refined(st_r, b, tol=1e-8, max_iter=40)
    x, i_p = mt.solve_mg_refined(st, b, tol=1e-8, max_iter=40)
    assert abs(i_p["iters"] - i_r["iters"]) <= 1
    assert np.linalg.norm(b - A @ x.numpy()) < 1e-8
