"""The port's recorded programs (mgtpu_torch/cycle/capture.py) in their
plain form, on the CPU: the device loops against the eager loops, bit for
bit; `solve_mg_jit` and the recordable FGMRES projection against mgtpu; the
launch-counter tally.  On the CPU a recorded program calls its function,
so these tests hold the masked chunked loops themselves; the CUDA graphs
are held against the eager runs on the card (tests/test_torch_gpu.py and
chip_smoke.py)."""
import gc

import jax  # noqa: F401  (conftest pins JAX to the CPU with x64 on)
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import mgtpu
from mgtpu.krylov.fgmres import _fgmres_cycle as fgmres_cycle_ref
from mgtpu.models.operators import nodal_div_sig_grad_matrix
from mgtpu.solvers.mg_solver import solve_mg_jit as solve_mg_jit_ref

import mgtpu_torch as mt
from mgtpu_torch.cycle import capture
from mgtpu_torch.cycle import grid_cycle as gc_mod
from mgtpu_torch.cycle.cycle import cycle_jit, make_cycle_fn, recursive_cycle
from mgtpu_torch.cycle.grid_cycle import grid_cycle, grid_cycle_jit
from mgtpu_torch.krylov.fgmres import _fgmres_cycle
from mgtpu_torch.models.operators import nodal_laplacian_matrix


def _laplacian(dims, shift=1e-4):
    M = mt.get_regular_mesh([0.0, 1.0] * len(dims), list(dims))
    L = nodal_laplacian_matrix(M)
    L = (L + shift * abs(L).sum(0).max() * sp.identity(L.shape[0])).tocsr()
    b = L @ np.random.RandomState(0).rand(L.shape[0])
    return M, L, b / np.linalg.norm(b)


def _divsig(n, shift=1e-8, seed=3):
    M = mt.get_regular_mesh([0.0, 1.0, 0.0, 1.0], [n, n])
    sig = np.exp(np.random.RandomState(seed).randn(M.num_cells))
    A = nodal_div_sig_grad_matrix(M, sig)
    A = (A + shift * abs(A).sum(0).max() * sp.identity(A.shape[0])).tocsr()
    b = A @ np.random.RandomState(seed + 1).rand(A.shape[0])
    return M, A, b / np.linalg.norm(b)


def _aniso(n, eps):
    """eps u_xx + u_yy on an n^2-cell node grid (the line smoother's case)."""
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n + 1, n + 1)) * n * n
    I = sp.identity(n + 1)
    A = (sp.kron(I, eps * T) + sp.kron(T, I)).tocsr()
    A = (A + 1e-4 * abs(A).sum(0).max() * sp.identity(A.shape[0])).tocsr()
    M = mt.get_regular_mesh([0.0, 1.0, 0.0, 1.0], [n, n])
    b = A @ np.random.RandomState(1).rand(A.shape[0])
    return M, A, b / np.linalg.norm(b)


# configurations of the refined solve: (name, problem, setup keywords,
# solve keywords); each runs as the device loop and as the eager loop
GRID = {
    "jacobi-2d": (lambda: _laplacian([32, 32]),
                  dict(levels=3, relax_type="jacobi", relax_param=0.8,
                       nu_pre=1, nu_post=1), {}),
    "jacobi-3d": (lambda: _laplacian([16, 16, 16]),
                  dict(levels=3, relax_type="jacobi", relax_param=0.8,
                       nu_pre=1, nu_post=1), {}),
    "spai-3d": (lambda: _laplacian([16, 16, 16]),
                dict(levels=3, relax_type="spai"), {}),
    "chebyshev": (lambda: _laplacian([32, 32]),
                  dict(levels=3, relax_type="chebyshev", cheby_degree=3,
                       nu_pre=1, nu_post=0), {}),
    "line-jacobi": (lambda: _aniso(32, 100.0),
                    dict(levels=3, relax_type="line-jacobi", relax_param=0.8,
                         nu_pre=1, nu_post=1), {}),
    "fmg": (lambda: _laplacian([64, 64]),
            dict(levels=4, relax_type="chebyshev", cheby_degree=3, nu_pre=1,
                 nu_post=0), dict(fmg=True)),
    "w-cycle": (lambda: _divsig(32),
                dict(levels=3, relax_type="jacobi", relax_param=0.8,
                     nu_pre=1, nu_post=1, cycle_type="W"), {}),
}


def _state(name, engine="auto"):
    make, opts, solve_kw = GRID[name]
    M, A, b = make()
    cfg, rp = mt.get_mg_param(dtype=np.float32, engine=engine, **opts)
    return mt.mg_setup(A, M, cfg, rp, device="cpu"), A, b, solve_kw


@pytest.fixture(params=[1, 3, 8])
def chunk(request, monkeypatch):
    """Iterations a recorded program (krylov/_loop.py's CHUNK)."""
    monkeypatch.setattr(mt.krylov._loop, "CHUNK", request.param)
    return request.param


def _same_refined(st, b, **kw):
    """The device loop against the eager loop: the same count and residual
    history, and x bit for bit."""
    x1, i1 = mt.solve_mg_refined(st, b, device_loop=True, **kw)
    x0, i0 = mt.solve_mg_refined(st, b, device_loop=False, **kw)
    assert i1["iters"] == i0["iters"]
    assert np.array_equal(i1["resvec"], i0["resvec"])
    assert i1["relres"] == i0["relres"]
    assert torch.equal(x1, x0)
    return i0


@pytest.mark.parametrize("name", sorted(GRID))
def test_refined_device_loop_is_the_eager_loop(name, chunk):
    """The grid engine's refined solve to 1e-8: its count (which ends mid
    chunk for most of these) and x equal the eager loop's."""
    st, A, b, kw = _state(name)
    info = _same_refined(st, b, tol=1e-8, max_iter=60, **kw)
    assert info["relres"] < 1e-8


def test_refined_device_loop_stops_at_max_iter(chunk):
    """A max_iter that is no multiple of the chunk: the masked iterations
    past it change nothing."""
    st, _, b, _ = _state("jacobi-2d")
    info = _same_refined(st, b, tol=1e-14, max_iter=7)
    assert info["iters"] == 7


def test_refined_device_loop_stops_on_divergence(chunk):
    """An over-relaxed Jacobi (omega 2.6) diverges: both loops stop at the
    first residual above 1e3 ||b||."""
    M, A, b = _laplacian([32, 32])
    cfg, rp = mt.get_mg_param(levels=3, relax_type="jacobi", relax_param=2.6,
                              nu_pre=2, nu_post=2, dtype=np.float32)
    st = mt.mg_setup(A, M, cfg, rp, device="cpu")
    info = _same_refined(st, b, tol=1e-8, max_iter=60)
    assert info["iters"] < 60 and info["resvec"][-1] >= 1e3


def test_refined_device_loop_flat_engine(chunk):
    """The flat engine: greedy SA (DIA fine level, ELL levels, DenseLU)."""
    _, A, b = _divsig(32, seed=5)
    cfg, rp = mt.get_mg_param(levels=3, relax_type="spai", dtype=np.float32)
    st = mt.sa_amg_setup(A, cfg, rp, device="cpu")
    assert type(st.hier.coarse).__name__ == "DenseLU"
    info = _same_refined(st, b, tol=1e-8, max_iter=60)
    assert info["relres"] < 1e-8


@pytest.mark.parametrize("engine", ["grid", "flat"])
def test_refined_device_loop_sparse_lu_coarsest(engine, chunk, monkeypatch):
    """A host SuperLU coarsest (a host step inside the program) on either
    engine, V- and W-cycles."""
    monkeypatch.setattr(gc_mod, "HOST_INV_MAX", 16)
    monkeypatch.setattr(gc_mod, "DENSE_LU_MAX", 16)
    for name in ("jacobi-2d", "w-cycle"):
        st, _, b, _ = _state(name, engine=engine)
        assert type(st.hier.coarse).__name__ == (
            "GridSparseLU" if engine == "grid" else "SparseLUCoarse")
        info = _same_refined(st, b, tol=1e-8, max_iter=60)
        assert info["relres"] < 1e-8


# ---------------------------------------------------------------------------
# the Krylov loops
# ---------------------------------------------------------------------------

KRYLOV = {
    "cg": (mt.solve_cg_mg, {}),
    "bicgstab": (mt.solve_bicgstab_mg, {}),
    "block-cg": (mt.solve_cg_mg, dict(block=True)),
}


@pytest.mark.parametrize("nrhs", [1, 4])
@pytest.mark.parametrize("method", sorted(KRYLOV))
def test_krylov_device_loop_is_the_eager_loop(method, chunk, nrhs):
    """MG-preconditioned CG, BiCGSTAB and block CG (f32 hierarchy, f64
    outer iteration) at 1 and 4 right-hand sides: iteration count,
    residual history and x equal the eager loop's."""
    M, A, b = _divsig(32)
    B = b if nrhs == 1 else np.random.RandomState(4).rand(A.shape[0], nrhs)
    cfg, rp = mt.get_mg_param(levels=3, relax_type="jacobi", relax_param=0.8,
                              nu_pre=1, nu_post=1, max_outer_iter=60,
                              relative_tol=1e-8, dtype=np.float32)
    st = mt.mg_setup(A, M, cfg, rp, device="cpu")
    solve, kw = KRYLOV[method]
    x1, i1 = solve(st, B, **kw)
    x0, i0 = solve(st, B, device_loop=False, **kw)
    assert i1["iters"] == i0["iters"] < 60
    assert torch.equal(i1["resvec"], i0["resvec"])
    assert torch.equal(x1, x0)
    rr = np.linalg.norm(B - A @ x1.numpy(), axis=0) / np.linalg.norm(B, axis=0)
    assert np.all(rr < 1e-7)


def test_krylov_device_loop_stops_at_max_iter(chunk):
    """pcg with a max_iter that is no multiple of the chunk (tol 0)."""
    _, A, b = _divsig(16)
    At = torch.from_numpy(A.toarray())
    B = torch.from_numpy(np.random.RandomState(2).rand(2, A.shape[0]))
    mv = lambda V: (At @ V.T).T
    x1, i1 = mt.pcg(mv, B, tol=0.0, max_iter=7)
    x0, i0 = mt.pcg(mv, B, tol=0.0, max_iter=7, device_loop=False)
    assert i1["iters"] == i0["iters"] == 7
    assert torch.equal(x1, x0) and torch.equal(i1["resvec"], i0["resvec"])


def test_gmres_solve_restarts_as_eager():
    """K-cycle FGMRES: each restart a program, equal to eager restarts."""
    M, A, b = _divsig(32)
    cfg, rp = mt.get_mg_param(levels=3, relax_type="jac-gmres",
                              relax_param=1.0, cycle_type="K", nu_pre=1,
                              nu_post=1, max_outer_iter=20,
                              relative_tol=1e-8, dtype=np.float32)
    st = mt.mg_setup(A, M, cfg, rp, device="cpu")
    x1, i1 = mt.solve_gmres_mg(st, b, inner=5)
    x0, i0 = mt.solve_gmres_mg(st, b, inner=5, device_loop=False)
    assert i1["iters"] == i0["iters"]
    assert np.array_equal(i1["resvec"], i0["resvec"])
    assert torch.equal(x1, x0)
    assert np.linalg.norm(b - A @ x1.numpy()) < 1e-8


# ---------------------------------------------------------------------------
# mgtpu's names: solve_mg_jit, grid_cycle_jit, cycle_jit, make_cycle_fn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_cycles", [1, 4])
def test_solve_mg_jit_matches_reference(num_cycles):
    """A fixed count of cycles against mgtpu's solve_mg_jit on JAX's CPU,
    f64, 1e-9 relative (BASELINE.md's conformance bound)."""
    M, L, _ = _laplacian([32, 32])
    rng = np.random.RandomState(7)
    B = rng.rand(L.shape[0], 2)
    X0 = rng.rand(L.shape[0], 2)
    kw = dict(levels=3, relax_type="jacobi", relax_param=0.8, nu_pre=1,
              nu_post=1, dtype=np.float64)
    Mr = mgtpu.get_regular_mesh([0.0, 1.0, 0.0, 1.0], [32, 32])
    st_r = mgtpu.mg_setup(L, Mr, *mgtpu.get_mg_param(**kw))
    st_p = mt.mg_setup(L, M, *mt.get_mg_param(**kw), device="cpu")
    for x0 in (None, X0):
        want = np.asarray(solve_mg_jit_ref(
            st_r, B, x0, num_cycles=num_cycles))
        got = mt.solve_mg_jit(st_p, B, x0, num_cycles=num_cycles).numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-9


def test_solve_mg_jit_is_a_fixed_count_of_cycles():
    """solve_mg_jit(n) = n cycles of grid_cycle; one column comes back as
    (n,)."""
    st, _, b, _ = _state("jacobi-2d")
    x = mt.solve_mg_jit(st, b, num_cycles=3)
    bg = torch.from_numpy(b.astype(np.float32)).reshape(
        (1,) + st.hier.fine_grid)
    xg = torch.zeros_like(bg)
    for _ in range(3):
        xg = grid_cycle(st.config, st.hier, bg, xg)
    assert x.shape == (b.shape[0],)
    assert torch.equal(x, xg.reshape(-1))


@pytest.mark.parametrize("x_zero", [False, True])
def test_cycle_programs_are_the_plain_cycles(x_zero):
    """grid_cycle_jit, cycle_jit and make_cycle_fn on the CPU are the plain
    cycles (grid and flat engine)."""
    st, _, b, _ = _state("jacobi-2d")
    rng = np.random.RandomState(3)
    bg = torch.from_numpy(rng.rand(2, *st.hier.fine_grid).astype(np.float32))
    xg = torch.zeros_like(bg) if x_zero else torch.rand_like(bg)
    assert torch.equal(grid_cycle_jit(st.config, st.hier, bg, xg, x_zero),
                       grid_cycle(st.config, st.hier, bg, xg, x_zero=x_zero))
    _, A, b = _divsig(32, seed=5)
    cfg, rp = mt.get_mg_param(levels=3, relax_type="spai", dtype=np.float32)
    sf = mt.sa_amg_setup(A, cfg, rp, device="cpu")
    bf = torch.from_numpy(rng.rand(A.shape[0], 2).astype(np.float32))
    xf = torch.zeros_like(bf) if x_zero else torch.rand_like(bf)
    want = recursive_cycle(cfg, sf.hier, bf, xf, x_zero=x_zero)
    assert torch.equal(cycle_jit(cfg, sf.hier, bf, xf, x_zero), want)
    assert torch.equal(make_cycle_fn(cfg)(sf.hier, bf, xf, x_zero), want)


# ---------------------------------------------------------------------------
# the FGMRES projection
# ---------------------------------------------------------------------------

TOL_PROJ = {np.float64: 1e-9, np.float32: 1e-4}


@pytest.mark.parametrize("restart", [3, 6])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fgmres_projection_matches_reference(dtype, restart):
    """One restart with the recordable ridge solve against mgtpu's
    `_fgmres_cycle` (its pinv), two right-hand sides, Jacobi-preconditioned,
    within the projection tolerances of tests/test_torch_krylov.py."""
    _, A, _ = _divsig(8, shift=1e-2)
    Ad = A.toarray().astype(dtype)
    d = (1.0 / A.diagonal()).astype(dtype)
    rng = np.random.RandomState(9)
    B = rng.rand(2, A.shape[0]).astype(dtype)
    X = rng.rand(2, A.shape[0]).astype(dtype)
    Aj, At = jnp.asarray(Ad), torch.from_numpy(Ad)
    dj, dt = jnp.asarray(d), torch.from_numpy(d)
    xr, rr = fgmres_cycle_ref(lambda V: (Aj @ V.T).T, lambda r: dj * r,
                              restart, True, jnp.asarray(X), jnp.asarray(B))
    xp, rp = _fgmres_cycle(lambda V: (At @ V.T).T,
                                      lambda r: dt * r, restart,
                                      torch.from_numpy(X), torch.from_numpy(B))
    xr, rr = np.asarray(xr, np.float64), np.asarray(rr, np.float64)
    assert np.abs(xp.numpy() - xr).max() / np.abs(xr).max() < TOL_PROJ[dtype]
    assert np.abs(rp.numpy() - rr).max() / np.abs(rr).max() < TOL_PROJ[dtype]


def test_ridge_solve_takes_a_happy_breakdown():
    """An exact solve inside the restart (restart > n) leaves a singular
    normal-equation block; the ridge solve gives the solution as pinv
    does, with no inf or nan."""
    A = torch.from_numpy(np.diag([1.0, 2.0, 3.0, 4.0]))
    B = torch.from_numpy(np.random.RandomState(1).rand(1, 4))
    X, rn = _fgmres_cycle(lambda V: (A @ V.T).T, lambda r: r, 6,
                                     torch.zeros_like(B), B)
    assert torch.isfinite(X).all()
    assert float(rn.max()) < 1e-10 * float(B.norm())


# ---------------------------------------------------------------------------
# the launch-counter tally and the program cache
# ---------------------------------------------------------------------------

def test_tally_counts_each_replay():
    """A fake counter dict: one recording (its increments taken back), then
    three replays count three times the recording's launches; a key first
    seen in the recording is added too."""
    fake = {"a": 5, "b": 0}
    tally = capture.Tally([fake])
    tally.begin()
    fake["a"] += 2                  # what the wrappers add while recording
    fake["c"] = 1
    tally.end()
    assert fake == {"a": 5, "b": 0}
    for _ in range(3):
        tally.replay()
    assert fake == {"a": 11, "b": 0, "c": 3}


def test_programs_are_kept_per_owner_and_freed_with_it():
    """The program cache is weakly keyed by its owner."""

    class Owner:
        pass

    o = Owner()
    p = capture.programs(o)
    assert capture.programs(o) is p
    n = len(capture._PROGRAMS)
    del o
    gc.collect()
    assert len(capture._PROGRAMS) == n - 1


def test_programs_run_plainly_on_the_cpu():
    """On CPU tensors `run`, `Captured` and `host_step` call their function
    (the plain form); host_step's result keeps the input's device."""
    calls = []

    def fn(ctx, a, b):
        calls.append(ctx)
        return a + b, a * b

    a, b = torch.ones(3), torch.full((3,), 2.0)
    s, p = capture.run(object(), "k", fn, "ctx", a, b)
    assert torch.equal(s, a + b) and torch.equal(p, a * b)
    assert capture.Captured(fn)("c2", a, b)[0].tolist() == [3.0] * 3
    assert calls == ["ctx", "c2"]
    out = capture.host_step(lambda t: t * 3, a)
    assert out.device == a.device and torch.equal(out, a * 3)


# ---------------------------------------------------------------------------
# the while form (capture.loop): its programs in their plain form
# ---------------------------------------------------------------------------

def _loop_in_python(owner, key, first, body, ctx, *args, count, keep=()):
    """capture.loop's graph, step for step, in Python on the CPU: the
    start program, then the iteration program (its state written back in
    place) while the condition holds; the count read once at the end."""
    state, go = capture._loop_start(first, ctx, args)
    while bool(go):
        go = capture._loop_step(body, ctx, args, state)
    return state, int(state[count])


@pytest.fixture
def while_form(monkeypatch):
    """The solvers' loops in the while form's plain programs."""
    from mgtpu_torch.solvers import mg_solver
    monkeypatch.setattr(mt.krylov._loop, "loop", _loop_in_python)
    monkeypatch.setattr(mg_solver, "loop", _loop_in_python)


@pytest.mark.parametrize("nrhs", [1, 4])
@pytest.mark.parametrize("method", sorted(KRYLOV) + ["block-bicgstab"])
def test_while_form_is_the_eager_krylov_loop(method, nrhs, while_form):
    """The while form's programs (the start, then the iteration written
    back into the loop's buffers) give the eager loop's count, history
    and x bit for bit: BiCGSTAB's start returns R three times (its
    buffers are cloned apart), the iteration returns entries unchanged
    (skipped)."""
    M, A, b = _divsig(32)
    B = b if nrhs == 1 else np.random.RandomState(4).rand(A.shape[0], nrhs)
    cfg, rp = mt.get_mg_param(levels=3, relax_type="jacobi", relax_param=0.8,
                              nu_pre=1, nu_post=1, max_outer_iter=60,
                              relative_tol=1e-8, dtype=np.float32)
    st = mt.mg_setup(A, M, cfg, rp, device="cpu")
    solve, kw = KRYLOV.get(method, (mt.solve_bicgstab_mg, dict(block=True)))
    x1, i1 = solve(st, B, **kw)
    x0, i0 = solve(st, B, device_loop=False, **kw)
    assert i1["iters"] == i0["iters"] > 1
    assert torch.equal(i1["resvec"], i0["resvec"])
    assert torch.equal(x1, x0)


@pytest.mark.parametrize("name", ["jacobi-2d", "fmg", "w-cycle"])
def test_while_form_is_the_eager_refined_loop(name, while_form):
    st, A, b, kw = _state(name)
    info = _same_refined(st, b, tol=1e-8, max_iter=60, **kw)
    assert info["relres"] < 1e-8


def test_while_form_stops_at_max_iter(while_form):
    st, _, b, _ = _state("jacobi-2d")
    assert _same_refined(st, b, tol=1e-14, max_iter=7)["iters"] == 7
    _, A, _ = _divsig(16)
    At = torch.from_numpy(A.toarray())
    B = torch.from_numpy(np.random.RandomState(2).rand(2, A.shape[0]))
    mv = lambda V: (At @ V.T).T
    x1, i1 = mt.pcg(mv, B, tol=0.0, max_iter=7)
    x0, i0 = mt.pcg(mv, B, tol=0.0, max_iter=7, device_loop=False)
    assert i1["iters"] == i0["iters"] == 7
    assert torch.equal(x1, x0) and torch.equal(i1["resvec"], i0["resvec"])


def test_while_form_stops_on_divergence(while_form):
    M, A, b = _laplacian([32, 32])
    cfg, rp = mt.get_mg_param(levels=3, relax_type="jacobi", relax_param=2.6,
                              nu_pre=2, nu_post=2, dtype=np.float32)
    st = mt.mg_setup(A, M, cfg, rp, device="cpu")
    info = _same_refined(st, b, tol=1e-8, max_iter=60)
    assert info["iters"] < 60 and info["resvec"][-1] >= 1e3


def test_loop_step_writes_back_through_aliases():
    """An iteration that swaps two entries, keeps one and computes one:
    the swapped values are cloned before the write-back, the kept entry is
    not copied, and the buffers are the start's own."""
    a, b = torch.arange(3.0), torch.arange(3.0) + 10

    def first(ctx, a, b):
        return a, b, a, torch.zeros((), dtype=torch.int64), torch.tensor(True)

    def body(ctx, args, s):
        x, y, z, k = s
        return y, x, z, k + 1, k + 1 < 3

    state, go = capture._loop_start(first, None, (a, b))
    ptrs = [t.data_ptr() for t in state]
    assert len(set(ptrs)) == 4 and not {a.data_ptr(), b.data_ptr()} & set(ptrs)
    n = 0
    while bool(go):
        go = capture._loop_step(body, None, (a, b), state)
        n += 1
    assert n == 3 and [t.data_ptr() for t in state] == ptrs
    assert torch.equal(state[0], b) and torch.equal(state[1], a)
    assert torch.equal(state[2], a) and int(state[3]) == 3


def test_loop_step_refuses_a_state_that_changes_type():
    state = (torch.zeros(3), torch.zeros((), dtype=torch.int64))
    with pytest.raises(ValueError, match="shapes and types"):
        capture._loop_step(lambda ctx, args, s: (s[0].double(), s[1],
                                                  torch.tensor(False)),
                           None, (), state)


@pytest.mark.parametrize("where", ["none", "start", "iteration"])
def test_a_host_step_keeps_a_loop_on_chunks(where):
    """The rule that picks a loop's form: its warm-up (the start and one
    iteration) takes a host step (a SuperLU coarsest's `host_step`) or
    not.  With one, the loop stays on chunks."""
    lu = lambda t: t * 2

    def first(ctx, x):
        y = capture.host_step(lu, x) if where == "start" else x + 1
        return (y, torch.tensor(True))

    def body(ctx, args, s):
        y = capture.host_step(lu, s[0]) if where == "iteration" else s[0]
        return (y, torch.tensor(False))

    assert capture._warm(first, body, None, (torch.ones(4),)) == (
        where != "none")


def test_loop_takes_no_while_form_on_the_cpu():
    """On CPU tensors `loop` gives None: the caller's chunked form runs,
    which the CPU tests above hold."""
    def first(ctx, x):
        return (x, torch.tensor(False))

    assert capture.loop(object(), "k", first, None, None, torch.ones(2),
                        count=0) is None


@pytest.mark.parametrize("k", [0, 1, 7])
def test_tally_adds_the_start_once_and_the_iteration_k_times(k):
    """A loop's two tallies: the start's increments once, the iteration's
    once for each of the k iterations run (k read from the count)."""
    fake = {"d": 0}
    start, step = capture.Tally([fake]), capture.Tally([fake])
    for tally, inc in ((start, 3), (step, 2)):
        tally.begin()
        fake["d"] += inc
        fake["new"] = fake.get("new", 0) + 1
        tally.end()
    assert fake == {"d": 0}
    start.replay()
    step.replay(k)
    assert fake == {"d": 3 + 2 * k, "new": 1 + k}


@pytest.mark.parametrize("counts,takes", [
    ({"kernel": 591, "memcpy": 66, "memset": 17}, True),
    ({"kernel": 14, "graph": 2, "empty": 1}, True),
    ({"kernel": 591, "memcpy": 66, "mem_alloc": 8, "mem_free": 8}, False),
    ({"kernel": 3, "memcpy": 1, "host_memcpy": 1}, False),
    ({"kernel": 3, "event_record": 1}, False),
    ({"kernel": 3, "host": 1}, False)])
def test_the_loop_graph_takes_what_a_while_body_takes(counts, takes):
    """The census rule that keeps a loop on chunks after its recording: a
    memory-allocation node (a library's stream-ordered workspace, as the
    K-cycles' recording held on the card), a host node or event, or a
    copy to or from host memory, which a WHILE body refuses."""
    from mgtpu_torch.ops.cuda import device_loop
    assert device_loop.body_takes(counts) is takes


def test_warm_up_leaves_the_inputs_alone():
    """A start that returns an input as its state and an iteration that
    writes its state in place (as the refined loop's does): the warm-up
    runs them on the start's own buffers, so the program's static inputs
    keep the call's values for the first launch."""
    x = torch.arange(4.0)

    def first(ctx, x):
        return (x, torch.tensor(True))

    def body(ctx, args, s):
        return (s[0].add_(1.0), torch.tensor(False))

    assert capture._warm(first, body, None, (x,)) is False
    assert torch.equal(x, torch.arange(4.0))
    state, go = capture._loop_start(first, None, (x,))
    assert not bool(capture._loop_step(body, None, (x,), state))
    assert torch.equal(state[0], torch.arange(4.0) + 1)
    assert torch.equal(x, torch.arange(4.0))


def test_loop_step_writes_back_by_size_and_dtype(monkeypatch):
    """_loop_step's write-back: an entry above BIG elements by a `copy_` of
    its own, the small ones by one `_foreach_copy_` a dtype; every entry
    copied, an unchanged one left out."""
    calls = []
    real = torch._foreach_copy_
    monkeypatch.setattr(torch, "_foreach_copy_", lambda d, s: (
        calls.append([t.dtype for t in d]), real(d, s))[1])
    state = (torch.zeros(capture.BIG + 1), torch.zeros(3),
             torch.zeros((), dtype=torch.int64),
             torch.zeros(2, dtype=torch.bool), torch.zeros(5),
             torch.zeros(capture.BIG))
    new = (torch.ones(capture.BIG + 1), torch.full((3,), 2.0),
           torch.tensor(5), torch.tensor([True, False]), state[4],
           torch.full((capture.BIG,), 3.0))
    go = capture._loop_step(lambda ctx, args, s: new + (torch.tensor(True),),
                            None, (), state)
    assert bool(go)
    assert calls == [[torch.float32] * 2, [torch.int64], [torch.bool]]
    assert all(torch.equal(s, n) for s, n in zip(state, new))
    assert all(s is not n for s, n in zip(state[:4], new[:4]))
