"""Façade and lifecycle parity of the PyTorch port (mgtpu_torch) with
mgtpu, on the CPU: the solver wrappers (MGSolver, SAAMGSolver,
ClassicalAMGSolver: lazy setup, the Krylov switch, adjoint solves through
`transpose_hierarchy`, the counters), `replace_matrix_in_hierarchy` and
`transpose_hierarchy` (level operators bit for bit), re-discretized
hierarchies (`OperatorConstructor`: level operators bit for bit, refined
counts), the lifecycle helpers, and the solve arguments: `grid_fmg`'s
n_cycles, `solve_mg_refined`'s outer_dtype / cycle_dtype (bfloat16
cycles), `get_mg_preconditioner`'s outer_dtype and the FMG start on a
flat hierarchy (mgtpu solves from zero there)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import mgtpu
from mgtpu.cycle.grid_cycle import grid_fmg as fmg_ref
from mgtpu.models.operators import (linear_elasticity_operator as el_ref,
                                    linear_elasticity_operator_mixed as
                                    mixed_ref,
                                    nodal_div_sig_grad_matrix as dsg_ref,
                                    nodal_laplacian_matrix as lap_ref)
from mgtpu.setup.transfers import restrict_cell_centered_variables as rcc_ref

import mgtpu_torch as mt
from mgtpu_torch.cycle import capture
from mgtpu_torch.cycle.grid_cycle import grid_fmg
from mgtpu_torch.ops.cuda import const3d
from mgtpu_torch.ops.grid_stencil import flat_to_grid
from mgtpu_torch.setup.transfers import restrict_cell_centered_variables


def _np(t):
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _rel(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _opn1(A):
    return abs(A).sum(axis=0).max()


def _meshes(dims):
    dom = [0.0, 1.0] * len(dims)
    return (mgtpu.get_regular_mesh(dom, list(dims)),
            mt.get_regular_mesh(dom, list(dims)))


def _shifted_lap(n, dim=2, shift=1e-4):
    M, Mp = _meshes([n] * dim)
    L = lap_ref(M)
    return M, Mp, (L + shift * _opn1(L) * sp.identity(L.shape[0])).tocsr()


def _divsig(n, shift, seed=3):
    M, Mp = _meshes([n, n])
    A = dsg_ref(M, np.exp(np.random.RandomState(seed).randn(M.num_cells)))
    return M, Mp, (A + shift * _opn1(A) * sp.identity(A.shape[0])).tocsr()


def _rhs(A, m=None, seed=4):
    rng = np.random.RandomState(seed)
    if m is None:
        b = A @ rng.rand(A.shape[0])
        return b / np.linalg.norm(b)
    B = A @ rng.rand(A.shape[0], m)
    return B / np.linalg.norm(B, axis=0)


def _same_levels(st_p, st_r):
    assert len(st_p.As) == len(st_r.As)
    for a, b in zip(st_p.As, st_r.As):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert (a != b).nnz == 0


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("krylov", ["gmres", "pcg", "bicgstab"])
def test_mg_solver_wrapper_matches_reference(krylov):
    """test_solvers.py:81 (testLinSolveMGWrapper.jl): four right-hand
    sides, ||AX - B|| / ||B|| < 1e-2, mgtpu's n_iter; the setup is made
    once and reused; clear and copy."""
    M, Mp, A = _shifted_lap(50, shift=1e-2)
    B = A @ np.random.RandomState(1).rand(A.shape[0], 4)
    kw = dict(levels=5, max_outer_iter=15, relative_tol=1e-2,
              relax_type="spai", relax_param=1.0, nu_pre=2, nu_post=2)
    s = mt.MGSolver(*mt.get_mg_param(**kw), mesh=Mp, krylov=krylov,
                    device="cpu")
    r = mgtpu.MGSolver(*mgtpu.get_mg_param(**kw), mesh=M, krylov=krylov)
    X = s.solve_linear_system(A, B)
    X_r = r.solve_linear_system(A, B)
    assert s.n_iter == r.n_iter
    assert np.linalg.norm(A @ _np(X) - B) / np.linalg.norm(B) < 1e-2
    assert _rel(X, X_r) < 1e-4
    t_setup, hier = s.time_setup, s.state.hier
    X2 = s.solve_linear_system(A, B)
    assert s.state.hier is hier and s.time_setup == t_setup
    assert s.n_iter == 2 * r.n_iter and torch.equal(X, X2)
    s.clear()
    assert s.state is None and not mt.hierarchy_exists(s.state)
    s2 = s.copy()
    X = s2.solve_linear_system(A, B)
    assert np.linalg.norm(A @ _np(X) - B) / np.linalg.norm(B) < 1e-2
    assert s2.time_setup > 0 and s2.time_solve > 0
    assert torch.equal(s2.solve_linear_system(A, np.zeros_like(B)),
                       torch.zeros(B.shape, dtype=torch.float64))


def test_amg_wrappers_match_reference():
    """test_solvers.py:129 (testLinSolveAMGWrapper.jl)."""
    M, Mp, A = _divsig(50, 1e-2, seed=2)
    B = A @ np.random.RandomState(1).rand(A.shape[0], 4)
    kw = dict(levels=3, max_outer_iter=15, relative_tol=1e-2,
              relax_type="spai", relax_param=1.0, nu_pre=2, nu_post=2)
    for cls, cls_r in ((mt.SAAMGSolver, mgtpu.SAAMGSolver),
                       (mt.ClassicalAMGSolver, mgtpu.ClassicalAMGSolver)):
        s = cls(*mt.get_mg_param(**kw), krylov="pcg", device="cpu")
        r = cls_r(*mgtpu.get_mg_param(**kw), krylov="pcg")
        X = s.solve_linear_system(A, B)
        r.solve_linear_system(A, B)
        assert s.n_iter == r.n_iter
        assert np.linalg.norm(A @ _np(X) - B) / np.linalg.norm(B) < 1e-2


def _nonsym(n):
    M, Mp = _meshes([n, n])
    L = lap_ref(M)
    N = L.shape[0]
    C = sp.diags([np.ones(N - 1)], [1], shape=(N, N)) * (0.05 * _opn1(L) / 8)
    return M, Mp, (L + 1e-3 * _opn1(L) * sp.identity(N) + C).tocsr()


def test_facade_adjoint_solve_matches_reference():
    """test_coverage_extra.py:167: sym=0; an adjoint solve transposes the
    hierarchy (level operators bit for bit mgtpu's A^H ones), and back;
    the third solve equals the first bit for bit; mgtpu's counts."""
    M, Mp, A = _nonsym(48)
    kw = dict(levels=3, max_outer_iter=20, relative_tol=1e-8,
              relax_type="jacobi", relax_param=0.7, nu_pre=1, nu_post=1)
    s = mt.MGSolver(*mt.get_mg_param(**kw), mesh=Mp, sym=0, krylov="gmres",
                    gmres_inner=10, device="cpu")
    r = mgtpu.MGSolver(*mgtpu.get_mg_param(**kw), mesh=M, sym=0,
                       krylov="gmres", gmres_inner=10)
    b = A @ np.random.RandomState(2).rand(A.shape[0])
    xs = []
    for tr in (False, True, False):
        x = s.solve_linear_system(A, b, transpose=tr)
        r.solve_linear_system(A, b, transpose=tr)
        _same_levels(s.state, r.state)
        assert s.n_iter == r.n_iter
        assert s.state.do_transpose == r.state.do_transpose == int(tr)
        Ax = A.conj().T if tr else A
        assert np.linalg.norm(Ax @ _np(x) - b) / np.linalg.norm(b) < 1e-6
        xs.append(x)
    assert torch.equal(xs[0], xs[2])


def test_sym_wrapper_never_transposes():
    M, Mp, A = _shifted_lap(16)
    s = mt.MGSolver(*mt.get_mg_param(levels=2, relax_type="jacobi",
                                     relax_param=0.8), mesh=Mp,
                    krylov="mg", device="cpu")
    b = _rhs(A)
    s.solve_linear_system(A, b)
    hier = s.state.hier
    s.solve_linear_system(A, b, transpose=True)
    assert s.state.hier is hier and s.state.do_transpose == 0


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["grid", "flat"])
def test_replace_matrix_matches_reference(kind):
    """bench.py:269-280's sequence 1.7 L, L, 1.7 L, L: the level
    operators bit for bit mgtpu's after each replace (the structured RAP
    on the grid path, scipy's on the flat one), the refined count, the old
    hierarchy's recorded programs dropped."""
    M, Mp, L = _shifted_lap(32)
    kw = dict(levels=3, relax_type="jacobi", relax_param=0.8, nu_pre=1,
              nu_post=1, dtype=np.float32,
              engine="auto" if kind == "grid" else "flat")
    st_r = mgtpu.mg_setup(L, M, *mgtpu.get_mg_param(**kw))
    st_p = mt.mg_setup(L, Mp, *mt.get_mg_param(**kw), device="cpu")
    for A_new in ((1.7 * L).tocsr(), L, (1.7 * L).tocsr(), L):
        old = st_p.hier
        capture.programs(old)
        mgtpu.replace_matrix_in_hierarchy(st_r, A_new)
        assert mt.replace_matrix_in_hierarchy(st_p, A_new) is st_p
        assert st_p.hier is not old and old not in capture._PROGRAMS
        _same_levels(st_p, st_r)
        assert (st_p.A_input != A_new).nnz == 0
    assert type(st_p.hier).__name__ == type(st_r.hier).__name__
    b = _rhs(L)
    x_r, i_r = mgtpu.solve_mg_refined(st_r, b, tol=1e-8, max_iter=40)
    x_p, i_p = mt.solve_mg_refined(st_p, b, tol=1e-8, max_iter=40)
    assert abs(i_p["iters"] - i_r["iters"]) <= 1
    assert np.linalg.norm(L @ _np(x_p) - b) < 1e-8


def test_replace_with_new_coefficients_matches_fresh_setup():
    """R-sigma at 32^2: a hierarchy replaced by sigma' solves as a fresh
    setup on sigma' (the same operators, the same CG count), and as
    mgtpu's replaced one."""
    M, Mp, A = _divsig(32, 1e-8)
    _, _, A2 = _divsig(32, 1e-8, seed=7)
    kw = dict(levels=3, relax_type="jacobi", relax_param=0.8, nu_pre=1,
              nu_post=1, dtype=np.float32, relative_tol=1e-8,
              max_outer_iter=100)
    st = mt.mg_setup(A, Mp, *mt.get_mg_param(**kw), device="cpu")
    mt.replace_matrix_in_hierarchy(st, A2)
    fresh = mt.mg_setup(A2, Mp, *mt.get_mg_param(**kw), device="cpu")
    _same_levels(st, fresh)
    st_r = mgtpu.mg_setup(A, M, *mgtpu.get_mg_param(**kw))
    mgtpu.replace_matrix_in_hierarchy(st_r, A2)
    _same_levels(st, st_r)
    b = _rhs(A2)
    _, i1 = mt.solve_cg_mg(st, b)
    _, i2 = mt.solve_cg_mg(fresh, b)
    _, i_r = mgtpu.solve_cg_mg(st_r, b)
    assert int(i1["iters"]) == int(i2["iters"])
    assert abs(int(i1["iters"]) - int(i_r["iters"])) <= 1


def test_transpose_hierarchy_matches_reference():
    M, Mp, A = _nonsym(16)
    kw = dict(levels=3, relax_type="spai", relax_param=0.9)
    st_r = mgtpu.mg_setup(A, M, *mgtpu.get_mg_param(**kw))
    st_p = mt.mg_setup(A, Mp, *mt.get_mg_param(**kw), device="cpu")
    for k in range(2):
        mgtpu.transpose_hierarchy(st_r)
        mt.transpose_hierarchy(st_p)
        _same_levels(st_p, st_r)
        for a, b in zip(list(st_p.Ps) + list(st_p.Rs),
                        list(st_r.Ps) + list(st_r.Rs)):
            assert (a != b).nnz == 0
        assert st_p.do_transpose == (k + 1) % 2
    cfg, rp = mt.get_mg_param(levels=2, relax_type="chebyshev")
    st = mt.mg_setup(A, Mp, cfg, rp, device="cpu")
    with pytest.raises(NotImplementedError, match="pointwise"):
        mt.transpose_hierarchy(st)


def test_copy_solver_and_clear():
    M, Mp, A = _shifted_lap(16)
    ds = mt.DirectSolver("dense")
    st = mt.mg_setup(A, Mp, *mt.get_mg_param(levels=2), coarse_solver=ds,
                     device="cpu")
    assert mt.hierarchy_exists(st) and not mt.hierarchy_exists(None)
    c = mt.copy_solver(st)
    assert not mt.hierarchy_exists(c)
    assert c.config == st.config and c.coarse_solver is ds
    assert c.device == st.device
    mt.clear(st)
    assert not mt.hierarchy_exists(st) and st.As == []


# ---------------------------------------------------------------------------
# re-discretization
# ---------------------------------------------------------------------------

def _ctor_pair(op_ref, op_port, mu0):
    scale = {}

    def make(op):
        def get_op(mesh, mu):
            A = op(mesh, mu, mu)
            if "s" not in scale:
                scale["s"] = 1e-3 * _opn1(A)
            return A + scale["s"] * sp.identity(A.shape[0])
        return get_op

    return (mgtpu.OperatorConstructor(
                mu0, make(op_ref), lambda mf, mc, mu, lvl:
                rcc_ref(mu, list(mf.n))),
            mt.OperatorConstructor(
                mu0, make(op_port), lambda mf, mc, mu, lvl:
                restrict_cell_centered_variables(mu, list(mf.n))))


@pytest.mark.parametrize("mixed", [False, True])
def test_rediscretized_systems_match_reference(mixed):
    """test_coverage_extra.py:190 (mixed elasticity, Vanka V(1,1)) at its
    64^2 and :24 (elasticity, SPAI V(2,2)) at 32^2 (its 128^2 is a slow
    test there): every level re-discretized with coefficient coarsening,
    bit for bit mgtpu's; the same engine; the refined count."""
    from mgtpu_torch.models import operators as ops
    M, Mp = _meshes([64, 64] if mixed else [32, 32])
    mu0 = 1.0 + (np.arange(M.num_cells) % (4 if mixed else 3)) * \
        (0.25 if mixed else 0.5)
    ctor_r, ctor_p = _ctor_pair(
        mixed_ref if mixed else el_ref,
        ops.linear_elasticity_operator_mixed if mixed
        else ops.linear_elasticity_operator, mu0)
    kw = dict(levels=3, max_outer_iter=10, relative_tol=1e-10,
              relax_type="VankaFaces" if mixed else "spai",
              relax_param=0.75, nu_pre=1 if mixed else 2,
              nu_post=1 if mixed else 2, dtype=np.float32,
              transfer_type="SystemsFacesMixedLinear" if mixed
              else "SystemsFacesLinear")
    st_r = mgtpu.mg_setup(ctor_r, M, *mgtpu.get_mg_param(**kw))
    st_p = mt.mg_setup(ctor_p, Mp, *mt.get_mg_param(**kw), device="cpu")
    _same_levels(st_p, st_r)
    assert type(st_p.hier).__name__ == type(st_r.hier).__name__
    A = ctor_p.operator(Mp).tocsr()
    assert (A.astype(np.float32) != st_p.As[0]).nnz == 0
    b = _rhs(A)
    x_r, i_r = mgtpu.solve_mg_refined(st_r, b, tol=1e-8, max_iter=60)
    x_p, i_p = mt.solve_mg_refined(st_p, b, tol=1e-8, max_iter=60)
    assert abs(i_p["iters"] - i_r["iters"]) <= 1
    assert np.linalg.norm(A @ _np(x_p) - b) < 1e-8


@pytest.mark.parametrize("cells", [32, 33])
def test_rediscretized_nodal_matches_reference(cells):
    """A nodal DivSigGrad re-discretized with sigma restricted: the same
    levels (an odd cell count stops coarsening, fw_interp_1d's geometric
    mode), the grid engine where mgtpu takes it, one cycle and the refined
    count."""
    M, Mp = _meshes([cells, cells])
    sig = np.exp(np.random.RandomState(3).randn(M.num_cells))

    def make(op, rcc):
        return (lambda mesh, s: op(mesh, s) + 1e-4 * sp.identity(
                    int(np.prod(np.asarray(mesh.n) + 1))),
                lambda mf, mc, s, lvl: rcc(s, list(mf.n)))

    from mgtpu_torch.models.operators import nodal_div_sig_grad_matrix
    ctor_r = mgtpu.OperatorConstructor(sig, *make(dsg_ref, rcc_ref))
    ctor_p = mt.OperatorConstructor(
        sig, *make(nodal_div_sig_grad_matrix,
                   restrict_cell_centered_variables))
    kw = dict(levels=3, relax_type="jacobi", relax_param=0.8, nu_pre=1,
              nu_post=1)
    st_r = mgtpu.mg_setup(ctor_r, M, *mgtpu.get_mg_param(**kw))
    st_p = mt.mg_setup(ctor_p, Mp, *mt.get_mg_param(**kw), device="cpu")
    _same_levels(st_p, st_r)
    assert type(st_p.hier).__name__ == type(st_r.hier).__name__
    A = ctor_p.operator(Mp).tocsr()
    b = _rhs(A)
    x_r, i_r = mgtpu.solve_mg_refined(st_r, b, tol=1e-8, max_iter=60)
    x_p, i_p = mt.solve_mg_refined(st_p, b, tol=1e-8, max_iter=60)
    assert i_p["iters"] == i_r["iters"]


# ---------------------------------------------------------------------------
# solve arguments
# ---------------------------------------------------------------------------

def test_grid_fmg_n_cycles_matches_reference():
    M, Mp, A = _shifted_lap(32)
    kw = dict(levels=4, relax_type="chebyshev", nu_pre=1, nu_post=0)
    st_r = mgtpu.mg_setup(A, M, *mgtpu.get_mg_param(**kw))
    st_p = mt.mg_setup(A, Mp, *mt.get_mg_param(**kw), device="cpu")
    b = _rhs(A, 2)
    grid = st_p.hier.fine_grid
    bg = flat_to_grid(torch.tensor(b), grid)
    from mgtpu.ops.grid_stencil import flat_to_grid as f2g_ref
    for n in (1, 2):
        got = grid_fmg(st_p.config, st_p.hier, bg, n_cycles=n)
        want = fmg_ref(st_r.config, st_r.hier, f2g_ref(jnp.asarray(b), grid),
                       n_cycles=n)
        assert _rel(got, want) < 1e-9


def test_refined_outer_and_cycle_dtypes():
    """outer_dtype=float32 (an f32 residual, x in f32) and
    cycle_dtype=bfloat16 (a cast copy of the hierarchy, kept on the state;
    its 3D stencil applies counted as kernel A's plain calls) against
    mgtpu's counts; the f64 default unchanged."""
    M, Mp, A = _shifted_lap(16, dim=3)
    kw = dict(levels=3, relax_type="jacobi", relax_param=0.8, nu_pre=1,
              nu_post=1, dtype=np.float32)
    st_r = mgtpu.mg_setup(A, M, *mgtpu.get_mg_param(**kw))
    st_p = mt.mg_setup(A, Mp, *mt.get_mg_param(**kw), device="cpu")
    b = _rhs(A)
    const3d.PLAIN_CALLS["matvec"] = 0
    x_p, i_p = mt.solve_mg_refined(st_p, b, tol=1e-8, max_iter=60,
                                   cycle_dtype=torch.bfloat16)
    plain = const3d.PLAIN_CALLS["matvec"]
    assert plain > 0 and i_p["iters"] > 0
    lo = st_p._lo_hier[1]
    assert lo.levels[0].A.dtype == torch.bfloat16
    assert st_p.hier.levels[0].A.dtype == torch.float32
    x_r, i_r = mgtpu.solve_mg_refined(st_r, b, tol=1e-8, max_iter=60,
                                      cycle_dtype=jnp.bfloat16)
    assert abs(i_p["iters"] - i_r["iters"]) <= 1
    assert x_p.dtype == torch.float64
    assert np.linalg.norm(A @ _np(x_p) - b) < 1e-8
    mt.solve_mg_refined(st_p, b, tol=1e-8, max_iter=60,
                        cycle_dtype=torch.bfloat16)
    assert st_p._lo_hier[1] is lo
    # eager and recorded-form loops agree (the CPU runs both plainly)
    x_e, i_e = mt.solve_mg_refined(st_p, b, tol=1e-8, max_iter=60,
                                   cycle_dtype=torch.bfloat16,
                                   device_loop=False)
    assert i_e["iters"] == i_p["iters"] and torch.equal(x_e, x_p)
    x32, i32 = mt.solve_mg_refined(st_p, b, tol=1e-5, max_iter=60,
                                   outer_dtype=np.float32)
    assert x32.dtype == torch.float32
    x32_r, i32_r = mgtpu.solve_mg_refined(st_r, b, tol=1e-5, max_iter=60,
                                          outer_dtype=np.float32,
                                          device_loop=False)
    assert abs(i32["iters"] - i32_r["iters"]) <= 1
    assert np.linalg.norm(A @ _np(x32).astype(np.float64) - b) < 1e-4


def test_mg_preconditioner_outer_dtype():
    M, Mp, A = _shifted_lap(16)
    kw = dict(levels=3, relax_type="jacobi", relax_param=0.8, nu_pre=1,
              nu_post=1, dtype=np.float32)
    st_r = mgtpu.mg_setup(A, M, *mgtpu.get_mg_param(**kw))
    st_p = mt.mg_setup(A, Mp, *mt.get_mg_param(**kw), device="cpu")
    r = _rhs(A)
    z = mt.get_mg_preconditioner(st_p, outer_dtype=np.float64)(
        torch.tensor(r, dtype=torch.float32))
    z_r = mgtpu.get_mg_preconditioner(st_r, outer_dtype=np.float64)(
        jnp.asarray(r, dtype=jnp.float32))
    assert z.dtype == torch.float64 and tuple(z.shape) == r.shape
    assert _rel(z, z_r) < 1e-5
    z32 = mt.get_mg_preconditioner(st_p)(torch.tensor(r,
                                                      dtype=torch.float32))
    assert z32.dtype == torch.float32


@pytest.mark.parametrize("engine", ["flat", "systems"])
def test_fmg_on_non_grid_hierarchies_solves_from_zero(engine):
    """mgtpu seeds FMG only on the grid engine (its df32 loop); on a flat
    or systems hierarchy fmg=True solves from zero, as there: the count
    and x of fmg=False, and mgtpu's count."""
    if engine == "flat":
        M, Mp, A = _divsig(32, 1e-8)
        kw = dict(levels=3, relax_type="jacobi", relax_param=0.8, nu_pre=1,
                  nu_post=1, dtype=np.float32, engine="flat")
    else:
        M, Mp = _meshes([16, 16])
        mu = np.ones(M.num_cells)
        A = mixed_ref(M, mu, mu)
        A = (A + 1e-3 * _opn1(A) * sp.identity(A.shape[0])).tocsr()
        kw = dict(levels=3, relax_type="VankaFaces", relax_param=0.75,
                  nu_pre=1, nu_post=1, dtype=np.float32,
                  transfer_type="SystemsFacesMixedLinear")
    st_r = mgtpu.mg_setup(A, M, *mgtpu.get_mg_param(**kw))
    st_p = mt.mg_setup(A, Mp, *mt.get_mg_param(**kw), device="cpu")
    b = _rhs(A)
    x_f, i_f = mt.solve_mg_refined(st_p, b, tol=1e-8, max_iter=60, fmg=True)
    x_0, i_0 = mt.solve_mg_refined(st_p, b, tol=1e-8, max_iter=60)
    _, i_r = mgtpu.solve_mg_refined(st_r, b, tol=1e-8, max_iter=60, fmg=True)
    assert i_f["iters"] == i_0["iters"] and torch.equal(x_f, x_0)
    assert abs(i_f["iters"] - i_r["iters"]) <= 1
    assert i_f["resvec"][0] == pytest.approx(1.0)
