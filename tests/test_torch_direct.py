"""Direct-tier and Schur parity of the PyTorch port (mgtpu_torch) with
mgtpu, on the CPU: `DirectSolver` (dense and host backends, A and A^H, 1
and 5 right-hand sides, all four value types at test_solvers.py's
DTYPES_TOL), `batched_dense_lu`, a DirectSolver and a Schur solver as a
hierarchy's coarsest (one cycle within 1e-9, the flat engine as in
mgtpu), and `SchurComplementSolver` with its dense and Kaczmarz inner
solves (test_solvers.py:32, :56, :66, :81, :145)."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import mgtpu
from mgtpu.cycle.cycle import recursive_cycle as cycle_ref
from mgtpu.models.operators import (linear_elasticity_operator_mixed as
                                    mixed_ref, nodal_gradient_matrix,
                                    nodal_laplacian_matrix as lap_ref)
from mgtpu.solvers import direct as dr_ref
from mgtpu.solvers import schur as schur_ref

import mgtpu_torch as mt
from mgtpu_torch.convert import (batched_lu_from_arrays,
                                 flat_hierarchy_from_arrays)
from mgtpu_torch.cycle.cycle import recursive_cycle as cycle_port
from mgtpu_torch.cycle.coarse import DenseLU
from mgtpu_torch.ops.cuda import kaczmarz as kf
from mgtpu_torch.solvers import direct as dr
from mgtpu_torch.solvers import schur

DTYPES_TOL = [(np.float64, 1e-8), (np.float32, 1e-4),
              (np.complex128, 1e-8), (np.complex64, 1e-4)]


def _np(t):
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _rel(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _sym_operator(seed=0):
    """test_solvers.py's operator: DivSigGrad on a 20 x 23 mesh + shift."""
    M = mgtpu.get_regular_mesh([0.0, 1.0, 0.0, 1.0], [20, 23])
    G = nodal_gradient_matrix(M)
    rng = np.random.RandomState(seed)
    A = (G.T @ sp.diags(np.exp(rng.randn(G.shape[0]))) @ G).tocsr()
    A = A + 1e-1 * abs(A).sum(axis=0).max() * sp.identity(A.shape[0])
    return A.tocsr()


@pytest.mark.parametrize("dtype,tol", DTYPES_TOL)
@pytest.mark.parametrize("backend", ["dense", "host"])
def test_direct_solver_all_dtypes(dtype, tol, backend):
    """A and A^H, 1 and 5 right-hand sides, against the tolerance and
    mgtpu's solution; the counters, clear and copy."""
    A = _sym_operator().astype(dtype)
    if np.issubdtype(dtype, np.complexfloating):
        P = sp.random(*A.shape, density=0.001, random_state=2)
        A = (A + 1j * 0.1 * abs(A).sum() / A.nnz * (P - P.T)).tocsr()
        A = A.astype(dtype)
    LU = dr.DirectSolver(backend=backend, dtype=dtype, device="cpu")
    ref = dr_ref.DirectSolver(backend=backend, dtype=dtype)
    rng = np.random.RandomState(1)
    for nrhs in (1, 5):
        b = (A @ rng.rand(A.shape[0], nrhs)).astype(dtype)
        b = b[:, 0] if nrhs == 1 else b
        x = LU.solve_linear_system(A, b)
        x_r = ref.solve_linear_system(A, b)
        assert x.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
        assert np.abs(A @ _np(x) - b).max() / np.abs(b).max() < tol
        assert _rel(x, x_r) < tol
        xt = LU.solve(b, transpose=True)
        assert np.abs(A.conj().T @ _np(xt) - b).max() / np.abs(b).max() < tol
        assert _rel(xt, ref.solve(b, transpose=True)) < tol
    assert LU.n_fac == 1 and LU.n_solve == 4
    assert LU.fac_time > 0 and LU.solve_time > 0
    LU.clear()
    assert not LU.is_setup
    assert not LU.copy().is_setup


def test_direct_solver_nonsymmetric_and_limits():
    """test_solvers.py:56; the dense limit; only the dense backend is a
    coarsest solver."""
    n = 300
    A = sp.random(n, n, density=0.05, format="csr", random_state=11)
    A = (A + n * sp.identity(n)).tocsr()
    b = np.random.RandomState(2).randn(n)
    for backend in ("dense", "host"):
        x = dr.DirectSolver(backend=backend,
                            device="cpu").solve_linear_system(A, b)
        assert np.abs(A @ _np(x) - b).max() < 1e-8
    with pytest.raises(ValueError, match="dense_limit"):
        dr.DirectSolver(dense_limit=100, device="cpu").setup(A)
    with pytest.raises(ValueError, match="dense backend"):
        dr.DirectSolver("host").setup_coarse(A)
    with pytest.raises(ValueError, match="backend"):
        dr.DirectSolver("umfpack")


def test_batched_dense_lu_matches_reference():
    """test_solvers.py:66: 32 systems of 12, three right-hand sides, A and
    A^H; mgtpu's factors carried across solve the same."""
    nb, k, m = 32, 12, 3
    rng = np.random.RandomState(3)
    Ab = rng.randn(nb, k, k) + k * np.eye(k)[None]
    B = rng.randn(nb, k, m)
    lu = dr.batched_dense_lu(Ab, device="cpu")
    X = _np(lu.solve(torch.tensor(B)))
    assert np.abs(np.einsum("bij,bjm->bim", Ab, X) - B).max() < 1e-10
    Xa = _np(lu.solve_adjoint(torch.tensor(B)))
    assert np.abs(np.einsum("bji,bjm->bim", Ab.conj(), Xa) - B).max() < 1e-10
    ref = dr_ref.batched_dense_lu(Ab)
    assert _rel(X, ref.solve(jnp.asarray(B))) < 1e-12
    assert _rel(lu.lu, ref.lu) < 1e-12
    assert np.array_equal(_np(lu.piv), np.asarray(ref.piv) + 1)
    lu2 = batched_lu_from_arrays(np.asarray(ref.lu), np.asarray(ref.piv),
                                 "cpu")
    assert _rel(lu2.solve_adjoint(torch.tensor(B)),
                ref.solve_adjoint(jnp.asarray(B))) < 1e-12


def test_direct_as_mg_coarse_solver_matches_reference():
    """test_solvers.py:145: a DirectSolver coarsest takes the hierarchy to
    the flat engine in both packages; one cycle within 1e-9; the count."""
    M = mgtpu.get_regular_mesh([0.0, 1.0, 0.0, 1.0], [64, 64])
    Mp = mt.get_regular_mesh([0.0, 1.0, 0.0, 1.0], [64, 64])
    L = lap_ref(M)          # singular (Neumann): the test's count
    # the cycle is compared on the shifted operator: with L's singular
    # coarsest LU the null-space component of a solve is rounding noise
    As = (L + 1e-4 * abs(L).sum(axis=0).max()
          * sp.identity(L.shape[0])).tocsr()
    kw = dict(levels=3, max_outer_iter=5, relative_tol=1e-2,
              relax_type="jacobi", relax_param=0.8, nu_pre=1, nu_post=1)
    st_r = mgtpu.mg_setup(As, M, *mgtpu.get_mg_param(**kw),
                          coarse_solver=dr_ref.DirectSolver("dense"))
    ds = dr.DirectSolver("dense")
    st_p = mt.mg_setup(As, Mp, *mt.get_mg_param(**kw), coarse_solver=ds,
                       device="cpu")
    assert type(st_p.hier).__name__ == type(st_r.hier).__name__ == \
        "Hierarchy"
    assert isinstance(st_p.hier.coarse, DenseLU) and ds.n_fac == 1
    assert ds.device == torch.device("cpu")
    b = L @ np.random.RandomState(4).rand(L.shape[0], 2)
    b /= np.linalg.norm(b)
    y_r = cycle_ref(st_r.config, st_r.hier, jnp.asarray(b),
                    jnp.zeros_like(jnp.asarray(b)))
    y_p = cycle_port(st_p.config, st_p.hier, torch.tensor(b),
                     torch.zeros(b.shape, dtype=torch.float64))
    assert _rel(y_p, y_r) < 1e-9
    st_r = mgtpu.mg_setup(L, M, *mgtpu.get_mg_param(**kw),
                          coarse_solver=dr_ref.DirectSolver("dense"))
    st_p = mt.mg_setup(L, Mp, *mt.get_mg_param(**kw),
                       coarse_solver=dr.DirectSolver("dense"), device="cpu")
    b = L @ np.random.RandomState(4).rand(L.shape[0])
    b /= np.linalg.norm(b)
    x_r, i_r = mgtpu.solve_mg(st_r, b)
    x_p, i_p = mt.solve_mg(st_p, b)
    assert i_p["iters"] == i_r["iters"]
    assert np.linalg.norm(L @ _np(x_p) - b) < 0.005


def _mixed(n):
    M = mgtpu.get_regular_mesh([0.0, 1.0, 0.0, 1.0], [n, n])
    Mp = mt.get_regular_mesh([0.0, 1.0, 0.0, 1.0], [n, n])
    mu = np.ones(M.num_cells)
    A = mixed_ref(M, mu, 10.0 * mu)
    A = (A + 1e-3 * abs(A).sum(axis=0).max() * sp.identity(A.shape[0]))
    return M, Mp, A.tocsr()


def test_schur_complement_solver_matches_reference():
    """test_solvers.py:81 at 16^2, the dense inner: to 1e-10 with the
    counters, within 1e-9 of mgtpu's; copy and clear."""
    M, Mp, A = _mixed(16)
    b = A @ np.random.RandomState(5).rand(A.shape[0])
    S = schur.SchurComplementSolver(inner="dense", device="cpu")
    x = S.solve_linear_system(A, b, mesh=Mp)
    assert np.linalg.norm(A @ _np(x) - b) / np.linalg.norm(b) < 1e-10
    assert S.n_fac == 1 and S.n_solve == 1
    x_r = schur_ref.SchurComplementSolver("dense").solve_linear_system(
        A, b, mesh=M)
    assert _rel(x, x_r) < 1e-9
    assert not S.copy().is_setup
    S.clear()
    assert not S.is_setup
    with pytest.raises(ValueError, match="inner"):
        schur.SchurComplementSolver(inner="lu", device="cpu").setup(A, Mp)


# the Kaczmarz inner: within 1e-9 of mgtpu's at 5 FGMRES steps; at the
# test's 20 the regularised normal equations of 20 directions amplify the
# summation order of either package (1.3e-4 measured), so 1e-3 there
@pytest.mark.parametrize("inner,tol", [(5, 1e-9), (20, 1e-3)])
def test_schur_kaczmarz_inner_matches_reference(inner, tol):
    """test_solvers.py:81's Kaczmarz inner (kernel F's plain version, one
    call an FGMRES step) below 0.5, as the test holds it."""
    M, Mp, A = _mixed(16)
    b = A @ np.random.RandomState(5).rand(A.shape[0])
    opts = {"num_domains": [2, 2], "omega": 0.8, "num_it": 2,
            "inner": inner}
    S2 = schur.SchurComplementSolver(inner="kaczmarz", kaczmarz_opts=opts,
                                     device="cpu")
    kf.PLAIN_CALLS["float64"] = 0
    x2 = S2.solve_linear_system(A, b, mesh=Mp)
    assert kf.PLAIN_CALLS["float64"] == inner
    assert np.linalg.norm(A @ _np(x2) - b) / np.linalg.norm(b) < 0.5
    x2_r = schur_ref.SchurComplementSolver(
        "kaczmarz", kaczmarz_opts=opts).solve_linear_system(A, b, mesh=M)
    assert _rel(x2, x2_r) < tol


def test_schur_as_mg_coarse_solver_matches_reference():
    """A Schur coarsest under Vanka on a mixed hierarchy: the flat engine
    in both packages (the systems engine refuses an external coarsest);
    one cycle within 1e-9, and mgtpu's Schur state carried across gives
    the same cycle."""
    M, Mp, A = _mixed(16)
    kw = dict(levels=2, max_outer_iter=5, relative_tol=1e-10,
              relax_type="VankaFaces", relax_param=0.75, nu_pre=1,
              nu_post=1, transfer_type="SystemsFacesMixedLinear")
    st_r = mgtpu.mg_setup(A, M, *mgtpu.get_mg_param(**kw),
                          coarse_solver=schur_ref.SchurComplementSolver())
    st_p = mt.mg_setup(A, Mp, *mt.get_mg_param(**kw),
                       coarse_solver=schur.SchurComplementSolver(),
                       device="cpu")
    assert type(st_p.hier).__name__ == type(st_r.hier).__name__ == \
        "Hierarchy"
    b = A @ np.random.RandomState(6).rand(A.shape[0], 1)
    b /= np.linalg.norm(b)
    y_r = cycle_ref(st_r.config, st_r.hier, jnp.asarray(b),
                    jnp.zeros_like(jnp.asarray(b)))
    y_p = cycle_port(st_p.config, st_p.hier, torch.tensor(b),
                     torch.zeros(b.shape, dtype=torch.float64))
    assert _rel(y_p, y_r) < 1e-9
    # mgtpu's Schur coarsest (its dense factor) carried across
    c = st_r.hier.coarse
    ell = lambda E: {"indices": np.asarray(E.indices),
                     "values": np.asarray(E.values), "shape": E.shape}
    lv = st_r.hier.levels[0]
    vk = {k: np.asarray(getattr(lv.relax, k))
          for k in ("idx", "dinv", "rows_idx", "rows_val")}
    h = flat_hierarchy_from_arrays(
        [{"A": ell(lv.A), "P": ell(lv.P), "R": ell(lv.R),
          "vanka": dict(vk, variant=lv.relax.variant)},
         {"A": ell(st_r.hier.levels[1].A)}],
        {"schur": {"B": ell(c.B), "CT": ell(c.CT),
                   "Dinv": np.asarray(c.Dinv), "n_cut": c.n_cut,
                   "lu": np.asarray(c.s_solver.lu),
                   "piv": np.asarray(c.s_solver.piv)}}, device="cpu")
    y_h = cycle_port(st_r.config, h, torch.tensor(b),
                     torch.zeros(b.shape, dtype=torch.float64))
    assert _rel(y_h, y_r) < 1e-9
    x_r, i_r = mgtpu.solve_mg(st_r, b[:, 0])
    x_p, i_p = mt.solve_mg(st_p, b[:, 0])
    assert i_p["iters"] == i_r["iters"]
