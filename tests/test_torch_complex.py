"""Complex hierarchies on the PyTorch port (mgtpu_torch) against mgtpu, on
the CPU: complex64 and complex128 values through the grid and flat
engines, SA and classical AMG, the cycles and their smoothers, the Krylov
solves, certified refinement from complex64 (a complex128 outer
residual), hybrid Kaczmarz, the Schwarz tier, the façade and `convert.py`.

The workload is a heterogeneous shifted-Laplacian Helmholtz operator,
A = L - (1 - 0.5i) diag(k^2) with k = (kh / h) / c, c =
exp(0.2 randn) (scripts/complex_reference.py), and a complex-shifted
rough DivSigGrad for the AMG setups.  Host products are compared bit for
bit, single applies within 1e-12 and cycles and sweeps within 1e-9 in
complex128; counts equal mgtpu's."""

import importlib.util
import os
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import mgtpu
from mgtpu.cycle.cycle import recursive_cycle as cycle_ref
from mgtpu.cycle.grid_cycle import (grid_prolong as prolong_ref,
                                    grid_restrict as restrict_ref)
from mgtpu.cycle.kaczmarz import (kaczmarz_sweep as sweep_ref,
                                  setup_hybrid_kaczmarz as kz_ref)
from mgtpu.dd.indices import nodal_indices_of_box as box_ref
from mgtpu.dd.schwarz import DDSolver as DDRef
from mgtpu.ops.dia import dia_from_scipy as dia_ref
from mgtpu.ops.ell import ell_from_scipy as ell_ref
from mgtpu.ops.grid_stencil import (grid_stencil_from_csr as gs_ref,
                                    stride2_transfer_from_scipy as s2_ref)
from mgtpu.setup import smoothers as sm_ref

import mgtpu_torch as mt
from mgtpu_torch.config import torch_dtype
from mgtpu_torch.cycle.grid_cycle import (grid_cycle, grid_fmg, grid_prolong,
                                          grid_restrict)
from mgtpu_torch.cycle.kaczmarz import kaczmarz_sweep, setup_hybrid_kaczmarz
from mgtpu_torch.dd.indices import nodal_indices_of_box
from mgtpu_torch.dd.schwarz import DDSolver
from mgtpu_torch.ops.cuda import kaczmarz as kf
from mgtpu_torch.ops.cuda import stencil as sk
from mgtpu_torch.ops.dia import dia_from_scipy
from mgtpu_torch.ops.ell import ell_from_scipy
from mgtpu_torch.ops.grid_stencil import (grid_stencil_from_csr,
                                          stride2_transfer_from_scipy)
from mgtpu_torch.setup import smoothers as sm

_SPEC = importlib.util.spec_from_file_location(
    "complex_reference", os.path.join(os.path.dirname(__file__), "..",
                                      "scripts", "complex_reference.py"))
ref_script = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(ref_script)

DTYPES = [np.complex64, np.complex128]


def _np(t):
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _rel(a, b):
    a = _np(a).astype(np.complex128)
    b = _np(b).astype(np.complex128)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _same(A, B):
    A, B = sp.csr_matrix(A), sp.csr_matrix(B)
    return (A.shape == B.shape and A.dtype == B.dtype
            and (A != B).nnz == 0)


def _meshes(dims):
    dom = [0.0, 1.0] * len(dims)
    return mgtpu.get_regular_mesh(dom, dims), mt.get_regular_mesh(dom, dims)


def _helmholtz(dims, kh=0.125):
    return ref_script.helmholtz(list(dims), kh)


def _zdivsig(n):
    return ref_script.shifted_divsig([n, n])


def _rhs(n, m=2, seed=4):
    rng = np.random.RandomState(seed)
    return rng.rand(n, m) + 1j * rng.rand(n, m)


def _states(A, dims, dtype, fields=None, **kw):
    """mgtpu's and the port's mg_setup of A; `fields` replaces MGConfig
    fields that get_mg_param does not take."""
    M, Mp = _meshes(dims)
    kw = dict(levels=3, relax_type="jacobi", relax_param=0.8, nu_pre=1,
              nu_post=1, dtype=dtype) | kw
    (cfg_r, rp), (cfg_p, _) = mgtpu.get_mg_param(**kw), mt.get_mg_param(**kw)
    if fields:
        cfg_r, cfg_p = replace(cfg_r, **fields), replace(cfg_p, **fields)
    st_r = mgtpu.mg_setup(A, M, cfg_r, rp)
    st_p = mt.mg_setup(A, Mp, cfg_p, rp, device="cpu")
    return st_r, st_p


def _amg_states(kind, dtype, n=32, **kw):
    A = _zdivsig(n)
    kw = dict(levels=3, relax_type="spai", dtype=dtype) | kw
    if kind == "sa-grid":
        M, Mp = _meshes([n, n])
        return A, (mgtpu.sa_amg_setup(A, mgtpu.get_mg_param(**kw)[0], 1.0,
                                      mesh=M),
                   mt.sa_amg_setup(A, mt.get_mg_param(**kw)[0], 1.0,
                                   mesh=Mp, device="cpu"))
    ref_fn, port_fn = {"sa": (mgtpu.sa_amg_setup, mt.sa_amg_setup),
                       "classical": (mgtpu.classical_amg_setup,
                                     mt.classical_amg_setup)}[kind]
    return A, (ref_fn(A, mgtpu.get_mg_param(**kw)[0], 1.0),
               port_fn(A, mt.get_mg_param(**kw)[0], 1.0, device="cpu"))


# ---------------------------------------------------------------------------
# host products, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dims", [[32, 32], [16, 16, 16]])
def test_grid_host_products_bitwise(dims, dtype):
    """The level operators, the stencil coefficients of every level, the
    Jacobi diagonals, the transfer factors and the coarsest inverse (made
    in complex128 on the host, then cast) equal mgtpu's."""
    A = _helmholtz(dims)
    st_r, st_p = _states(A, dims, dtype)
    assert type(st_p.hier).__name__ == "GridHierarchy"
    for a_r, a_p in zip(st_r.As, st_p.As):
        assert _same(a_r, a_p) and a_p.dtype == np.dtype(dtype)
    for lr, lp in zip(st_r.hier.levels, st_p.hier.levels):
        assert type(lp.A).__name__ == type(lr.A).__name__ == "GridStencil"
        assert lp.A.offsets == lr.A.offsets
        assert np.array_equal(_np(lp.A.coeff), np.asarray(lr.A.coeff))
        assert _np(lp.A.coeff).dtype == np.dtype(dtype)
        if lr.d is not None:
            assert np.array_equal(_np(lp.d), np.asarray(lr.d))
            for pr, pp in zip(lr.P1, lp.P1):
                assert np.array_equal(_np(pp), np.asarray(pr))
    inv_p, inv_r = _np(st_p.hier.coarse.inv), np.asarray(st_r.hier.coarse.inv)
    assert inv_p.dtype == np.dtype(dtype) and np.array_equal(inv_p, inv_r)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("relax", ["jacobi", "spai", "chebyshev"])
def test_smoother_states_bitwise(relax, dtype):
    """Jacobi, SPAI (omega conj(a_ii) / ||A e_i||^2, the COLUMN norms) and
    Chebyshev states of a complex operator equal mgtpu's."""
    A = _helmholtz([16, 16]).astype(dtype)
    fn = {"jacobi": "jacobi_prec", "spai": "spai_prec",
          "chebyshev": "chebyshev_prec"}[relax]
    r = getattr(sm_ref, fn)(A, 0.8, dtype=dtype)
    p = getattr(sm, fn)(A, 0.8, dtype=dtype)
    assert np.asarray(p.d).dtype == np.dtype(dtype)
    assert np.array_equal(np.asarray(p.d), np.asarray(r.d))
    if relax == "chebyshev":
        assert p.lam_max == r.lam_max
    if relax == "spai":
        # the column norms, not the row norms: A^T != A^H here
        col = np.asarray(A.multiply(A.conj()).sum(axis=0)).ravel().real
        want = 0.8 * np.conj(A.diagonal()) / col
        assert np.array_equal(np.asarray(p.d), want.astype(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["sa", "sa-grid", "classical"])
def test_amg_host_products_bitwise(kind, dtype):
    """SA (greedy and structured) and classical AMG: every level's A, P
    and R = P^H equal mgtpu's, and so do the operator complexity and the
    engine."""
    _, (st_r, st_p) = _amg_states(kind, dtype)
    assert type(st_p.hier).__name__ == type(st_r.hier).__name__
    assert st_p.num_levels == st_r.num_levels >= 2
    for a_r, a_p in zip(st_r.As, st_p.As):
        assert _same(a_r, a_p)
    for l in range(st_r.num_levels - 1):
        assert _same(st_r.Ps[l], st_p.Ps[l])
        assert _same(st_r.Rs[l], st_p.Rs[l])
        assert _same(st_p.Rs[l], st_p.Ps[l].conj().T)
    assert st_p.operator_complexity() == st_r.operator_complexity()


@pytest.mark.parametrize("dtype", DTYPES)
def test_transposed_hierarchy_bitwise(dtype):
    """transpose_hierarchy conjugate-transposes every level and swaps P
    and R, as mgtpu's does; the cycle on it solves A^H."""
    A = _helmholtz([32, 32])
    st_r, st_p = _states(A, [32, 32], dtype)
    mgtpu.transpose_hierarchy(st_r)
    mt.transpose_hierarchy(st_p)
    for name in ("As", "Ps", "Rs"):
        for a_r, a_p in zip(getattr(st_r, name), getattr(st_p, name)):
            assert _same(a_r, a_p)
    assert _same(st_p.A_input, A.conj().T)
    assert _same(st_p.As[0], A.astype(dtype).conj().T)
    b = _rhs(A.shape[0])
    x, info = mt.solve_mg_refined(st_p, b[:, 0], tol=1e-9, max_iter=60)
    xr, ir = mgtpu.solve_mg_refined(st_r, b[:, 0], tol=1e-9, max_iter=60)
    assert info["iters"] == ir["iters"]
    assert np.linalg.norm(A.conj().T @ x.numpy() - b[:, 0]) \
        < 1e-9 * np.linalg.norm(b[:, 0])


# ---------------------------------------------------------------------------
# single applies, complex128 within 1e-12
# ---------------------------------------------------------------------------

def _stride2_pair():
    return _amg_states("sa-grid", np.complex128, levels=2)[1]


@pytest.mark.parametrize("form", ["apply", "apply-3d", "restrict", "prolong",
                                  "dia", "ell", "stride2-prolong",
                                  "stride2-restrict"])
def test_applies_match_reference(form):
    """One apply of each form on complex128 fields against mgtpu's."""
    rng = np.random.RandomState(7)
    if form in ("apply", "apply-3d"):
        dims = [32, 32] if form == "apply" else [12, 12, 12]
        A = _helmholtz(dims)
        nodes = [d + 1 for d in dims]
        g_r, g_p = gs_ref(A, nodes), grid_stencil_from_csr(A, nodes)
        x = rng.rand(2, *g_p.grid) + 1j * rng.rand(2, *g_p.grid)
        y_r = g_r.matvec(jnp.asarray(x))
        y_p = g_p.to("cpu").matvec(torch.from_numpy(x))
        assert _rel(y_p, y_r) < 1e-12
        assert _rel(grid_stencil_from_csr(A, nodes).to("cpu").matvec(
            torch.from_numpy(x.reshape(2, -1).T.copy())),
            A @ x.reshape(2, -1).T) < 1e-12
        return
    if form in ("restrict", "prolong"):
        A = _helmholtz([32, 32])
        st_r, st_p = _states(A, [32, 32], np.complex128)
        P_r, P_p = st_r.hier.levels[0].P1, st_p.hier.levels[0].P1
        fine, coarse = st_p.hier.levels[0].A.grid, st_p.hier.levels[1].A.grid
        shape = fine if form == "restrict" else coarse
        v = rng.rand(2, *shape) + 1j * rng.rand(2, *shape)
        fr, fp = ((restrict_ref, grid_restrict) if form == "restrict"
                  else (prolong_ref, grid_prolong))
        assert _rel(fp(torch.from_numpy(v), P_p),
                    fr(jnp.asarray(v), P_r)) < 1e-12
        return
    if form in ("dia", "ell"):
        A = _zdivsig(24)
        x = rng.rand(A.shape[0], 3) + 1j * rng.rand(A.shape[0], 3)
        mr = (dia_ref(A) if form == "dia" else ell_ref(A))
        mp = (dia_from_scipy(A) if form == "dia" else ell_from_scipy(A))
        assert _rel(mp.matvec(torch.from_numpy(x)),
                    mr.matvec(jnp.asarray(x))) < 1e-12
        assert _rel(mp.matvec(torch.from_numpy(x)), A @ x) < 1e-12
        return
    st_r, st_p = _stride2_pair()
    P = st_p.Ps[0]
    fine = tuple(st_p.hier.levels[0].A.grid)
    coarse = tuple(st_p.hier.levels[0].P1.coarse_grid)
    T_r = s2_ref(P, list(reversed(fine)), list(reversed(coarse)))
    T_p = stride2_transfer_from_scipy(P, list(reversed(fine)),
                                      list(reversed(coarse)))
    if form == "stride2-prolong":
        v = rng.rand(2, *coarse) + 1j * rng.rand(2, *coarse)
        y_p, y_r = T_p.prolong(torch.from_numpy(v)), T_r.prolong(
            jnp.asarray(v))
        assert _rel(y_p.reshape(2, -1).T, P @ v.reshape(2, -1).T) < 1e-12
    else:
        v = rng.rand(2, *fine) + 1j * rng.rand(2, *fine)
        y_p, y_r = T_p.restrict(torch.from_numpy(v)), T_r.restrict(
            jnp.asarray(v))
        assert _rel(y_p.reshape(2, -1).T,
                    P.conj().T @ v.reshape(2, -1).T) < 1e-12
    assert _rel(y_p, y_r) < 1e-12


@pytest.mark.parametrize("kind", ["stride2", "full-weighting"])
def test_plain_restrict_is_the_adjoint_of_prolong(kind):
    """<R r, x> = <r, P x> for the plain versions in complex128: R = P^H
    for the stride-2 transfers (their restriction table conjugated at
    packing), 0.5^d P^T = 0.5^d P^H for the real full-weighting
    factors."""
    rng = np.random.RandomState(3)
    if kind == "stride2":
        _, st_p = _stride2_pair()
        T = st_p.hier.levels[0].P1
        r = torch.from_numpy(rng.rand(*T.fine_grid)
                             + 1j * rng.rand(*T.fine_grid))
        x = torch.from_numpy(rng.rand(*T.coarse_grid)
                             + 1j * rng.rand(*T.coarse_grid))
        Rr, Px, scale = (sk.stride2_restrict_plain(T, r[None])[0],
                         sk.stride2_prolong_plain(T, x[None])[0], 1.0)
    else:
        A = _helmholtz([32, 32])
        _, st_p = _states(A, [32, 32], np.complex128)
        P1 = st_p.hier.levels[0].P1
        fine, coarse = (st_p.hier.levels[0].A.grid,
                        st_p.hier.levels[1].A.grid)
        r = torch.from_numpy(rng.rand(*fine) + 1j * rng.rand(*fine))
        x = torch.from_numpy(rng.rand(*coarse) + 1j * rng.rand(*coarse))
        Rr, Px, scale = (grid_restrict(r[None], P1)[0],
                         grid_prolong(x[None], P1)[0], 0.25)
    lhs = torch.vdot(Rr.flatten(), x.flatten())
    rhs = scale * torch.vdot(r.flatten(), Px.flatten())
    assert abs(complex(lhs - rhs)) < 1e-12 * abs(complex(rhs))


# ---------------------------------------------------------------------------
# cycles and sweeps, complex128 within 1e-9
# ---------------------------------------------------------------------------

CYCLES = {
    "grid-jacobi-V": ("grid", dict()),
    "grid-jacobi-W": ("grid", dict(cycle_type="W")),
    "grid-spai-3d": ("grid", dict(relax_type="spai", relax_param=1.0)),
    "grid-chebyshev": ("grid", dict(relax_type="chebyshev", nu_post=0)),
    "grid-K": ("grid", dict(relax_type="jac-gmres", relax_param=1.0,
                            cycle_type="K")),
    "flat-jacobi-V": ("flat", dict()),
    "flat-K": ("flat", dict(relax_type="jac-gmres", relax_param=1.0,
                            cycle_type="K")),
    # 4 FGMRES steps on the 81-dof coarsest: more leave the projection
    # ill-determined, in f64 as in complex128 (ROADMAP queue 3, PR 6)
    "flat-gmres-coarse": ("flat", dict(coarse_solve="gmres",
                                       fields=dict(gmres_coarse_inner=4))),
}


@pytest.mark.parametrize("name", sorted(CYCLES))
def test_cycles_match_reference(name):
    """One cycle (from zero and from a non-zero iterate) of the grid and
    flat engines, complex128, 2 right-hand sides, against mgtpu's."""
    engine, kw = CYCLES[name]
    dims = [12, 12, 12] if name.endswith("3d") else [32, 32]
    A = _helmholtz(dims)
    st_r, st_p = _states(A, dims, np.complex128, engine=engine, **kw)
    assert type(st_p.hier).__name__ == type(st_r.hier).__name__ == (
        "GridHierarchy" if engine == "grid" else "Hierarchy")
    b = _rhs(A.shape[0])
    x0 = np.zeros_like(b)
    for xz in (True, False):
        y_r = cycle_ref(st_r.config, st_r.hier, jnp.asarray(b),
                        jnp.asarray(x0), x_zero=xz)
        y_p = mt.recursive_cycle(st_p.config, st_p.hier, torch.from_numpy(b),
                                 torch.from_numpy(x0), x_zero=xz)
        assert _rel(y_p, y_r) < 1e-9, (name, xz)
        x0 = np.asarray(y_r)


@pytest.mark.parametrize("kind", ["sa", "sa-grid", "classical"])
def test_amg_cycles_match_reference(kind):
    """One SA (flat and structured) and classical cycle, complex128."""
    A, (st_r, st_p) = _amg_states(kind, np.complex128)
    b = _rhs(A.shape[0], seed=6)
    y_r = cycle_ref(st_r.config, st_r.hier, jnp.asarray(b),
                    jnp.zeros_like(jnp.asarray(b)))
    y_p = mt.recursive_cycle(st_p.config, st_p.hier, torch.from_numpy(b),
                             torch.zeros(b.shape, dtype=torch.complex128))
    assert _rel(y_p, y_r) < 1e-9


@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("dtype", DTYPES)
def test_kaczmarz_sweep_matches_reference(dtype, m):
    """Two hybrid Kaczmarz sweeps ([4, 4] nodal boxes, omega 0.8) on a
    complex Helmholtz operator: the tables equal mgtpu's (row norms real),
    the sweep within 1e-9 (complex128) or 1e-5 (complex64)."""
    A = _helmholtz([16, 16], 0.25)
    M, Mp = _meshes([16, 16])
    r = kz_ref(A, M, [4, 4], box_ref, 0.8, 2, dtype=dtype)
    p = setup_hybrid_kaczmarz(A, Mp, [4, 4], nodal_indices_of_box, 0.8, 2,
                              dtype=dtype)
    for k in ("arr", "mask", "invd", "ell_idx", "ell_val"):
        assert np.array_equal(np.asarray(getattr(p, k)),
                              np.asarray(getattr(r, k))), k
    assert np.asarray(p.invd).dtype == np.dtype(dtype).type(0).real.dtype
    tdt = torch_dtype(dtype)
    pd = p.to(tdt, "cpu")
    assert pd.mask.dtype == pd.invd.dtype == tdt.to_real()
    b = _rhs(A.shape[0], m).astype(dtype)
    x0 = _rhs(A.shape[0], m, seed=5).astype(dtype)
    y_r = sweep_ref(jnp.asarray(x0), jnp.asarray(b), r)
    before = kf.PLAIN_CALLS[str(tdt).split(".")[-1]]
    y_p = kaczmarz_sweep(torch.from_numpy(x0), torch.from_numpy(b), pd)
    assert kf.PLAIN_CALLS[str(tdt).split(".")[-1]] == before + 1
    assert _rel(y_p, y_r) < (1e-9 if dtype == np.complex128 else 1e-5)


# ---------------------------------------------------------------------------
# solves: the contract rows at a small size, refinement, Krylov, FMG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("row", ref_script.ROWS)
def test_contract_rows_match_reference(row):
    """Each contract row of scripts/complex_reference.py at 64^2 / 16^3
    (three levels): the port takes mgtpu's count."""
    assert (ref_script.row(row, 64, 16, "port")
            == ref_script.row(row, 64, 16, "mgtpu"))


def test_complex_shifted_laplacian_replayed():
    """mgtpu's test_grid_engine_complex_shifted_laplacian on the port: the
    grid engine equals the flat one within 1e-9, solve_mg converges, and
    refinement from a complex64 hierarchy reaches 1e-10."""
    Mp = mt.get_regular_mesh([0.0, 1.0, 0.0, 1.0], [32, 32])
    from mgtpu_torch.models.operators import nodal_laplacian_matrix
    L = nodal_laplacian_matrix(Mp).astype(np.complex128)
    n = L.shape[0]
    L = (L + (0.05 + 0.05j) * abs(L).sum(axis=0).max()
         * sp.identity(n)).tocsr()
    mk = lambda engine: mt.get_mg_param(levels=3, relax_type="jacobi",
                                        relax_param=0.8, nu_pre=1, nu_post=1,
                                        max_outer_iter=25,
                                        relative_tol=1e-9,
                                        dtype=np.complex128, engine=engine)
    cfg_g, rp = mk("grid")
    cfg_f, _ = mk("flat")
    st_g = mt.mg_setup(L, Mp, cfg_g, rp, device="cpu")
    st_f = mt.mg_setup(L, Mp, cfg_f, rp, device="cpu")
    assert type(st_g.hier).__name__ == "GridHierarchy"
    b = np.random.rand(n, 2) + 1j * np.random.rand(n, 2)
    bt = torch.from_numpy(b)
    xg = mt.recursive_cycle(cfg_g, st_g.hier, bt, torch.zeros_like(bt))
    xf = mt.recursive_cycle(cfg_f, st_f.hier, bt, torch.zeros_like(bt))
    assert _rel(xg, xf) < 1e-9
    x, info = mt.solve_mg(st_g, b)
    assert info["relres"] < 1e-9
    cfg_c, rp_c = mt.get_mg_param(levels=3, relax_type="jacobi",
                                  relax_param=0.8, nu_pre=1, nu_post=1,
                                  max_outer_iter=40, dtype=np.complex64)
    st_c = mt.mg_setup(L, Mp, cfg_c, rp_c, device="cpu")
    assert type(st_c.hier).__name__ == "GridHierarchy"
    xr, rinfo = mt.solve_mg_refined(st_c, b[:, 0], tol=1e-10)
    assert xr.dtype == torch.complex128
    assert rinfo["relres"] < 1e-10
    assert np.linalg.norm(L @ xr.numpy() - b[:, 0]) < 1e-8


@pytest.mark.parametrize("engine", ["grid", "flat"])
def test_refined_device_loop_is_the_eager_loop(engine):
    """The recorded refined solve (device loop, real norms and tol beside
    complex state) is the eager loop bit for bit: count, history, x."""
    A = _helmholtz([32, 32])
    _, st_p = _states(A, [32, 32], np.complex64, engine=engine)
    b = ref_script.rhs(A)
    x1, i1 = mt.solve_mg_refined(st_p, b, tol=1e-8, max_iter=60)
    x0, i0 = mt.solve_mg_refined(st_p, b, tol=1e-8, max_iter=60,
                                 device_loop=False)
    assert i1["iters"] == i0["iters"] and i1["relres"] < 1e-8
    assert np.array_equal(i1["resvec"], i0["resvec"])
    assert i1["resvec"].dtype == np.float64
    assert torch.equal(x1, x0) and x1.dtype == torch.complex128


@pytest.mark.parametrize("method", ["bicgstab", "gmres", "cg"])
def test_krylov_solves_match_reference(method):
    """MG-preconditioned BiCGSTAB, FGMRES and CG (complex64 hierarchy,
    complex128 b and outer): mgtpu's count, the device loop equal to the
    eager loop bit for bit.  CG on a complex symmetric (non-Hermitian)
    operator is mgtpu's conjugated recurrence too."""
    A = _helmholtz([32, 32])
    st_r, st_p = _states(A, [32, 32], np.complex64, max_outer_iter=60,
                         relative_tol=1e-8)
    b = ref_script.rhs(A)
    fn = {"bicgstab": "solve_bicgstab_mg", "gmres": "solve_gmres_mg",
          "cg": "solve_cg_mg"}[method]
    x1, i1 = getattr(mt, fn)(st_p, b)
    x0, i0 = getattr(mt, fn)(st_p, b, device_loop=False)
    xr, ir = getattr(mgtpu, fn)(st_r, b)
    assert int(i1["iters"]) == int(i0["iters"]) == int(ir["iters"])
    assert torch.equal(x1, x0) and x1.dtype == torch.complex128
    if method != "cg":
        assert np.linalg.norm(b - A @ x1.numpy()) < 1e-8


def test_mg_preconditioner_outer_dtype():
    """get_mg_preconditioner(outer_dtype=complex128) on a complex64
    hierarchy: a complex128 correction equal to mgtpu's within the
    complex64 cycle's rounding."""
    A = _helmholtz([32, 32])
    st_r, st_p = _states(A, [32, 32], np.complex64)
    r = _rhs(A.shape[0])
    z_p = mt.get_mg_preconditioner(st_p, outer_dtype=np.complex128)(
        torch.from_numpy(r))
    z_r = mgtpu.get_mg_preconditioner(st_r, outer_dtype=np.complex128)(
        jnp.asarray(r))
    assert z_p.dtype == torch.complex128
    assert _rel(z_p, z_r) < 1e-5


def test_solve_mg_jit_matches_reference():
    """A fixed count of complex128 cycles as one program against mgtpu's
    solve_mg_jit, within 1e-9."""
    A = _helmholtz([32, 32])
    st_r, st_p = _states(A, [32, 32], np.complex128)
    b = _rhs(A.shape[0])
    want = np.asarray(mgtpu.solve_mg_jit(st_r, b, num_cycles=3))
    got = mt.solve_mg_jit(st_p, b, num_cycles=3)
    assert _rel(got, want) < 1e-9


def test_fmg_on_complex_grid_hierarchy():
    """fmg=True on a complex grid hierarchy certifies and takes no more
    iterations than a start from zero (mgtpu drops fmg outside its real
    df32 path, ROADMAP F6, so there is no count of its to hold to)."""
    A = _helmholtz([64, 64])
    _, st_p = _states(A, [64, 64], np.complex64)
    b = ref_script.rhs(A)
    x0, i0 = mt.solve_mg_refined(st_p, b, tol=1e-8, max_iter=60)
    x1, i1 = mt.solve_mg_refined(st_p, b, tol=1e-8, max_iter=60, fmg=True)
    assert i1["relres"] < 1e-8 and i1["iters"] <= i0["iters"]
    assert np.linalg.norm(b - A @ x1.numpy()) < 1e-8 * np.linalg.norm(b)


def test_large_coarsest_dense_inverse_on_the_device(monkeypatch):
    """A coarsest above the host inverse's size is inverted on the state's
    device in the hierarchy's complex type (mgtpu builds it in cfg.dtype
    too); its cycle equals mgtpu's within 1e-9 in complex128."""
    import mgtpu.cycle.grid_cycle as gc_ref
    from mgtpu_torch.cycle import grid_cycle as gc
    monkeypatch.setattr(gc_ref, "_HOST_INV_MAX", 100)
    monkeypatch.setattr(gc, "HOST_INV_MAX", 100)
    A = _helmholtz([32, 32])
    st_r, st_p = _states(A, [32, 32], np.complex128, levels=2)
    assert _np(st_p.hier.coarse.inv).dtype == np.complex128
    assert _rel(st_p.hier.coarse.inv, st_r.hier.coarse.inv) < 1e-9
    b = _rhs(A.shape[0])
    y_r = cycle_ref(st_r.config, st_r.hier, jnp.asarray(b),
                    jnp.zeros_like(jnp.asarray(b)))
    y_p = mt.recursive_cycle(st_p.config, st_p.hier, torch.from_numpy(b),
                             torch.zeros(b.shape, dtype=torch.complex128))
    assert _rel(y_p, y_r) < 1e-9


@pytest.mark.parametrize("engine", ["grid", "flat"])
def test_sparse_lu_coarsest_is_complex(engine, monkeypatch):
    """A coarsest above the dense budget takes host SuperLU in complex128
    (mgtpu's splu type for a complex operator); the cycle equals mgtpu's
    within 1e-9."""
    import mgtpu.cycle.grid_cycle as gc_ref
    from mgtpu_torch.cycle import grid_cycle as gc
    for mod, name in ((gc_ref, "_DENSE_LU_MAX"), (gc, "DENSE_LU_MAX"),
                      (gc_ref, "_HOST_INV_MAX"), (gc, "HOST_INV_MAX")):
        monkeypatch.setattr(mod, name, 100)
    A = _helmholtz([32, 32])
    st_r, st_p = _states(A, [32, 32], np.complex128, levels=2,
                         engine=engine)
    assert "Sparse" in type(st_p.hier.coarse).__name__
    assert st_p.hier.coarse.factor.U.dtype == np.complex128
    b = _rhs(A.shape[0])
    y_r = cycle_ref(st_r.config, st_r.hier, jnp.asarray(b),
                    jnp.zeros_like(jnp.asarray(b)))
    y_p = mt.recursive_cycle(st_p.config, st_p.hier, torch.from_numpy(b),
                             torch.zeros(b.shape, dtype=torch.complex128))
    assert _rel(y_p, y_r) < 1e-9


# ---------------------------------------------------------------------------
# the façade, the Schwarz tier, the direct coarsest
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["MGSolver", "SAAMGSolver",
                                   "ClassicalAMGSolver"])
def test_wrappers_take_complex_operators(which):
    """The façade on a complex operator, BiCGSTAB, as mgtpu takes it: the
    same count, and the adjoint solve of a non-symmetric MGSolver."""
    A = _helmholtz([32, 32]) if which == "MGSolver" else _zdivsig(32)
    B = _rhs(A.shape[0]) / 40.0
    kw = dict(levels=3, relax_type="spai", dtype=np.complex64,
              relative_tol=1e-8, max_outer_iter=60)
    M, Mp = _meshes([32, 32])
    mesh = {"MGSolver": (M, Mp)}.get(which, (None, None))
    s_r = getattr(mgtpu, which)(mgtpu.get_mg_param(**kw)[0], 1.0,
                                mesh=mesh[0], krylov="bicgstab", sym=0)
    s_p = getattr(mt, which)(mt.get_mg_param(**kw)[0], 1.0, mesh=mesh[1],
                             krylov="bicgstab", sym=0, device="cpu")
    X_r = s_r.solve_linear_system(A, B)
    X_p = s_p.solve_linear_system(A, B)
    assert s_p.n_iter == s_r.n_iter
    assert np.all(np.linalg.norm(B - A @ X_p.numpy(), axis=0)
                  < 1e-7 * np.linalg.norm(B, axis=0))
    if which == "MGSolver":
        Xt = s_p.solve_linear_system(A, B, transpose=True)
        Xtr = s_r.solve_linear_system(A, B, transpose=True)
        assert s_p.n_iter == s_r.n_iter
        assert np.all(np.linalg.norm(B - A.conj().T @ Xt.numpy(), axis=0)
                      < 1e-7 * np.linalg.norm(B, axis=0))
        assert _rel(Xt, Xtr) < 1e-5


def test_dd_solver_complex():
    """DDSolver(dtype=complex128) on a complex Helmholtz operator: the
    Schwarz state equals mgtpu's, and its FGMRES takes mgtpu's count."""
    A = _helmholtz([32, 32], 0.25)
    M, Mp = _meshes([32, 32])
    r = DDRef(M, [4, 4], [2, 2], layout="nodal", dtype=np.complex128)
    p = DDSolver(Mp, [4, 4], [2, 2], layout="nodal", dtype=np.complex128,
                 device="cpu")
    r.setup(A)
    p.setup(A)
    for k in ("idx", "mask", "rows_idx", "rows_val"):
        assert np.array_equal(_np(getattr(p.state, k)),
                              np.asarray(getattr(r.state, k))), k
    b = ref_script.rhs(A)
    x_p, i_p = p.solve_linear_system(A, b, tol=1e-8, max_iter=60)
    x_r, i_r = r.solve_linear_system(A, b, tol=1e-8, max_iter=60)
    assert i_p["iters"] == i_r["iters"]
    assert np.linalg.norm(b - A @ x_p.numpy()) < 1e-7


def test_direct_coarsest_complex():
    """coarse_solver=DirectSolver("dense") (the flat engine's external
    coarsest) on a complex hierarchy: the refined count equals mgtpu's."""
    A = _helmholtz([32, 32])
    M, Mp = _meshes([32, 32])
    kw = dict(levels=3, relax_type="jacobi", relax_param=0.8, nu_pre=1,
              nu_post=1, dtype=np.complex64)
    st_r = mgtpu.mg_setup(A, M, *mgtpu.get_mg_param(**kw),
                          coarse_solver=mgtpu.DirectSolver("dense"))
    st_p = mt.mg_setup(A, Mp, *mt.get_mg_param(**kw),
                       coarse_solver=mt.DirectSolver("dense"), device="cpu")
    b = ref_script.rhs(A)
    x_p, i_p = mt.solve_mg_refined(st_p, b, tol=1e-8, max_iter=60)
    _, i_r = mgtpu.solve_mg_refined(st_r, b, tol=1e-8, max_iter=60)
    assert i_p["iters"] == i_r["iters"] and i_p["relres"] < 1e-8


# ---------------------------------------------------------------------------
# convert.py: mgtpu's complex states carried across
# ---------------------------------------------------------------------------

def _grid_arrays(gh):
    """An mgtpu GridHierarchy (variable stencils; per-axis factors or
    stride-2 transfers) as convert.grid_hierarchy_from_arrays' arguments."""
    levels = []
    for lv in gh.levels:
        if lv.A is None:
            levels.append(dict(offsets=None))
            continue
        T = lv.P1
        if T is not None and hasattr(T, "coeff"):
            P1 = dict(coeff=np.asarray(T.coeff), offsets=T.offsets,
                      fine_grid=T.fine_grid, coarse_grid=T.coarse_grid)
        else:
            P1 = None if T is None else [np.asarray(p) for p in T]
        levels.append(dict(coeff=np.asarray(lv.A.coeff),
                           offsets=lv.A.offsets, grid=lv.A.grid,
                           d=None if lv.d is None else np.asarray(lv.d),
                           P1=P1, lam=lv.lam))
    return levels, np.asarray(gh.coarse.inv), gh.coarse.grid


def _flat_arrays(h):
    def mat(E):
        if hasattr(E, "indices"):
            return dict(indices=np.asarray(E.indices),
                        values=np.asarray(E.values), shape=E.shape)
        return dict(data=np.asarray(E.data), offsets=E.offsets,
                    shape=E.shape)
    levels = []
    for lv in h.levels:
        spec = dict(A=mat(lv.A), P=None if lv.P is None else mat(lv.P),
                    R=None if lv.R is None else mat(lv.R))
        if lv.relax is not None and hasattr(lv.relax, "arr"):
            spec["kaczmarz"] = {k: np.asarray(getattr(lv.relax, k)) for k in
                                ("arr", "mask", "invd", "ell_idx",
                                 "ell_val")} | dict(
                num_domains=lv.relax.num_domains, num_it=lv.relax.num_it,
                omega=lv.relax.omega)
        elif lv.relax is not None:
            spec["d"] = np.asarray(lv.relax.d)
        levels.append(spec)
    return levels, dict(lu=np.asarray(h.coarse.lu),
                        piv=np.asarray(h.coarse.piv))


@pytest.mark.parametrize("kind", ["grid", "sa-grid", "flat-sa", "kaczmarz",
                                  "schwarz"])
def test_convert_carries_complex_states(kind):
    """mgtpu's complex hierarchies as plain arrays — grid stencils, dense
    inverses, stride-2 transfers, DIA and ELL values, SPAI diagonals,
    DenseLU factors, Kaczmarz and Schwarz states — run the port's cycle
    (or sweep) to within 1e-9 of mgtpu's, complex128."""
    from mgtpu_torch import convert
    if kind == "schwarz":
        A = _helmholtz([16, 16], 0.25)
        M, _ = _meshes([16, 16])
        r = DDRef(M, [2, 2], [1, 1], layout="nodal", dtype=np.complex128)
        r.setup(A)
        st = convert.schwarz_state_from_arrays(
            {k: np.asarray(getattr(r.state, k)) for k in
             ("idx", "mask", "rows_idx", "rows_val", "lu", "piv")}
            | {"colors": r.state.colors}, "cpu")
        from mgtpu.dd.schwarz import schwarz_sweep as sw_ref
        from mgtpu_torch.dd.schwarz import schwarz_sweep
        b = _rhs(A.shape[0])
        y_r = sw_ref(r.state, jnp.zeros_like(jnp.asarray(b)),
                     jnp.asarray(b), 2)
        y_p = schwarz_sweep(st, torch.zeros(b.shape, dtype=torch.complex128),
                            torch.from_numpy(b), 2)
        assert _rel(y_p, y_r) < 1e-9
        return
    if kind in ("grid", "sa-grid"):
        if kind == "grid":
            A = _helmholtz([32, 32])
            st_r, st_p = _states(A, [32, 32], np.complex128)
        else:
            A, (st_r, st_p) = _amg_states("sa-grid", np.complex128)
        h = convert.grid_hierarchy_from_arrays(*_grid_arrays(st_r.hier),
                                               device="cpu")
        bg = _rhs(A.shape[0]).T.reshape((2,) + st_p.hier.fine_grid)
        y_r = mgtpu.cycle.grid_cycle.grid_cycle(
            st_r.config, st_r.hier, jnp.asarray(bg),
            jnp.zeros_like(jnp.asarray(bg)))
        y_p = grid_cycle(st_p.config, h, torch.from_numpy(bg),
                         torch.zeros(bg.shape, dtype=torch.complex128))
        assert _rel(y_p, y_r) < 1e-9
        return
    if kind == "flat-sa":
        A, (st_r, st_p) = _amg_states("sa", np.complex128)
        assert type(st_r.hier.levels[0].A).__name__ == "DIA"
    else:
        A = _helmholtz([16, 16], 0.25)
        M, Mp = _meshes([16, 16])
        kw = dict(levels=3, relax_type="hybridKaczmarzNodal", nu_pre=1,
                  nu_post=1, dtype=np.complex128)
        rp = {"num_domains": [4, 4], "omega": 0.8, "num_it": 2}
        st_r = mgtpu.mg_setup(A, M, mgtpu.get_mg_param(**kw)[0],
                              rp | {"index_fn": box_ref})
        st_p = mt.mg_setup(A, Mp, mt.get_mg_param(**kw)[0], rp,
                           device="cpu")
    h = convert.flat_hierarchy_from_arrays(*_flat_arrays(st_r.hier),
                                           device="cpu")
    b = _rhs(A.shape[0])
    y_r = cycle_ref(st_r.config, st_r.hier, jnp.asarray(b),
                    jnp.zeros_like(jnp.asarray(b)))
    y_p = mt.recursive_cycle(st_p.config, h, torch.from_numpy(b),
                             torch.zeros(b.shape, dtype=torch.complex128))
    assert _rel(y_p, y_r) < 1e-9


# ---------------------------------------------------------------------------
# the options ported after this file's first slice: complex line
# relaxation, semicoarsening, staggered systems, device aggregation, a lower
# cycle type (tests/test_torch_complex_rest.py holds them in full)
# ---------------------------------------------------------------------------

_REST = importlib.util.spec_from_file_location(
    "complex_rest_reference", os.path.join(
        os.path.dirname(__file__), "..", "scripts",
        "complex_rest_reference.py"))
rest_script = importlib.util.module_from_spec(_REST)
_REST.loader.exec_module(rest_script)


@pytest.mark.parametrize("kw,what", [
    (dict(relax_type="LineJac"), "complex line relaxation"),
    (dict(transfer_type="SemiCoarsening", relax_type="LineJac"),
     "complex semicoarsening"),
    (dict(transfer_type="SystemsFacesLinear", relax_type="SPAI"),
     "complex staggered systems"),
    (dict(relax_type="VankaFaces", transfer_type="SystemsFacesMixedLinear"),
     "complex staggered systems"),
])
def test_unported_complex_options_raise(kw, what):
    """The complex options that raised until they were ported (line
    relaxation, semicoarsening, staggered systems) set up and solve in
    complex64: the refined count equals mgtpu's, at a true complex128
    relres below 1e-8."""
    if "Systems" in kw.get("transfer_type", ""):
        A = rest_script.elasticity(16, "Mixed" in kw["transfer_type"])
    else:
        eps = 0.01 if "transfer_type" in kw else 100.0
        A = rest_script.shift(rest_script.aniso2d(16, eps), 0.125, 16)
    b = ref_script.rhs(A)
    out = []
    for pkg, dev in ((mgtpu, {}), (mt, {"device": "cpu"})):
        cfg, rp = pkg.get_mg_param(levels=3, dtype=np.complex64, nu_pre=1,
                                   nu_post=1, relax_param=0.75, **kw)
        st = pkg.mg_setup(A, pkg.get_regular_mesh([0.0, 1.0] * 2, [16, 16]),
                          cfg, rp, **dev)
        x, info = pkg.solve_mg_refined(st, b, tol=1e-8, max_iter=60)
        out.append((int(info["iters"]), ref_script.relres(A, b, x)))
    assert out[0][0] == out[1][0], (what, out)
    assert max(r for _, r in out) < 1e-8, (what, out)


def test_complex_cycle_dtype_and_device_aggregation_raise(monkeypatch):
    """What raised until it was ported: complex64 cycles below a
    complex128 hierarchy take mgtpu's refined count, and smoothed
    aggregation with MGTPU_AGG=device on a complex operator gives mgtpu's
    levels bit for bit.  (The raise that stays, a real cycle type for a
    complex hierarchy, has its own test in test_torch_complex_rest.py.)"""
    A = _helmholtz([16, 16])
    st_r, st_p = _states(A, [16, 16], np.complex128)
    b = ref_script.rhs(A)
    _, info_r = mgtpu.solve_mg_refined(st_r, b, cycle_dtype=np.complex64)
    x, info_p = mt.solve_mg_refined(st_p, b, cycle_dtype=torch.complex64)
    assert info_p["iters"] == info_r["iters"]
    assert ref_script.relres(A, b, x) < 1e-8
    monkeypatch.setenv("MGTPU_AGG", "device")
    kw = dict(levels=3, relax_type="spai", dtype=np.complex64)
    Z = _zdivsig(16)
    st_r = mgtpu.sa_amg_setup(Z, mgtpu.get_mg_param(**kw)[0], 1.0)
    st_p = mt.sa_amg_setup(Z, mt.get_mg_param(**kw)[0], 1.0, device="cpu")
    assert len(st_p.As) == len(st_r.As)
    assert all(_same(a, b) for a, b in zip(st_r.As, st_p.As))


def test_complex_values_take_kernel_d_plain_version_on_the_cpu():
    """On the CPU a complex cycle's applies take kernel D's counted plain
    versions, under their own type's count (on the card: the kernel,
    tests/test_torch_gpu.py)."""
    A = _helmholtz([16, 16])
    _, st_p = _states(A, [16, 16], np.complex64)
    b = torch.from_numpy(_rhs(A.shape[0]).astype(np.complex64))
    before = dict(sk.PLAIN_CALLS)
    mt.recursive_cycle(st_p.config, st_p.hier, b, torch.zeros_like(b))
    assert sk.PLAIN_CALLS["complex64"] > before["complex64"]
    assert sk.PLAIN_CALLS["float32"] == before["float32"]
    assert sk.supports_stencil(((0, 0),), (4, 4), torch.complex128)
    # the cross form takes complex values too (a complex staggered block)
    from mgtpu.ops.cross_stencil import cross_stencil_matvec as cross_ref
    coeff = (np.arange(40).reshape(2, 4, 5) * (1 - 0.5j)).astype(
        np.complex64)
    x = _rhs(24, 1).reshape(4, 6).astype(np.complex64)
    before = dict(sk.PLAIN_CALLS)
    y = sk.cross_apply(torch.from_numpy(coeff), ((0, 0), (0, 1)), (4, 6),
                       torch.from_numpy(x))
    assert sk.PLAIN_CALLS["complex64"] == before["complex64"] + 1
    want = np.asarray(cross_ref(jnp.asarray(coeff), ((0, 0), (0, 1)),
                                (4, 6), jnp.asarray(x)))
    assert _rel(y, want) < 2e-7
