"""Domain-decomposition parity of the PyTorch port (mgtpu_torch) with
mgtpu, on the CPU: the box index sets of every layout, the sub-meshes,
Dirichlet masses and colors bit for bit; the Schwarz state's index sets,
masks and gathered rows bit for bit; one Schwarz sweep and one hybrid
Kaczmarz sweep (kernel F's plain version, and kernel F's link-table
schedule emulated in numpy) within 1e-9 in float64; the Kaczmarz tables
bit for bit; one hybrid-Kaczmarz cycle; and the counts of mgtpu's own DD
and Kaczmarz tests (test_dd.py, test_coverage_extra.py:148); and the
multi-device Schwarz sweep (dd/parallel.py) on 2 and 4 CPU gloo ranks
equal to the serial sweep (test_dd.py:79), with mgtpu's ShardedSchwarz
carried across bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import mgtpu
from mgtpu.cycle import kaczmarz as kz_ref
from mgtpu.cycle.cycle import recursive_cycle as cycle_ref
from mgtpu.dd import indices as ddi_ref
from mgtpu.dd import schwarz as sw_ref
from mgtpu.models.operators import nodal_div_sig_grad_matrix as dsg_ref
from mgtpu.models.operators import nodal_laplacian_matrix as lap_ref
from mgtpu.models.operators import linear_elasticity_operator as el_ref
from mgtpu.ops.ell import ell_from_scipy as ell_ref

import _torch_ranks as tr
import mgtpu_torch as mt
from mgtpu.dd import parallel as par_ref
from mgtpu_torch.convert import (flat_hierarchy_from_arrays,
                                 kaczmarz_relax_from_arrays,
                                 schwarz_state_from_arrays,
                                 sharded_schwarz_from_arrays)
from mgtpu_torch.dd import parallel as par
from mgtpu_torch.parallel.launch import run_ranks
from mgtpu_torch.cycle import kaczmarz as kz
from mgtpu_torch.cycle.cycle import recursive_cycle as cycle_port
from mgtpu_torch.dd import indices as ddi
from mgtpu_torch.dd import schwarz as sw
from mgtpu_torch.krylov import fgmres
from mgtpu_torch.models.operators import nodal_laplacian_matrix as lap_port
from mgtpu_torch.ops.cuda import kaczmarz as kf
from mgtpu_torch.ops.ell import ell_from_scipy


def _np(t):
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _rel(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _meshes(dims):
    dom = [0.0, 1.0] * len(dims)
    return (mgtpu.get_regular_mesh(dom, list(dims)),
            mt.get_regular_mesh(dom, list(dims)))


def _poisson(n, shift=1e-4):
    M, Mp = _meshes([n, n])
    L = lap_ref(M)
    A = (L + shift * abs(L).sum(axis=0).max() * sp.identity(L.shape[0]))
    return M, Mp, A.tocsr()


def _divsig(n, shift, seed=3):
    M, Mp = _meshes([n, n])
    A = dsg_ref(M, np.exp(np.random.RandomState(seed).randn(M.num_cells)))
    A = A + shift * abs(A).sum(axis=0).max() * sp.identity(A.shape[0])
    return M, Mp, A.tocsr()


def _rhs(A, m=None, seed=4):
    rng = np.random.RandomState(seed)
    b = A @ (rng.rand(A.shape[0]) if m is None else rng.rand(A.shape[0], m))
    return b / np.linalg.norm(b)


# ---------------------------------------------------------------------------
# index geometry, bit for bit
# ---------------------------------------------------------------------------

FNS = ["cell_centered_indices_of_box", "nodal_indices_of_box",
       "faces_staggered_indices_of_box",
       "faces_staggered_indices_of_box_no_pressure"]


@pytest.mark.parametrize("fn", FNS)
@pytest.mark.parametrize("nc,ndom,ov", [((12, 10), (3, 2), (1, 2)),
                                        ((8, 6, 7), (2, 2, 3), (1, 0, 1))])
def test_box_indices_match_reference(fn, nc, ndom, ov):
    nc, ndom, ov = (np.asarray(v) for v in (nc, ndom, ov))
    for ic in range(int(np.prod(ndom))):
        i = ddi.cs2loc(ic, ndom)
        got = getattr(ddi, fn)(ndom, ov, i, nc)
        want = getattr(ddi_ref, fn)(ndom, ov, i, nc)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert ddi.box_color(i) == ddi_ref.box_color(i)


@pytest.mark.parametrize("dims", [(12, 10), (6, 8, 5)])
def test_sub_meshes_masses_and_tables_match_reference(dims):
    M, Mp = _meshes(dims)
    ndom = np.asarray([2] * len(dims))
    ov = np.asarray([1] * len(dims))
    for ic in range(int(np.prod(ndom))):
        i = ddi.cs2loc(ic, ndom)
        sm, sm_r = (ddi.sub_mesh_of_box(ndom, ov, i, Mp),
                    ddi_ref.sub_mesh_of_box(ndom, ov, i, M))
        assert sm.n == sm_r.n and sm.domain == sm_r.domain
        assert np.array_equal(
            ddi.dirichlet_mass_nodal(ndom, ov, i, np.asarray(dims)),
            ddi_ref.dirichlet_mass_nodal(ndom, ov, i, np.asarray(dims)))
    for fn in FNS:
        got = ddi.indices_of_cells_array(Mp, ov, ndom, getattr(ddi, fn))
        want = ddi_ref.indices_of_cells_array(M, ov, ndom,
                                              getattr(ddi_ref, fn))
        assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# Schwarz
# ---------------------------------------------------------------------------

def _dd_pair(n=16, ndom=(4, 4), ov=(1, 1)):
    M, Mp, A = _poisson(n)
    ref = sw_ref.DDSolver(M, list(ndom), list(ov), layout="nodal").setup(A)
    port = sw.DDSolver(Mp, list(ndom), list(ov), layout="nodal",
                       device="cpu").setup(A)
    return A, ref, port


def _state_arrays(st):
    return {k: np.asarray(getattr(st, k)) for k in
            ("idx", "mask", "rows_idx", "rows_val", "lu", "piv")} | {
        "colors": st.colors}


def test_schwarz_state_matches_reference():
    A, ref, port = _dd_pair()
    r, p = ref.state, port.state
    assert p.colors == r.colors
    for k in ("idx", "mask", "rows_idx", "rows_val"):
        assert np.array_equal(_np(getattr(p, k)), np.asarray(getattr(r, k)))
    # the factors: the same padded blocks through two LAPACK getrf calls
    assert _rel(p.lu, r.lu) < 1e-12
    assert np.array_equal(_np(p.piv), np.asarray(r.piv) + 1)


@pytest.mark.parametrize("symmetric", [False, True])
def test_schwarz_sweep_matches_reference(symmetric):
    A, ref, port = _dd_pair()
    b = _rhs(A, 2)
    x0 = np.random.RandomState(5).rand(*b.shape)
    want = sw_ref.schwarz_sweep(ref.state, jnp.asarray(x0), jnp.asarray(b),
                                2, symmetric)
    got = sw.schwarz_sweep(port.state, torch.tensor(x0), torch.tensor(b), 2,
                           symmetric)
    assert _rel(got, want) < 1e-9
    # mgtpu's own state carried across sweeps the same
    st = schwarz_state_from_arrays(_state_arrays(ref.state), "cpu")
    got2 = sw.schwarz_sweep(st, torch.tensor(x0), torch.tensor(b), 2,
                            symmetric)
    assert _rel(got2, want) < 1e-9


def test_dd_serial_preconditioner_count():
    """test_dd.py:26 — 32^2, 8 x 8 domains, overlap 1."""
    M, Mp, A = _poisson(32)
    b = _rhs(A)
    dd_r = sw_ref.DDSolver(M, [8, 8], [1, 1], layout="nodal").setup(A)
    x_r, i_r = dd_r.solve_linear_system(A, b, tol=1e-8, max_iter=10,
                                        restart=5)
    dd_p = sw.DDSolver(Mp, [8, 8], [1, 1], layout="nodal", device="cpu")
    x_p, i_p = dd_p.solve_linear_system(A, b, tol=1e-8, max_iter=10,
                                        restart=5)
    assert i_p["iters"] == i_r["iters"]
    # mgtpu's residual at this b (its test's 1e-6 holds at its own seed)
    res_r = np.linalg.norm(A @ np.asarray(x_r) - b)
    assert np.linalg.norm(A @ _np(x_p) - b) < 1.001 * res_r + 1e-12
    assert dd_p.n_fac == 1 and dd_p.n_solve == 1
    assert _rel(x_p, x_r) < 1e-7


def test_dd_sweep_reduces_residual():
    """test_dd.py:38 — two sweeps, and one symmetric sweep."""
    M, Mp, A = _poisson(32)
    dd = sw.DDSolver(Mp, [4, 4], [1, 1], layout="nodal",
                     device="cpu").setup(A)
    b = _rhs(A)
    x = dd.sweep(np.zeros_like(b), b, num_it=2)
    assert np.linalg.norm(A @ _np(x) - b) < 0.5
    xs = dd.sweep(np.zeros_like(b), b, num_it=1, symmetric=True)
    assert np.linalg.norm(A @ _np(xs) - b) < 0.6


def test_dd_rediscretization_matches_reference():
    """test_dd.py:50 — subdomain operators re-discretized with a Dirichlet
    interface mass: the same blocks (bit for bit, through their factors'
    inputs) and the same FGMRES count."""
    M, Mp, _ = _poisson(32)
    L = lap_ref(M)
    A = (L + 1e-4 * abs(L).sum(axis=0).max() * sp.identity(L.shape[0])).tocsr()
    shift = 1e-4 * abs(L).sum(axis=0).max()

    def get_operator(params, sub_mesh):
        Ls = lap_port(sub_mesh)
        return Ls + shift * sp.identity(Ls.shape[0])

    def get_operator_ref(params, sub_mesh):
        Ls = lap_ref(sub_mesh)
        return Ls + shift * sp.identity(Ls.shape[0])

    ctor = sw.DDOperatorConstructor(
        None, lambda *a: None, get_operator,
        lambda i, nd, ov, nc: 1e4 * ddi.dirichlet_mass_nodal(nd, ov, i, nc))
    ctor_r = sw_ref.DDOperatorConstructor(
        None, lambda *a: None, get_operator_ref,
        lambda i, nd, ov, nc: 1e4 * ddi_ref.dirichlet_mass_nodal(nd, ov, i,
                                                                 nc))
    dd_p = sw.DDSolver(Mp, [4, 4], [1, 1], layout="nodal", device="cpu")
    dd_p.setup_with_operator(ctor, A)
    dd_r = sw_ref.DDSolver(M, [4, 4], [1, 1], layout="nodal")
    dd_r.setup_with_operator(ctor_r, A)
    assert _rel(dd_p.state.lu, dd_r.state.lu) < 1e-12
    for k in ("idx", "mask", "rows_idx", "rows_val"):
        assert np.array_equal(_np(getattr(dd_p.state, k)),
                              np.asarray(getattr(dd_r.state, k)))
    b = _rhs(A)
    x_p, i_p = dd_p.solve_linear_system(A, b, tol=1e-8, max_iter=15,
                                        restart=5)
    x_r, i_r = dd_r.solve_linear_system(A, b, tol=1e-8, max_iter=15,
                                        restart=5)
    assert i_p["iters"] == i_r["iters"]
    assert np.linalg.norm(A @ _np(x_p) - b) < 1e-5
    with pytest.raises(ValueError, match="setup_with_operator"):
        sw.DDSolver(Mp, [4, 4], [1, 1], device="cpu").setup(ctor)


def test_dd_as_mg_coarse_solver_matches_reference():
    """test_dd.py:101 — DD as the coarsest solver: the flat engine in both
    packages, one cycle within 1e-9, and solve_mg's count."""
    M, Mp, A = _poisson(64)
    kw = dict(levels=3, max_outer_iter=10, relative_tol=1e-6,
              relax_type="jacobi", relax_param=0.8, nu_pre=1, nu_post=1)
    st_r = mgtpu.mg_setup(A, M, *mgtpu.get_mg_param(**kw),
                          coarse_solver=sw_ref.DDSolver(None, [2, 2], [1, 1]))
    st_p = mt.mg_setup(A, Mp, *mt.get_mg_param(**kw),
                       coarse_solver=sw.DDSolver(None, [2, 2], [1, 1]),
                       device="cpu")
    assert type(st_r.hier).__name__ == type(st_p.hier).__name__ == \
        "Hierarchy"
    b = _rhs(A, 1)
    x0 = np.zeros_like(b)
    y_r = cycle_ref(st_r.config, st_r.hier, jnp.asarray(b), jnp.asarray(x0))
    y_p = cycle_port(st_p.config, st_p.hier, torch.tensor(b),
                     torch.tensor(x0))
    assert _rel(y_p, y_r) < 1e-9
    x_r, i_r = mgtpu.solve_mg(st_r, b[:, 0])
    x_p, i_p = mt.solve_mg(st_p, b[:, 0])
    assert i_p["iters"] == i_r["iters"] and i_p["relres"] < 1e-4
    with pytest.raises(ValueError, match="engine='grid'"):
        mt.mg_setup(A, Mp, *mt.get_mg_param(engine="grid", **kw),
                    coarse_solver=sw.DDSolver(None, [2, 2], [1, 1]),
                    device="cpu")


# ---------------------------------------------------------------------------
# hybrid Kaczmarz
# ---------------------------------------------------------------------------

def _kz_pair(A, M, Mp, ndom=(4, 4), omega=0.8, num_it=2, layout="nodal",
             dtype=np.float64):
    fn = {"nodal": "nodal_indices_of_box",
          "faces": "faces_staggered_indices_of_box_no_pressure"}[layout]
    r = kz_ref.setup_hybrid_kaczmarz(A, M, list(ndom),
                                     getattr(ddi_ref, fn), omega, num_it,
                                     dtype=dtype)
    p = kz.setup_hybrid_kaczmarz(A, Mp, list(ndom), getattr(ddi, fn), omega,
                                 num_it, dtype=dtype)
    return r, p


def _kz_arrays(r):
    return {k: np.asarray(getattr(r, k)) for k in
            ("arr", "mask", "invd", "ell_idx", "ell_val")} | dict(
        num_domains=r.num_domains, num_it=r.num_it, omega=r.omega)


@pytest.mark.parametrize("layout", ["nodal", "faces"])
def test_kaczmarz_tables_match_reference(layout):
    if layout == "nodal":
        M, Mp, A = _divsig(12, 1e-4)
    else:
        M, Mp = _meshes([12, 12])
        mu = 2.0 * np.ones(M.num_cells)
        A = el_ref(M, mu, mu)
        A = (A + 2e-1 * abs(A).sum(axis=0).max()
             * sp.identity(A.shape[0])).tocsr()
    r, p = _kz_pair(A, M, Mp, (3, 2), layout=layout)
    for k in ("arr", "mask", "invd", "ell_idx", "ell_val"):
        got, want = getattr(p, k), np.asarray(getattr(r, k))
        assert got.dtype == want.dtype and np.array_equal(got, want), k
    assert (p.num_domains, p.num_it, p.omega) == (r.num_domains, r.num_it,
                                                  r.omega)


def _emulate_kernel(x, b, p, num_it):
    """Kernel F's schedule in numpy: per step, every domain's r from the x
    before the step; then each column's owner sums its chain in order and
    adds once."""
    x = x.copy()
    max_len, nd = p.arr.shape
    K = p.ell_idx.shape[1]
    for _ in range(num_it):
        for i in range(max_len):
            inner = np.zeros((nd, x.shape[1]))
            for d in range(nd):
                if p.mask[i, d] != 0:
                    row = p.arr[i, d]
                    ax = p.ell_val[row] @ x[p.ell_idx[row]]
                    inner[d] = (b[row] - ax) * p.invd[row] * p.mask[i, d]
            for t in range(nd * K):
                c = p.link[i, t]
                if c <= -2:
                    continue
                d, k = divmod(t, K)
                row = p.arr[i, d]
                acc = p.ell_val[row, k] * inner[d]
                nx = c
                while nx >= 0:
                    d2, k2 = divmod(nx, K)
                    acc = acc + p.ell_val[p.arr[i, d2], k2] * inner[d2]
                    c2 = p.link[i, nx]
                    nx = -c2 - 3 if c2 <= -3 else -1
                x[p.ell_idx[row, k]] += acc
    return x


def test_kaczmarz_link_table_covers_every_live_tap_once():
    M, Mp, A = _divsig(10, 1e-4)
    _, p = _kz_pair(A, M, Mp, (3, 3))
    max_len, nd = p.arr.shape
    K = p.ell_idx.shape[1]
    counts = np.diff(A.tocsr().indptr)
    for i in range(max_len):
        seen = set()
        for t in range(nd * K):
            c = p.link[i, t]
            if c <= -2:
                continue
            col = p.ell_idx[p.arr[i, t // K], t % K]
            chain = [t]
            while c >= 0:
                chain.append(c)
                c2 = p.link[i, c]
                c = -c2 - 3 if c2 <= -3 else -1
            for u in chain:
                d, k = divmod(u, K)
                assert p.ell_idx[p.arr[i, d], k] == col
                assert u not in seen
                seen.add(u)
        live = {d * K + k for d in range(nd) if p.mask[i, d] != 0
                for k in range(counts[p.arr[i, d]])}
        assert seen == live


@pytest.mark.parametrize("m", [1, 3])
def test_kaczmarz_sweep_matches_reference(m):
    """The plain version and the kernel's schedule (emulated) against
    mgtpu's fori_loop, f64, 1e-9; padded domains included ((3, 2) domains
    of unequal size)."""
    M, Mp, A = _divsig(13, 1e-4)
    r, p = _kz_pair(A, M, Mp, (3, 2))
    assert (p.mask == 0).any()                  # ragged: padded steps
    rng = np.random.RandomState(6)
    x0, b = rng.rand(A.shape[0], m), rng.rand(A.shape[0], m)
    want = np.asarray(kz_ref.kaczmarz_sweep(jnp.asarray(x0), jnp.asarray(b),
                                            r, 2))
    pt = p.to(torch.float64, "cpu")
    kf.PLAIN_CALLS["float64"] = 0
    got = kz.kaczmarz_sweep(torch.tensor(x0), torch.tensor(b), pt, 2)
    assert kf.PLAIN_CALLS["float64"] == 1
    assert _rel(got, want) < 1e-9
    assert _rel(_emulate_kernel(x0, b, p, 2), want) < 1e-9
    # mgtpu's state carried across gives the same sweep
    pc = kaczmarz_relax_from_arrays(_kz_arrays(r), "cpu")
    assert np.array_equal(_np(pc.link), p.link)
    assert _rel(kz.kaczmarz_sweep(torch.tensor(x0), torch.tensor(b), pc, 2),
                want) < 1e-9


def test_kaczmarz_preconditioner_matches_reference():
    """test_dd.py:115 at its 64^2: Kaczmarz-preconditioned FGMRES,
    restart 5, three restarts, both packages within 1e-9 of each other."""
    from mgtpu.krylov import fgmres as fgmres_ref
    M, Mp, A = _divsig(64, 2e-1)
    r, p = _kz_pair(A, M, Mp, (4, 4), num_it=5)
    B = _rhs(A, 2)
    X_r, i_r = fgmres_ref(ell_ref(A).matvec, jnp.asarray(B), restart=5,
                          prec=kz_ref.make_kaczmarz_precond(r), tol=1e-10,
                          max_iter=3)
    E = ell_from_scipy(A)
    prec = kz.make_kaczmarz_precond(p.to(torch.float64, "cpu"))
    X_p, i_p = fgmres(lambda v: E.matvec(v.T).T, torch.tensor(B.T.copy()),
                      restart=5, prec=lambda v: prec(v.T).T, tol=1e-10,
                      max_iter=3)
    assert i_p["iters"] == i_r["iters"] == 3
    assert _rel(X_p.T, X_r) < 1e-9
    assert np.linalg.norm(A @ _np(X_p.T) - B) < 0.1 * np.linalg.norm(B)


def _kmg(n, levels, dtype=np.float64):
    M, Mp, A = _divsig(n, 1e-4)
    A = A.tocsr()
    kw = dict(levels=levels, max_outer_iter=10, relative_tol=1e-6,
              relax_type="hybridKaczmarzNodal", nu_pre=1, nu_post=1,
              dtype=dtype)
    rp = {"num_domains": [4, 4], "omega": 0.8, "num_it": 2}
    st_r = mgtpu.mg_setup(A, M, *mgtpu.get_mg_param(**kw)[:1],
                          dict(rp, index_fn=ddi_ref.nodal_indices_of_box))
    st_p = mt.mg_setup(A, Mp, mt.get_mg_param(**kw)[0],
                       dict(rp, index_fn=ddi.nodal_indices_of_box),
                       device="cpu")
    return A, st_r, st_p


def test_hybrid_kaczmarz_cycle_matches_reference():
    """test_coverage_extra.py:148 at its size (32^2, 2 levels): the flat
    engine in both packages, the smoother's tables bit for bit, one cycle
    within 1e-9, solve_mg's count."""
    A, st_r, st_p = _kmg(32, 2)
    assert type(st_p.hier).__name__ == "Hierarchy"
    lr, lp = st_r.hier.levels[0].relax, st_p.hier.levels[0].relax
    for k in ("arr", "mask", "invd", "ell_idx", "ell_val"):
        assert np.array_equal(_np(getattr(lp, k)), np.asarray(getattr(lr, k)))
    b = _rhs(A, 1)
    y_r = cycle_ref(st_r.config, st_r.hier, jnp.asarray(b),
                    jnp.zeros_like(jnp.asarray(b)))
    y_p = cycle_port(st_p.config, st_p.hier, torch.tensor(b),
                     torch.zeros(b.shape, dtype=torch.float64))
    assert _rel(y_p, y_r) < 1e-9
    x_r, i_r = mgtpu.solve_mg(st_r, b[:, 0])
    x_p, i_p = mt.solve_mg(st_p, b[:, 0])
    assert i_p["iters"] == i_r["iters"] and i_p["relres"] < 1e-3


def test_hybrid_kaczmarz_flat_hierarchy_from_arrays():
    """mgtpu's Kaczmarz hierarchy carried across (its tables and DenseLU):
    the port's cycle on it equals mgtpu's within 1e-9."""
    A, st_r, _ = _kmg(16, 2)
    lv0 = st_r.hier.levels[0]
    ell = lambda E: {"indices": np.asarray(E.indices),
                     "values": np.asarray(E.values), "shape": E.shape}
    h = flat_hierarchy_from_arrays(
        [{"A": ell(lv0.A), "P": ell(lv0.P), "R": ell(lv0.R),
          "kaczmarz": _kz_arrays(lv0.relax)},
         {"A": ell(st_r.hier.levels[1].A)}],
        {"lu": np.asarray(st_r.hier.coarse.lu),
         "piv": np.asarray(st_r.hier.coarse.piv)}, device="cpu")
    b = _rhs(A, 2)
    y_r = cycle_ref(st_r.config, st_r.hier, jnp.asarray(b),
                    jnp.zeros_like(jnp.asarray(b)))
    y_p = cycle_port(st_r.config, h, torch.tensor(b),
                     torch.zeros(b.shape, dtype=torch.float64))
    assert _rel(y_p, y_r) < 1e-9


def test_hybrid_kaczmarz_bfloat16_cycles_match_reference():
    """solve_mg_refined with bfloat16 cycles on a hybrid-Kaczmarz flat
    hierarchy (32^2, 3 levels): kernel F's plain version counted in
    bfloat16, the DenseLU coarsest solved from its bfloat16 factors, the
    true f64 residual below 1e-8 at mgtpu's count +- 1."""
    A, st_r, st_p = _kmg(32, 3)
    b = _rhs(A, 1)[:, 0]
    p0 = kf.PLAIN_CALLS.get("bfloat16", 0)
    x_p, i_p = mt.solve_mg_refined(st_p, b, tol=1e-8, max_iter=60,
                                   cycle_dtype=torch.bfloat16)
    assert kf.PLAIN_CALLS["bfloat16"] > p0
    assert st_p._lo_hier[1].levels[0].relax.invd.dtype == torch.bfloat16
    x_r, i_r = mgtpu.solve_mg_refined(st_r, b, tol=1e-8, max_iter=60,
                                      cycle_dtype=jnp.bfloat16)
    assert abs(i_p["iters"] - i_r["iters"]) <= 1
    assert x_p.dtype == torch.float64
    assert np.linalg.norm(A @ _np(x_p) - b) < 1e-8 * np.linalg.norm(b)


# ---------------------------------------------------------------------------
# the multi-device sweep (mgtpu's dd/parallel.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[2, 4], ids=lambda r: f"R{r}")
def dd_group(request):
    """tests/_torch_ranks.py::dd_cases on R gloo ranks: (R, outputs)."""
    R = request.param
    return R, run_ranks(tr.dd_cases, R, "cpu", "gloo", tr.DEADLINE_S)


def _dd_problem():
    M, A = tr.poisson(tr.DD_N)
    Mr = mgtpu.get_regular_mesh(list(M.domain), list(np.asarray(M.n)))
    return M, Mr, A, tr.rhs(A, seed=6)


def test_dd_sharded_sweep_matches_serial(dd_group):
    """One sweep from zero with the domains spread over the ranks equals
    the serial sweep (test_dd.py:79, atol 1e-11), on every rank, and
    mgtpu's serial sweep."""
    _, outs = dd_group
    M, Mr, A, b = _dd_problem()
    serial = sw.DDSolver(M, list(tr.DD_DOMAINS), list(tr.DD_OVERLAP),
                         layout="nodal", device="cpu").setup(A)
    x_serial = _np(serial.sweep(np.zeros_like(b), b, 1))
    ref = sw_ref.DDSolver(Mr, list(tr.DD_DOMAINS), list(tr.DD_OVERLAP),
                          layout="nodal").setup(A)
    x_ref = np.asarray(ref.sweep(np.zeros_like(b), b, 1))
    for o in outs:
        np.testing.assert_allclose(o["sweep"], x_serial, atol=1e-11)
        np.testing.assert_allclose(o["sweep"], x_ref, atol=1e-11)


def test_dd_sharded_preconditioner_under_fgmres(dd_group):
    """FGMRES(5) preconditioned by the sharded sweep: mgtpu's bound
    (||A x - b|| < 1e-6, test_dd.py:95) in the serial preconditioner's
    restarts."""
    _, outs = dd_group
    M, Mr, A, b = _dd_problem()
    ref = sw_ref.DDSolver(Mr, list(tr.DD_DOMAINS), list(tr.DD_OVERLAP),
                          layout="nodal").setup(A)
    _, info = ref.solve_linear_system(A, b, tol=1e-8, max_iter=10, restart=5)
    for o in outs:
        assert np.linalg.norm(A @ o["x"] - b) < 1e-6
        assert o["restarts"] == int(info["iters"])
        assert o["sent"]["psum"] > 0


@pytest.mark.parametrize("R", [2, 4])
def test_sharded_schwarz_from_arrays_round_trip(R):
    """mgtpu's ShardedSchwarz for R devices, carried across, gives each
    rank's shard bit for bit: the port's own colour-major regrouping of the
    same serial state."""
    M, Mr, A, _ = _dd_problem()
    ref = sw_ref.DDSolver(Mr, list(tr.DD_DOMAINS), list(tr.DD_OVERLAP),
                          layout="nodal").setup(A)
    sh_ref = par_ref.build_sharded_schwarz(ref, R)
    spec = {k: np.asarray(getattr(sh_ref, k)) for k in
            ("idx", "mask", "rows_idx", "rows_val", "lu", "piv")}
    spec["ncolors"] = sh_ref.ncolors
    port = sw.DDSolver(M, list(tr.DD_DOMAINS), list(tr.DD_OVERLAP),
                       layout="nodal", device="cpu")
    port.state = schwarz_state_from_arrays(_state_arrays(ref.state), "cpu")
    fields = ("idx", "mask", "rows_idx", "rows_val", "lu", "piv", "perm",
              "iperm")
    for k in range(R):
        got = sharded_schwarz_from_arrays(spec, R, k, device="cpu")
        own = par.build_sharded_schwarz(port, R, k, "cpu")
        L = spec["idx"].shape[1] // R
        assert np.array_equal(_np(got.lu), spec["lu"][:, k * L:(k + 1) * L])
        assert np.array_equal(_np(got.piv),
                              spec["piv"][:, k * L:(k + 1) * L] + 1)
        assert got.ncolors == own.ncolors == sh_ref.ncolors
        for f in fields:
            a, b = _np(getattr(got, f)), _np(getattr(own, f))
            assert a.dtype == b.dtype and np.array_equal(a, b), f
