"""Staggered-systems parity of the PyTorch port (mgtpu_torch) with mgtpu, on
the CPU: the elasticity operators, the systems transfers and the cross
stencils bit for bit, the block operator against scipy, one systems grid
cycle on mgtpu's own state (carried across by
`systems_hierarchy_from_arrays`), the grid engine against the flat one,
BASELINE's elasticity contracts, mgtpu's refined counts and the recorded
loops against the eager ones.  Float64 cycles agree to 1e-9 relative
(BASELINE.md:70); grid against flat to 1e-6, as mgtpu holds it."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import mgtpu
from mgtpu.cycle.systems_grid import block_to_fields as b2f_ref
from mgtpu.cycle.systems_grid import fields_to_block as f2b_ref
from mgtpu.cycle.systems_grid import systems_grid_cycle as sys_cycle_ref
from mgtpu.models import operators as ops_ref
from mgtpu.setup import transfers as tr_ref

import mgtpu_torch as mt
from mgtpu_torch.convert import systems_hierarchy_from_arrays
from mgtpu_torch.cycle import systems_grid as sg
from mgtpu_torch.cycle.cycle import recursive_cycle as cycle_port
from mgtpu_torch.models import mesh as mesh_port
from mgtpu_torch.models import operators as ops_port
from mgtpu_torch.ops.cuda import stencil
from mgtpu_torch.setup import transfers as tr_port


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


def _elasticity(n, dim=2, mixed=False, lam=1.0, shift=1e-3):
    """mgtpu's test operator: elasticity (mixed or not), mu = 1, lam, plus
    shift * (max column sum) * I."""
    M, Mp = _meshes([n] * dim)
    mu = np.ones(M.num_cells)
    make = (ops_ref.linear_elasticity_operator_mixed if mixed
            else ops_ref.linear_elasticity_operator)
    A = make(M, mu, lam * mu)
    A = (A + shift * abs(A).sum(axis=0).max() * sp.identity(A.shape[0]))
    return M, Mp, A.tocsr()


def _params(relax, mixed, **kw):
    """(mgtpu config, port config, relax_param) of one systems setup."""
    args = dict(relax_type=relax, transfer_type="systems-faces-mixed"
                if mixed else "systems-faces", **kw)
    cfg_r, rp = mgtpu.get_mg_param(**args)
    cfg_p, _ = mt.get_mg_param(**args)
    return cfg_r, cfg_p, rp


def _export(h):
    """mgtpu's SystemsGridHierarchy as the arrays of
    `systems_hierarchy_from_arrays`."""
    levels = []
    for lv in h.levels:
        spec = dict(
            stencils=[dict(coeff=np.asarray(s.coeff), offsets=s.offsets,
                           in_grid=s.in_grid) for s in lv.A.stencils],
            pairs=lv.A.pairs, grids=lv.A.grids)
        if lv.d is not None:
            spec["d"] = [np.asarray(d) for d in lv.d]
        if lv.vanka is not None:
            v = lv.vanka
            spec["vanka"] = dict(dinv=np.asarray(v.dinv),
                                 masks=np.asarray(v.masks), slots=v.slots,
                                 cell_grid=v.cell_grid, variant=v.variant)
        for k in ("P1", "R1"):
            f = getattr(lv, k)
            if f is not None:
                spec[k] = [[np.asarray(w) for w in comp] for comp in f]
        levels.append(spec)
    return levels, np.asarray(h.coarse.inv)


# ---------------------------------------------------------------------------
# host products
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims", [[6, 5], [4, 3, 5]])
def test_elasticity_operators_bitwise(dims):
    M, Mp = _meshes(dims)
    rng = np.random.RandomState(2)
    mu, lam = rng.rand(M.num_cells) + 0.5, rng.rand(M.num_cells) + 0.5
    pairs = [(ops_ref.linear_elasticity_operator(M, mu, lam),
              ops_port.linear_elasticity_operator(Mp, mu, lam)),
             (ops_ref.linear_elasticity_operator_mixed(M, mu, lam),
              ops_port.linear_elasticity_operator_mixed(Mp, mu, lam)),
             (ops_ref.face_divergence_matrix(M),
              ops_port.face_divergence_matrix(Mp)),
             (ops_ref.face_mass_matrix(M, mu), ops_port.face_mass_matrix(Mp, mu)),
             (ops_ref.tensor_mass_matrix(M, mu),
              ops_port.tensor_mass_matrix(Mp, mu))]
    for a, b in pairs:
        assert a.shape == b.shape and a.dtype == b.dtype
        assert (a != b).nnz == 0
    from mgtpu.models.mesh import cs2loc, get_nodal_grid, loc2cs
    assert np.array_equal(get_nodal_grid(M), mesh_port.get_nodal_grid(Mp))
    cs = np.arange(M.num_cells)
    loc = mesh_port.cs2loc(cs, dims)
    assert np.array_equal(loc, cs2loc(cs, dims))
    assert np.array_equal(mesh_port.loc2cs(loc, dims), loc2cs(loc, dims))
    assert np.array_equal(mesh_port.loc2cs(loc, dims), cs)


@pytest.mark.parametrize("n", [[16, 8], [8, 16, 12], [6, 8]])
@pytest.mark.parametrize("cells_block", [False, True])
def test_systems_transfers_bitwise(n, cells_block):
    Pr, Rr, ncr = tr_ref.linear_operators_systems_faces(n, cells_block)
    Pp, Rp, ncp = tr_port.linear_operators_systems_faces(n, cells_block)
    assert np.array_equal(ncr, ncp)
    assert (Pr != Pp).nnz == 0 and (Rr != Rp).nnz == 0
    Ir = tr_ref.injection_operators_systems_faces(n, cells_block)
    Ip = tr_port.injection_operators_systems_faces(n, cells_block)
    assert (Ir != Ip).nnz == 0
    for k in ("node_injection_1d", "node_fw_restriction_1d",
              "prolongation_cells_1d", "restriction_cells_1d",
              "prolongation_nodes_1d"):
        for c in n:
            a, na = getattr(tr_ref, k)(c)
            b, nb = getattr(tr_port, k)(c)
            assert na == nb and (a != b).nnz == 0, k
    rho = np.random.RandomState(0).rand(int(np.prod(n)))
    assert np.array_equal(tr_ref.restrict_cell_centered_variables(rho, n),
                          tr_port.restrict_cell_centered_variables(rho, n))
    nodes = [c + 1 for c in n]
    rho = np.random.RandomState(1).rand(int(np.prod(nodes)))
    assert np.array_equal(tr_ref.restrict_nodal_variables(rho, nodes),
                          tr_port.restrict_nodal_variables(rho, nodes))


@pytest.mark.parametrize("dim,mixed", [(2, False), (2, True), (3, False),
                                       (3, True)])
def test_cross_stencils_bitwise(dim, mixed):
    from mgtpu.cycle.systems_grid import block_operator_from_csr as bo_ref
    _, _, A = _elasticity(8, dim, mixed)
    ref = bo_ref(A, [8] * dim, mixed)
    port = sg.block_operator_from_csr(A, [8] * dim, mixed)
    assert port.pairs == ref.pairs and port.grids == ref.grids
    for sr, spt in zip(ref.stencils, port.stencils):
        assert spt.offsets == sr.offsets
        assert (spt.out_grid, spt.in_grid) == (sr.out_grid, sr.in_grid)
        assert np.array_equal(np.asarray(sr.coeff), spt.coeff)
        assert (spt.to_scipy() != sr.to_scipy()).nnz == 0


@pytest.mark.parametrize("dim,mixed", [(2, False), (2, True), (3, False),
                                       (3, True)])
def test_block_operator_matvec_matches_scipy(dim, mixed):
    _, _, A = _elasticity(8, dim, mixed)
    op = sg.block_operator_from_csr(A, [8] * dim, mixed, device="cpu")
    x = np.random.RandomState(3).rand(A.shape[0], 2)
    y = sg.fields_to_block(op.matvec(sg.block_to_fields(torch.tensor(x),
                                                         op.grids)))
    assert _rel(y, A @ x) < 1e-12
    yr = op.rows_matvec(torch.tensor(np.ascontiguousarray(x.T)))
    assert _rel(yr.T, A @ x) < 1e-12
    # one cross block on its own: the plain version, counted
    S = next(s for s, (ci, cj) in zip(op.stencils, op.pairs) if ci != cj)
    xs = torch.tensor(np.random.RandomState(4).rand(3, *S.in_grid))
    n0 = stencil.PLAIN_CALLS["float64"]
    ys = S.matvec(xs)
    assert stencil.PLAIN_CALLS["float64"] == n0 + 1
    want = (S.to_scipy() @ _np(xs).reshape(3, -1).T).T
    assert _rel(ys.reshape(3, -1), want) < 1e-12


def test_field_layouts_round_trip():
    grids, offs = sg.face_component_grids([5, 4], True)
    x = torch.arange(float(offs[-1] * 3)).reshape(-1, 3)
    xs = sg.block_to_fields(x, grids)
    xr = b2f_ref(jnp.asarray(_np(x)), grids)
    for a, b in zip(xs, xr):
        assert np.array_equal(_np(a), np.asarray(b))
    assert torch.equal(sg.fields_to_block(xs), x)
    assert np.array_equal(np.asarray(f2b_ref(xr)), _np(x))
    rows = x.T.contiguous()
    fs = sg.rows_to_fields(rows, grids)
    assert all(f.is_contiguous() for f in fs)
    assert torch.equal(sg.fields_to_rows(fs), rows)
    one = rows[:1]
    f1 = sg.rows_to_fields(one, grids)
    assert f1[1].data_ptr() == one.data_ptr() + offs[1] * one.element_size()


# ---------------------------------------------------------------------------
# setup and cycles against mgtpu
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("relax,mixed", [("spai", False), ("jacobi", False),
                                         ("vanka", True),
                                         ("econ-vanka", True),
                                         ("vanka-add", True)])
def test_systems_setup_matches_reference(relax, mixed):
    """mg_setup's host hierarchy and its systems grid engine equal mgtpu's:
    operators, transfers, diagonals or Vanka inverses and masks, factors,
    coarsest inverse."""
    M, Mp, A = _elasticity(16, 2, mixed)
    cfg_r, cfg_p, rp = _params(relax, mixed, levels=3, relax_param=0.75)
    st_r = mgtpu.mg_setup(A, M, cfg_r, rp)
    st_p = mt.mg_setup(A, Mp, cfg_p, rp, device="cpu")
    assert isinstance(st_p.hier, sg.SystemsGridHierarchy)
    assert len(st_p.As) == len(st_r.As)
    for a, b in zip(st_r.As, st_p.As):
        assert (a != b).nnz == 0
    for l in range(len(st_r.As) - 1):
        assert (st_r.Ps[l] != st_p.Ps[l]).nnz == 0
        assert (st_r.Rs[l] != st_p.Rs[l]).nnz == 0
    levels, inv = _export(st_r.hier)
    for spec, lv in zip(levels, st_p.hier.levels):
        for sr, s in zip(spec["stencils"], lv.A.stencils):
            assert np.array_equal(sr["coeff"], _np(s.coeff))
        if "d" in spec:
            for a, b in zip(spec["d"], lv.d):
                assert np.array_equal(a, _np(b))
        if "vanka" in spec:
            assert np.array_equal(spec["vanka"]["dinv"], _np(lv.vanka.dinv))
            assert np.array_equal(spec["vanka"]["masks"],
                                  _np(lv.vanka.masks))
            assert spec["vanka"]["slots"] == lv.vanka.slots
        for k in ("P1", "R1"):
            for ca, cb in zip(spec.get(k, ()), getattr(lv, k) or ()):
                for a, b in zip(ca, cb):
                    assert np.array_equal(a, _np(b))
    assert np.array_equal(inv, _np(st_p.hier.coarse.inv))
    assert set(st_p.setup_times) >= {"rap", "transfers", "cross_stencils",
                                     "smoother", "coarse"}


@pytest.mark.parametrize("relax,mixed", [("spai", False), ("vanka", True),
                                         ("vanka-add", True)])
@pytest.mark.parametrize("ctype", ["V", "W", "F", "K"])
def test_systems_grid_cycle_matches_reference(relax, mixed, ctype):
    """One cycle of the port on mgtpu's own systems hierarchy (carried
    across as arrays) against mgtpu's cycle, f64, 2 right-hand sides."""
    M, Mp, A = _elasticity(16, 2, mixed)
    cfg_r, cfg_p, rp = _params(relax, mixed, levels=3, relax_param=0.75,
                               nu_pre=1, nu_post=1, cycle_type=ctype)
    st_r = mgtpu.mg_setup(A, M, cfg_r, rp)
    h = systems_hierarchy_from_arrays(*_export(st_r.hier), device="cpu")
    b = np.random.RandomState(5).rand(A.shape[0], 2)
    x0 = np.random.RandomState(6).rand(A.shape[0], 2)
    grids = h.fine_grids
    y_r = f2b_ref(sys_cycle_ref(cfg_r, st_r.hier,
                                b2f_ref(jnp.asarray(b), grids),
                                b2f_ref(jnp.asarray(x0), grids)))
    y_p = sg.fields_to_block(sg.systems_grid_cycle(
        cfg_p, h, sg.block_to_fields(torch.tensor(b), grids),
        sg.block_to_fields(torch.tensor(x0), grids)))
    assert _rel(y_p, np.asarray(y_r)) < 1e-9


@pytest.mark.parametrize("relax,mixed", [("jacobi", False), ("spai", False),
                                         ("econ-vanka", True),
                                         ("vanka-add", True)])
@pytest.mark.parametrize("ctype", ["V", "W", "K"])
def test_systems_grid_cycle_matches_flat(relax, mixed, ctype):
    """mgtpu's conformance test on the port: the systems grid engine and
    the flat engine give one cycle within 1e-6."""
    M, Mp, A = _elasticity(16, 2, mixed)
    rp = 0.75 if relax != "econ-vanka" else 2.0
    out = {}
    for engine in ("flat", "grid"):
        _, cfg, _ = _params(relax, mixed, levels=3, relax_param=rp,
                            nu_pre=1, nu_post=1, cycle_type=ctype,
                            engine=engine)
        st = mt.mg_setup(A, Mp, cfg, rp, device="cpu")
        assert isinstance(st.hier, sg.SystemsGridHierarchy) == \
            (engine == "grid")
        b = torch.tensor(np.random.RandomState(7).rand(A.shape[0], 2))
        out[engine] = cycle_port(cfg, st.hier, b, torch.zeros_like(b))
    np.testing.assert_allclose(_np(out["grid"]), _np(out["flat"]),
                               rtol=1e-6, atol=1e-9)


def test_systems_grid_3d_mixed_vanka_matches_reference():
    """3D 8^3 mixed elasticity, VankaFaces V(1,1), 2 levels: one cycle of
    the port's own setup against mgtpu's, f64."""
    M, Mp, A = _elasticity(8, 3, True)
    cfg_r, cfg_p, rp = _params("vanka", True, levels=2, relax_param=0.75,
                               nu_pre=1, nu_post=1)
    st_r = mgtpu.mg_setup(A, M, cfg_r, rp)
    st_p = mt.mg_setup(A, Mp, cfg_p, rp, device="cpu")
    b = np.random.RandomState(8).rand(A.shape[0], 1)
    from mgtpu.cycle.cycle import recursive_cycle as cycle_ref
    y_r = cycle_ref(cfg_r, st_r.hier, jnp.asarray(b),
                    jnp.zeros_like(jnp.asarray(b)))
    y_p = cycle_port(cfg_p, st_p.hier, torch.tensor(b),
                     torch.zeros(b.shape, dtype=torch.float64))
    assert _rel(y_p, np.asarray(y_r)) < 1e-9


# ---------------------------------------------------------------------------
# solves: BASELINE's contracts, mgtpu's counts, the recorded loops
# ---------------------------------------------------------------------------

def test_elasticity_contract_spai():
    """GMG-Elasticity (BASELINE.md:29) at mgtpu's grid-engine test size:
    64^2, SystemsFacesLinear, SPAI 0.75, V(2,2), 4 levels, 2 right-hand
    sides: < 0.05 after 5 cycles, < 0.01 under CG."""
    M, Mp, A = _elasticity(64, 2, False)
    cfg, rp = mt.get_mg_param(levels=4, max_outer_iter=5, relative_tol=1e-10,
                              relax_type="spai", relax_param=0.75, nu_pre=2,
                              nu_post=2, transfer_type="SystemsFacesLinear",
                              engine="grid")
    st = mt.mg_setup(A, Mp, cfg, rp, device="cpu")
    B = A @ np.random.RandomState(9).rand(A.shape[0], 2)
    B = B / np.linalg.norm(B)
    X, _ = mt.solve_mg(st, B)
    assert np.linalg.norm(A @ _np(X) - B) < 0.05
    X, _ = mt.solve_cg_mg(st, B)
    assert np.linalg.norm(A @ _np(X) - B) < 0.01


def test_mixed_vanka_contract():
    """GMG-Vanka-mixed (BASELINE.md:30) at mgtpu's grid-engine test size:
    32^2 mixed elasticity, VankaFaces 0.75, V(1,1), 3 levels, 10 cycles:
    < 0.05 standalone, < 0.01 under CG."""
    M, Mp, A = _elasticity(32, 2, True)
    cfg, rp = mt.get_mg_param(levels=3, max_outer_iter=10, relative_tol=1e-10,
                              relax_type="VankaFaces", relax_param=0.75,
                              nu_pre=1, nu_post=1,
                              transfer_type="SystemsFacesMixedLinear",
                              engine="grid")
    st = mt.mg_setup(A, Mp, cfg, rp, device="cpu")
    assert isinstance(st.hier, sg.SystemsGridHierarchy)
    b = A @ np.random.RandomState(10).rand(A.shape[0])
    b = b / np.linalg.norm(b)
    x, _ = mt.solve_mg(st, b)
    assert np.linalg.norm(A @ _np(x) - b) < 0.05
    x, _ = mt.solve_cg_mg(st, b)
    assert np.linalg.norm(A @ _np(x) - b) < 0.01


def _contract_states(key, n=64):
    """The V-2d / E-2d configurations (scripts/systems_reference.py) at
    n^2, f32, in both packages, and the normalised right-hand side."""
    mixed = key == "V"
    M, Mp, A = _elasticity(n, 2, mixed)
    relax, nu = ("vanka", 1) if mixed else ("spai", 2)
    cfg_r, cfg_p, rp = _params(relax, mixed, levels=4, relax_param=0.75,
                               nu_pre=nu, nu_post=nu, dtype=np.float32,
                               max_outer_iter=60)
    b = A @ np.random.RandomState(4).rand(A.shape[0])
    b = b / np.linalg.norm(b)
    return (mgtpu.mg_setup(A, M, cfg_r, rp),
            mt.mg_setup(A, Mp, cfg_p, rp, device="cpu"), A, b)


@pytest.mark.parametrize("key", ["V", "E"])
def test_refined_counts_match_reference(key):
    """solve_mg_refined at 64^2 takes mgtpu's iteration count, to a true
    f64 relres below 1e-8; the device loop is the eager loop bit for bit."""
    st_r, st_p, A, b = _contract_states(key)
    _, info_r = mgtpu.solve_mg_refined(st_r, b, tol=1e-8, max_iter=60)
    x, info = mt.solve_mg_refined(st_p, b, tol=1e-8, max_iter=60)
    assert info["iters"] == info_r["iters"]
    assert np.linalg.norm(b - A @ _np(x)) / np.linalg.norm(b) < 1e-8
    assert x.dtype == torch.float64
    xe, info_e = mt.solve_mg_refined(st_p, b, tol=1e-8, max_iter=60,
                                     device_loop=False)
    assert info_e["iters"] == info["iters"]
    assert torch.equal(xe, x)
    assert np.array_equal(info_e["resvec"], info["resvec"])


def test_cg_count_and_loops_on_systems():
    """E-cg's form at 32^2: solve_cg_mg with an f64 b over the f32 systems
    hierarchy takes mgtpu's count; the recorded loop is the eager one bit
    for bit; solve_mg_jit equals mgtpu's fixed-count solve."""
    st_r, st_p, A, b = _contract_states("E", 32)
    for st in (st_r, st_p):
        st.config = dataclasses.replace(st.config, max_outer_iter=100,
                                        relative_tol=1e-8)
    _, info_r = mgtpu.solve_cg_mg(st_r, b)
    x, info = mt.solve_cg_mg(st_p, b)
    assert int(info["iters"]) == int(info_r["iters"])
    assert np.linalg.norm(b - A @ _np(x)) / np.linalg.norm(b) < 1e-8
    xe, info_e = mt.solve_cg_mg(st_p, b, device_loop=False)
    assert int(info_e["iters"]) == int(info["iters"])
    assert torch.equal(xe, x)
    b32 = b.astype(np.float32)
    xj_r = mgtpu.solve_mg_jit(st_r, b32, num_cycles=3)
    xj = mt.solve_mg_jit(st_p, b32, num_cycles=3)
    assert _rel(xj, np.asarray(xj_r)) < 1e-5


def test_high_precision_block_operator():
    """The refined residual's float64 operator is a block operator of cross
    stencils of A_input: A x to 1e-13, through kernel D's plain version on
    the CPU."""
    from mgtpu_torch.solvers.mg_solver import (_hi_matvec,
                                               high_precision_fine_operator)
    M, Mp, A = _elasticity(16, 2, True)
    cfg, rp = mt.get_mg_param(levels=3, relax_type="vanka", relax_param=0.75,
                              transfer_type="systems-faces-mixed",
                              dtype=np.float32)
    st = mt.mg_setup(A, Mp, cfg, rp, device="cpu")
    op = high_precision_fine_operator(st)
    assert isinstance(op, sg.BlockGridOperator) and op.dtype == torch.float64
    x = np.random.RandomState(11).rand(2, A.shape[0])
    n0 = stencil.PLAIN_CALLS["float64"]
    y = _hi_matvec(st)(torch.tensor(x))
    assert stencil.PLAIN_CALLS["float64"] == n0 + len(op.stencils)
    assert _rel(y.T, A @ x.T) < 1e-13
