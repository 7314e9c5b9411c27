"""The rest of the complex port (mgtpu_torch) against mgtpu, on the CPU:
complex line relaxation and semicoarsening (kernel C's plain version), the
complex staggered-systems engine (kernel D's cross form, the grid Vanka,
kernel E's plain version, cell Kaczmarz), complex device aggregation and
complex64 cycles below a complex128 hierarchy.

Operators: the anisotropic and Helmholtz rows are shifted by
-(1 - 0.5i) diag(k^2), the systems rows by (1e-3 + 1e-3i) (max column
sum) I (scripts/complex_rest_reference.py).  Host products are compared
bit for bit, single applies within 1e-12 and cycles and sweeps within 1e-9
in complex128 (complex64: 2e-5 relative); every contract row's count at
64^2 / 16^3 equals mgtpu's."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import mgtpu
from mgtpu.cycle.cycle import recursive_cycle as cycle_ref
from mgtpu.cycle.grid_cycle import grid_cycle as grid_cycle_ref
from mgtpu.cycle.relax import _line_correct as line_correct_ref
from mgtpu.cycle.relax import line_solve as line_solve_ref
from mgtpu.cycle.systems_grid import block_to_fields as b2f_ref
from mgtpu.cycle.systems_grid import build_grid_vanka as grid_vanka_ref
from mgtpu.cycle.systems_grid import fields_to_block as f2b_ref
from mgtpu.cycle.systems_grid import systems_grid_cycle as sys_cycle_ref
from mgtpu.cycle.vanka import vanka_sweep as sweep_ref
from mgtpu.ops.cross_stencil import cross_stencil_matvec as cross_ref
from mgtpu.setup import device_agg as da_ref
from mgtpu.setup import sa_amg as sa_ref
from mgtpu.setup import smoothers as sm_ref

import mgtpu_torch as mt
from mgtpu_torch import convert
from mgtpu_torch.cycle import relax as port_relax
from mgtpu_torch.cycle import systems_grid as sg
from mgtpu_torch.cycle.grid_cycle import grid_cycle
from mgtpu_torch.cycle.vanka import vanka_sweep
from mgtpu_torch.krylov._loop import CHUNK
from mgtpu_torch.ops.cuda import stencil as sk
from mgtpu_torch.ops.cuda import tridiag
from mgtpu_torch.ops.cuda import vanka as vk
from mgtpu_torch.setup import device_agg as da_port
from mgtpu_torch.setup import smoothers as sm

from test_torch_line import _same_line_state, hierarchy_arrays
from test_torch_systems import _elasticity, _export, _params
from test_torch_vanka import _export_flat, _tables


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(os.path.dirname(__file__), "..", "scripts",
                           f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _script("complex_rest_reference")
ref12 = _script("complex_reference")

DTYPES = [np.complex64, np.complex128]
VARIANTS = ["vanka", "econ-vanka", "vanka-lex", "vanka-add",
            "kaczmarz-vanka"]
CSHIFT = 1e-3 + 1e-3j


def _np(t):
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _rel(a, b):
    a = _np(a).astype(np.complex128)
    b = _np(b).astype(np.complex128)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _tol(dtype):
    return 1e-12 if np.dtype(dtype) == np.complex128 else 2e-5


def _crand(*shape, seed=0):
    rng = np.random.RandomState(seed)
    return rng.rand(*shape) + 1j * rng.rand(*shape)


def _same(A, B):
    A, B = sp.csr_matrix(A), sp.csr_matrix(B)
    return (A.shape == B.shape and A.dtype == B.dtype
            and (A != B).nnz == 0)


def _meshes(dims):
    dom = [0.0, 1.0] * len(dims)
    return (mgtpu.get_regular_mesh(dom, list(dims)),
            mt.get_regular_mesh(dom, list(dims)))


def _line_op(cells, eps=100.0):
    """The CL operators at a small size: shifted, eps on mesh axis 0 in 2D
    and on grid axis 0 in 3D; cells per mesh axis."""
    A = (_aniso2d(*cells, eps) if len(cells) == 2
         else ref.aniso3d(list(cells), 0))
    return ref.shift(A, 0.125, cells[0])


def _aniso2d(nx, ny, eps):
    """eps u_xx + u_yy on an (nx+1) x (ny+1) node grid (x fastest)."""
    Tx = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx + 1, nx + 1)) \
        * nx ** 2
    Ty = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(ny + 1, ny + 1)) \
        * ny ** 2
    return sp.csr_matrix(eps * sp.kron(sp.identity(ny + 1), Tx)
                         + sp.kron(Ty, sp.identity(nx + 1)))


# ---------------------------------------------------------------------------
# complex line relaxation: the Thomas factors, the solve and the correction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["2d", "2d-axis0", "2d-alt", "3d"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_complex_line_prec_matches_reference_bitwise(case, dtype):
    """line_prec's complex Thomas factors (alpha, pivot, cprime) and axis
    equal mgtpu's bit for bit; both read the real part of the
    coefficients when they pick the axis and factor the lines (mgtpu's
    float64 cast, kept as it is)."""
    dims = [6, 8, 10] if case == "3d" else [18, 24]
    kw = {"2d-axis0": {"axis": 0}, "2d-alt": {"axis": "alt"}}.get(case, {})
    A = _line_op(dims)
    M, Mp = _meshes(dims)
    want = sm_ref.line_prec(A, M, 0.8, dtype=dtype, **kw)
    got = sm.line_prec(A, Mp, 0.8, dtype=dtype, **kw)
    _same_line_state(got, want)


@pytest.mark.parametrize("cells", [(18, 24), (6, 8, 10)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lead", [(), (3,)])
def test_complex_line_solve_and_correct_match_reference(cells, dtype, lead):
    """Kernel C's plain version on complex fields: T^-1 r (solve) and
    x + omega T^-1 r (correct) against mgtpu's line_solve / _line_correct
    on every line axis, within 1e-12 in complex128; counted under the
    value type."""
    A = _line_op(cells)
    M, Mp = _meshes(cells)
    grid = tuple(v + 1 for v in reversed(cells))
    r = _crand(*(lead + grid), seed=1).astype(dtype)
    x = _crand(*(lead + grid), seed=2).astype(dtype)
    key = np.dtype(dtype).name
    for axis in range(len(grid)):
        lr_r = sm_ref.line_prec(A, M, 0.8, dtype=dtype, axis=axis)
        lr_p = port_relax.LineRelax(
            *(torch.from_numpy(np.asarray(getattr(lr_r, k))) for k in
              ("alpha", "pivot", "cprime")), axis, 0.8)
        n0 = tridiag.PLAIN_CALLS[key]
        got = port_relax.line_solve(lr_p, torch.from_numpy(r))
        want = line_solve_ref(lr_r, jnp.asarray(r))
        assert got.dtype == torch.from_numpy(r).dtype
        assert _rel(got, np.asarray(want)) < _tol(dtype)
        got = port_relax.line_correct(lr_p, torch.from_numpy(r),
                                      torch.from_numpy(x))
        want = line_correct_ref(lr_r, jnp.asarray(r), jnp.asarray(x))
        assert _rel(got, np.asarray(want)) < _tol(dtype)
        assert tridiag.PLAIN_CALLS[key] == n0 + 2


def test_line_plan_takes_complex_itemsizes():
    """The launch plan of complex lines: a strided staged tile of 4
    complex64 or 2 complex128 lines (one 32-byte sector a row), within the
    shared memory left beside 32 complex128 cross-warp slots; the
    strided 1025^2 complex128 correct streams."""
    p = tridiag.line_plan(1, 1025, 1025, 8, "correct")
    assert (p.variant, p.tile, p.smem) == ("staged", 4, 5 * 1025 * 5 * 8)
    p = tridiag.line_plan(1, 129, 129 * 129, 16, "solve")
    assert (p.variant, p.tile) == ("staged", 2)
    assert tridiag.line_plan(1, 1025, 1025, 16, "correct").variant == \
        "streamed"
    assert tridiag.max_smem(16) == 232_448 - 1024
    assert tridiag.max_smem(4) == tridiag.max_smem(8) == tridiag.MAX_SMEM
    p = tridiag.line_plan(1025, 1025, 1, 16, "correct")
    assert (p.variant, p.tile, p.smem) == ("staged", 1, 5 * 1025 * 16)


# ---------------------------------------------------------------------------
# line-smoothed and semicoarsened hierarchies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["line", "alt", "semi", "line-3d"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_complex_line_hierarchies_match_reference(case, dtype):
    """mg_setup with complex line relaxation (one axis, alternating) or
    semicoarsening: the level operators, transfers and grids bit for bit,
    the line states on every level equal mgtpu's, and one V-cycle within
    1e-9 (complex128) of mgtpu's on its own hierarchy carried across by
    grid_hierarchy_from_arrays, and of the port's own."""
    if case == "line-3d":
        dims, A = [8, 8, 8], ref.shift(ref.aniso3d([8, 8, 8], 0), 0.125, 8)
    else:
        eps = 0.01 if case == "semi" else 100.0
        dims, A = [16, 16], ref.shift(ref.aniso2d(16, eps), 0.125, 16)
    M, Mp = _meshes(dims)
    kw = dict(levels=3, relax_type="line-jacobi", nu_pre=1, nu_post=1,
              dtype=dtype,
              relax_param={"omega": 0.8, "axis": "alt"} if case == "alt"
              else 0.8,
              transfer_type="semicoarsening" if case == "semi"
              else "full-weighting")
    cfg_r, rp = mgtpu.get_mg_param(**kw)
    cfg_p, _ = mt.get_mg_param(**kw)
    st_r = mgtpu.mg_setup(A, M, cfg_r, rp)
    st_p = mt.mg_setup(A, Mp, cfg_p, rp, device="cpu")
    assert all(_same(a, b) for a, b in zip(st_r.As, st_p.As))
    assert all(_same(a, b) for a, b in zip(st_r.Ps, st_p.Ps))
    assert [lv.A.grid for lv in st_r.hier.levels] == \
        [lv.A.grid for lv in st_p.hier.levels]
    if case == "semi":
        # eps = 0.01: y coarsens, the x lines keep their length
        assert st_p.hier.levels[1].A.grid[1] == st_p.hier.levels[0].A.grid[1]
    for lv_r, lv_p in zip(st_r.hier.levels[:-1], st_p.hier.levels[:-1]):
        lines_r = lv_r.d.lines if case == "alt" else (lv_r.d,)
        lines_p = lv_p.line.lines if case == "alt" else (lv_p.line,)
        for c_r, c_p in zip(lines_r, lines_p):
            assert c_p.axis == c_r.axis
            for k in ("alpha", "pivot", "cprime"):
                assert np.array_equal(_np(getattr(c_p, k)),
                                      np.asarray(getattr(c_r, k))), k
    if np.dtype(dtype) != np.complex128:
        return
    h = convert.grid_hierarchy_from_arrays(*hierarchy_arrays(st_r.hier),
                                           device="cpu")
    grid = st_p.hier.levels[0].A.grid
    b = _crand(2, *grid, seed=3)
    x0 = _crand(2, *grid, seed=4)
    y_r = np.asarray(grid_cycle_ref(cfg_r, st_r.hier, jnp.asarray(b),
                                    jnp.asarray(x0)))
    for hier in (h, st_p.hier):
        y_p = grid_cycle(cfg_p, hier, torch.from_numpy(b),
                         torch.from_numpy(x0))
        assert _rel(y_p, y_r) < 1e-9


# ---------------------------------------------------------------------------
# the complex staggered-systems engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_complex_vanka_tables_bitwise(variant, dtype):
    """setup_vanka on a complex mixed-elasticity operator: the cell index
    sets, the row tables and the complex64 block inverses (the single
    variant of either complex type) equal mgtpu's bit for bit."""
    M, Mp, A = _elasticity(8, 2, True, shift=CSHIFT)
    w = 2.0 if variant == "econ-vanka" else 0.75
    vr = sm_ref.setup_vanka(A, M, w, True, variant, dtype=dtype)
    vp = sm.setup_vanka(A, Mp, w, True, variant, dtype=dtype)
    for k in ("idx", "dinv", "rows_idx", "rows_val"):
        a, b = np.asarray(getattr(vr, k)), getattr(vp, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert vp.dinv.dtype == np.complex64
    assert vp.rows_val.dtype == np.dtype(dtype)


@pytest.mark.parametrize("variant", ["vanka", "econ-vanka", "vanka-add"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_complex_grid_vanka_bitwise(variant, dtype):
    """The systems engine's grid-form Vanka of a complex operator: block
    inverses (complex64) and colour masks equal mgtpu's bit for bit."""
    M, Mp, A = _elasticity(8, 2, True, shift=CSHIFT)
    w = 2.0 if variant == "econ-vanka" else 0.75
    gr = grid_vanka_ref(A, M, w, True, variant, np.dtype(dtype),
                        np.dtype(np.complex64))
    gp = sg.build_grid_vanka(A, Mp, w, True, variant, np.dtype(dtype),
                             np.dtype(np.complex64))
    for k in ("dinv", "masks"):
        a, b = np.asarray(getattr(gr, k)), _np(getattr(gp, k))
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert gp.slots == gr.slots and gp.cell_grid == gr.cell_grid


@pytest.mark.parametrize("variant", VARIANTS)
def test_complex_vanka_sweeps_match_reference(variant):
    """Two flat sweeps of every variant on mgtpu's complex tables,
    complex128 values, 2 right-hand sides, within 1e-12: kernel E's plain
    version for vanka-lex (counted under complex128), the conjugated rows
    of cell Kaczmarz."""
    M, Mp, A = _elasticity(8, 2, True, shift=CSHIFT)
    w = 2.0 if variant == "econ-vanka" else 0.75
    vr = sm_ref.setup_vanka(A, M, w, True, variant, dtype=np.complex128)
    vp = convert.vanka_relax_from_arrays(_tables(vr), A.shape[0],
                                         torch.complex128, "cpu")
    x, b = _crand(A.shape[0], 2, seed=1), _crand(A.shape[0], 2, seed=2)
    n0 = vk.PLAIN_CALLS["complex128"]
    y_r = sweep_ref(jnp.asarray(x), jnp.asarray(b), vr, 2)
    y_p = vanka_sweep(torch.from_numpy(x), torch.from_numpy(b), vp, 2)
    assert y_p.dtype == torch.complex128
    assert _rel(y_p, np.asarray(y_r)) < 1e-12
    assert vk.PLAIN_CALLS["complex128"] == n0 + (variant == "vanka-lex")


@pytest.mark.parametrize("dtype", DTYPES)
def test_complex_lex_sweep_promotes_the_inverse_first(dtype):
    """Kernel E's plain version in complex: the per-cell update by hand,
    with the complex64 block inverse raised to x's type before the
    product (mgtpu's dinv.astype(x.dtype) @ r)."""
    M, Mp, A = _elasticity(4, 2, True, shift=CSHIFT)
    vp = sm.setup_vanka(A, Mp, 0.75, True, "vanka-lex", dtype=dtype).to(
        torch.complex128 if dtype == np.complex128 else torch.complex64,
        "cpu")
    x, b = (_crand(A.shape[0], 1, seed=s).astype(dtype) for s in (5, 6))
    y = vk.lex_sweep(torch.from_numpy(x), torch.from_numpy(b), vp.idx[0],
                     vp.dinv[0], vp.rows_idx[0], vp.rows_val[0], 1)
    want = x.copy()
    Ad = A.astype(dtype).toarray()
    idx, dinv = _np(vp.idx[0]), _np(vp.dinv[0]).astype(dtype)
    for l in range(idx.shape[0]):
        r = b[idx[l]] - Ad[idx[l]] @ want
        want[idx[l]] += dinv[l] @ r
    assert _rel(y, want) < _tol(dtype) * 10


@pytest.mark.parametrize("relax,mixed", [("spai", False), ("vanka", True),
                                         ("econ-vanka", True),
                                         ("vanka-add", True)])
def test_complex_systems_cycle_matches_reference(relax, mixed):
    """One systems grid cycle, complex128: the port's own setup (cross
    stencils, transfers, grid Vanka, dense coarsest inverse bit for bit)
    and mgtpu's hierarchy carried across by systems_hierarchy_from_arrays,
    each within 1e-9 of mgtpu's cycle."""
    M, Mp, A = _elasticity(16, 2, mixed, shift=CSHIFT)
    rp = 2.0 if relax == "econ-vanka" else 0.75
    cfg_r, cfg_p, rp = _params(relax, mixed, levels=3, relax_param=rp,
                               nu_pre=1, nu_post=1, dtype=np.complex128)
    st_r = mgtpu.mg_setup(A, M, cfg_r, rp)
    st_p = mt.mg_setup(A, Mp, cfg_p, rp, device="cpu")
    assert isinstance(st_p.hier, sg.SystemsGridHierarchy)
    levels, inv = _export(st_r.hier)
    assert inv.dtype == np.complex128
    assert np.array_equal(inv, _np(st_p.hier.coarse.inv))
    for spec, lv in zip(levels, st_p.hier.levels):
        for s, S in zip(spec["stencils"], lv.A.stencils):
            assert np.array_equal(s["coeff"], _np(S.coeff))
    h = convert.systems_hierarchy_from_arrays(levels, inv, device="cpu")
    b, x0 = _crand(A.shape[0], 2, seed=5), _crand(A.shape[0], 2, seed=6)
    grids = h.fine_grids
    y_r = np.asarray(f2b_ref(sys_cycle_ref(
        cfg_r, st_r.hier, b2f_ref(jnp.asarray(b), grids),
        b2f_ref(jnp.asarray(x0), grids))))
    for hier in (h, st_p.hier):
        y_p = sg.fields_to_block(sg.systems_grid_cycle(
            cfg_p, hier, sg.block_to_fields(torch.from_numpy(b), grids),
            sg.block_to_fields(torch.from_numpy(x0), grids)))
        assert _rel(y_p, y_r) < 1e-9


@pytest.mark.parametrize("variant", ["vanka-lex", "kaczmarz-vanka"])
def test_complex_flat_vanka_cycle_matches_reference(variant):
    """One flat-engine cycle of the lex and cell-Kaczmarz variants,
    complex128, on mgtpu's hierarchy carried across by
    flat_hierarchy_from_arrays and on the port's own, within 1e-9."""
    M, Mp, A = _elasticity(8, 2, True, shift=CSHIFT)
    kw = dict(levels=2, relax_type=variant, relax_param=0.75, nu_pre=1,
              nu_post=1, transfer_type="systems-faces-mixed", engine="flat",
              dtype=np.complex128)
    cfg_r, rp = mgtpu.get_mg_param(**kw)
    cfg_p, _ = mt.get_mg_param(**kw)
    st_r = mgtpu.mg_setup(A, M, cfg_r, rp)
    st_p = mt.mg_setup(A, Mp, cfg_p, rp, device="cpu")
    h = convert.flat_hierarchy_from_arrays(*_export_flat(st_r.hier),
                                           device="cpu")
    b, x0 = _crand(A.shape[0], 2, seed=3), _crand(A.shape[0], 2, seed=4)
    y_r = np.asarray(cycle_ref(cfg_r, st_r.hier, jnp.asarray(b),
                               jnp.asarray(x0)))
    for hier in (h, st_p.hier):
        y_p = mt.recursive_cycle(cfg_p, hier, torch.from_numpy(b),
                                 torch.from_numpy(x0))
        assert _rel(y_p, y_r) < 1e-9


def test_complex_rediscretized_systems_match_reference():
    """Re-discretization (OperatorConstructor) of a complex-shifted mixed
    elasticity operator on every level keeps the value type: the levels
    bit for bit mgtpu's in complex64, the same engine, the refined
    count."""
    from mgtpu.models.operators import linear_elasticity_operator_mixed \
        as mixed_ref

    def op(mesh):
        mu = np.ones(int(np.prod(mesh.n)))
        A = mixed_ref(mesh, mu, mu)
        return (A + CSHIFT * 1e4 * sp.identity(A.shape[0])).tocsr()
    M, Mp = _meshes([16, 16])
    kw = dict(levels=3, relax_type="VankaFaces", relax_param=0.75,
              nu_pre=1, nu_post=1, dtype=np.complex64, max_outer_iter=60,
              transfer_type="SystemsFacesMixedLinear")
    st_r = mgtpu.mg_setup(mgtpu.OperatorConstructor(None, op), M,
                          *mgtpu.get_mg_param(**kw))
    st_p = mt.mg_setup(mt.OperatorConstructor(None, op), Mp,
                       *mt.get_mg_param(**kw), device="cpu")
    assert type(st_p.hier).__name__ == type(st_r.hier).__name__ == \
        "SystemsGridHierarchy"
    assert len(st_p.As) == len(st_r.As) == 3
    assert all(_same(a, b) and a.dtype == np.complex64
               for a, b in zip(st_p.As, st_r.As))
    A = op(M)
    b = ref.rhs(A)
    counts = [int(pkg.solve_mg_refined(st, b, tol=1e-8)[1]["iters"])
              for pkg, st in ((mgtpu, st_r), (mt, st_p))]
    assert counts[0] == counts[1]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lead", [(), (2,)])
def test_complex_cross_apply_matches_reference(dtype, lead):
    """Kernel D's cross form in complex: every block of a complex mixed
    elasticity operator applied by cross_apply (its plain version here,
    counted under the value type) against mgtpu's cross_stencil_matvec,
    within 1e-12 in complex128; the operator against scipy."""
    M, Mp, A = _elasticity(6, 2, True, shift=CSHIFT)
    op = sg.block_operator_from_csr(A, [6, 6], True, dtype=dtype,
                                    device="cpu")
    key = np.dtype(dtype).name
    for S in op.stencils:
        x = _crand(*(lead + S.in_grid), seed=7).astype(dtype)
        n0 = sk.PLAIN_CALLS[key]
        got = sk.cross_apply(S.coeff, S.offsets, S.in_grid,
                             torch.from_numpy(x))
        assert sk.PLAIN_CALLS[key] == n0 + 1
        want = cross_ref(jnp.asarray(_np(S.coeff)), S.offsets, S.in_grid,
                         jnp.asarray(x))
        assert got.dtype == S.coeff.dtype == torch.from_numpy(x).dtype
        assert _rel(got, np.asarray(want)) < _tol(dtype)
    xs = _crand(A.shape[0], seed=8)
    y = op.rows_matvec(torch.from_numpy(xs.astype(dtype))[None])[0]
    assert _rel(y, A @ xs) < _tol(dtype) * 10


# ---------------------------------------------------------------------------
# complex device aggregation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_complex_device_aggregation_matches_reference(dtype, monkeypatch):
    """sa_amg_setup with MGTPU_AGG=device on the complex-shifted rough
    DivSigGrad: the MIS-2 labels of every level (from the float32
    strengths of -Re A), the prolongators and every coarse operator equal
    mgtpu's bit for bit."""
    monkeypatch.setenv("MGTPU_AGG", "device")
    A = ref12.shifted_divsig([32, 32])
    kw = dict(levels=4, relax_type="spai", dtype=dtype)
    st_r = sa_ref.sa_amg_setup(A, *mgtpu.get_mg_param(**kw))
    st_p = mt.sa_amg_setup(A, *mt.get_mg_param(**kw), device="cpu")
    assert st_p.num_levels == st_r.num_levels >= 3
    for a_r, a_p in zip(st_r.As, st_p.As):
        assert _same(a_r, a_p)
    for p_r, p_p in zip(st_r.Ps, st_p.Ps):
        assert _same(p_r, p_p)
    for a in st_r.As[:-1]:
        S = sa_ref.strength_matrix(a, 0.4)
        assert np.array_equal(da_port.device_aggregation(S, device="cpu"),
                              da_ref.device_aggregation(S))


# ---------------------------------------------------------------------------
# complex64 cycles below a complex128 hierarchy
# ---------------------------------------------------------------------------

def _h_states(n=32):
    A = ref12.helmholtz([n, n], 0.125)
    M, Mp = _meshes([n, n])
    kw = dict(levels=3, relax_type="jacobi", relax_param=0.8, nu_pre=1,
              nu_post=1, dtype=np.complex128)
    st_r = mgtpu.mg_setup(A, M, *mgtpu.get_mg_param(**kw))
    st_p = mt.mg_setup(A, Mp, *mt.get_mg_param(**kw), device="cpu")
    return A, st_r, st_p


def test_complex64_cycles_below_a_complex128_hierarchy():
    """solve_mg_refined(cycle_dtype=complex64) on a complex128 hierarchy:
    mgtpu's count at a true complex128 relres below 1e-8, the cycles on
    cast_hierarchy's complex64 copy (kernel D's plain version counted in
    complex64 only for the cycles; the complex128 residual beside it), x
    complex128."""
    A, st_r, st_p = _h_states()
    b = ref.rhs(A)
    x_r, info_r = mgtpu.solve_mg_refined(st_r, b, tol=1e-8, max_iter=60,
                                         cycle_dtype=np.complex64)
    n64, n128 = sk.PLAIN_CALLS["complex64"], sk.PLAIN_CALLS["complex128"]
    x_p, info_p = mt.solve_mg_refined(st_p, b, tol=1e-8, max_iter=60,
                                      cycle_dtype=torch.complex64)
    assert info_p["iters"] == info_r["iters"]
    assert x_p.dtype == torch.complex128
    assert ref.relres(A, b, x_p) < 1e-8
    assert sk.PLAIN_CALLS["complex64"] > n64
    # the residuals: one an iteration of the chunks the device loop ran
    assert sk.PLAIN_CALLS["complex128"] - n128 <= info_p["iters"] + CHUNK
    lo = st_p._lo_hier[1]
    assert lo.levels[0].A.coeff.dtype == torch.complex64
    assert lo.coarse.inv.dtype == torch.complex64


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
def test_real_cycle_dtype_for_a_complex_hierarchy_raises(cd):
    """The one complex raise left: a real or bfloat16 cycle type for a
    complex hierarchy (torch has no complex bfloat16; a real cycle would
    drop the imaginary part)."""
    A, _, st_p = _h_states(16)
    with pytest.raises(NotImplementedError, match="imaginary part"):
        mt.solve_mg_refined(st_p, ref.rhs(A), cycle_dtype=cd)


# ---------------------------------------------------------------------------
# the contracts at 64^2 / 16^3
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("row", ref.ROWS)
def test_contract_counts_equal_reference(row, capsys):
    """Each contract row of scripts/complex_rest_reference.py at --cells
    64 --cells3d 16: the port's refined count equals mgtpu's, and both
    reach a true complex128 relres below 1e-8."""
    counts = [ref.row(row, 64, 16, p) for p in ("mgtpu", "port")]
    out = capsys.readouterr().out
    assert counts[0] == counts[1], out
    relres = [float(line.rsplit("relres ", 1)[1].split(",")[0])
              for line in out.splitlines() if "relres" in line]
    assert len(relres) == 2 and max(relres) < 1e-8, out
