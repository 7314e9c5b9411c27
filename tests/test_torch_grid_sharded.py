"""The grid-sharded cycle and the sharded solves of the PyTorch port
(mgtpu_torch/parallel/grid_sharded.py, sharded_solve.py, and the Krylov
reductions of krylov/) against mgtpu, on CPU gloo ranks.

mgtpu runs these on jax.devices()[:R] of conftest's virtual CPU devices
(GSPMD); the port runs R spawned gloo ranks (parallel/launch.py) on the
same numpy inputs: slabs on R in {1, 2, 4} and a 2 x 2 pencil.  One rank
group a layout, made once by a module-scoped fixture that runs every case
of this file (tests/_torch_ranks.py::grid_sharded_cases); each case is its
own test.  Tolerances are mgtpu's own (tests/test_grid_sharded.py,
test_sharded_solve.py): the cycle within rtol 1e-10 (f64) of the
single-device cycle; refined counts equal, residual histories within 2e-6
and x within 1e-6 across layouts, true relres below 1e-8; Krylov counts
equal to mgtpu's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from mgtpu import get_mg_param as get_mg_param_ref
from mgtpu import mg_setup as mg_setup_ref
from mgtpu.cycle.grid_cycle import grid_cycle as grid_cycle_ref
from mgtpu.models.mesh import get_regular_mesh as mesh_ref
from mgtpu.ops.grid_stencil import flat_to_grid, grid_to_flat
from mgtpu.parallel.sharded_solve import make_sharded_refined_solver
from mgtpu.solvers.mg_solver import solve_mg_refined

import _torch_ranks as tr
from mgtpu_torch.parallel.launch import run_ranks

LAYOUTS = [(1,), (2,), (4,), (2, 2)]
_GROUPS: dict = {}


def _group(shape):
    """Every case of this file on the rank grid `shape` (made once)."""
    if shape not in _GROUPS:
        _GROUPS[shape] = run_ranks(tr.grid_sharded_cases,
                                   int(np.prod(shape)), "cpu", "gloo",
                                   tr.DEADLINE_S, args=(shape,))
    return _GROUPS[shape]


@pytest.fixture(scope="module", params=LAYOUTS,
                ids=lambda s: "x".join(map(str, s)))
def group(request):
    return request.param, _group(request.param)


@pytest.fixture(scope="module", params=[s for s in LAYOUTS if len(s) == 1],
                ids=lambda s: str(s[0]))
def slab_group(request):
    """The slab layouts' groups, which also ran the Krylov cases."""
    return request.param, _group(request.param)


def _ref_state(n, levels, dtype, **kw):
    M, A = tr.poisson(n)
    Mr = mesh_ref(list(M.domain), list(np.asarray(M.n)))
    cfg, rp = get_mg_param_ref(**tr.params(levels, dtype, **kw))
    return mg_setup_ref(A, Mr, cfg, rp), A


@pytest.fixture(scope="module")
def ref_cycle():
    """mgtpu's three single-device cycles on the same inputs."""
    st, A = _ref_state(tr.CYCLE_N, tr.CYCLE_LEVELS, np.float64)
    bg = flat_to_grid(jnp.asarray(np.random.RandomState(3).rand(
        A.shape[0], 2)), st.hier.fine_grid)
    xg = jnp.zeros_like(bg)
    for _ in range(3):
        xg = grid_cycle_ref(st.config, st.hier, bg, xg)
    return np.asarray(grid_to_flat(xg))


@pytest.fixture(scope="module")
def ref_options():
    """mgtpu's two single-device cycles of each CYCLE_OPTIONS entry."""
    M, A = tr.poisson(tr.CYCLE_N)
    Mr = mesh_ref(list(M.domain), list(np.asarray(M.n)))
    out = {}
    for option in tr.CYCLE_OPTIONS:
        st = mg_setup_ref(A, Mr, *get_mg_param_ref(**tr.cycle_params(option)))
        bg = flat_to_grid(jnp.asarray(np.random.RandomState(3).rand(
            A.shape[0], 2)), st.hier.fine_grid)
        xg = jnp.zeros_like(bg)
        for _ in range(2):
            xg = grid_cycle_ref(st.config, st.hier, bg, xg)
        out[option] = np.asarray(grid_to_flat(xg))
    return out


@pytest.fixture(scope="module")
def ref_solve():
    """mgtpu's f32 hierarchy of the solve problem and its operator."""
    return _ref_state(tr.SOLVE_N, tr.SOLVE_LEVELS, np.float32,
                      max_outer_iter=40, relative_tol=1e-6)


@pytest.fixture(scope="module")
def ref_refined(ref_solve):
    """mgtpu's single-device refined count and residual history."""
    st, A = ref_solve
    _, info = solve_mg_refined(st, tr.rhs(A, seed=1), tol=1e-8)
    return int(info["iters"]), np.asarray(info["resvec"])


_KRYLOV: dict = {}


def _ref_krylov(ref_solve, name):
    """mgtpu's count of a Krylov solve on a one-device mesh."""
    if name not in _KRYLOV:
        st, A = ref_solve
        s1 = make_sharded_refined_solver(
            st, Mesh(np.array(jax.devices()[:1]), ("x",)))
        b = np.random.RandomState(3).rand(A.shape[0])
        _, info = getattr(s1, name)(b / np.linalg.norm(b), tol=1e-8,
                                    max_iter=30)
        _KRYLOV[name] = int(info["iters"])
    return _KRYLOV[name]


def _relres(A, b, x):
    return (np.linalg.norm(b - A.astype(np.float64) @ x)
            / np.linalg.norm(b))


def test_grid_sharded_cycle_matches_single_device(group, ref_cycle):
    """Three sharded cycles equal three single-device cycles
    (test_grid_sharded.py: slab and pencil, rtol 1e-10)."""
    _, outs = group
    for o in outs:
        np.testing.assert_allclose(o["cycle"], ref_cycle, rtol=1e-10,
                                   atol=1e-12)


@pytest.mark.parametrize("option", list(tr.CYCLE_OPTIONS))
def test_grid_sharded_cycle_options_match_single_device(group, ref_options,
                                                        option):
    """Chebyshev (W and V, degree 3 and 4) and SPAI (F) cycles, sharded,
    equal mgtpu's single-device cycles (rtol 1e-10, as the Jacobi V)."""
    _, outs = group
    for o in outs:
        np.testing.assert_allclose(o[option], ref_options[option],
                                   rtol=1e-10, atol=1e-12)


def test_refined_meets_the_single_device_contract(group, ref_solve,
                                                 ref_refined):
    """The sharded refined solve takes mgtpu's single-device count, its
    residual history (rtol 1e-5, test_sharded_solve.py:97) and a true f64
    relres below 1e-8."""
    _, outs = group
    iters, resvec = ref_refined
    A = ref_solve[1]
    b = tr.rhs(A, seed=1)
    for o in outs:
        x, it, rv = o["refined"]
        assert it == iters
        assert np.allclose(rv, resvec, rtol=1e-5)
        assert _relres(A, b, x) < 1e-8


def test_refined_trajectory_agrees_across_layouts(group):
    """Against one rank: the same count, residual histories within 2e-6
    and x within 1e-6 (mgtpu's bounds, test_sharded_solve.py:84-88)."""
    _, outs = group
    x1, it1, rv1 = _group((1,))[0]["refined"]
    for o in outs:
        x, it, rv = o["refined"]
        assert it == it1
        assert np.all(np.abs(rv - rv1) <= 2e-6 * np.maximum(rv1, 1e-30))
        assert np.max(np.abs(x - x1)) <= 1e-6 * max(np.abs(x1).max(), 1e-30)


def test_refined_multirhs(group):
    _, outs = group
    _, A = tr.poisson(tr.SOLVE_N)
    B = np.random.RandomState(2).rand(A.shape[0], 3)
    for o in outs:
        x, _ = o["refined_multi"]
        assert x.shape == B.shape
        assert _relres(A, B, x) < 1e-8


@pytest.mark.parametrize("name", ["solve_fgmres", "solve_cg",
                                  "solve_bicgstab"])
def test_krylov_counts_match_reference(slab_group, ref_solve, name):
    """f64 outer, f32 cycle preconditioner, inner products summed over the
    ranks: mgtpu's count, a true relres below 5e-8."""
    _, outs = slab_group
    A = ref_solve[1]
    b = np.random.RandomState(3).rand(A.shape[0])
    b /= np.linalg.norm(b)
    want = _ref_krylov(ref_solve, name)
    for o in outs:
        x, it = o[name]
        assert it == want
        assert _relres(A, b, x) < 5e-8


def test_fgmres_f32_operands(slab_group):
    """Hierarchy-precision (f32) FGMRES on sharded operands converges to
    f32's attainable relres (test_sharded_solve.py:100-111)."""
    _, outs = slab_group
    _, A = tr.poisson(tr.SOLVE_N)
    b = np.random.RandomState(4).rand(A.shape[0]).astype(np.float32)
    for o in outs:
        x, _ = o["fgmres_f32"]
        assert _relres(A, b, np.asarray(x, np.float64)) < 1e-3


def test_block_cg_multirhs(slab_group):
    """Shared-space block CG on sharded operands: every column below 1e-6,
    in no more iterations than the batched CG."""
    _, outs = slab_group
    _, A = tr.poisson(tr.SOLVE_N)
    rng = np.random.RandomState(5)
    base = rng.rand(A.shape[0], 1)
    B = base + 0.05 * rng.rand(A.shape[0], 3)
    for o in outs:
        (xb, ib), (_, ia) = o["block_cg"]
        r = np.linalg.norm(B - A @ xb, axis=0)
        assert np.all(r / np.linalg.norm(B, axis=0) < 1e-6)
        assert ib <= ia


def test_byte_counts_follow_the_collectives(group):
    """One rank sends nothing; several exchange halos, reduce-scatter the
    restrictions, gather the prolongations and the coarsest, all-reduce
    the norms."""
    shape, outs = group
    for o in outs:
        sent = o["sent"]
        if int(np.prod(shape)) == 1:
            assert not any(sent.values())
        else:
            assert all(sent[k] > 0 for k in ("halo", "psum", "all_gather",
                                              "reduce_scatter"))


METHODS = ["pcg", "bicgstab", "block_pcg", "block_bicgstab", "fgmres",
           "block_fgmres"]


@pytest.mark.parametrize("method", METHODS)
def test_krylov_without_a_group_is_the_single_device_path(method):
    """The rank reduction hook (krylov/_layout.py's `reduce`) is the only
    change to the Krylov code: with an identity reduction every method
    returns bit for bit what it returns without one (the single-device
    path), and the hook sees every inner product."""
    import torch
    from mgtpu_torch import krylov
    from mgtpu_torch.krylov.block import block_bicgstab, block_pcg
    from mgtpu_torch.ops.grid_stencil import flat_to_grid as to_grid
    M, A = tr.poisson(16)
    st = tr.setup(M, A, **tr.params(2, np.float64))
    grid = st.hier.fine_grid
    B = to_grid(torch.tensor(tr.rhs(A, 2, seed=7)), grid)
    d = st.hier.levels[0].d
    fn = {"pcg": krylov.pcg, "bicgstab": krylov.bicgstab,
          "block_pcg": block_pcg, "block_bicgstab": block_bicgstab,
          "fgmres": krylov.fgmres, "block_fgmres": krylov.block_fgmres}[
        method]
    calls = []

    def ident(s):
        calls.append(1)
        return s.clone()

    kw = dict(prec=lambda r: d * r, tol=1e-10, max_iter=6,
              device_loop=False)
    x0, i0 = fn(st.hier.levels[0].A.matvec, B, **kw)
    x1, i1 = fn(st.hier.levels[0].A.matvec, B, reduce=ident, **kw)
    assert calls
    assert torch.equal(x0, x1) and i0["iters"] == i1["iters"]
    assert np.array_equal(np.asarray(i0["resvec"]),
                          np.asarray(i1["resvec"]))


@pytest.fixture(scope="module")
def ref_refined_f64_cycles(ref_solve):
    """mgtpu's sharded refined count with float64 cycles of the float32
    hierarchy (its cycle_dtype), on a one-device mesh."""
    st, A = ref_solve
    s1 = make_sharded_refined_solver(
        st, Mesh(np.array(jax.devices()[:1]), ("x",)))
    _, info = s1.solve_refined(tr.rhs(A, seed=1), tol=1e-8,
                               cycle_dtype=np.float64)
    return int(info["iters"])


def test_refined_cycle_dtype_matches_mgtpu(group, ref_solve,
                                           ref_refined_f64_cycles):
    """solve_refined's cycle_dtype (mgtpu's argument): float64 cycles of
    the float32 hierarchy take mgtpu's count +- 1 at a true f64 relres
    below 1e-8."""
    _, outs = group
    A = ref_solve[1]
    b = tr.rhs(A, seed=1)
    for o in outs:
        x, it = o["refined_f64_cycles"]
        assert abs(it - ref_refined_f64_cycles) <= 1
        assert _relres(A, b, x) < 1e-8
