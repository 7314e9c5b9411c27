"""Jac-GMRES smoothing and K-cycles on the sharded grid and systems engines
of the PyTorch port (parallel/grid_sharded.py, systems_sharded.py, and the
reduce hook of cycle/relax.py::fgmres_relaxation) against mgtpu, on CPU
gloo ranks.

mgtpu runs these options under GSPMD with the single-device cycle and has
no sharded test of them; the port runs them on R spawned gloo ranks
(parallel/launch.py) with the FGMRES Gram sums reduced over the ranks, on
the same numpy inputs: the grid engine on slabs of R in {1, 2, 4} and a
2 x 2 pencil, the systems engine on slabs.  One rank group a layout, made
once by a module-scoped fixture that runs every case of this file
(tests/_torch_ranks.py::sharded_kcycle_cases).  The bounds are those of
the other sharded options (test_torch_grid_sharded.py,
test_torch_systems_sharded.py): two f64 cycles within rtol 1e-10 of
mgtpu's single-device cycles; refined counts within one of mgtpu's
single-device count at a true relres below 1e-8; Krylov counts within one
of mgtpu's (a K-cycle preconditioner in f32 is not a fixed linear
operator) below 5e-8.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from mgtpu import get_mg_param as get_mg_param_ref
from mgtpu import mg_setup as mg_setup_ref
from mgtpu.cycle.grid_cycle import grid_cycle as grid_cycle_ref
from mgtpu.cycle.systems_grid import block_to_fields, fields_to_block
from mgtpu.cycle.systems_grid import systems_grid_cycle as systems_cycle_ref
from mgtpu.models.mesh import get_regular_mesh as mesh_ref
from mgtpu.ops.grid_stencil import flat_to_grid, grid_to_flat
from mgtpu.parallel.sharded_solve import make_sharded_refined_solver
from mgtpu.solvers.mg_solver import solve_mg_refined

import _torch_ranks as tr
from mgtpu_torch.cycle.relax import fgmres_relaxation
from mgtpu_torch.parallel.launch import run_ranks

LAYOUTS = [(1,), (2,), (4,), (2, 2)]
DEADLINE_S = 180.0          # a rank group's hard limit (a hang guard)
_GROUPS: dict = {}
_REF: dict = {}


def _group(shape):
    """Every case of this file on the rank grid `shape` (made once)."""
    if shape not in _GROUPS:
        _GROUPS[shape] = run_ranks(tr.sharded_kcycle_cases,
                                   int(np.prod(shape)), "cpu", "gloo",
                                   DEADLINE_S, args=(shape,))
    return _GROUPS[shape]


@pytest.fixture(scope="module", params=LAYOUTS,
                ids=lambda s: "x".join(map(str, s)))
def group(request):
    return request.param, _group(request.param)


@pytest.fixture(scope="module", params=[s for s in LAYOUTS if len(s) == 1],
                ids=lambda s: str(s[0]))
def slab_group(request):
    """The slab layouts' groups, which also ran the systems cases."""
    return request.param, _group(request.param)


def _mesh_ref(M):
    return mesh_ref(list(M.domain), list(np.asarray(M.n)))


def _grid_state(option, dtype=np.float64, **kw):
    key = ("grid", option, np.dtype(dtype).name)
    if key not in _REF:
        M, A = tr.poisson(tr.KCYCLE_N)
        _REF[key] = (mg_setup_ref(A, _mesh_ref(M), *get_mg_param_ref(
            **tr.kcycle_params(option, dtype, **kw))), A)
    return _REF[key]


def _systems_state(dtype=np.float64, **kw):
    key = ("systems", np.dtype(dtype).name)
    if key not in _REF:
        M, A, p = tr.kcycle_systems_case(dtype, **kw)
        _REF[key] = (mg_setup_ref(A, _mesh_ref(M), *get_mg_param_ref(**p)),
                     A)
    return _REF[key]


def _relres(A, b, x):
    return (np.linalg.norm(b - A.astype(np.float64) @ x)
            / np.linalg.norm(b))


@pytest.fixture(scope="module")
def ref_cycles():
    """mgtpu's two single-device cycles of every KCYCLE_OPTIONS entry."""
    out = {}
    for option in tr.KCYCLE_OPTIONS:
        st, A = _grid_state(option)
        bg = flat_to_grid(jnp.asarray(np.random.RandomState(3).rand(
            A.shape[0], 2)), st.hier.fine_grid)
        xg = jnp.zeros_like(bg)
        for _ in range(2):
            xg = grid_cycle_ref(st.config, st.hier, bg, xg)
        out[option] = np.asarray(grid_to_flat(xg))
    return out


@pytest.mark.parametrize("option", list(tr.KCYCLE_OPTIONS))
def test_grid_sharded_cycle_matches_single_device(group, ref_cycles, option):
    """Jac-GMRES smoothing (V) and K-cycles (Jacobi, Jac-GMRES), sharded on
    a slab or a pencil, equal mgtpu's single-device cycles (rtol 1e-10,
    as the other options), and the pad of x stays zero."""
    _, outs = group
    for o in outs:
        np.testing.assert_allclose(o[option], ref_cycles[option],
                                   rtol=1e-10, atol=1e-12)
        assert o[f"{option}_pad_zero"]


@pytest.fixture(scope="module")
def ref_refined():
    """mgtpu's single-device refined count of the f32 Jac-GMRES K-cycle."""
    st, A = _grid_state("jacgmres-K", np.float32, max_outer_iter=40)
    _, info = solve_mg_refined(st, tr.rhs(A, seed=1), tol=1e-8)
    return int(info["iters"])


def test_refined_k_cycle_meets_the_single_device_contract(group,
                                                         ref_refined):
    """ShardedGridSolver.solve_refined with Jac-GMRES K-cycles: mgtpu's
    single-device count +- 1 at a true f64 relres below 1e-8, on slabs and
    the pencil."""
    _, outs = group
    _, A = tr.poisson(tr.KCYCLE_N)
    b = tr.rhs(A, seed=1)
    for o in outs:
        x, it = o["refined"]
        assert abs(it - ref_refined) <= 1
        assert _relres(A, b, x) < 1e-8


_KRYLOV: dict = {}


def _ref_krylov(name):
    """mgtpu's count of a Krylov solve preconditioned by the f32 K-cycle,
    on a one-device mesh."""
    if name not in _KRYLOV:
        st, A = _grid_state("jacgmres-K", np.float32, max_outer_iter=40)
        s1 = make_sharded_refined_solver(
            st, Mesh(np.array(jax.devices()[:1]), ("x",)))
        b = np.random.RandomState(3).rand(A.shape[0])
        _, info = getattr(s1, name)(b / np.linalg.norm(b), tol=1e-8,
                                    max_iter=30)
        _KRYLOV[name] = int(info["iters"])
    return _KRYLOV[name]


@pytest.mark.parametrize("name", ["solve_fgmres", "solve_cg",
                                  "solve_bicgstab"])
def test_krylov_k_cycle_counts_match_reference(group, name):
    """f64 outer, the f32 Jac-GMRES K-cycle as the preconditioner, the
    inner products and the cycle's Gram sums reduced over the ranks:
    mgtpu's count +- 1 below 5e-8, on slabs and the pencil."""
    _, outs = group
    _, A = tr.poisson(tr.KCYCLE_N)
    b = np.random.RandomState(3).rand(A.shape[0])
    b /= np.linalg.norm(b)
    want = _ref_krylov(name)
    for o in outs:
        x, it = o[name]
        assert abs(it - want) <= 1
        assert _relres(A, b, x) < 5e-8


@pytest.fixture(scope="module")
def ref_systems_cycle():
    """mgtpu's two single-device systems K-cycles (2 right-hand sides)."""
    st, A = _systems_state()
    bf = block_to_fields(jnp.asarray(np.random.RandomState(3).rand(
        A.shape[0], 2)), st.hier.fine_grids)
    xf = tuple(jnp.zeros_like(t) for t in bf)
    for _ in range(2):
        xf = systems_cycle_ref(st.config, st.hier, bf, xf)
    return np.asarray(fields_to_block(xf))


def test_systems_k_cycle_matches_single_device(slab_group,
                                               ref_systems_cycle):
    """Two sharded systems K-cycles (mixed elasticity, VankaFaces, 4
    levels, f64) within rtol 1e-10 of mgtpu's single-device cycles; the
    pad of x zero."""
    _, outs = slab_group
    for o in outs:
        np.testing.assert_allclose(o["systems"], ref_systems_cycle,
                                   rtol=1e-10, atol=1e-11)
        assert o["systems_pad_zero"]


def test_systems_k_cycle_dead_slot_stays_zero(slab_group):
    """Every K-cycle FGMRES took the reduce hook, and the dead slot (the
    top face plane of a rank below the last) is zero in its right-hand
    side and in every Krylov vector z and A z; the rows view leaves it out
    of the Gram sums besides."""
    _, outs = slab_group
    for o in outs:
        dead, calls, reduced = o["systems_dead"]
        assert calls > 0 and reduced
        assert dead == 0.0


@pytest.fixture(scope="module")
def ref_systems_refined():
    st, A = _systems_state(np.float32, max_outer_iter=40)
    _, info = solve_mg_refined(st, tr.rhs(A, seed=9), tol=1e-8)
    return int(info["iters"]), A


def test_systems_refined_k_cycle(slab_group, ref_systems_refined):
    """ShardedSystemsSolver.solve_refined with K-cycles: mgtpu's
    single-device count +- 1 at a true f64 relres below 1e-8."""
    _, outs = slab_group
    want, A = ref_systems_refined
    b = tr.rhs(A, seed=9)
    for o in outs:
        x, it = o["systems_refined"]
        assert abs(it - want) <= 1
        assert _relres(A, b, x) < 1e-8


def _block_problem(nblocks=4, p=30, m=2, seed=0):
    """A block-diagonal SPD matrix (one block a rank's rows), a
    right-hand side and a Jacobi diagonal, float64."""
    rng = np.random.RandomState(seed)
    blocks = []
    for _ in range(nblocks):
        B = rng.rand(p, p)
        blocks.append(B @ B.T + p * np.eye(p))
    A = np.zeros((nblocks * p, nblocks * p))
    for k, B in enumerate(blocks):
        A[k * p:(k + 1) * p, k * p:(k + 1) * p] = B
    r0 = rng.rand(nblocks * p, m)
    return (torch.tensor(A), torch.tensor(r0),
            torch.tensor(0.8 / np.diag(A))[:, None])


@pytest.mark.parametrize("inner", [1, 2, 3])
def test_fgmres_relaxation_on_row_blocks_equals_the_whole(inner):
    """fgmres_relaxation on each rank's rows with `reduce` summing the
    stacked (inner, inner + 1) Gram system over the blocks gives the
    whole vector's correction (1e-12); `reduce` is called once a call.
    (From five steps on, this well-conditioned problem's Krylov vectors are
    nearly dependent and the normal equations turn the blocks' other
    summation order into 3e-7.)"""
    A, r0, d = _block_problem()
    whole = fgmres_relaxation(lambda v: A @ v, lambda v: d * v, r0,
                              torch.zeros_like(r0), inner)
    p = 30
    rows = [slice(k * p, (k + 1) * p) for k in range(4)]
    local, shapes = [], []

    def keep(t):
        local.append(t.clone())
        shapes.append(tuple(t.shape))
        return t

    for sl in rows:         # each block's own Gram system
        fgmres_relaxation(lambda v, sl=sl: A[sl, sl] @ v,
                          lambda v, sl=sl: d[sl] * v, r0[sl],
                          torch.zeros_like(r0[sl]), inner, keep)
    total = sum(local)
    parts = [fgmres_relaxation(lambda v, sl=sl: A[sl, sl] @ v,
                               lambda v, sl=sl: d[sl] * v, r0[sl],
                               torch.zeros_like(r0[sl]), inner,
                               lambda t: total.clone())
             for sl in rows]
    assert shapes == [(inner, inner + 1)] * 4
    np.testing.assert_allclose(torch.cat(parts).numpy(), whole.numpy(),
                               rtol=1e-12, atol=1e-14)


def test_fgmres_relaxation_without_reduce_is_unchanged():
    """An identity `reduce` gives bit for bit what no `reduce` gives: the
    single-device path is the same arithmetic."""
    A, r0, d = _block_problem(seed=1)
    kw = dict(matvec=lambda v: A @ v, prec=lambda v: d * v, r0=r0,
              x0=torch.zeros_like(r0), inner=4)
    assert torch.equal(fgmres_relaxation(**kw),
                       fgmres_relaxation(**kw, reduce=lambda t: t.clone()))
