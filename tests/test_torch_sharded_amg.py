"""The row-sharded flat tier of the PyTorch port's multi-device layer
(mgtpu_torch/parallel/sharded_amg.py) against mgtpu, on CPU gloo ranks.

mgtpu runs its sharded AMG tier on jax.devices()[:R] of conftest's virtual
CPU devices (GSPMD); the port runs R spawned gloo ranks
(parallel/launch.py) on the same numpy inputs, R in {1, 2, 4}.  One rank
group a layout, made once by a module-scoped fixture that runs every case
of this file (tests/_torch_ranks.py::sharded_amg_cases); each case is its
own test.  The operator and bounds are mgtpu's tests/test_sharded_amg.py:
one cycle within 1e-5 (f32, :67) of mgtpu's single-device recursive_cycle,
1e-10 in f64; refined counts within one of mgtpu's single-device
solve_mg_refined at a true f64 relres below 1e-8; FGMRES below 1e-4 at
tol 1e-5 (:102).  The padded rows equal mgtpu's arrays exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from mgtpu import get_mg_param as get_mg_param_ref
from mgtpu.cycle.cycle import recursive_cycle as cycle_ref
from mgtpu.parallel.sharded_amg import shard_flat_hierarchy as shard_ref
from mgtpu.setup.classical_amg import classical_amg_setup as cl_ref
from mgtpu.setup.sa_amg import sa_amg_setup as sa_ref
from mgtpu.solvers.mg_solver import solve_mg_refined

import _torch_ranks as tr
from mgtpu_torch.parallel.launch import run_ranks
from mgtpu_torch.parallel.sharded_amg import pad_flat_hierarchy

WORLDS = [1, 2, 4]
DEADLINE_S = 180.0          # a rank group's hard limit (a hang guard)
_GROUPS: dict = {}
_REF: dict = {}
L = tr.amg_problem()


def _ref_state(kind, dtype, **kw):
    """mgtpu's flat state of the same operator and parameters."""
    key = (kind, np.dtype(dtype).name, tuple(sorted(kw.items())))
    if key not in _REF:
        cfg, rp = get_mg_param_ref(**tr.amg_params(dtype, **kw))
        _REF[key] = (sa_ref(L, cfg, rp) if kind == "sa"
                     else cl_ref(L, cfg, rp, coarsening="pmis"))
    return _REF[key]


def _mesh(R):
    return Mesh(np.array(jax.devices()[:R]), ("x",))


def _ell(op):
    return dict(indices=np.asarray(op.indices), values=np.asarray(op.values),
                shape=op.shape)


def _padded_arrays(hier):
    """mgtpu's shard_flat_hierarchy as the mappings of
    convert.sharded_flat_from_arrays (a DenseLU coarsest)."""
    levels = []
    for lv in hier.levels:
        m = dict(A=_ell(lv.A))
        if lv.P is not None:
            m.update(P=_ell(lv.P), R=_ell(lv.R), d=np.asarray(lv.relax.d))
        levels.append(m)
    c = hier.coarse
    return (levels, dict(lu=np.asarray(c.inner.lu),
                         piv=np.asarray(c.inner.piv)), c.nc)


def _group(world):
    """Every case of this file on `world` gloo ranks (made once)."""
    if world not in _GROUPS:
        st = _ref_state("sa", np.float32)
        ref_padded = _padded_arrays(shard_ref(st.hier, _mesh(world)))
        _GROUPS[world] = run_ranks(tr.sharded_amg_cases, world, "cpu",
                                   "gloo", DEADLINE_S, args=(ref_padded,))
    return _GROUPS[world]


@pytest.fixture(scope="module", params=WORLDS, ids=str)
def group(request):
    return request.param, _group(request.param)


_CYCLES: dict = {}


def _ref_cycle(name):
    """mgtpu's single-device cycle of an AMG_CYCLES case from zero."""
    if name not in _CYCLES:
        kind, dt, ctype = tr.AMG_CYCLES[name]
        st = _ref_state(kind, dt, cycle_type=ctype)
        b = jnp.asarray(np.random.RandomState(2).rand(L.shape[0], 2)
                        .astype(dt))
        _CYCLES[name] = np.asarray(cycle_ref(st.config, st.hier, b,
                                             jnp.zeros_like(b)))
    return _CYCLES[name]


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def _relres(b, x):
    return (np.linalg.norm(b - L.astype(np.float64) @ x)
            / np.linalg.norm(b))


def _same(a, b):
    assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("R", [3, 4, 8])
@pytest.mark.parametrize("kind", ["sa", "cl"])
def test_padded_rows_equal_mgtpus(kind, R):
    """pad_flat_hierarchy's rows are mgtpu's shard_flat_hierarchy arrays,
    bit for bit: every level's ELL (the DIA levels converted), P, R, the
    smoother diagonals, the coarsest's true size."""
    st = tr.amg_setup(kind, L, **tr.amg_params(np.float32))
    ours = pad_flat_hierarchy(st.hier, R)
    ref = shard_ref(_ref_state(kind, np.float32).hier, _mesh(R))
    assert len(ours.levels) == len(ref.levels)
    for lo, lr in zip(ours.levels, ref.levels):
        for a, b in ((lo.A, lr.A), (lo.P, lr.P), (lo.R, lr.R)):
            assert (a is None) == (b is None)
            if a is not None:
                assert tuple(a.shape) == tuple(b.shape)
                _same(a.indices, b.indices)
                _same(a.values, b.values)
        assert (lo.relax is None) == (lr.relax is None)
        if lo.relax is not None:
            _same(lo.relax.d, lr.relax.d)
    assert ours.coarse.nc == ref.coarse.nc


@pytest.mark.parametrize("name", list(tr.AMG_CYCLES))
def test_sharded_cycle_matches_single_device(group, name):
    """One sharded cycle (V, W or K; Jacobi 0.8) equals mgtpu's
    single-device recursive_cycle: 1e-5 relative in f32, 1e-10 in f64.
    The f32 K-cycle is held to 1e-4, the port's bound for FGMRES
    projections in f32 against mgtpu (ROADMAP queue 3: they amplify the
    summation order; one rank, the port's single-device cycle, is 2.2e-5
    off); in f64 it meets 1e-10."""
    _, outs = group
    kind, dt, ctype = tr.AMG_CYCLES[name]
    tol = (1e-10 if dt == np.float64 else 1e-4 if ctype == "K" else 1e-5)
    ref = _ref_cycle(name)
    for o in outs:
        assert _rel(o[name], ref) <= tol


@pytest.mark.parametrize("name", list(tr.AMG_CYCLES))
def test_sharded_cycle_agrees_across_layouts(group, name):
    """Rows split over R ranks give one rank's cycle: the row products
    are the same sums, the vectors replicated (1e-6 relative in f32,
    1e-12 in f64)."""
    _, outs = group
    tol = 1e-12 if tr.AMG_CYCLES[name][1] == np.float64 else 1e-6
    y1 = _group(1)[0][name]
    for o in outs:
        assert _rel(o[name], y1) <= tol


@pytest.mark.parametrize("name", [k for k in tr.AMG_CYCLES
                                  if k not in ("sa", "cl")])
def test_pad_rows_stay_zero(group, name):
    _, outs = group
    assert all(o[f"{name}_pad_zero"] for o in outs)


def test_cycle_from_mgtpus_padded_arrays(group):
    """convert.sharded_flat_from_arrays on mgtpu's row-padded hierarchy
    gives the same cycle."""
    _, outs = group
    for o in outs:
        assert _rel(o["convert"], _ref_cycle("sa")) <= 1e-5


@pytest.fixture(scope="module")
def ref_refined():
    b = tr.rhs(L, seed=3)
    return {kind: int(solve_mg_refined(_ref_state(kind, np.float32), b,
                                       tol=1e-8, max_iter=80)[1]["iters"])
            for kind in ("sa", "cl")}


@pytest.mark.parametrize("kind", ["sa", "cl"])
def test_refined_meets_the_single_device_contract(group, ref_refined, kind):
    """The sharded refined solve (f32 hierarchy, f64 residual): mgtpu's
    single-device count +- 1 at a true f64 relres below 1e-8."""
    _, outs = group
    b = tr.rhs(L, seed=3)
    for o in outs:
        x, it = o[f"refined_{kind}"]
        assert abs(it - ref_refined[kind]) <= 1
        assert _relres(b, x) < 1e-8


@pytest.mark.parametrize("kind", ["sa", "cl"])
def test_refined_agrees_across_layouts(group, kind):
    """x within 1e-6 of one rank's, the same count."""
    _, outs = group
    x1, it1 = _group(1)[0][f"refined_{kind}"]
    for o in outs:
        x, it = o[f"refined_{kind}"]
        assert it == it1
        assert np.abs(x - x1).max() <= 1e-6 * np.abs(x1).max()


def test_fgmres_reaches_mgtpus_bound(group):
    """FGMRES in f32 on replicated operands: a true relres below 1e-4 at
    tol 1e-5 (test_sharded_amg.py:102)."""
    _, outs = group
    b = tr.rhs(L, seed=4)
    for o in outs:
        x, _ = o["fgmres"]
        assert _relres(b, np.asarray(x, np.float64)) < 1e-4


@pytest.mark.parametrize("what", ["jacgmres", "vanka", "grid"])
def test_refusals(group, what):
    """A smoother that is not pointwise (Jac-GMRES, lexicographic Vanka)
    and a grid-engine state are refused."""
    _, outs = group
    assert all(o[f"refuses_{what}"] for o in outs)


def test_byte_counts_follow_the_collectives(group):
    """The tier's one collective is the all-gather after each row
    product: one rank sends nothing, several only gather."""
    world, outs = group
    for o in outs:
        sent = o["sent"]
        if world == 1:
            assert not any(sent.values())
        else:
            assert sent["all_gather"] > 0
            assert not any(v for k, v in sent.items() if k != "all_gather")
