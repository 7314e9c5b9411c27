"""The systems tier of the PyTorch port's multi-device layer
(mgtpu_torch/parallel/systems_sharded.py, sharded_solve.py's
ShardedSystemsSolver) against mgtpu, on CPU gloo ranks.

mgtpu runs its systems tier on jax.devices()[:D] of conftest's virtual CPU
devices (GSPMD); the port runs D spawned gloo ranks (parallel/launch.py)
on the same numpy inputs, D in {1, 2, 4}.  One rank group a layout, made
once by a module-scoped fixture that runs every case of this file
(tests/_torch_ranks.py::systems_sharded_cases); each case is its own test.
Tolerances are mgtpu's (tests/test_systems_sharded.py:57,
test_sharded_solve.py:173-200): two cycles within rtol 1e-10, atol 1e-11
(f64) of mgtpu's single-device cycle; the refined count within one of
mgtpu's single-device count at a true f64 relres below 1e-8; x within
1e-6 across layouts.  The padded embedding equals mgtpu's arrays exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgtpu import get_mg_param as get_mg_param_ref
from mgtpu import get_regular_mesh as mesh_ref
from mgtpu import mg_setup as mg_setup_ref
from mgtpu.cycle.systems_grid import block_to_fields, fields_to_block
from mgtpu.cycle.systems_grid import systems_grid_cycle as cycle_ref
from mgtpu.parallel.systems_sharded import (
    pad_systems_hierarchy as pad_ref)
from mgtpu.solvers.mg_solver import solve_mg_refined

import _torch_ranks as tr
from mgtpu_torch.parallel.launch import run_ranks
from mgtpu_torch.parallel.systems_sharded import (pad_systems_hierarchy,
                                                  stacked_order)

WORLDS = [1, 2, 4]
DEADLINE_S = 180.0          # a rank group's hard limit (a hang guard)
_GROUPS: dict = {}
_REF: dict = {}


def _ref_state(name, dtype=np.float64, **kw):
    """mgtpu's state of a tests/_torch_ranks.py systems case (the same
    scipy operator and parameters) and its operator."""
    key = (name, np.dtype(dtype).name, tuple(sorted(kw.items())))
    if key not in _REF:
        M, A, p = tr.systems_case(name, dtype, **kw)
        Mr = mesh_ref(list(M.domain), list(np.asarray(M.n)))
        _REF[key] = (mg_setup_ref(A, Mr, *get_mg_param_ref(**p)), A)
    return _REF[key]


def _np(a):
    return None if a is None else np.asarray(a)


def _padded_arrays(gh_pad):
    """mgtpu's padded systems hierarchy as the mappings of
    convert.sharded_systems_from_arrays."""
    levels = []
    for lv in gh_pad.levels:
        vk = lv.vanka
        levels.append(dict(
            stencils=[dict(coeff=_np(s.coeff), offsets=s.offsets,
                           in_grid=s.in_grid) for s in lv.A.stencils],
            pairs=lv.A.pairs, grids=lv.A.grids,
            d=None if lv.d is None else [_np(d) for d in lv.d],
            vanka=None if vk is None else dict(
                dinv=_np(vk.dinv), masks=_np(vk.masks), slots=vk.slots,
                cell_grid=vk.cell_grid, variant=vk.variant),
            P1=None if lv.P1 is None else [[_np(f) for f in c]
                                           for c in lv.P1],
            R1=None if lv.R1 is None else [[_np(f) for f in c]
                                           for c in lv.R1]))
    c = gh_pad.coarse
    return levels, _np(c.inner.inv), c.true_grids


def _group(world):
    """Every case of this file on `world` gloo ranks (made once)."""
    if world not in _GROUPS:
        st, _ = _ref_state("mixed")
        ref_padded = _padded_arrays(pad_ref(st.hier, world)[0])
        _GROUPS[world] = run_ranks(tr.systems_sharded_cases, world, "cpu",
                                   "gloo", DEADLINE_S, args=(ref_padded,))
    return _GROUPS[world]


@pytest.fixture(scope="module", params=WORLDS, ids=str)
def group(request):
    return request.param, _group(request.param)


_CYCLES: dict = {}


def _ref_cycle(name):
    """mgtpu's two single-device cycles of a case (2 right-hand sides)."""
    if name not in _CYCLES:
        st, A = _ref_state(name)
        bf = block_to_fields(jnp.asarray(np.random.RandomState(3).rand(
            A.shape[0], 2)), st.hier.fine_grids)
        xf = tuple(jnp.zeros_like(t) for t in bf)
        for _ in range(2):
            xf = cycle_ref(st.config, st.hier, bf, xf)
        _CYCLES[name] = np.asarray(fields_to_block(xf))
    return _CYCLES[name]


@pytest.fixture(scope="module")
def ref_refined():
    """mgtpu's single-device refined count of the solve case (f32)."""
    st, A = _ref_state("solve", np.float32, max_outer_iter=40)
    _, info = solve_mg_refined(st, tr.rhs(A, seed=9), tol=1e-8)
    return int(info["iters"]), A


def _relres(A, b, x):
    return (np.linalg.norm(b - A.astype(np.float64) @ x)
            / np.linalg.norm(b))


def _same(a, b):
    assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("D", [2, 4, 8])
@pytest.mark.parametrize("name", ["mixed", "spai", "mixed3d"])
def test_padded_arrays_equal_mgtpus(name, D):
    """pad_systems_hierarchy's arrays are mgtpu's, bit for bit: stencils,
    diagonals, Vanka inverses and masks, transfer factors, the coarsest
    inverse and its grids (2D mixed, 2D plain and 3D mixed)."""
    M, A, p = tr.systems_case(name)
    ours, pg = pad_systems_hierarchy(tr.setup(M, A, **p).hier, D)
    st, _ = _ref_state(name)
    ref, pg_ref = pad_ref(st.hier, D)
    assert tuple(pg) == tuple(pg_ref)
    for lo, lr in zip(ours.levels, ref.levels):
        assert lo.A.grids == lr.A.grids and lo.A.pairs == lr.A.pairs
        for so, sr in zip(lo.A.stencils, lr.A.stencils):
            assert so.offsets == sr.offsets and so.in_grid == sr.in_grid
            assert so.out_grid == sr.out_grid
            _same(so.coeff, sr.coeff)
        assert (lo.d is None) == (lr.d is None)
        for a, b in zip(lo.d or (), lr.d or ()):
            _same(a, b)
        assert (lo.vanka is None) == (lr.vanka is None)
        if lo.vanka is not None:
            _same(lo.vanka.dinv, lr.vanka.dinv)
            _same(lo.vanka.masks, lr.vanka.masks)
            assert lo.vanka.slots == lr.vanka.slots
            assert lo.vanka.cell_grid == lr.vanka.cell_grid
        for fo, fr in ((lo.P1, lr.P1), (lo.R1, lr.R1)):
            assert (fo is None) == (fr is None)
            for co, cr in zip(fo or (), fr or ()):
                for a, b in zip(co, cr):
                    _same(a, b)
    _same(ours.coarse.inner.inv, ref.coarse.inner.inv)
    assert ours.coarse.pad_grids == ref.coarse.pad_grids
    assert ours.coarse.true_grids == ref.coarse.true_grids


@pytest.mark.parametrize("D", [1, 2, 3, 4])
def test_stacked_order_is_a_cell_aligned_permutation(D):
    """The face component's blocks: each rank's S faces under its cells,
    then the top face on the last rank and a pad face elsewhere."""
    S = 3
    C = S * D
    order = stacked_order(C + D, C, D)
    assert sorted(order) == list(range(C + D))
    for k in range(D):
        blk = order[k * (S + 1):(k + 1) * (S + 1)]
        assert list(blk[:S]) == list(range(k * S, (k + 1) * S))
        assert blk[S] == (C if k == D - 1 else C + 1 + k)
    assert list(stacked_order(C, C, D)) == list(range(C))


@pytest.mark.parametrize("name", list(tr.SYSTEMS_CYCLES))
def test_sharded_cycles_match_single_device(group, name):
    """Two sharded cycles (f64, 2 right-hand sides) equal mgtpu's two
    single-device systems_grid_cycle calls (rtol 1e-10, atol 1e-11):
    coloured, econ and additive Vanka, the SPAI form, 3D mixed."""
    _, outs = group
    ref = _ref_cycle(name)
    for o in outs:
        np.testing.assert_allclose(o[name], ref, rtol=1e-10, atol=1e-11)


@pytest.mark.parametrize("name", list(tr.SYSTEMS_CYCLES))
def test_pad_stays_zero(group, name):
    """After the cycles every pad plane of x, the dead slots among them,
    is exactly zero."""
    _, outs = group
    assert all(o[f"{name}_pad_zero"] for o in outs)


def test_cycle_from_mgtpus_padded_arrays(group):
    """convert.sharded_systems_from_arrays on mgtpu's padded hierarchy
    gives the same cycles."""
    _, outs = group
    ref = _ref_cycle("mixed")
    for o in outs:
        np.testing.assert_allclose(o["convert"], ref, rtol=1e-10,
                                   atol=1e-11)


def test_refined_meets_the_single_device_contract(group, ref_refined):
    """The sharded refined solve (f32 hierarchy, f64 residual) takes
    mgtpu's single-device count +- 1 at a true f64 relres below 1e-8."""
    _, outs = group
    iters, A = ref_refined
    b = tr.rhs(A, seed=9)
    for o in outs:
        x, it, _ = o["refined"]
        assert abs(it - iters) <= 1
        assert _relres(A, b, x) < 1e-8


@pytest.fixture(scope="module")
def ref_refined_f64_cycles():
    """mgtpu's single-device refined count with float64 cycles of the
    float32 hierarchy (its cycle_dtype)."""
    st, A = _ref_state("solve", np.float32, max_outer_iter=40)
    _, info = solve_mg_refined(st, tr.rhs(A, seed=9), tol=1e-8,
                               cycle_dtype=np.float64)
    return int(info["iters"])


def test_refined_cycle_dtype(group, ref_refined, ref_refined_f64_cycles):
    """float64 cycles of the float32 hierarchy (a cast copy of the sharded
    hierarchy): mgtpu's count +- 1 at a true f64 relres below 1e-8."""
    _, outs = group
    A = ref_refined[1]
    b = tr.rhs(A, seed=9)
    for o in outs:
        x, it = o["refined_f64_cycles"]
        assert abs(it - ref_refined_f64_cycles) <= 1
        assert _relres(A, b, x) < 1e-8


def test_refined_multirhs(group, ref_refined):
    _, outs = group
    A = ref_refined[1]
    B = np.random.RandomState(10).rand(A.shape[0], 2)
    for o in outs:
        x, _ = o["refined_multi"]
        assert x.shape == B.shape
        assert _relres(A, B, x) < 1e-8


def test_refined_agrees_across_layouts(group):
    """x within 1e-6 of one rank's (test_sharded_solve.py:87), the same
    count."""
    _, outs = group
    x1, it1, _ = _group(1)[0]["refined"]
    for o in outs:
        x, it, _ = o["refined"]
        assert it == it1
        assert np.max(np.abs(x - x1)) <= 1e-6 * np.abs(x1).max()


def test_refuses_k_cycles(group):
    """K-cycles need a global reduction inside the cycle.  They were
    refused until the cycles took a reduce hook (the FGMRES Gram sums over
    the ranks); now make_systems_sharded_cycle takes them, and one K-cycle
    from zero equals mgtpu's single-device K-cycle (rtol 1e-10; more in
    test_torch_sharded_kcycle.py)."""
    _, outs = group
    st, A = _ref_state("mixed", cycle_type="K")
    bf = block_to_fields(jnp.asarray(np.random.RandomState(3).rand(
        A.shape[0], 2)), st.hier.fine_grids)
    ref = np.asarray(fields_to_block(cycle_ref(
        st.config, st.hier, bf, tuple(jnp.zeros_like(t) for t in bf))))
    for o in outs:
        np.testing.assert_allclose(o["K"], ref, rtol=1e-10, atol=1e-11)


def test_byte_counts_follow_the_collectives(group):
    """One rank sends nothing; several exchange halos (the block applies,
    the Vanka top planes), reduce-scatter the restrictions, gather the
    prolongations and the coarsest, all-reduce the norms."""
    world, outs = group
    for o in outs:
        sent = o["sent"]
        if world == 1:
            assert not any(sent.values())
        else:
            assert all(sent[k] > 0 for k in ("halo", "psum", "all_gather",
                                              "reduce_scatter"))
            assert sent["broadcast"] == 0


def test_needs_the_systems_engine():
    from mgtpu_torch.parallel.systems_sharded import (
        make_systems_sharded_cycle)
    M, A = tr.poisson(8)
    st = tr.setup(M, A, **tr.params(2, np.float64))
    with pytest.raises(ValueError, match="systems grid engine"):
        make_systems_sharded_cycle(st, None, "cpu")


def test_shift_moves_one_step(group):
    """RankGrid.shift: each rank gets the tensor of the rank one step
    before it (step 1) or after it (step -1), zeros past the ends."""
    world, outs = group
    for k, o in enumerate(outs):
        up, down = o["shift"]
        assert np.array_equal(up, np.full(2, k - 1.0 if k else 0.0))
        assert np.array_equal(down, np.full(2, k + 1.0 if k < world - 1
                                            else 0.0))
