"""Kernel D's block-operator form (ops/cuda/stencil.py::block_apply,
csrc/block_stencil.cu) on the CPU, against mgtpu.

A staggered system's level operator applied, or its residual b - A x
taken, in one launch on the card; on the CPU the wrapper runs its plain
version (the blocks' plain cross applies, added per output component in
block order, subtracted from b).  Here, at small sizes: the plain block
apply and residual of mgtpu's own level operators (carried across by
convert.systems_hierarchy_from_arrays) against mgtpu's
BlockGridOperator.matvec and b - matvec, 2D mixed and unmixed elasticity
at 16^2 and 3D mixed at 6^3, every level, float64 and complex128 to
1e-12, float32 and complex64 to 2e-5 (relative to the largest entry),
m = 1, 2, 5; the host block table (boxes, tap ranges, inner ranges, each
block's split) against stencil_plan and a brute-force count, for every
block of every level, single-device and sharded; the kernel's schedule
emulated in numpy through the table (slices, blocks, then b) against the
plain version, also on a cast_hierarchy copy, whose table answers for its
own coefficients; and the sharded residual (parallel/systems_sharded.py,
the halo-extended inputs) on 1, 2 and 4 gloo ranks against mgtpu's
single-device operator, the pad and the dead slots exactly zero.  The
kernel itself is held bitwise against the per-block path on the card
(tests/test_torch_gpu.py, chip_smoke.py phase 13)."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import mgtpu
from mgtpu.models import operators as ops_ref

import _torch_ranks as tr
import mgtpu_torch as mt
from mgtpu_torch.convert import systems_hierarchy_from_arrays
from mgtpu_torch.ops.cuda import stencil as sk
from mgtpu_torch.parallel.launch import run_ranks
from mgtpu_torch.parallel.systems_sharded import (pad_block_operator,
                                                  padded_grids,
                                                  shard_block_operator)
from mgtpu_torch.solvers.mg_solver import cast_hierarchy

# name -> (dim, cells, mixed, levels, relax)
CASES = {"2d-mixed": (2, 16, True, 3, "VankaFaces"),
         "2d": (2, 16, False, 3, "SPAI"),
         "3d-mixed": (3, 6, True, 2, "VankaFaces")}
DTYPES = [np.float64, np.float32, np.complex128, np.complex64]
TOLS = {np.dtype(np.float64): 1e-12, np.dtype(np.float32): 2e-5,
        np.dtype(np.complex128): 1e-12, np.dtype(np.complex64): 2e-5}
WORLDS = [1, 2, 4]
DEADLINE_S = 120.0          # a rank group's hard limit (a hang guard)
_STATES: dict = {}


def _operator(dim, cells, mixed, complex_):
    """Elasticity (mixed or not), mu = lambda = 1, plus shift * (max
    column sum) * I, shift 1e-3 (1e-3 + 1e-3i in complex)."""
    M = mgtpu.get_regular_mesh([0.0, 1.0] * dim, [cells] * dim)
    mu = np.ones(M.num_cells)
    A = (ops_ref.linear_elasticity_operator_mixed if mixed
         else ops_ref.linear_elasticity_operator)(M, mu, mu)
    shift = (1e-3 + 1e-3j) if complex_ else 1e-3
    return M, (A + shift * abs(A).sum(axis=0).max()
               * sp.identity(A.shape[0])).tocsr()


def _state(name, dtype):
    """mgtpu's systems hierarchy of a case in `dtype` and the port's
    level operators made from its arrays: [(mgtpu's, the port's)]."""
    key = (name, np.dtype(dtype).name)
    if key not in _STATES:
        dim, cells, mixed, levels, relax = CASES[name]
        M, A = _operator(dim, cells, mixed, np.iscomplexobj(dtype(0)))
        cfg, rp = mgtpu.get_mg_param(
            levels=levels, relax_type=relax, relax_param=0.75, nu_pre=1,
            nu_post=1, dtype=dtype, transfer_type=(
                "SystemsFacesMixedLinear" if mixed else "SystemsFacesLinear"))
        h = mgtpu.mg_setup(A, M, cfg, rp).hier
        specs = [dict(stencils=[dict(coeff=np.asarray(s.coeff),
                                     offsets=s.offsets, in_grid=s.in_grid)
                                for s in lv.A.stencils],
                      pairs=lv.A.pairs, grids=lv.A.grids)
                 for lv in h.levels]
        hp = systems_hierarchy_from_arrays(specs, np.asarray(h.coarse.inv),
                                           device="cpu")
        _STATES[key] = [(lr.A, lp.A) for lr, lp in zip(h.levels, hp.levels)]
    return _STATES[key]


def _fields(grids, m, dtype, seed):
    rng = np.random.RandomState(seed)
    out = []
    for g in grids:
        a = rng.rand(m, *g)
        if np.iscomplexobj(dtype(0)):
            a = a + 1j * rng.rand(m, *g)
        out.append(a.astype(dtype))
    return out


def _rel(got, want) -> float:
    got = np.asarray(got).astype(np.complex128)
    want = np.asarray(want).astype(np.complex128)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _ref_matvec(op_ref, xs):
    return [np.asarray(y) for y in op_ref.matvec(tuple(jnp.asarray(x)
                                                       for x in xs))]


@pytest.mark.parametrize("m", [1, 2, 5])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("name", list(CASES))
def test_block_apply_matches_mgtpu(name, dtype, m):
    """The port's block apply (the plain version on the CPU) of every
    level of mgtpu's hierarchy equals mgtpu's BlockGridOperator.matvec;
    on the CPU it counts one plain cross apply a block."""
    tol = TOLS[np.dtype(dtype)]
    for l, (op_ref, op) in enumerate(_state(name, dtype)):
        xs = _fields(op.grids, m, dtype, seed=10 + l)
        key = np.dtype(dtype).name
        n0 = sk.PLAIN_CALLS[key]
        ys = op.matvec(tuple(torch.from_numpy(x) for x in xs))
        assert sk.PLAIN_CALLS[key] == n0 + len(op.stencils)
        for y, want in zip(ys, _ref_matvec(op_ref, xs)):
            assert str(y.dtype).split(".")[-1] == want.dtype.name
            assert _rel(y.numpy(), want) < tol, (l, m)


@pytest.mark.parametrize("m", [1, 2, 5])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("name", list(CASES))
def test_block_residual_matches_mgtpu(name, dtype, m):
    """The port's block residual equals b - mgtpu's matvec on every level,
    and is bitwise b less the port's own block apply."""
    tol = TOLS[np.dtype(dtype)]
    for l, (op_ref, op) in enumerate(_state(name, dtype)):
        xs = _fields(op.grids, m, dtype, seed=20 + l)
        bs = _fields(op.grids, m, dtype, seed=30 + l)
        xt = tuple(torch.from_numpy(x) for x in xs)
        bt = tuple(torch.from_numpy(b) for b in bs)
        rs = op.residual(bt, xt)
        for r, b, y in zip(rs, bs, _ref_matvec(op_ref, xs)):
            assert _rel(r.numpy(), b - y) < tol, (l, m)
        for r, b, y in zip(rs, bt, op.matvec(xt)):
            assert torch.equal(r, b - y)


def _inner_box(obox, ibox, taps):
    """Brute force: the mask of output nodes whose every tap lands in the
    input box."""
    idx = np.stack(np.meshgrid(*[np.arange(v) for v in obox],
                               indexing="ij"), axis=-1)
    ok = np.ones(tuple(obox), dtype=bool)
    for d in taps:
        src = idx + np.asarray(d)
        ok &= np.all((src >= 0) & (src < np.asarray(ibox)), axis=-1)
    return ok


def _check_table(op, in_grids, offsets):
    """op.block_table against stencil_plan and a brute-force count."""
    comps, blocks, taps = sk.block_table_parts(op.block_table)
    box = lambda g: (1,) * (3 - len(g)) + tuple(g)
    assert len(comps) == len(op.grids) and len(blocks) == len(op.pairs)
    cta = 0
    for c, row in enumerate(comps):
        assert tuple(row[:3]) == box(op.grids[c])
        assert tuple(row[3:6]) == box(in_grids[c])
        mine = [s for s, (ci, _) in enumerate(op.pairs) if ci == c]
        b0, nb, split, cta0 = (int(v) for v in row[6:])
        assert list(blocks[b0:b0 + nb, 0]) == mine
        assert cta0 == cta
        assert split == max([int(v) for v in blocks[b0:b0 + nb, 5]],
                            default=1)
        cta += -(-int(np.prod(op.grids[c])) // (sk.THREADS // split))
    assert int(op.block_table[3]) == cta
    t0 = 0
    for src, ci, cj, tb, nd, split, per, *lohi in blocks:
        offs = offsets[src]
        assert (ci, cj) == tuple(op.pairs[src]) and tb == t0
        assert nd == len(offs)
        obox = box(op.grids[ci])
        for form in ("cross", "apply"):
            assert split == sk.stencil_plan(obox, nd, 1, torch.float32,
                                            form).split
        assert per == -(-nd // split)
        d3 = [(0,) * (3 - len(o)) + tuple(o) for o in offs]
        assert [tuple(t[:3]) for t in taps[tb:tb + nd]] == d3
        ibox = box(in_grids[cj])
        ok = _inner_box(obox, ibox, d3)
        lo, hi = lohi[:3], lohi[3:]
        want = np.zeros_like(ok)
        if all(a <= b for a, b in zip(lo, hi)):
            want[tuple(slice(a, b + 1) for a, b in zip(lo, hi))] = True
        assert np.array_equal(ok, want), (src, lo, hi)
        for dz, dy, dx, lin in taps[tb:tb + nd]:
            if ok.any():
                assert lin == (dz * ibox[1] + dy) * ibox[2] + dx
        t0 += nd


@pytest.mark.parametrize("name", list(CASES))
def test_block_table_matches_plans(name):
    """Every level's block table: the components' boxes and first CUDA
    blocks, each block's taps, its split (stencil_plan of its output box,
    the split of its own cross-form launch), its slice length and its
    inner range (the brute-force mask of nodes whose taps all land
    inside); no pointer (a pure function of the shapes and taps)."""
    for _, op in _state(name, np.float64):
        _check_table(op, op.grids, op.block_offsets)
        assert op.block_table.dtype == np.int32
        assert not op.block_table.flags.writeable


class _RankOf:
    """The layout questions a RankGrid answers for rank k of D (no process
    group): what one rank of the systems tier builds its blocks from."""

    def __init__(self, D, k):
        self.shape, self._k = (D,), k

    def axis_size(self, axis=0):
        return self.shape[0]

    def axis_index(self, axis=0):
        return self._k


@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("name", ["2d-mixed", "3d-mixed"])
def test_sharded_block_table_matches_plans(name, D):
    """The sharded blocks of every rank of D on every level: the table's
    inputs are the halo-extended components (owned planes + 2 radius), the
    taps shifted by the radius, each block's split the plan of its local
    output box."""
    for _, op in _state(name, np.float64):
        pad = pad_block_operator(op, padded_grids(op.grids, D))
        for k in range(D):
            sop = shard_block_operator(pad, _RankOf(D, k), "cpu")
            for j, (r, g) in enumerate(zip(sop.radius, sop.grids)):
                assert sop.in_grids[j][0] == (sop.layout.owned[j] + 2 * r
                                              if r else g[0])
            _check_table(sop, sop.in_grids, sop.block_offsets)


def _emulate(op, xs, bs):
    """The block kernel's schedule in numpy, through op.block_table: per
    output component, per block in table order, each slice's taps summed
    from zero in tap order (a tap off the input box reads nothing), the
    slices added in order, the block sums in order, then b - sum."""
    comps, blocks, taps = sk.block_table_parts(op.block_table)
    coeffs = op.block_coeffs
    out = []
    for c, row in enumerate(comps):
        obox = tuple(int(v) for v in row[:3])
        m = xs[0].shape[0]
        idx = np.stack(np.meshgrid(*[np.arange(v) for v in obox],
                                   indexing="ij"), axis=-1).reshape(-1, 3)
        tot = None
        b0, nb = int(row[6]), int(row[7])
        for src, ci, cj, t0, nd, split, per, *_ in blocks[b0:b0 + nb]:
            ibox = np.asarray(comps[cj, 3:6])
            x = xs[cj].reshape(m, -1)
            cf = coeffs[src].numpy().reshape(nd, -1)
            acc = None
            for s in range(split):
                part = np.zeros((m, idx.shape[0]), dtype=x.dtype)
                for k in range(s * per, min(nd, (s + 1) * per)):
                    dz, dy, dx, _ = taps[t0 + k]
                    src_i = idx + np.asarray((dz, dy, dx))
                    ok = np.all((src_i >= 0) & (src_i < ibox), axis=1)
                    lin = (src_i[:, 0] * ibox[1] + src_i[:, 1]) * ibox[2] \
                        + src_i[:, 2]
                    v = np.where(ok, x[:, np.where(ok, lin, 0)], 0)
                    part = part + np.where(ok, cf[k], 0) * v
                acc = part if acc is None else acc + part
            tot = acc if tot is None else tot + acc
        if tot is None:
            tot = np.zeros((m, idx.shape[0]), dtype=xs[0].dtype)
        shape = (m,) + tuple(op.grids[c])
        out.append(bs[c] - tot.reshape(shape))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_block_schedule_through_the_table(name):
    """The kernel's schedule, emulated through the table with the
    operator's own operands, gives the plain residual (1e-12, f64)."""
    for l, (_, op) in enumerate(_state(name, np.float64)):
        xs = _fields(op.grids, 2, np.float64, seed=40 + l)
        bs = _fields(op.grids, 2, np.float64, seed=50 + l)
        want = op.residual(tuple(map(torch.from_numpy, bs)),
                           tuple(map(torch.from_numpy, xs)))
        for got, w in zip(_emulate(op, xs, bs), want):
            assert _rel(got, w.numpy()) < 1e-12


def test_cast_copy_table_answers_for_its_own_coefficients():
    """A cast_hierarchy copy (float32 -> float64, the refined solve's
    cycle_dtype copy) holds its own operands: its table is a fresh one of
    the same shapes (no pointer to share), its block coefficients are its
    own float64 tensors, and the schedule emulated through its table with
    them gives the copy's plain residual (1e-12)."""
    dim, cells, mixed, levels, relax = CASES["2d-mixed"]
    M = mt.get_regular_mesh([0.0, 1.0] * dim, [cells] * dim)
    _, A = _operator(dim, cells, mixed, False)
    cfg, rp = mt.get_mg_param(levels=levels, relax_type=relax,
                              relax_param=0.75, dtype=np.float32,
                              transfer_type="SystemsFacesMixedLinear")
    hier = mt.mg_setup(A, M, cfg, rp, device="cpu").hier
    tables = [lv.A.block_table for lv in hier.levels]
    copy = cast_hierarchy(hier, torch.float64)
    for l, (lv, lc) in enumerate(zip(hier.levels, copy.levels)):
        op = lc.A
        assert op is not lv.A
        assert "block_table" not in op.__dict__
        assert np.array_equal(op.block_table, tables[l])
        for a, b in zip(op.block_coeffs, lv.A.block_coeffs):
            assert a.dtype == torch.float64 and b.dtype == torch.float32
            assert a.data_ptr() != b.data_ptr()
        xs = _fields(op.grids, 1, np.float64, seed=60 + l)
        bs = _fields(op.grids, 1, np.float64, seed=70 + l)
        want = op.residual(tuple(map(torch.from_numpy, bs)),
                           tuple(map(torch.from_numpy, xs)))
        for got, w in zip(_emulate(op, xs, bs), want):
            assert w.dtype == torch.float64
            assert _rel(got, w.numpy()) < 1e-12


# ---------------------------------------------------------------------------
# the sharded residual on gloo ranks (the ranks run tests/_torch_ranks.py)
# ---------------------------------------------------------------------------

_GROUPS: dict = {}


@pytest.fixture(scope="module", params=WORLDS, ids=str)
def group(request):
    world = request.param
    if world not in _GROUPS:
        _GROUPS[world] = run_ranks(tr.block_stencil_cases, world, "cpu",
                                   "gloo", DEADLINE_S)
    return world, _GROUPS[world]


@pytest.mark.parametrize("name", list(tr.BLOCK_CASES))
def test_sharded_residual_matches_mgtpu(group, name):
    """The sharded level operators' residual and apply (halo-extended
    inputs, one block-form call a rank) of every level, gathered, equal
    b - A x and A x of mgtpu's single-device operator on the true grids
    (1e-12, f64); every pad plane, the dead slots among them, exactly
    zero."""
    _, outs = group
    M, A, p = tr.systems_case(name)
    Mr = mgtpu.get_regular_mesh(list(M.domain), list(np.asarray(M.n)))
    hier = mgtpu.mg_setup(A, Mr, *mgtpu.get_mg_param(**p)).hier
    for l, lv in enumerate(hier.levels):
        grids = lv.A.grids
        xs = tr.block_fields(grids, 2, 80 + l)
        bs = tr.block_fields(grids, 2, 90 + l)
        ys = _ref_matvec(lv.A, xs)
        for o in outs:
            r, y = o[(name, l)]
            for c, g in enumerate(grids):
                true = (slice(None), slice(0, g[0]))
                assert _rel(r[c][true], bs[c] - ys[c]) < 1e-12
                assert _rel(y[c][true], ys[c]) < 1e-12
                assert not r[c][:, g[0]:].any() and not y[c][:, g[0]:].any()
