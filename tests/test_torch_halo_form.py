"""Kernel D's halo form (ops/cuda/stencil.py::halo_stencil,
csrc/halo_stencil.cu) and its entry points on the CPU, against mgtpu.

A rank's block apply, residual b - A x or Jacobi update x + d (b - A x)
in one launch on the card, reading the neighbours' halo planes where they
arrived; on the CPU the wrapper runs its plain version (the planes catted,
zero where a neighbour is missing, the plain cross apply of each row
range, torch's subtraction or update).  Here, at small sizes (33^2 and
17^3 nodes, three levels):

 * on 1, 2 and 4 gloo ranks and the 2 x 2 pencil
   (tests/_torch_ranks.py::halo_form_cases): `ShardedGridStencil.residual`
   and `matvec` on every level of the grid-sharded hierarchy against
   mgtpu's single-device b - A x and A x, and the slab GMG's residual and
   Jacobi sweep (parallel/sharded.py) on every level against mgtpu's
   `stencil_matvec_local` on the gathered grid; rtol 1e-12 in float64 and
   2e-5 in float32 (relative to the largest entry), m = 1, 2, 5; each
   bitwise the old path (the fused exchange and apply, torch's
   subtraction or update);
 * the host plan (`halo_plan`) against `stencil_plan`'s split for every
   level's block of those layouts, and its nodes a thread;
 * the kernel's addressing (make_taps, the segments, the output rows)
   emulated in numpy against the plain version, with live planes, missing
   ones and row ranges;
 * the plain form against the old path bit for bit, complex too;
 * every grid-engine operator's `residual` bitwise b - matvec(x).

The kernel itself is held bitwise against the old path on the card
(tests/test_torch_gpu.py, chip_smoke.py phase 19)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgtpu import get_mg_param as get_mg_param_ref
from mgtpu import mg_setup as mg_setup_ref
from mgtpu.models.mesh import get_regular_mesh as mesh_ref
from mgtpu.parallel import sharded as sharded_ref
from mgtpu.parallel import stencil as stencil_ref

import _torch_ranks as tr
from mgtpu_torch.ops.cuda import stencil as sk
from mgtpu_torch.ops.grid_stencil import (ConstGridStencil, GridStencil,
                                          grid_stencil_from_csr)
from mgtpu_torch.parallel.grid_sharded import pad_grid_hierarchy
from mgtpu_torch.parallel.launch import run_ranks
from mgtpu_torch.parallel.sharded import slab_sizes

LAYOUTS = [(1,), (2,), (4,), (2, 2)]
TOL = {"float64": 1e-12, "float32": 2e-5}
_GROUPS: dict = {}


def _group(shape):
    if shape not in _GROUPS:
        _GROUPS[shape] = run_ranks(tr.halo_form_cases, int(np.prod(shape)),
                                   "cpu", "gloo", tr.DEADLINE_S,
                                   args=(shape,))
    return _GROUPS[shape]


@pytest.fixture(scope="module", params=LAYOUTS,
                ids=lambda s: "x".join(map(str, s)))
def group(request):
    return request.param, _group(request.param)


@pytest.fixture(scope="module", params=[s for s in LAYOUTS if len(s) == 1],
                ids=lambda s: str(s[0]))
def slab_group(request):
    """The slab layouts' groups, which also ran the slab tier's cases."""
    return request.param, _group(request.param)


def _ref_state(name, dtype, levels=tr.HALO_LEVELS, slab=False):
    if slab:
        M, A, levels, _ = tr.slab_problem(name)
    else:
        n, dim = tr.HALO_GRIDS[name]
        M, A = tr.poisson(n, dim)
    Mr = mesh_ref(list(M.domain), list(np.asarray(M.n)))
    cfg, rp = get_mg_param_ref(**tr.params(levels, dtype))
    return mg_setup_ref(A, Mr, cfg, rp)


_REFS: dict = {}


def _ref(name, dtype, slab=False):
    key = (name, dtype, slab)
    if key not in _REFS:
        _REFS[key] = _ref_state(name, dtype, slab=slab)
    return _REFS[key]


def _close(got, ref, dt, what):
    err = float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))
    assert err <= TOL[dt], (what, err)


# ---------------------------------------------------------------------------
# the entry points on gloo ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["float64", "float32"])
@pytest.mark.parametrize("name", list(tr.HALO_GRIDS))
def test_grid_sharded_residual_matches_mgtpu(group, name, dt):
    """ShardedGridStencil.residual and matvec on every level against
    mgtpu's single-device b - A x and A x on the true grid; every rank's
    residual bitwise its b - matvec."""
    shape, outs = group
    st = _ref(name, np.dtype(dt).type)
    for l, lvl in enumerate(st.hier.levels):
        grid = tuple(lvl.A.grid)
        for m in tr.HALO_MS:
            r, y, _ = outs[0][("grid", name, dt, l, m)]
            assert all(o[("grid", name, dt, l, m)][2] for o in outs), \
                (shape, l, m)
            x, b = tr.halo_inputs(r.shape[1:], m, 10 * l + m,
                                  np.dtype(dt).type)
            true = (slice(None),) + tuple(slice(0, e) for e in grid)
            y_ref = np.asarray(lvl.A.matvec(jnp.asarray(x[true])))
            _close(y[true], y_ref, dt, (shape, name, l, m, "A x"))
            _close(r[true], b[true] - y_ref, dt, (shape, name, l, m,
                                                  "b - A x"))


@pytest.mark.parametrize("dt", ["float64", "float32"])
@pytest.mark.parametrize("name", ["poisson", "poisson3d"])
def test_slab_residual_and_jacobi_match_mgtpu(slab_group, name, dt):
    """The slab GMG's residual and Jacobi sweep on every level (kernel D's
    halo form, interior rows then both edge rows) against mgtpu's
    stencil_matvec_local on the gathered, zero-extended grid; bitwise the
    fused exchange + apply and torch's subtraction or update."""
    shape, outs = slab_group
    R = shape[0]
    mg = sharded_ref.build_sharded_mg(_ref(name, np.dtype(dt).type,
                                           slab=True), R,
                                      dtype=np.dtype(dt).type)
    for l, lvl in enumerate(mg.levels):
        for m in tr.HALO_MS:
            key = ("slab", name, dt, l, m)
            assert all(o[key][2] and o[key][3] for o in outs), (R, l, m)
            r, xj = outs[0][key][:2]
            x, b = tr.halo_inputs(r.shape[1:], m, 20 + 10 * l + m,
                                  np.dtype(dt).type)
            xh = np.pad(np.moveaxis(x, 0, -1), ((1, 1), (0, 0), (0, 0)))
            y = np.moveaxis(np.asarray(stencil_ref.stencil_matvec_local(
                jnp.asarray(lvl.coeff), lvl.di, lvl.dj, jnp.asarray(xh))),
                -1, 0)
            d = np.asarray(lvl.d)
            _close(r, b - y, dt, (R, name, l, m, "b - A x"))
            _close(xj, x + d * (b - y), dt, (R, name, l, m, "jacobi"))


# ---------------------------------------------------------------------------
# the host plan
# ---------------------------------------------------------------------------

def _blocks(shape):
    """(box, nd) of every level's block of the grid-sharded hierarchies
    on the rank grid `shape`, and of the slab tier's levels (their 5- or
    7-point fine stencils and 9- or 27-point Galerkin levels)."""
    out = []
    divs_of = lambda g: tuple(shape) + (1,) * (g - len(shape))
    for name, (n, dim) in tr.HALO_GRIDS.items():
        M, A = tr.poisson(n, dim)
        st = tr.setup(M, A, **tr.params(tr.HALO_LEVELS, np.float64))
        gh = pad_grid_hierarchy(st.hier, divs_of(dim))
        for lvl in gh.levels:
            box = tuple(g // d for g, d in zip(lvl.A.grid, divs_of(dim)))
            out.append((box, len(lvl.A.offsets)))
    if len(shape) == 1:
        for name in ("poisson", "poisson3d"):
            M, A, levels, _ = tr.slab_problem(name)
            n_nodes = [int(v) + 1 for v in np.asarray(M.n)]
            njs = [(n_nodes[-1] - 1) // 2 ** l + 1 for l in range(levels)]
            ni = [int(np.prod([(v - 1) // 2 ** l + 1 for v in n_nodes[:-1]]))
                  for l in range(levels)]
            for S, NI in zip(slab_sizes(njs, shape[0]), ni):
                out += [((S, NI), nd) for nd in ((5, 9) if len(n_nodes) == 2
                                                 else (7, 27))]
    return out


@pytest.mark.parametrize("shape", LAYOUTS, ids=lambda s: "x".join(map(str, s)))
def test_halo_plan_keeps_the_cross_split(shape):
    """For every level's block: the halo form slices each node's taps as
    stencil_plan's cross form does, for the whole block and for the
    overlapped slab's interior and edge rows (planned on the whole
    block), one node a thread and split."""
    for box, nd in _blocks(shape):
        for m in (1, 2, 5):
            for dt in (torch.float32, torch.float64, torch.complex64):
                want = sk.stencil_plan(sk._box(box), nd, m, dt, "cross")
                n = int(np.prod(box))
                for nodes in (n, n // box[0] * max(box[0] - 2, 1),
                              n // box[0] * min(box[0], 2)):
                    p = sk.halo_plan(sk._box(box), nodes, nd, m, dt)
                    assert (p.split, p.per_slice, p.mb, p.group,
                            p.smem) == (want.split, want.per_slice,
                                        want.mb, want.group, want.smem)
                    assert p.blocks == -(-nodes // (sk.THREADS // p.split))


def test_halo_plan_of_the_main_path_blocks():
    """MS-2d's fine slab (288 x 1025) and MG-3d's fine block (33 x 129^2):
    one thread a node (the split of a grid that fills the card); the
    overlapped slab's two edge rows keep the whole slab's split and take
    CUDA blocks for their own 2 x 1025 nodes."""
    for box, nd in (((1, 288, 1025), 5), ((33, 129, 129), 7)):
        n = int(np.prod(box))
        for dt in (torch.float32, torch.float64, torch.complex128):
            p = sk.halo_plan(box, n, nd, 1, dt)
            assert (p.split, p.blocks, p.smem) == (1, -(-n // 256), 0)
    p = sk.halo_plan((1, 288, 1025), 2 * 1025, 5, 1, torch.float32)
    assert (p.split, p.blocks) == (1, 9)
    # a small block's split survives the row cut
    whole = sk.stencil_plan((1, 34, 65), 9, 1, torch.float32, "cross")
    edge = sk.halo_plan((1, 34, 65), 2 * 65, 9, 1, torch.float32)
    assert whole.split == edge.split > 1


# ---------------------------------------------------------------------------
# the kernel's addressing, emulated
# ---------------------------------------------------------------------------

def _emulate(coeff, offsets, x, left, right, axis, b=None, d=None,
             rows=None, out=None):
    """csrc/halo_stencil.cu in numpy, float64, one right-hand side set:
    make_taps' inner range and offsets, the launch's node order and rows,
    each warp's fast test, load_tap's segments (the fast path's address
    checked against the segment rule wherever it is taken), the taps
    summed in order, the epilogue.  Returns y as a torch tensor."""
    g = coeff.ndim - 1
    pad = 3 - g
    box = lambda grid: (1,) * pad + tuple(int(v) for v in grid)
    O, I = box(coeff.shape[1:]), box(x.shape[-g:])
    h = pad + axis
    m = x.shape[0]
    taps = np.array([(0,) * pad + tuple(off) for off in offsets])
    lo = np.zeros(3, int)
    hi = np.array(O) - 1
    for dd in taps:
        lo = np.maximum(lo, np.where(dd < 0, -dd, 0))
        hi = np.minimum(hi, np.maximum(np.array(I) - 1 - dd, -1))
    lin = (taps[:, 0] * I[1] + taps[:, 1]) * I[2] + taps[:, 2]
    segs = [None if t is None else t.numpy().reshape(m, -1)
            for t in (left, x, right)]
    wl = 0 if left is None else left.shape[x.ndim - g + axis]
    wr = 0 if right is None else right.shape[x.ndim - g + axis]
    rr = (0, O[h], O[h], O[h]) if rows is None else rows
    n1, nr = rr[1] - rr[0], rr[1] - rr[0] + rr[3] - rr[2]
    ext = list(O)
    ext[h] = nr
    e = np.arange(int(np.prod(ext)))
    c = np.stack(np.unravel_index(e, ext), axis=1)
    c[:, h] = np.where(c[:, h] < n1, rr[0] + c[:, h], rr[2] + c[:, h] - n1)
    eo = np.ravel_multi_index(c.T, O)
    base = np.ravel_multi_index(c.T, I, mode="wrap")
    inner = np.all((c >= lo) & (c <= hi), axis=1)
    fast = np.repeat([inner[k:k + 32].all()
                      for k in range(0, len(e), 32)], 32)[:len(e)]
    cf = coeff.numpy().reshape(len(offsets), -1)
    acc = np.zeros((m, len(e)))
    for k, dd in enumerate(taps):
        s = c + dd
        ok = np.ones(len(e), bool)
        for a in range(3):
            if a != h:
                ok &= (s[:, a] >= 0) & (s[:, a] < I[a])
        seg = np.where(s[:, h] < 0, 0, np.where(s[:, h] >= I[h], 2, 1))
        ch = np.where(seg == 0, s[:, h] + wl, np.where(seg == 2,
                                                       s[:, h] - I[h],
                                                       s[:, h]))
        eh = np.choose(seg, [wl, I[h], wr])
        ok &= (ch >= 0) & (ch < eh)
        ok &= np.array([segs[q] is not None for q in range(3)])[seg]
        sb = np.tile(np.array(I), (len(e), 1))
        sb[:, h] = eh
        cc = s.copy()
        cc[:, h] = ch
        off = (cc[:, 0] * sb[:, 1] + cc[:, 1]) * sb[:, 2] + cc[:, 2]
        assert np.all(ok[fast] & (seg[fast] == 1)
                      & (off[fast] == base[fast] + lin[k]))
        for q in range(3):
            sel = ok & (seg == q)
            if sel.any():
                acc[:, sel] += cf[k, eo[sel]] * segs[q][:, off[sel]]
    y = (torch.zeros((m,) + tuple(coeff.shape[1:]), dtype=x.dtype)
         if out is None else out.clone()).reshape(m, -1)
    val = torch.from_numpy(acc)
    if b is not None:
        val = b.reshape(m, -1)[:, eo] - val
        if d is not None:
            val = x.reshape(m, -1)[:, eo] + d.reshape(-1)[eo] * val
    y[:, eo] = val
    return y.reshape((m,) + tuple(coeff.shape[1:]))


def _parts(x_full, axis, w, live=(True, True)):
    """x_full (m, *extended grid) cut along `axis` into (left, owned,
    right), w planes each side; a planes piece None where not live."""
    dim = 1 + axis
    n = x_full.shape[dim]
    left = x_full.narrow(dim, 0, w).contiguous() if live[0] else None
    right = x_full.narrow(dim, n - w, w).contiguous() if live[1] else None
    return left, x_full.narrow(dim, w, n - 2 * w).contiguous(), right


CASES = [  # (out grid, extended along axis 0 before the halo axis, axis,
           #  radius, taps)
    ((9, 7), 0, 0, 1, ((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0))),
    ((6, 11), 0, 0, 1, tuple((i, j) for i in (-1, 0, 1)
                             for j in (-1, 0, 1))),
    ((5, 6, 7), 0, 0, 1, ((-1, 0, 0), (0, -1, 0), (0, 0, -1), (0, 0, 0),
                          (0, 0, 1), (0, 1, 0), (1, 0, 0))),
    ((7, 9), 1, 1, 1, tuple((i, j) for i in (-1, 0, 1)
                            for j in (-1, 0, 1))),
    ((4, 5, 6), 1, 1, 1, tuple((i, j, k) for i in (-1, 0, 1)
                               for j in (-1, 0, 1) for k in (-1, 0, 1))),
    ((8, 5), 0, 0, 2, ((-2, 0), (-1, 0), (0, 0), (1, 1), (2, 0))),
]


def _case(out_grid, ext0, axis, r, offsets, m, seed):
    """Coefficients, the extended input, and the taps in the owned frame
    (shifted by the first axis's halo where it was catted)."""
    rng = np.random.RandomState(seed)
    coeff = torch.from_numpy(rng.rand(len(offsets), *out_grid))
    in_grid = list(out_grid)
    in_grid[axis] += 2 * r
    if ext0:
        in_grid[0] += 2
    x_full = torch.from_numpy(rng.rand(m, *in_grid))
    taps = tuple(tuple(v + (1 if a == 0 and ext0 else 0)
                       for a, v in enumerate(off)) for off in offsets)
    return coeff, x_full, taps


@pytest.mark.parametrize("case", range(len(CASES)))
def test_emulated_kernel_matches_plain(case):
    """The kernel's addressing in numpy against the plain halo form: live
    and missing planes, the whole block and the overlapped slab's two
    launches (interior rows, then both edge rows into the same tensor);
    apply, residual and the Jacobi update where the output is the owned
    block."""
    out_grid, ext0, axis, r, offsets = CASES[case]
    for m in (1, 2):
        coeff, x_full, taps = _case(out_grid, ext0, axis, r, offsets, m,
                                    case + m)
        rng = np.random.RandomState(100 + case)
        b = torch.from_numpy(rng.rand(m, *out_grid))
        for live in ((True, True), (False, True), (True, False),
                     (False, False)):
            left, own, right = _parts(x_full, axis, r, live)
            d = (torch.from_numpy(rng.rand(*out_grid))
                 if tuple(own.shape[1:]) == out_grid else None)
            forms = [(None, None), (b, None)] + ([(b, d)] if d is not None
                                                 else [])
            for bb, dd in forms:
                want = sk.halo_stencil_plain(coeff, taps, own, left, right,
                                             axis, b=bb, d=dd)
                got = _emulate(coeff, taps, own, left, right, axis, bb, dd)
                err = float((got - want).abs().max() / want.abs().max())
                assert err < 1e-13, (case, m, live, err)
                n = out_grid[axis]
                if n < 3:
                    continue
                part = sk.halo_stencil_plain(coeff, taps, own, None, None,
                                             axis, b=bb, d=dd,
                                             rows=(1, n - 1, n - 1, n - 1))
                emu = _emulate(coeff, taps, own, None, None, axis, bb, dd,
                               rows=(1, n - 1, n - 1, n - 1))
                part = sk.halo_stencil_plain(coeff, taps, own, left, right,
                                             axis, b=bb, d=dd,
                                             rows=(0, 1, n - 1, n),
                                             out=part)
                emu = _emulate(coeff, taps, own, left, right, axis, bb, dd,
                               rows=(0, 1, n - 1, n), out=emu)
                if r == 1:
                    assert torch.equal(part, want), (case, m, live)
                err = float((emu - part).abs().max() / part.abs().max())
                assert err < 1e-13, (case, m, live, "rows", err)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.complex128, torch.complex64])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_plain_form_is_the_old_path(case, dtype):
    """The plain halo form bit for bit the old path: the planes catted
    (zero planes for a missing neighbour), the plain cross apply on the
    extended block, torch's b - y and x + d * (b - y)."""
    out_grid, ext0, axis, r, offsets = CASES[case]
    coeff, x_full, taps = _case(out_grid, ext0, axis, r, offsets, 2, case)
    if dtype.is_complex:
        coeff = coeff + 1j * coeff.flip(0)
        x_full = x_full - 0.5j * x_full.flip(-1)
    coeff, x_full = coeff.to(dtype), x_full.to(dtype)
    b = torch.from_numpy(np.random.RandomState(50 + case).rand(
        2, *out_grid)).to(dtype)
    ext_taps = tuple(tuple(v + (r if a == axis else 0)
                           for a, v in enumerate(off)) for off in taps)
    for live in ((True, True), (False, True), (False, False)):
        left, own, right = _parts(x_full, axis, r, live)
        zero = lambda t, like: torch.zeros_like(like) if t is None else t
        xe = torch.cat([zero(left, own.narrow(1 + axis, 0, r)), own,
                        zero(right, own.narrow(1 + axis, 0, r))],
                       dim=1 + axis)
        y = sk.cross_apply_plain(coeff, ext_taps, tuple(xe.shape[1:]), xe)
        assert torch.equal(sk.halo_stencil_plain(coeff, taps, own, left,
                                                 right, axis), y)
        assert torch.equal(sk.halo_stencil(coeff, taps, own, left, right,
                                           axis, b=b), b - y)
        if tuple(own.shape[1:]) == out_grid and not dtype.is_complex:
            d = torch.rand(out_grid, dtype=torch.float64).to(dtype)
            assert torch.equal(sk.halo_stencil(coeff, taps, own, left,
                                               right, axis, b=b, d=d),
                               own + d * (b - y))


def test_halo_form_counts_plain_calls_on_the_cpu():
    """On a CPU tensor the halo form is its plain version: PLAIN_CALLS
    counts each row range, no launch counter moves."""
    coeff, x_full, taps = _case((6, 5), 0, 0, 1, CASES[0][4], 1, 0)
    left, own, right = _parts(x_full, 0, 1)
    before = (dict(sk.LAUNCHES), dict(sk.HALO_LAUNCHES),
              dict(sk.HALO_FORM_LAUNCHES), sk.PLAIN_CALLS["float64"])
    out = sk.halo_stencil(coeff, taps, own, None, None, 0,
                          rows=(1, 5, 5, 5))
    sk.halo_stencil(coeff, taps, own, left, right, 0, rows=(0, 1, 5, 6),
                    out=out)
    assert (dict(sk.LAUNCHES), dict(sk.HALO_LAUNCHES),
            dict(sk.HALO_FORM_LAUNCHES)) == before[:3]
    assert sk.PLAIN_CALLS["float64"] == before[3] + 3
    assert set(sk.HALO_FORM_LAUNCHES) == {
        f"{f}.{t}" for f in sk.HALO_FORMS for t in
        ("float32", "float64", "complex64", "complex128")
        if f != "jacobi" or t in ("float32", "float64")}


# ---------------------------------------------------------------------------
# every grid-engine operator's residual
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.complex128])
@pytest.mark.parametrize("dim", [2, 3])
def test_grid_operator_residual_is_b_minus_matvec(dim, dtype):
    """GridStencil.residual and ConstGridStencil.residual are b - matvec(x)
    bit for bit, on grid fields and flat columns: the single-device grid
    cycle and its recorded programs keep their bits."""
    n = 12 if dim == 2 else 6
    M, A = tr.poisson(n, dim)
    A = A.astype(dtype)
    grid = tuple(n + 1 for _ in range(dim))
    gs = grid_stencil_from_csr(A, list(grid), dtype=dtype)
    ops = [GridStencil(torch.as_tensor(gs.coeff), gs.offsets, gs.grid)]
    st = tr.setup(M, A.real.astype(np.float64),
                  **tr.params(2, np.float64))
    ops += [lv.A for lv in st.hier.levels
            if isinstance(lv.A, (GridStencil, ConstGridStencil))]
    rng = np.random.RandomState(dim)
    for op in ops:
        dt = op.dtype
        for shape in [(2,) + tuple(op.grid), (int(np.prod(op.grid)), 3)]:
            x = torch.from_numpy(rng.rand(*shape)).to(dt)
            b = torch.from_numpy(rng.rand(*shape)).to(dt)
            assert torch.equal(op.residual(b, x), b - op.matvec(x))
