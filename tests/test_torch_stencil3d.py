"""The PyTorch port's 3D stencil ops (mgtpu_torch/ops/cuda/const3d.py,
fused3d.py) against mgtpu's Pallas kernels in interpret mode and against
scipy's float64 L x, on the CPU.  Here the port's wrappers take their plain
versions (the tensors lie on the CPU); the CUDA kernels are held against
those plain versions on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

import mgtpu
import mgtpu.ops.pallas.const3d as c3
from mgtpu.models.operators import nodal_laplacian_matrix
from mgtpu.ops.grid_stencil import make_grid_stencil as make_ref
from mgtpu.ops.pallas import fused3d as f3_ref

from mgtpu_torch.ops.cuda import const3d as port_c3
from mgtpu_torch.ops.cuda import fused3d as port_f3
from mgtpu_torch.ops.grid_stencil import make_grid_stencil as make_port

KERNELS = ["matvec", "residual", "jacobi", "jacobi_corr", "jacobi_residual"]
DIMS = [(16, 16, 16), (24, 24, 24), (18, 24, 30)]


@pytest.fixture()
def small_kernels(monkeypatch):
    """Lower mgtpu's size floor so test-size grids build the kernels' face
    arrays, and route its matvec through the Pallas interpreter."""
    def sc(offsets, grid, dtype):
        return (len(grid) == 3
                and all(abs(d) <= 1 for off in offsets for d in off)
                and all(n >= 16 for n in grid)
                and np.dtype(dtype) == np.float32)
    monkeypatch.setattr(c3, "supports_const3d", sc)
    monkeypatch.setenv("MGTPU_PALLAS3D", "interpret")
    yield


def _operator(dims):
    M = mgtpu.get_regular_mesh([0.0, 1.0] * 3, list(dims))
    L = nodal_laplacian_matrix(M)
    L = (L + 1e-4 * abs(L).sum(0).max() * sp.identity(L.shape[0])
         ).tocsr().astype(np.float32)
    return L, [d + 1 for d in dims]


def _inputs(grid, m, seed):
    rng = np.random.RandomState(seed)
    x, b, p = (rng.rand(m, *grid).astype(np.float32) for _ in range(3))
    d = rng.rand(*grid).astype(np.float32)
    return x, b, d, p


def _reference_pallas(kernel, A, x, b, d, p):
    X, B, D, P = (jnp.asarray(v) for v in (x, b, d, p))
    if kernel == "matvec":
        out = c3.const3d_matvec_pallas(A.const, A.faces, A.offsets, X,
                                       A.boxes[0][1][0], interpret=True)
    elif kernel == "residual":
        out = f3_ref.residual3d(A, B, X, interpret=True)
    elif kernel == "jacobi":
        out = f3_ref.jacobi3d(A, D, B, X, interpret=True)
    elif kernel == "jacobi_corr":
        out = f3_ref.jacobi_corr3d(A, D, B, X, P, interpret=True)
    else:
        out = f3_ref.jacobi_residual3d(A, D, B, X, interpret=True)
    return [np.asarray(o) for o in (out if isinstance(out, tuple) else (out,))]


def _port(kernel, A, x, b, d, p):
    X, B, D, P = (torch.from_numpy(v) for v in (x, b, d, p))
    if kernel == "jacobi_residual":
        out = port_f3.jacobi_residual3d(A, D, B, X)
    else:
        out = port_c3.stencil3d_apply(A, kernel, X, b=B, d=D, p=P)
    return [o.numpy() for o in (out if isinstance(out, tuple) else (out,))]


def _scipy_f64(kernel, L, x, b, d, p):
    """The same op in float64 on the assembled operator (fields are
    (m, *grid); flat columns are grid fields raveled in C order)."""
    m = x.shape[0]
    shape = x.shape
    L64 = L.astype(np.float64)

    def mv(v):
        return (L64 @ v.reshape(m, -1).T).T.reshape(shape)
    x, b, d, p = (v.astype(np.float64) for v in (x, b, d, p))
    if kernel == "matvec":
        return [mv(x)]
    if kernel == "residual":
        return [b - mv(x)]
    if kernel == "jacobi":
        return [x + d * (b - mv(x))]
    if kernel == "jacobi_corr":
        s = x + p
        return [s + d * (b - mv(s))]
    x1 = x + d * (b - mv(x))
    return [x1, b - mv(x1)]


def _rel(a, ref):
    return float(np.abs(a.astype(np.float64) - ref).max()
                 / np.abs(ref).max())


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("dims", DIMS)
def test_port_matches_pallas_and_scipy(small_kernels, dims, m, kernel):
    L, nodes = _operator(dims)
    A_ref = make_ref(L, nodes)
    assert A_ref.faces is not None          # the Pallas path is taken
    A = make_port(L, nodes, device="cpu")
    assert type(A).__name__ == "ConstGridStencil"
    x, b, d, p = _inputs(A.grid, m, seed=sum(dims) + m)
    calls = dict(port_c3.PLAIN_CALLS, **port_f3.PLAIN_CALLS)
    got = _port(kernel, A, x, b, d, p)
    # on the CPU the wrapper took the plain version (and counted it)
    after = dict(port_c3.PLAIN_CALLS, **port_f3.PLAIN_CALLS)
    key = "jacobi_residual3d" if kernel == "jacobi_residual" else kernel
    assert after[key] == calls[key] + 1
    want = _reference_pallas(kernel, A_ref, x, b, d, p)
    exact = _scipy_f64(kernel, L, x, b, d, p)
    assert len(got) == len(want) == len(exact)
    for j, (g, w, e) in enumerate(zip(got, want, exact)):
        tol = 1e-4 if j == 1 else 2e-5      # r' of the double apply
        assert g.shape == w.shape == e.shape
        assert _rel(g, w.astype(np.float64)) < tol
        assert _rel(g, e) < tol


def test_kernel_meta_layout():
    """The int32 description the C entries read (csrc/stencil3d.cuh)."""
    L, nodes = _operator((6, 8, 10))
    A = make_port(L, nodes, device="cpu")
    meta = port_c3.kernel_meta(A.offsets, A.grid, A.boxes)
    nd = len(A.offsets)
    assert meta.dtype == np.int32
    assert list(meta[:5]) == [nd, *A.grid, 2]
    off = np.asarray(A.offsets)
    assert np.array_equal(meta[5:5 + 3 * nd].reshape(3, nd), off.T)
    boxes = meta[5 + 3 * nd:].reshape(2, 6, 3)
    assert [tuple(v) for v in boxes[0]] == [st for st, _ in A.boxes]
    assert [tuple(v) for v in boxes[1]] == [sz for _, sz in A.boxes]
    # the band packs the boxes in order: its size is nd * sum of box sizes
    assert A.band.numel() == nd * sum(int(np.prod(sz)) for _, sz in A.boxes)


def test_wrappers_refuse_other_devices():
    """A wrapper launches its kernel on CUDA, takes the plain version on the
    CPU, and raises for any other device rather than guessing."""
    L, nodes = _operator((6, 8, 10))
    A = make_port(L, nodes, device="cpu")
    x = torch.zeros((1,) + A.grid, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        port_c3.stencil3d_apply(A, "matvec", x)
    with pytest.raises(ValueError, match="no kernel"):
        port_f3.jacobi_residual3d(A, x[0], x, x)
    with pytest.raises(ValueError, match="needs b"):
        port_c3.stencil3d_apply(A, "residual", x)


def test_dispatch_rule_is_static():
    """3D radius-1 float32 stencils go to the kernels; float64 and 2D take
    the plain strip assembly (no kernel exists for them)."""
    sc = port_c3.supports_const3d
    off3 = [(0, 0, 1), (1, 0, 0)]
    assert sc(off3, (5, 5, 5), torch.float32)
    assert not sc(off3, (5, 5, 5), torch.float64)
    assert not sc([(0, 1), (1, 0)], (5, 5), torch.float32)
    assert not sc([(0, 0, 2)], (5, 5, 5), torch.float32)


# the grids kernel A runs on: the 3D main path's levels (129^3 nd 7, 65^3,
# 33^3, 17^3 nd 27, and the 129^3 Galerkin operator nd 27), the card's
# non-cubic checks and the plan's edges (X = 16 and 12 planes, y and z one
# node past the tile, and the narrowest and widest interiors of the wide
# tile)
PLAN_GRIDS = [(129, 129, 129), (65, 65, 65), (33, 33, 33), (17, 17, 17),
              (19, 25, 31), (37, 49, 61), (16, 17, 33), (12, 41, 71),
              (16, 23, 100), (12, 19, 131)]


def _band_boxes(grid, w=2):
    """The disjoint band cover of compress_grid_stencil (band width w, 2 on
    every level of the main path)."""
    boxes = []
    for a in range(3):
        start = [w if p < a else 0 for p in range(3)]
        size = [grid[p] - 2 * w if p < a else grid[p] for p in range(3)]
        for s0 in (0, grid[a] - w):
            st, sz = list(start), list(size)
            st[a], sz[a] = s0, w
            boxes.append((tuple(st), tuple(sz)))
    return tuple(boxes)


def test_band_boxes_helper_is_the_ports_cover():
    L, nodes = _operator((18, 24, 30))
    A = make_port(L, nodes, device="cpu")
    assert _band_boxes(A.grid, A.boxes[0][1][0]) == tuple(A.boxes)


@pytest.mark.parametrize("mode", port_c3.MODES)
@pytest.mark.parametrize("grid", PLAN_GRIDS,
                         ids=lambda g: "x".join(map(str, g)))
def test_apply_plan(grid, mode):
    """The interior x-runs cover [w, X-w) once, each nonempty and balanced;
    the tiles cover the interior (y, z) plane; the band blocks hold every
    band node; the rings fit in shared memory; the launch grid is legal for
    m = 1, 2, 4 (the plan depends on neither m nor the tap count, nd 7 or
    27)."""
    w = 2
    boxes = _band_boxes(grid, w)
    plan = port_c3.apply_plan(grid, boxes, mode)
    X, Y, Z = grid
    runs = plan.runs(X, w)
    assert len(runs) == plan.nruns
    covered = [x for a, b in runs for x in range(a, b)]
    assert covered == list(range(w, X - w))
    assert all(b > a for a, b in runs)
    assert max(b - a for a, b in runs) == plan.xrun
    assert plan.xrun >= min(port_c3.XRUN_MIN, X - 2 * w)
    wide = 4 * (Z - 2 * w) >= 3 * port_c3.TILES[1][1]
    assert (plan.ty, plan.tz) == port_c3.TILES[wide]
    assert plan.ntiles == -(-(Y - 2 * w) // plan.ty) * -(-(Z - 2 * w)
                                                         // plan.tz)
    assert plan.threads == plan.tz * plan.ty // 2
    band = sum(int(np.prod(sz)) for _, sz in boxes)
    assert band + (X - 2 * w) * (Y - 2 * w) * (Z - 2 * w) == X * Y * Z
    assert (plan.nband - 1) * plan.threads < band <= plan.nband * plan.threads
    assert plan.smem <= 232_448
    for m in (1, 2, 4):
        assert (plan.ntiles * plan.nruns + plan.nband) < 2 ** 31
        assert m * X * Y * Z < 2 ** 31


# the grids kernel B runs on: the 3D main path's levels, the card's
# non-cubic checks, chip_smoke's plan-edge grids (X = 33 with y, z one node
# past the tile; ragged tiles), grids with no core plane (X = 6 and 5, w =
# 2; X = 3, w = 1: X < 2w + 2), and w = 1 bands
JACRES_GRIDS = [((129, 129, 129), 2), ((65, 65, 65), 2), ((33, 33, 33), 2),
                ((17, 17, 17), 2), ((19, 25, 31), 2), ((37, 49, 61), 2),
                ((33, 17, 16), 2), ((100, 23, 16), 2), ((125, 25, 17), 2),
                ((6, 17, 17), 2), ((5, 9, 9), 2), ((3, 9, 41), 1),
                ((15, 16, 17), 1)]


def _cover(boxes, grid):
    """How many boxes cover each node of the grid."""
    n = np.zeros(grid, dtype=int)
    for st, sz in boxes:
        n[tuple(slice(a, a + z) for a, z in zip(st, sz))] += 1
    return n


@pytest.mark.parametrize("nruns", [None, 1, 10 ** 6])
@pytest.mark.parametrize("grid,w", JACRES_GRIDS,
                         ids=lambda g: "x".join(map(str, g))
                         if isinstance(g, tuple) else f"w{g}")
def test_jacres_plan(grid, w, nruns):
    """Kernel B's plan: the interior x-runs cover [w, X-w) once, each
    nonempty and balanced; the tiles cover the interior (y, z) plane; the
    band and layer boxes with the core cover the grid once, the band blocks
    hold every band node and the shell blocks every band and layer node;
    the rings fit in shared memory; the launch grid is legal for m = 1..3
    (the plan depends on neither m nor the tap count)."""
    boxes = _band_boxes(grid, w)
    plan = port_f3.jacres_plan(grid, boxes, nruns)
    X, Y, Z = grid
    xi, yi, zi = (max(0, v - 2 * w) for v in grid)
    assert (plan.ty, plan.tz, plan.threads) == (16, 32, 256)
    runs = plan.runs(X, w)
    assert len(runs) == plan.nruns
    assert [x for a, b in runs for x in range(a, b)] == list(range(w, X - w))
    assert all(b > a for a, b in runs)
    if xi and yi and zi:
        assert max(b - a for a, b in runs) == plan.xrun
        assert plan.xrun == -(-xi // plan.nruns)
        assert plan.ntiles == -(-yi // 16) * -(-zi // 32)
    else:
        assert plan.xrun == plan.nruns == plan.ntiles == 0
    # the band, the interior's first layer and the core cover the grid once
    layer = port_f3.layer_boxes(grid, w)
    core = tuple(slice(w + 1, v - w - 1) for v in grid)
    cover = _cover(boxes, grid) + _cover(layer, grid)
    cover[core] += 1
    assert (cover == 1).all()
    interior = np.zeros(grid, dtype=bool)
    interior[tuple(slice(w, v - w) for v in grid)] = True
    assert (_cover(layer, grid)[~interior] == 0).all()
    band = int(_cover(boxes, grid).sum())
    shell = band + int(_cover(layer, grid).sum())
    assert (plan.nband - 1) * 256 < band <= plan.nband * 256
    assert (plan.nshell - 1) * 256 < shell <= plan.nshell * 256
    assert plan.smem == 4 * (6 * 20 * 36 + 12 * 18 * 34) <= 232_448
    for m in (1, 2, 3):
        assert m * X * Y * Z < 2 ** 31
        assert plan.ntiles * plan.nruns + plan.nband < 2 ** 31


def test_jacres_plan_at_129():
    """The documented plan of the 129^3 fine level (w = 2): 32 tiles x 12
    runs of 11 planes, 757 band blocks, 1117 shell blocks, 46656 bytes of
    rings; below 65^3 runs of one or two planes."""
    grid = (129, 129, 129)
    plan = port_f3.jacres_plan(grid, _band_boxes(grid))
    assert tuple(plan) == (16, 32, 256, 11, 12, 32, 757, 1117, 46656)
    for n, xrun in ((65, 2), (33, 1), (17, 1)):
        assert port_f3.jacres_plan((n,) * 3, _band_boxes((n,) * 3)).xrun \
            == xrun
