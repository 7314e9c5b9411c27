"""Least bytes of kernel D at small shapes, and the byte-count wrappers."""
import torch

from mgbench import bytes as nb
from mgbench import counters


def test_stencil_bytes():
    assert nb.stencil(7, 100, 100, 1, 4) == 4 * (700 + 200)
    assert nb.stencil(27, 8, 27, 8, 8) == 8 * (27 * 8 + 8 * 27 + 8 * 8)
    assert nb.stencil(27, 8, 27, 1, 4, table=64) == 4 * (216 + 35) + 64


def test_wrappers_installed_once_and_transparent_on_cpu():
    from mgtpu_torch.ops.cuda import const3d, fused3d, stencil
    from mgtpu_torch.ops.grid_stencil import GridStencil, compress_grid_stencil
    import numpy as np
    assert set(counters.kernels()) == {"stencil"}
    plain_a = const3d.stencil3d_apply
    counters.install_byte_counts()
    first = stencil._launch
    counters.install_byte_counts()
    assert stencil._launch is first
    assert const3d.stencil3d_apply is plain_a is fused3d.stencil3d_apply
    offs = tuple((a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
                 for c in (-1, 0, 1) if abs(a) + abs(b) + abs(c) <= 1)
    coeff = np.zeros((7, 8, 8, 8), np.float32)
    for k, o in enumerate(offs):
        coeff[k] = 6.0 if o == (0, 0, 0) else -1.0
    A = compress_grid_stencil(GridStencil(coeff, offs, (8, 8, 8)))
    x = torch.rand(1, 8, 8, 8)
    before = counters.snapshot()
    y = const3d.stencil3d_apply(A, "matvec", x)
    d = counters.delta(before, counters.snapshot())
    assert d == {"const3d.plain.matvec": 1}                 # CPU: no kernel
    ref = const3d.apply_plain(A, "matvec", x)
    assert torch.equal(y, ref)


def test_kernel_launches_subtracts_other_forms_of_d():
    d = {"stencil.launches.float32": 10, "stencil.launches.float64": 2,
         "stencil.launches.mgbench.stencil.calls": 9,
         "stencil.halo.float32": 3, "const3d.launches.matvec": 4}
    assert counters.kernels()["stencil"].launches(d) == 9
    assert counters.launches(d) == 16
    assert counters.own_counts(d, "stencil") == (0, 9)
