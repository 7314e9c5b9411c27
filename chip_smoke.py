#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mgtpu_torch) end to end on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. card   — name and power limit (nvidia-smi) and torch's device name;
2. build  — compile every kernel from mgtpu_torch/csrc with nvcc (sm_90a),
            print ptxas's register, shared-memory and spill lines;
3. kernel — every kernel against its plain torch version on the card, on the
            3D bench operators (fine nd=7, Galerkin nd=27) at 129^3 (m=1-3),
            on the hierarchy's coarser levels, on non-cubic grids and at
            kernel A's plan edges (X = 16, ragged tiles, the wide tile);
            kernel B also against kernel A's jacobi followed by its
            residual (bit for bit, else 2e-5 / 1e-4), with its plan;
            then each kernel's device time (CUDA events, L2 cold at 129^3)
            at 129^3 nd 7 and 27, 65^3, 33^3 and 17^3 beside its byte bound,
            its plain version and a conv3d yardstick, with kernel A's and
            kernel B's plans;
4. path 3D — the 128^3 shifted nodal Laplacian (5 levels, float32):
            mg_setup + solve_mg, refined Jacobi 0.8 V(1,1) to 1e-8 (23 +- 1
            iterations), refined Chebyshev(3) V(1,0) (11 +- 1), and the
            library's default SPAI V(2,2) solve; true f64 residuals on the
            host; launch counters prove the kernels ran and no plain version
            did, and count kernel B's calls by grid;
5. path 2D — the 1024^2 problem, refined Jacobi to 1e-8 (16 +- 1), plain
            torch on the card (no kernel on 2D levels);
6. line kernel — the tridiagonal line kernel (solve and correct) against its
            plain version on every line axis of 1025^2 and 129^3 (m = 1-3),
            on a (19, 25, 31) grid, in float32 and float64, with the line_prec
            coefficients of configurations (a) and (d), and at its plan's
            edges (2- and 3-node lines, ragged strided tiles, the streamed
            variant on (4097, 40) and (40, 8193)); then its device time on
            the strided and the contiguous axes of 1025^2 and 129^3, with
            the plan;
7. path aniso — the anisotropic configurations, f32, refined to 1e-8:
            (a) 2D eps = 100 line Jacobi 0.8 (11 +- 1 iterations),
            (b) 2D eps = 0.01 semicoarsening + line Jacobi 0.9, 7 levels (6),
            (b6) the same at 6 levels, on a 33 x 257 coarsest whose dense
            inverse is built on the card (6),
            (c) 2D mixed strength, alternating lines 0.9 (21),
            (d) 3D eps = 50 on grid axis 0, line Jacobi 0.8 (11),
            (e) the same on grid axis 2 (11);
            launch counters prove the line kernel (both modes) and kernel A's
            matvec ran and no plain version did;
8. path 2D FMG — the 1024^2 problem, Chebyshev(3) V(1,0) refined from a
            full-multigrid start (6 +- 1);
9. stencil kernel — kernel D (the variable-coefficient stencil apply)
            against its plain version on every level of the rough-sigma
            DivSigGrad hierarchies (f) 1025^2 and (h) 129^3 (nd = 5, 7, 9,
            27), on (25, 41) and (19, 25, 31) grids and the slab form, at
            m = 1, 2, 4, in float32 (2e-5) and float64 (1e-12); then its
            device time per level beside its byte bound, its plain version
            and torch.sparse.mm of the operator's CSR form, with its launch
            plan (stream or split);
10. path Krylov — the rough-sigma DivSigGrad solves, f32 hierarchies with
            float64 right-hand sides, to a true f64 relres below 1e-8:
            (f) solve_cg_mg 19 +- 1 iterations, f-bicg solve_bicgstab_mg 12,
            f-block solve_cg_mg(block=True) on 4 right-hand sides 22,
            (g) Jac-GMRES K-cycles under solve_gmres_mg 4 restarts,
            (h) 3D 128^3 solve_cg_mg 16; launch counters prove kernel D ran
            in float32 and float64 and its plain version did not; one CG
            iteration's time by CUDA events and the host clock, and the
            device busy share;
11. AMG   — smoothed aggregation on the 512^2 rough-sigma operator, f32,
            4 levels: kernel D against its plain version on every SA-s
            level (5 / 13 / 37 / 97 taps), the 3D SA levels of a 32^3
            hierarchy (7 / 33 / 179), the DIA form of SA-f's fine level and
            both stride-2 transfer applies (against P @ x, P^T @ r), f32
            (2e-5) and f64 (1e-12), m = 1, 3, and a 257-tap stencil
            refused; at its plan's edges (1, 9 and 256 taps, m = 1, 3, 8,
            9, splits 1, 2, 16, both sides of the stream/split boundary,
            the parity-form transfers on odd and even extents in 2D and
            3D); its device time and plan at those shapes beside its byte
            bound (P's own for the transfers), its plain version and
            torch.sparse.mm (of P^T for the restricts, of the 3D levels'
            CSR); then (SA-s) structured
            SA, SPAI V(2,2) (38 +- 1 refined iterations), (SA-K) the same
            operator with Jac-GMRES K-cycles (48), (SA-f) greedy SA on the
            flat engine (50), each to a true f64 relres below 1e-8, with
            setup time, hierarchy, coarsest solver (a 4225-dof inverse
            built on the card; DenseLU of 964) and operator complexity
            (2.40 / 1.63); launch counters prove kernel D ran in float32
            and float64 in each solve and no plain version did; one cycle's
            time by CUDA events and the host clock, and the busy share;
12. classical — bench.py's agg_ab problem (SA-f's operator, 512^2, f32,
            4 levels, SPAI V(2,2)), set up on the card and solved inside
            one launch-counter window: (C-cc) classical AMG with the C++
            common-C coloring and direct interpolation (13 +- 1 refined
            iterations), (C-pmis) PMIS coloring on the card (13), (SA-dev)
            SA with MIS-2 aggregation on the card (20), each to a true f64
            relres below 1e-8 at its operator complexity (2.7356 / 3.1210 /
            2.2391 +- 0.01), level sizes, formats and coarsest solver
            (SuperLU / SuperLU / DenseLU), with the setup's host and device
            seconds and the device loops' round counts; (C-cg) C-cc under
            solve_cg_mg (8 +- 1, true relres <= 1e-7); counters prove the
            C++ coloring ran, kernel D ran in f32 and f64 in each solve and
            no plain version did; then kernel D against its plain version
            on C-cc's two DIA levels (f32 2e-5, f64 1e-12) and its times
            there; one cycle of each by CUDA events and the host clock, and
            the busy share.

The last lines are one JSON object with a row per kernel, the card's name and
power limit, and {"ok": true, "device": {...}}.  Without a CUDA device, or
without the mgtpu_torch package beside it, the script fails.
"""
from __future__ import annotations

import itertools
import json
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as sp
import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
FP32_FLOPS = 67e12               # H100 SXM float32 outside the tensor cores
FP64_FLOPS = 34e12               # H100 SXM float64 outside the tensor cores
SEED = 0


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def log(*a) -> None:
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# problems
# ---------------------------------------------------------------------------

def shifted_laplacian(dims):
    """The bench operator: nodal Laplacian + 1e-4 (max column sum) I."""
    from mgtpu_torch import get_regular_mesh
    from mgtpu_torch.models.operators import nodal_laplacian_matrix
    M = get_regular_mesh([0.0, 1.0] * len(dims), list(dims))
    L = nodal_laplacian_matrix(M)
    L = (L + 1e-4 * abs(L).sum(axis=0).max()
         * sp.identity(L.shape[0])).tocsr()
    return M, L


def galerkin_coeff(n: int):
    """Grid coefficients of the first full-weighting Galerkin coarsening of
    the shifted nodal Laplacian on an n^3 cube mesh, from its 1D factors:
    A = sum_a L1 (x) I (x) I + s I and P = P1 (x) P1 (x) P1 give
    R A P = 1/8 [Lc (x) Mc (x) Mc + ... + s Mc (x) Mc (x) Mc] with
    Lc = P1' L1 P1, Mc = P1' P1 — so the coarse operator at (n/2 + 1)^3 nodes
    is built without assembling the fine matrix."""
    from mgtpu_torch.models.operators import _ddx_cell
    from mgtpu_torch.setup.transfers import fw_interp_1d
    D = _ddx_cell(n, 1.0 / n)
    L1 = (D.T @ D).tocsr()
    s = 1e-4 * 3 * float(abs(L1).sum(axis=0).max())
    P1 = fw_interp_1d(n + 1)[0]
    Lc = np.asarray((P1.T @ L1 @ P1).todense())
    Mc = np.asarray((P1.T @ P1).todense())
    nc = Lc.shape[0]

    def band(T, o):
        v = np.zeros(nc)
        i = np.arange(max(0, -o), nc - max(0, o))
        v[i] = T[i, i + o]
        return v

    offsets = sorted(itertools.product((-1, 0, 1), repeat=3))
    coeff = np.empty((len(offsets), nc, nc, nc), dtype=np.float64)
    for k, (o0, o1, o2) in enumerate(offsets):
        l0, l1, l2 = band(Lc, o0), band(Lc, o1), band(Lc, o2)
        m0, m1, m2 = band(Mc, o0), band(Mc, o1), band(Mc, o2)
        coeff[k] = 0.125 * (
            l0[:, None, None] * m1[None, :, None] * m2[None, None, :]
            + m0[:, None, None] * l1[None, :, None] * m2[None, None, :]
            + m0[:, None, None] * m1[None, :, None] * l2[None, None, :]
            + s * m0[:, None, None] * m1[None, :, None] * m2[None, None, :])
    return coeff, tuple(offsets), (nc,) * 3


def aniso2d(n: int, eps: float):
    """(a), (b): eps*u_xx + u_yy on the (n+1)^2 node grid, 5-point
    (tests/test_line_smoother.py::_aniso)."""
    from mgtpu_torch import get_regular_mesh
    N = n + 1
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(N, N)) * (n ** 2)
    I = sp.identity(N)
    A = eps * sp.kron(I, T) + sp.kron(T, I)
    return get_regular_mesh([0.0, 1.0, 0.0, 1.0], [n, n]), sp.csr_matrix(A)


def mixed_strength(n: int):
    """(c): a(x)*u_xx + u_yy with a = 100 on the left half, 0.01 on the
    right, plus a 1e-6 shift (tests/test_line_smoother.py::_mixed_strength)."""
    from mgtpu_torch import get_regular_mesh
    N = n + 1
    a_edge = np.where(np.arange(N - 1) < (N - 1) // 2, 100.0, 0.01)
    D = sp.diags([-1.0, 1.0], [0, 1], shape=(N - 1, N))
    Tx = (D.T @ sp.diags(a_edge) @ D) * (n ** 2)
    Ty = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(N, N)) * (n ** 2)
    A = sp.kron(sp.identity(N), Tx) + sp.kron(Ty, sp.identity(N))
    A = A + 1e-6 * abs(A).sum(0).max() * sp.identity(A.shape[0])
    return get_regular_mesh([0.0, 1.0, 0.0, 1.0], [n, n]), sp.csr_matrix(A)


def aniso3d(dims, strong: int, eps: float = 50.0):
    """(d), (e): a 3D 7-point operator with eps on grid axis `strong`
    (tests/test_line_smoother.py::test_line_jacobi_3d); dims per mesh axis."""
    from mgtpu_torch import get_regular_mesh
    Ts = [sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(d + 1, d + 1))
          * (d ** 2) for d in reversed(dims)]          # grid axes (z, y, x)
    A = 0
    for k in range(3):
        mats = [sp.identity(d + 1) for d in reversed(dims)]
        mats[k] = Ts[k]
        w = eps if k == strong else 1.0
        A = A + w * sp.kron(sp.kron(mats[0], mats[1]), mats[2])
    return get_regular_mesh([0.0, 1.0] * 3, list(dims)), sp.csr_matrix(A)


def galerkin_stencil(n: int, device):
    from mgtpu_torch.ops.grid_stencil import (GridStencil,
                                              compress_grid_stencil)
    coeff, offsets, grid = galerkin_coeff(n)
    A = compress_grid_stencil(
        GridStencil(coeff.astype(np.float32), offsets, grid), device=device)
    require(A is not None, "Galerkin operator is not constant-interior")
    return A


def check_galerkin_builder() -> None:
    """The 1D-factor Galerkin builder agrees with the setup's structured RAP
    of the assembled operator (small cube, float64)."""
    from mgtpu_torch.ops.grid_stencil import (grid_stencil_from_csr,
                                              structured_fw_rap)
    n = 16
    _, L = shifted_laplacian((n, n, n))
    ref = structured_fw_rap(grid_stencil_from_csr(L, [n + 1] * 3))
    coeff, offsets, grid = galerkin_coeff(n)
    require(offsets == ref.offsets and grid == ref.grid,
            "Galerkin builder: offsets/grid differ from structured RAP")
    err = np.abs(coeff - ref.coeff).max() / np.abs(ref.coeff).max()
    require(err < 1e-12, f"Galerkin builder differs from RAP: {err:.2e}")
    log(f"galerkin builder vs structured RAP (16^3, f64): rel err {err:.2e}")


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

class Timer:
    """Device time of one call by CUDA events: `reps` calls back to back,
    enqueued behind a GPU sleep so that host launch overhead leaves no idle
    gaps, rotating over several input sets so that at 129^3 each call finds
    its inputs evicted from the card's 50 MB L2 by the others.  Also returns
    the host time of one synchronised call (wrapper and launch overhead)."""

    def __init__(self, reps: int = 20):
        self.reps = reps

    def __call__(self, calls) -> tuple[float, float]:
        for c in calls:
            c()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        calls[0]()
        torch.cuda.synchronize()
        host = time.perf_counter() - t0
        torch.cuda._sleep(int(3e9 * host * self.reps) + 2_000_000)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for i in range(self.reps):
            calls[i % len(calls)]()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / self.reps, host * 1e3


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_card():
    require(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()
    name = torch.cuda.get_device_name(0)
    log(f"[card] {smi} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | {name} x{torch.cuda.device_count()}")
    return smi, name


def phase_build():
    from mgtpu_torch.ops.cuda import _build
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"[build] nvcc {' '.join(_build.FLAGS)}: "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(k in line for k in ("registers", "spill", "entry")):
                log(f"[build] {name}: {line.strip()}")
    for name in _build.SOURCES:
        _build.library(name)


KERNELS = {
    # row name: (replaces, source, fields moved, kernel call)
    "stencil3d_apply.matvec": (
        "mgtpu/ops/pallas/const3d.py:526 _interior_kernel (K1) + "
        ":573 _xband_fix_kernel (K2)", "mgtpu_torch/csrc/const3d.cu", 2),
    "stencil3d_apply.residual": (
        "mgtpu/ops/pallas/fused3d.py:55 _fused_kernel as residual3d (K3) + "
        "const3d.py:573 (K2)", "mgtpu_torch/csrc/const3d.cu", 3),
    "stencil3d_apply.jacobi": (
        "mgtpu/ops/pallas/fused3d.py:55 _fused_kernel as jacobi3d (K4) + "
        "const3d.py:573 (K2)", "mgtpu_torch/csrc/const3d.cu", 4),
    "stencil3d_apply.jacobi_corr": (
        "mgtpu/ops/pallas/fused3d.py:55 _fused_kernel as jacobi_corr3d (K5) "
        "+ const3d.py:573 (K2)", "mgtpu_torch/csrc/const3d.cu", 5),
    "jacobi_residual3d": (
        "mgtpu/ops/pallas/fused3d.py:196 _jacres_kernel (K6) + "
        "const3d.py:573 (K2)", "mgtpu_torch/csrc/fused3d.cu", 5),
    # fields moved per right-hand side (r, out; + x), plus 3 coefficients
    "tridiag.solve": (
        "mgtpu/ops/pallas/tridiag.py:71 _fwd_kernel + :85 _bwd_kernel (K7) "
        "as line_solve_pallas", "mgtpu_torch/csrc/tridiag.cu", 2),
    "tridiag.correct": (
        "mgtpu/ops/pallas/tridiag.py:71 _fwd_kernel + :85 _bwd_kernel (K7) "
        "as line_correct_pallas", "mgtpu_torch/csrc/tridiag.cu", 3),
    # fields moved per right-hand side (x, y), plus nd coefficients
    "stencil.float32": (
        "mgtpu/ops/pallas/stencil_kernel.py:31 _stencil_kernel (K8), "
        "pallas_call at :76", "mgtpu_torch/csrc/stencil.cu", 2),
    "stencil.float64": (
        "mgtpu/ops/pallas/stencil_kernel.py:31 _stencil_kernel (K8), "
        "pallas_call at :76", "mgtpu_torch/csrc/stencil.cu", 2),
}
STENCIL_KERNELS = [k for k in KERNELS
                   if not k.startswith(("tridiag", "stencil."))]


def run_kernel(name, A, x, b, d, p, plain: bool):
    from mgtpu_torch.ops.cuda import const3d, fused3d
    if name == "jacobi_residual3d":
        fn = fused3d.jacobi_residual_plain if plain \
            else fused3d.jacobi_residual3d
        return fn(A, d, b, x)
    mode = name.split(".")[1]
    fn = const3d.apply_plain if plain else const3d.stencil3d_apply
    return fn(A, mode, x, b=b, d=d, p=p)


def fields(grid, m, seed):
    rng = np.random.RandomState(seed)
    x, b, p = (torch.tensor(rng.rand(m, *grid).astype(np.float32),
                            device="cuda") for _ in range(3))
    d = torch.tensor(rng.rand(*grid).astype(np.float32), device="cuda")
    return x, b, d, p


def phase_kernels(st, rows):
    """Kernel against plain version on every case; fills rows[name]."""
    from mgtpu_torch.ops.grid_stencil import (compress_grid_stencil,
                                              grid_stencil_from_csr,
                                              make_grid_stencil,
                                              structured_fw_rap)
    check_galerkin_builder()
    levels = [lv.A for lv in st.hier.levels[:-1]]
    _, Ln = shifted_laplacian((18, 24, 30))
    Ln = Ln.astype(np.float32)
    An7 = make_grid_stencil(Ln, [19, 25, 31], device="cuda")
    An27 = compress_grid_stencil(structured_fw_rap(
        grid_stencil_from_csr(shifted_laplacian((36, 48, 60))[1]
                              .astype(np.float32), [37, 49, 61])),
        device="cuda")
    t0 = time.perf_counter()
    A129_27 = galerkin_stencil(256, "cuda")
    log(f"[kernel] 129^3 Galerkin (nd=27) operator built in "
        f"{time.perf_counter() - t0:.1f} s")
    # kernel A's plan edges: X = 16 planes (one x-run) with y and z one node
    # past the narrow (16, 32) tile; the wide (4, 128) tile at its narrowest
    # interior, ragged in y, and with a Galerkin level
    edge = {}
    for dims in ((32, 16, 15), (99, 22, 15), (124, 24, 16)):   # mesh axes
        nodes = [d + 1 for d in dims]
        L = shifted_laplacian(dims)[1].astype(np.float32)
        edge[tuple(nodes)] = make_grid_stencil(L, nodes, device="cuda")
        if all(n % 2 for n in nodes):
            edge[tuple(nodes) + ("G",)] = compress_grid_stencil(
                structured_fw_rap(grid_stencil_from_csr(L, nodes)),
                device="cuda")
    cases = [("129^3 fine", levels[0], (1, 2, 3)),
             ("129^3 Galerkin", A129_27, (1, 2)),
             ("65^3 Galerkin", levels[1], (1, 2)),
             ("33^3", levels[2], (1,)), ("17^3", levels[3], (1,)),
             ("mesh (18,24,30)", An7, (1, 2, 3)),
             ("mesh (18,24,30) Galerkin", An27, (1, 2))] + [
        (f"edge {k[:3]}{' Galerkin' if len(k) > 3 else ''}", A, (1, 3))
        for k, A in edge.items()]
    from mgtpu_torch.ops.cuda import const3d, fused3d
    for label, A, ms in cases:
        for m in ms:
            x, b, d, p = fields(A.grid, m, SEED)
            for name in STENCIL_KERNELS:
                out = run_kernel(name, A, x, b, d, p, plain=False)
                ref = run_kernel(name, A, x, b, d, p, plain=True)
                outs = out if isinstance(out, tuple) else (out,)
                refs = ref if isinstance(ref, tuple) else (ref,)
                for j, (o, r) in enumerate(zip(outs, refs)):
                    require(o.shape == r.shape and bool(
                        torch.isfinite(o).all()), f"{name}: bad output")
                    ae = float((o - r).abs().max())
                    re = ae / float(r.abs().max())
                    tol = 1e-4 if j == 1 else 2e-5       # r' of the double
                    row = rows[name]
                    row["max_abs_err"] = max(row["max_abs_err"], ae)
                    row["max_rel_err"] = max(row["max_rel_err"], re)
                    require(re < tol, f"{name} {label} m={m}: relative "
                            f"error {re:.3e} >= {tol}")
            # kernel B is kernel A's jacobi followed by its residual, node
            # by node the same arithmetic: bit for bit, else within 2e-5
            # (x') / 1e-4 (r')
            x1, r1 = run_kernel("jacobi_residual3d", A, x, b, d, p,
                                plain=False)
            xa = run_kernel("stencil3d_apply.jacobi", A, x, b, d, p,
                            plain=False)
            ra = run_kernel("stencil3d_apply.residual", A, xa, b, d, p,
                            plain=False)
            same = bool(torch.equal(x1, xa) and torch.equal(r1, ra))
            row = rows["jacobi_residual3d"]
            row["bitwise_kernel_a"] = row.get("bitwise_kernel_a", True) and same
            for o, r, tol in ((x1, xa, 2e-5), (r1, ra, 1e-4)):
                re = float((o - r).abs().max() / r.abs().max())
                require(re < tol, f"kernel B {label} m={m}: {re:.3e} from "
                        f"kernel A's jacobi + residual (>= {tol})")
            plan = const3d.apply_plan(tuple(A.grid), A.boxes, "matvec")
            bplan = fused3d.jacres_plan(tuple(A.grid), A.boxes)
            log(f"[kernel] {label} grid {A.grid} nd={len(A.offsets)} m={m}: "
                f"all kernels match their plain versions (kernel A tile "
                f"{plan.ty}x{plan.tz}, x-run {plan.xrun}, {plan.ntiles} x "
                f"{plan.nruns} interior + {plan.nband} band blocks); kernel B "
                f"{'equals' if same else 'is within tolerance of'} kernel "
                f"A's jacobi + residual (plan: tile {bplan.ty}x{bplan.tz}, "
                f"x-run {bplan.xrun}, "
                f"{bplan.ntiles} x {bplan.nruns} interior + {bplan.nband} "
                f"band + {bplan.nshell} shell blocks)")
    return [(lbl, A) for lbl, A, _ in cases[:5]]


def conv3d_yardstick(A, x):
    """torch conv3d with the interior constants (no boundary band)."""
    w = torch.zeros((1, 1, 3, 3, 3), dtype=torch.float32, device="cuda")
    for k, (dx, dy, dz) in enumerate(A.offsets):
        w[0, 0, 1 + dx, 1 + dy, 1 + dz] = A.const[k]
    xc = x[:, None]
    return lambda: torch.nn.functional.conv3d(xc, w, padding=1)


def phase_timing(timed_levels, rows):
    """Kernel, plain and yardstick device times per level (m = 1)."""
    from mgtpu_torch.ops.cuda import const3d, fused3d
    timer = Timer()
    for label, A in timed_levels:
        sets = [fields(A.grid, 1, SEED + 1 + j) for j in range(4)]
        nodes = int(np.prod(A.grid))
        band_bytes = 4 * int(A.band.numel())
        conv_ms, _ = timer([conv3d_yardstick(A, x) for x, _, _, _ in sets])
        for name in STENCIL_KERNELS:
            nfields = KERNELS[name][2]
            ms, host_ms = timer([
                lambda f=f: run_kernel(name, A, *f, plain=False)
                for f in sets])
            plain_ms, plain_host_ms = timer([
                lambda f=f: run_kernel(name, A, *f, plain=True)
                for f in sets])
            fbytes = nfields * 4 * nodes
            flops = 2 * len(A.offsets) * nodes * (
                2 if name == "jacobi_residual3d" else 1)
            bound = max(fbytes / HBM_BYTES_PER_S,
                        flops / FP32_FLOPS) * 1e3
            rows[name].setdefault("times", {})[
                f"{label} nd={len(A.offsets)}"] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bound,
                library_ms=conv_ms if name.endswith("matvec") else None)
            if name.startswith("stencil3d_apply."):
                plan = const3d.apply_plan(tuple(A.grid), A.boxes,
                                          name.split(".")[1])
            else:
                plan = fused3d.jacres_plan(tuple(A.grid), A.boxes)
            tile = f"  tile {plan.ty}x{plan.tz} x-run {plan.xrun}"
            log(f"[time] {label:14s} nd={len(A.offsets):2d} {name:28s} "
                f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                f"bound {bound:.4f} ms ({fbytes / 1e6:.1f} MB fields, "
                f"+{band_bytes / 1e6:.2f} MB band)  conv3d {conv_ms:.4f} ms"
                f"  kernel/bound {ms / bound:.1f}x  host per call: kernel "
                f"{host_ms:.3f} ms, plain {plain_host_ms:.3f} ms{tile}")
            if label == "129^3 fine":
                rows[name].update(
                    ms=ms, plain_ms=plain_ms, bound_ms=bound,
                    bound_by="bytes" if fbytes / HBM_BYTES_PER_S
                    >= flops / FP32_FLOPS else "operations",
                    band_bytes=band_bytes, conv3d_interior_ms=conv_ms,
                    host_ms=host_ms, plain_host_ms=plain_host_ms,
                    library_ms=conv_ms if name.endswith("matvec") else None)


def reset_counters():
    from mgtpu_torch.ops.cuda import const3d, fused3d, stencil, tridiag
    from mgtpu_torch.setup import native
    for dct in (const3d.LAUNCHES, const3d.PLAIN_CALLS, fused3d.LAUNCHES,
                fused3d.PLAIN_CALLS, tridiag.LAUNCHES, tridiag.PLAIN_CALLS,
                stencil.LAUNCHES, stencil.PLAIN_CALLS, native.CALLS,
                native.PLAIN_CALLS):
        for k in dct:
            dct[k] = 0
    fused3d.GRID_LAUNCHES.clear()


def counters():
    from mgtpu_torch.ops.cuda import const3d, fused3d
    launches = {f"stencil3d_apply.{k}": v for k, v in const3d.LAUNCHES.items()}
    launches.update(fused3d.LAUNCHES)
    plain = dict(const3d.PLAIN_CALLS, **fused3d.PLAIN_CALLS)
    return launches, plain


def line_counters():
    """Launches and plain calls of the line kernel, per mode."""
    from mgtpu_torch.ops.cuda import tridiag
    return ({f"tridiag.{k}": v for k, v in tridiag.LAUNCHES.items()},
            {f"tridiag.{k}": v for k, v in tridiag.PLAIN_CALLS.items()})


def stencil_counters():
    """Launches and plain calls of kernel D, per float type."""
    from mgtpu_torch.ops.cuda import stencil
    return ({f"stencil.{k}": v for k, v in stencil.LAUNCHES.items()},
            {f"stencil.{k}": v for k, v in stencil.PLAIN_CALLS.items()})


def true_relres(L, b, x) -> float:
    xh = x.detach().cpu().numpy().astype(np.float64)
    require(xh.shape == b.shape and np.isfinite(xh).all(),
            "solution has the wrong shape or non-finite values")
    return float(np.linalg.norm(b - L @ xh) / np.linalg.norm(b))


def refined(st, L, b, want, label, card, max_iter=40, fmg=False):
    """Certified refined solve: iteration count and host f64 residual."""
    from mgtpu_torch import solve_mg_refined
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, info = solve_mg_refined(st, b, tol=1e-8, max_iter=max_iter, fmg=fmg)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    rr = true_relres(L, b, x)
    log(f"[path] {label}: refined iters {info['iters']} (want {want} +- 1), "
        f"true f64 relres {rr:.3e}, time to 1e-8 {wall:.1f} ms "
        f"(host clock, synchronised; {card})")
    require(abs(info["iters"] - want) <= 1,
            f"{label}: {info['iters']} refined iterations, want {want} +- 1")
    require(rr < 1e-8, f"{label}: true relres {rr:.3e} >= 1e-8")
    return info["iters"], rr, wall


def one_cycle(st, b):
    """A call running one cycle of the state's hierarchy (either engine)
    from a zero guess on b, in the hierarchy's precision."""
    from mgtpu_torch.config import torch_dtype
    from mgtpu_torch.solvers.mg_solver import _runtime
    to_field, _, cycle, _ = _runtime(st)
    bg = to_field(torch.as_tensor(b, dtype=torch_dtype(st.config.dtype),
                                  device="cuda")[:, None])
    x0 = torch.zeros_like(bg)
    return lambda: cycle(bg, x0)


def vcycle_ms(st, b, card, label="129^3, 5 levels"):
    """One cycle from a zero guess on the fine grid: CUDA events and the
    synchronised host clock (the eager cycle is launch-bound at depth)."""
    run = one_cycle(st, b)
    for _ in range(3):
        run()
    ev, host = [], []
    for _ in range(10):
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        run()
        e1.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        ev.append(e0.elapsed_time(e1))
    ev_ms, host_ms = sorted(ev)[5], sorted(host)[5]
    log(f"[path] {st.config.cycle_type}-cycle ({st.config.relax_type}, "
        f"{label}): {ev_ms:.3f} ms CUDA events, {host_ms:.3f} ms host clock "
        f"({card})")
    return ev_ms, host_ms


def vcycle_profile(st, b, cycle_ms, card, label="129^3"):
    """Device time of one cycle by torch.profiler (sum of kernel times
    over five cycles) against its CUDA-event time: the busy share."""
    from torch.profiler import ProfilerActivity, profile
    run = one_cycle(st, b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            run()
        torch.cuda.synchronize()
    events = [(e.key, e.self_device_time_total / 5e3)
              for e in prof.key_averages() if e.self_device_time_total > 0]
    busy = sum(ms for _, ms in events)
    if busy == 0:
        log("[path] V-cycle device time: not measured (no device events)")
        return None
    d_ms = sum(ms for key, ms in events if "stencil_kernel" in key)
    log(f"[path] {st.config.cycle_type}-cycle ({label}) device time "
        f"{busy:.3f} ms of {cycle_ms:.3f} ms "
        f"(busy share {busy / cycle_ms:.2f}; kernel D {d_ms:.4f} ms; "
        f"{card}); largest:")
    for key, ms in sorted(events, key=lambda e: -e[1])[:6]:
        log(f"[path]   {ms:.4f} ms  {key[:70]}")
    return busy


def per_cycle_launches(st, b):
    """Kernel launches of one V-cycle from a non-zero-guess entry."""
    from mgtpu_torch.cycle.grid_cycle import grid_cycle
    from mgtpu_torch.ops.grid_stencil import flat_to_grid
    bg = flat_to_grid(torch.as_tensor(b, dtype=torch.float32,
                                      device="cuda")[:, None],
                      st.hier.fine_grid)
    reset_counters()
    grid_cycle(st.config, st.hier, bg, torch.zeros_like(bg))
    launches, _ = counters()
    log(f"[path] launches in one Jacobi V(1,1) cycle (plus one "
        f"stencil3d_apply.matvec per solve_mg residual): {launches}")


def phase_path3d(M3, L3, st_jac, card):
    from mgtpu_torch import get_mg_param, mg_setup, solve_mg
    b = L3 @ np.random.RandomState(SEED).rand(L3.shape[0])
    b /= np.linalg.norm(b)
    bc = L3 @ np.random.RandomState(8).rand(L3.shape[0])
    bc /= np.linalg.norm(bc)
    cfg_c, rp_c = get_mg_param(levels=5, relax_type="chebyshev",
                               cheby_degree=3, nu_pre=1, nu_post=0,
                               dtype=np.float32)
    st_cheb = mg_setup(L3, M3, cfg_c, rp_c)
    cfg_s, rp_s = get_mg_param(levels=5, dtype=np.float32)  # SPAI V(2,2)
    st_spai = mg_setup(L3, M3, cfg_s, rp_s)

    reset_counters()                       # ---- main path window ----
    x, info = solve_mg(st_jac, b)
    rr = true_relres(L3, b, x)
    log(f"[path] 3D Jacobi V(1,1) solve_mg: {info['iters']} cycles, relres "
        f"{info['relres']:.3e} (true f64 {rr:.3e})")
    require(info["relres"] < 1e-6, "3D solve_mg did not reach 1e-6")
    refined(st_jac, L3, b, 23, "3D Jacobi 0.8 V(1,1)", card)
    refined(st_cheb, L3, bc, 11, "3D Chebyshev(3) V(1,0)", card)
    xs, info_s = solve_mg(st_spai, b)
    rr_s = true_relres(L3, b, xs)
    log(f"[path] 3D default config (SPAI 1.0 V(2,2)) solve_mg: "
        f"{info_s['iters']} cycles, relres {info_s['relres']:.3e} "
        f"(true f64 {rr_s:.3e})")
    require(info_s["relres"] < 1e-6, "3D SPAI solve_mg did not reach 1e-6")
    launches, plain = counters()           # ---- end of window ----
    from mgtpu_torch.ops.cuda import fused3d
    by_grid = {"x".join(map(str, g)): n
               for g, n in sorted(fused3d.GRID_LAUNCHES.items())}
    log(f"[path] kernel launches: {launches}")
    log(f"[path] kernel B calls by grid: {by_grid}")
    log(f"[path] plain-version calls on the card: {plain}")
    require(all(v > 0 for v in launches.values()),
            f"a kernel of the path was never launched: {launches}")
    require(sum(by_grid.values()) == launches["jacobi_residual3d"],
            f"kernel B calls by grid {by_grid} do not add up")
    require(not any(plain.values()), f"plain versions ran: {plain}")

    # timings after the window (they do not count toward the launches)
    refined(st_jac, L3, b, 23, "3D Jacobi 0.8 V(1,1) (warm)", card)
    refined(st_cheb, L3, bc, 11, "3D Chebyshev(3) V(1,0) (warm)", card)
    jac_ms, _ = vcycle_ms(st_jac, b, card)
    vcycle_profile(st_jac, b, jac_ms, card)
    vcycle_ms(st_cheb, bc, card)
    per_cycle_launches(st_jac, b)
    return launches, by_grid


def phase_path2d(card):
    from mgtpu_torch import get_mg_param, mg_setup
    M, L = shifted_laplacian((1024, 1024))
    cfg, rp = get_mg_param(levels=6, max_outer_iter=20, relative_tol=1e-6,
                           relax_type="jacobi", relax_param=0.8, nu_pre=1,
                           nu_post=1, dtype=np.float32)
    t0 = time.perf_counter()
    st = mg_setup(L, M, cfg, rp)
    log(f"[path] 2D 1024^2 setup {time.perf_counter() - t0:.1f} s")
    b = L @ np.random.RandomState(SEED).rand(L.shape[0])
    b /= np.linalg.norm(b)
    before = counters()
    refined(st, L, b, 16, "2D 1024^2 Jacobi 0.8 V(1,1)", card)
    refined(st, L, b, 16, "2D 1024^2 Jacobi 0.8 V(1,1) (warm)", card)
    require(counters() == before, "2D levels launched a 3D kernel")


# ---------------------------------------------------------------------------
# the line kernel and the anisotropic paths
# ---------------------------------------------------------------------------

def line_states(M, A, dtype):
    """line_prec states (omega 0.8) on every grid axis, as tensors on the
    card; host pivots in f64 once per axis, cast as line_prec casts."""
    from mgtpu_torch.cycle.grid_cycle import line_state_to
    from mgtpu_torch.setup.smoothers import line_prec
    g = len(np.asarray(M.n).ravel())
    return [line_state_to(line_prec(A, M, 0.8, axis=a), dtype, "cuda")
            for a in range(g)]


def run_line(name, lr, r, x, plain: bool):
    from mgtpu_torch.ops.cuda import tridiag
    fn = tridiag.line_plain if plain else tridiag.line_apply
    mode = name.split(".")[1]
    args = (mode, lr.alpha, lr.pivot, lr.cprime, lr.axis, r)
    if mode == "solve":
        return fn(*args, omega=lr.omega)
    return fn(*args, x=x, omega=lr.omega)


def phase_line_kernels(ops, rows):
    """The line kernel against its plain version on every axis, m = 1, 2,
    float32 (2e-4 relative) and float64 (1e-10); returns the f32 states of
    the timed shapes."""
    timed = {}
    for label, (M, A) in ops.items():
        for dtype, tol in ((torch.float32, 2e-4), (torch.float64, 1e-10)):
            states = line_states(M, A, dtype)
            if dtype == torch.float32:
                timed[label] = states
            for lr in states:
                for m in (1, 2, 3):
                    rng = np.random.RandomState(SEED + m)
                    r, x = (torch.tensor(rng.rand(m, *lr.alpha.shape),
                                         dtype=dtype, device="cuda")
                            for _ in range(2))
                    for name in ("tridiag.solve", "tridiag.correct"):
                        o = run_line(name, lr, r, x, plain=False)
                        ref = run_line(name, lr, r, x, plain=True)
                        torch.cuda.synchronize()
                        require(o.shape == ref.shape and o.dtype == ref.dtype
                                and bool(torch.isfinite(o).all()),
                                f"{name}: bad output")
                        ae = float((o - ref).abs().max())
                        re = ae / float(ref.abs().max())
                        row = rows[name]
                        row["max_abs_err"] = max(row["max_abs_err"], ae)
                        row["max_rel_err"] = max(row["max_rel_err"], re)
                        require(re < tol, f"{name} {label} axis {lr.axis} "
                                f"m={m} {dtype}: relative error {re:.3e} "
                                f">= {tol}")
            log(f"[kernel] line kernel, {label} grid "
                f"{tuple(states[0].alpha.shape)} {dtype}: solve and correct "
                "match their plain versions on every axis, m = 1, 2, 3")
    return timed


def thomas_coeffs(grid, axis, dtype, seed=0):
    """Thomas coefficients of a random diagonally dominant tridiagonal
    operator along `axis` of `grid`, in line_prec's form (alpha zero at
    line starts, cprime zero at line ends), on the card."""
    rng = np.random.RandomState(seed)
    sub, sup = (-rng.uniform(0.5, 1.0, grid) for _ in range(2))
    diag = 2.5 + rng.rand(*grid)
    sub, sup, diag = (np.moveaxis(v, axis, 0) for v in (sub, sup, diag))
    sub[0] = 0.0
    sup[-1] = 0.0
    piv, cp = np.empty_like(diag), np.empty_like(diag)
    for i in range(diag.shape[0]):
        piv[i] = 1.0 / (diag[i] - sub[i] * (cp[i - 1] if i else 0.0))
        cp[i] = sup[i] * piv[i]
    return [torch.tensor(np.ascontiguousarray(np.moveaxis(v, 0, axis)),
                         dtype=dtype, device="cuda")
            for v in (-piv * sub, piv, cp)]


# kernel C's plan edges: 2- and 3-node lines, a strided inner extent that
# is not a multiple of the tile, the long lines of a (4097, 40) grid on both
# axes (streamed strided, staged contiguous) and of (40, 8193) (a staged
# contiguous line past 48 KB in f32, a streamed one in f64)
LINE_EDGES = [((2, 37), 0), ((3, 37), 0), ((37, 2), 1), ((37, 3), 1),
              ((4097, 40), 0), ((4097, 40), 1), ((40, 8193), 1)]


def phase_line_edges(rows):
    """The line kernel against its plain version at its plan's edges, both
    variants, float32 (2e-4) and float64 (1e-10), m = 1 and 3."""
    from mgtpu_torch.ops.cuda import tridiag
    seen = set()
    for grid, axis in LINE_EDGES:
        inner = int(np.prod(grid[axis + 1:]))
        len_outer = int(np.prod(grid[:axis]))
        for dtype, tol in ((torch.float32, 2e-4), (torch.float64, 1e-10)):
            alpha, piv, cp = thomas_coeffs(grid, axis, dtype)
            for m in (1, 3):
                rng = np.random.RandomState(SEED + m)
                r, x = (torch.tensor(rng.rand(m, *grid), dtype=dtype,
                                     device="cuda") for _ in range(2))
                for mode in tridiag.MODES:
                    kw = dict(omega=0.8, x=x if mode == "correct" else None)
                    plan = tridiag.line_plan(
                        r.numel() // (grid[axis] * inner), grid[axis], inner,
                        r.element_size(), mode)
                    seen.add((mode, plan.variant))
                    o = tridiag.line_apply(mode, alpha, piv, cp, axis, r, **kw)
                    ref = tridiag.line_plain(mode, alpha, piv, cp, axis, r,
                                             **kw)
                    torch.cuda.synchronize()
                    require(o.shape == ref.shape and bool(
                        torch.isfinite(o).all()), f"line {grid}: bad output")
                    ae = float((o - ref).abs().max())
                    re = ae / float(ref.abs().max())
                    row = rows[f"tridiag.{mode}"]
                    row["max_abs_err"] = max(row["max_abs_err"], ae)
                    row["max_rel_err"] = max(row["max_rel_err"], re)
                    require(re < tol, f"line {grid} axis {axis} m={m} {mode} "
                            f"{dtype} ({plan.variant}): relative error "
                            f"{re:.3e} >= {tol}")
            plans = {md: tridiag.line_plan(
                len_outer, grid[axis], inner, r.element_size(), md)[:2]
                for md in tridiag.MODES}
            log(f"[kernel] line kernel edge {grid} axis {axis} {dtype}: "
                f"matches its plain version, m = 1, 3 (m = 1 plans: "
                f"{plans})")
    want = {(m, v) for m in tridiag.MODES for v in ("staged", "streamed")}
    require(seen == want, f"line edges reached {sorted(seen)}, want both "
            "variants in both modes")


def phase_line_timing(timed, rows):
    """Device time of the line kernel (m = 1, f32, four input sets with
    their own copies of the coefficients, so that every call reads its
    inputs from device memory) beside its byte bound and plain time."""
    from mgtpu_torch.cycle.relax import LineRelax
    from mgtpu_torch.ops.cuda import tridiag
    timer = Timer()
    cases = [("1025^2", 0), ("1025^2", 1), ("129^3", 0), ("129^3", 2)]
    for label, axis in cases:
        lr = timed[label][axis]
        nodes = lr.alpha.numel()
        sets = [(LineRelax(lr.alpha.clone(), lr.pivot.clone(),
                           lr.cprime.clone(), lr.axis, lr.omega),
                 *(torch.tensor(np.random.RandomState(SEED + 10 + j).rand(
                     1, *lr.alpha.shape), dtype=torch.float32, device="cuda")
                   for _ in range(2))) for j in range(4)]
        for name in ("tridiag.solve", "tridiag.correct"):
            ms, host_ms = timer([lambda s=s: run_line(name, *s, False)
                                 for s in sets])
            plain_ms, _ = timer([lambda s=s: run_line(name, *s, True)
                                 for s in sets])
            fbytes = (KERNELS[name][2] + 3) * 4 * nodes
            flops = (7 if name.endswith("correct") else 6) * nodes
            bound = max(fbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
            grid = tuple(lr.alpha.shape)
            inner = int(np.prod(grid[axis + 1:]))
            plan = tridiag.line_plan(nodes // (grid[axis] * inner),
                                     grid[axis], inner, 4, name[8:])
            log(f"[time] line {label} axis {axis} "
                f"({'contiguous' if inner == 1 else 'strided'}) "
                f"{name:16s} kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                f"bound {bound:.4f} ms ({fbytes / 1e6:.1f} MB)  "
                f"kernel/bound {ms / bound:.1f}x  host per call "
                f"{host_ms:.3f} ms  plan {tuple(plan)}")
            rows[name].setdefault("times", {})[f"{label} axis {axis}"] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bound)
            if (label, axis) == ("1025^2", 1):     # configuration (a)'s lines
                rows[name].update(
                    ms=ms, plain_ms=plain_ms, bound_ms=bound,
                    bound_by="bytes" if fbytes / HBM_BYTES_PER_S
                    >= flops / FP32_FLOPS else "operations",
                    library_ms=None, host_ms=host_ms,
                    timed_shape="1025^2 f32 m=1, lines on grid axis 1")


ANISO = [
    # key, label, operator, options, refined iterations
    ("a", "(a) 2D eps=100, line Jacobi 0.8 V(1,1), 6 levels",
     lambda: aniso2d(1024, 100.0),
     dict(levels=6, relax_type="line-jacobi", relax_param=0.8), 11),
    ("b", "(b) 2D eps=0.01, semicoarsening + line Jacobi 0.9, 7 levels",
     lambda: aniso2d(1024, 0.01),
     dict(levels=7, relax_type="line-jacobi", relax_param=0.9,
          transfer_type="semicoarsening"), 6),
    ("b6", "(b6) the same at 6 levels: a 33 x 257 coarsest, device-built "
     "inverse", lambda: aniso2d(1024, 0.01),
     dict(levels=6, relax_type="line-jacobi", relax_param=0.9,
          transfer_type="semicoarsening"), 6),
    ("c", "(c) 2D mixed strength, alternating lines 0.9, 6 levels",
     lambda: mixed_strength(1024),
     dict(levels=6, relax_type="line-jacobi",
          relax_param={"axis": "alt", "omega": 0.9}), 21),
    ("d", "(d) 3D eps=50 on grid axis 0, line Jacobi 0.8, 5 levels",
     lambda: aniso3d([128] * 3, 0),
     dict(levels=5, relax_type="line-jacobi", relax_param=0.8), 11),
    ("e", "(e) 3D eps=50 on grid axis 2, line Jacobi 0.8, 5 levels",
     lambda: aniso3d([128] * 3, 2),
     dict(levels=5, relax_type="line-jacobi", relax_param=0.8), 11),
]
SEMI_GRIDS = [(1025, 1025), (513, 1025), (257, 1025), (129, 1025),
              (65, 513), (33, 257), (17, 129)]


def phase_aniso(ops, card):
    """Configurations (a)-(e) through mg_setup + solve_mg_refined on the
    card; returns the launches of the window."""
    from mgtpu_torch import get_mg_param, mg_setup
    runs = []
    for key, label, make, opts, want in ANISO:
        M, A = ops[key] if key in ops else make()
        cfg, rp = get_mg_param(nu_pre=1, nu_post=1, dtype=np.float32, **opts)
        t0 = time.perf_counter()
        st = mg_setup(A, M, cfg, rp)
        grids = [tuple(lv.A.grid) for lv in st.hier.levels]
        log(f"[path] {label}: setup {time.perf_counter() - t0:.1f} s, "
            f"grids {grids}")
        if key in ("b", "b6"):
            want_grids = SEMI_GRIDS[:cfg.levels]
            require(grids == want_grids, f"({key}) level grids {grids}, "
                    f"want {want_grids}")
        if key == "b6":
            from mgtpu_torch.cycle.grid_cycle import DenseInverse
            require(isinstance(st.hier.coarse, DenseInverse),
                    "(b6): want the device-built dense inverse")
        b = A @ np.random.RandomState(SEED).rand(A.shape[0])
        runs.append((key, label, st, A, b / np.linalg.norm(b), want))

    reset_counters()                       # ---- main path window ----
    for key, label, st, A, b, want in runs:
        before = dict(line_counters()[0], **stencil_counters()[0])
        refined(st, A, b, want, label, card, max_iter=60)
        after = dict(line_counters()[0], **stencil_counters()[0])
        log(f"[path] {key}: line kernel and kernel D launches in this "
            f"solve: {({k: v - before[k] for k, v in after.items()})}")
    launches, plain = counters()           # ---- end of window ----
    for more in (line_counters(), stencil_counters()):
        launches.update(more[0])
        plain.update(more[1])
    log(f"[path] aniso kernel launches: {launches}")
    log(f"[path] aniso plain-version calls on the card: {plain}")
    # (c) is a variable-coefficient operator: kernel D in f32 and f64
    for k in ("tridiag.solve", "tridiag.correct", "stencil3d_apply.matvec",
              "stencil.float32", "stencil.float64"):
        require(launches[k] > 0, f"{k} was never launched on the aniso path")
    require(not any(plain.values()), f"plain versions ran: {plain}")

    for key, label, st, A, b, want in runs:
        if key in ("a", "d"):
            refined(st, A, b, want, label + " (warm)", card, max_iter=60)
            ev_ms, _ = vcycle_ms(st, b, card, label=label)
            vcycle_profile(st, b, ev_ms, card, label=f"({key})")
    return launches


def phase_fmg(card):
    """The 2D 1024^2 bench operator, Chebyshev(3) V(1,0), 6 levels, refined
    from a full-multigrid start (6 +- 1)."""
    from mgtpu_torch import get_mg_param, mg_setup
    M, L = shifted_laplacian((1024, 1024))
    cfg, rp = get_mg_param(levels=6, relax_type="chebyshev", cheby_degree=3,
                           nu_pre=1, nu_post=0, dtype=np.float32)
    st = mg_setup(L, M, cfg, rp)
    b = L @ np.random.RandomState(SEED).rand(L.shape[0])
    b /= np.linalg.norm(b)
    reset_counters()                       # ---- path window ----
    refined(st, L, b, 6, "2D 1024^2 Chebyshev(3) V(1,0), FMG start", card,
            fmg=True)
    launches, plain = counters()           # ---- end of window ----
    line_l, line_p = line_counters()
    d_l, d_p = stencil_counters()
    plain.update(line_p, **d_p)
    require(not any(plain.values()), f"plain versions ran: {plain}")
    require(not any(launches.values()) and not any(line_l.values())
            and not any(d_l.values()),
            "the constant-coefficient 2D FMG path launched a 3D, line or "
            "variable-coefficient kernel")
    refined(st, L, b, 6, "2D 1024^2 Chebyshev(3) V(1,0), FMG start (warm)",
            card, fmg=True)


# ---------------------------------------------------------------------------
# kernel D and the variable-coefficient (Krylov) paths
# ---------------------------------------------------------------------------

def divsig(dims, shift=1e-8, seed=3):
    """Rough-sigma DivSigGrad, sigma = exp(RandomState(seed).randn(cells)),
    + shift * (max column sum) I (bench.py:540-544's operator)."""
    from mgtpu_torch import get_regular_mesh
    from mgtpu_torch.models.operators import nodal_div_sig_grad_matrix
    M = get_regular_mesh([0.0, 1.0] * len(dims), list(dims))
    sig = np.exp(np.random.RandomState(seed).randn(M.num_cells))
    A = nodal_div_sig_grad_matrix(M, sig)
    A = (A + shift * abs(A).sum(axis=0).max()
         * sp.identity(A.shape[0])).tocsr()
    return M, A


def stencil_cases(states):
    """(label, GridStencil) of every level of the (f) and (h) hierarchies,
    in f32 and as f64 casts, plus the f64 fine operators and the small
    non-square / non-cubic fine and Galerkin levels."""
    from mgtpu_torch.ops.grid_stencil import (GridStencil,
                                              grid_stencil_from_csr,
                                              structured_fw_rap)
    from mgtpu_torch.solvers.mg_solver import high_precision_fine_operator
    cases = []
    for key, st in states.items():
        for l, lv in enumerate(st.hier.levels):
            A = lv.A
            require(isinstance(A, GridStencil),
                    f"({key}) level {l} is a {type(A).__name__}, want a "
                    "variable GridStencil")
            cases.append((f"({key}) level {l}", A))
            cases.append((f"({key}) level {l} f64", GridStencil(
                A.coeff.double(), A.offsets, A.grid)))
        cases.append((f"({key}) f64 fine operator",
                      high_precision_fine_operator(st)))
    for dims in ((24, 40), (18, 24, 30)):
        _, A = divsig(dims)
        gs = grid_stencil_from_csr(A, [d + 1 for d in dims])
        for dt in (np.float32, np.float64):
            g = GridStencil(gs.coeff.astype(dt), gs.offsets, gs.grid)
            cases.append((f"{g.grid} fine {np.dtype(dt).name}",
                          g.to("cuda")))
            r = structured_fw_rap(g)
            cases.append((f"{r.grid} Galerkin {np.dtype(dt).name}",
                          r.to("cuda")))
    return cases


D_TOLS = {torch.float32: 2e-5, torch.float64: 1e-12}


def check_d(rows, label, out, ref):
    """Kernel D's output against its reference: same shape and type,
    finite, relative error below 2e-5 (f32) / 1e-12 (f64); the row of its
    type keeps the largest errors."""
    torch.cuda.synchronize()
    require(out.shape == ref.shape and out.dtype == ref.dtype
            and bool(torch.isfinite(out).all()), f"D {label}: bad output")
    ae = float((out - ref).abs().max())
    re = ae / float(ref.abs().max())
    row = rows[f"stencil.{str(ref.dtype).split('.')[-1]}"]
    row["max_abs_err"] = max(row["max_abs_err"], ae)
    row["max_rel_err"] = max(row["max_rel_err"], re)
    require(re < D_TOLS[ref.dtype], f"kernel D {label}: relative error "
            f"{re:.3e} >= {D_TOLS[ref.dtype]}")


def phase_stencil_kernels(states, rows):
    """Kernel D against its plain version on every case, m = 1, 2, 4;
    the slab entry on a 2D and a folded 3D operator."""
    from mgtpu_torch.ops.cuda import stencil
    from mgtpu_torch.ops.grid_stencil import grid_stencil_matvec
    from mgtpu_torch.parallel.stencil import stencil_from_banded
    def check(label, m, out, ref):
        check_d(rows, f"{label} m={m}", out, ref)

    for label, A in stencil_cases(states):
        for m in (1, 2, 4):
            x = torch.tensor(np.random.RandomState(SEED + m).rand(
                m, *A.grid), dtype=A.coeff.dtype, device="cuda")
            check(label, m, stencil.grid_apply(A.coeff, A.offsets, x),
                  grid_stencil_matvec(A.coeff, A.offsets, x))
        log(f"[kernel] D {label}: grid {A.grid} nd={len(A.offsets)} "
            f"{A.coeff.dtype}: matches its plain version, m = 1, 2, 4")
    for dims in ((24, 40), (18, 24, 30)):
        _, A = divsig(dims)
        for dt in (np.float32, np.float64):
            sl = stencil_from_banded(A, [d + 1 for d in dims], 0.8, dtype=dt)
            coeff = torch.tensor(sl.coeff, device="cuda")
            for m in (1, 2, 4):
                x = torch.tensor(np.random.RandomState(m).rand(m, *sl.shape),
                                 dtype=coeff.dtype, device="cuda")
                check(f"slab {sl.shape}", m,
                      stencil.stencil_matvec(coeff, sl.di, sl.dj, x),
                      stencil.stencil_matvec_plain(coeff, sl.di, sl.dj, x))
        log(f"[kernel] D slab form of {dims} ({len(sl.di)} taps, NI = "
            f"{sl.shape[1]}): matches its plain version, f32 and f64")


def sparse_mm_yardstick(C, dtype):
    """The level's host CSR matrix as a torch CSR tensor on the card (the
    operand of the torch.sparse.mm yardstick)."""
    C = sp.csr_matrix(C)
    return torch.sparse_csr_tensor(
        torch.tensor(C.indptr, dtype=torch.int64),
        torch.tensor(C.indices, dtype=torch.int64),
        torch.tensor(C.data), size=C.shape, dtype=dtype, device="cuda")


def d_plan(box, nd, dtype, form="apply", m=1):
    """Kernel D's launch plan (ops/cuda/stencil.py::stencil_plan) as a dict
    with its schedule; None for a checkout whose kernel D has no plan."""
    from mgtpu_torch.ops.cuda import stencil
    planner = getattr(stencil, "stencil_plan", None)
    if planner is None:
        return None
    p = planner(tuple(int(v) for v in box), int(nd), m, dtype, form)
    return dict(p._asdict(), schedule=p.schedule)


def box3(grid):
    return (1,) * (3 - len(grid)) + tuple(int(v) for v in grid)


def d_case(kind, op, csr):
    """What timing one kernel-D case needs: (dtype, input shape, kernel
    call, plain call, plan, least bytes, flops, shape note).  kind: "grid"
    (a GridStencil), "dia" (a DIA matrix), "prolong" / "restrict" (a
    Stride2Transfer, whose least bytes are P's own: nnz + nc + nf values
    of csr, P or P^T)."""
    from mgtpu_torch.ops.cuda import stencil
    from mgtpu_torch.ops.grid_stencil import grid_stencil_matvec
    dt = op.dtype
    item = torch.empty((), dtype=dt).element_size()
    if kind == "grid":
        n, nd = int(np.prod(op.grid)), len(op.offsets)
        return (dt, (1,) + tuple(op.grid),
                lambda x: stencil.grid_apply(op.coeff, op.offsets, x),
                lambda x: grid_stencil_matvec(op.coeff, op.offsets, x),
                d_plan(box3(op.grid), nd, dt), (nd + 2) * n * item,
                2 * nd * n, f"grid {op.grid} nd={nd}")
    if kind == "dia":
        n, nd = op.shape[0], len(op.offsets)
        return (dt, (n, 1),
                lambda x: stencil.dia_apply(op.data, op.offsets, x),
                lambda x: stencil.dia_apply_plain(op.data, op.offsets, x),
                d_plan((1, 1, n), nd, dt), (nd + 2) * n * item, 2 * nd * n,
                f"DIA n={n} nd={nd}")
    pbytes = (csr.nnz + csr.shape[0] + csr.shape[1]) * item
    packed = hasattr(op, "pcoeff")
    if kind == "prolong":
        return (dt, (1,) + tuple(op.coarse_grid), op.prolong,
                getattr(stencil, "stride2_prolong_plain", None)
                and (lambda x: stencil.stride2_prolong_plain(op, x)),
                d_plan(box3(op.fine_grid), op.pcoeff.shape[0], dt,
                       "prolong") if packed else None, pbytes, 2 * csr.nnz,
                f"{op.coarse_grid} -> {op.fine_grid} "
                f"taps {len(op.offsets)}")
    return (dt, (1,) + tuple(op.fine_grid), op.restrict,
            getattr(stencil, "stride2_restrict_plain", None)
            and (lambda x: stencil.stride2_restrict_plain(op, x)),
            d_plan(box3(op.coarse_grid), len(op.offsets), dt, "restrict")
            if packed else None, pbytes, 2 * csr.nnz,
            f"{op.fine_grid} -> {op.coarse_grid} taps {len(op.offsets)}")


def time_d(label, kind, op, csr, timer, card, plain=True, seed=30):
    """Kernel D's device time on one case (m = 1, four input sets), beside
    its least time, its plain version (if `plain`) and torch.sparse.mm of
    `csr`; returns the entry and the kernel's output on the first set."""
    dt, shape, run, plain_fn, plan, fbytes, flops, note = d_case(kind, op,
                                                                 csr)
    sets = [torch.tensor(np.random.RandomState(SEED + seed + j).rand(*shape),
                         dtype=dt, device="cuda") for j in range(4)]
    ms, host_ms = timer([lambda x=x: run(x) for x in sets])
    plain_ms = (timer([lambda x=x: plain_fn(x) for x in sets])[0]
                if plain and plain_fn else None)
    lib_ms = None
    if csr is not None:
        Tm = sparse_mm_yardstick(csr, dt)
        lib_ms = timer([lambda c=x.reshape(-1, 1): torch.sparse.mm(Tm, c)
                        for x in sets])[0]
    peak = FP32_FLOPS if dt == torch.float32 else FP64_FLOPS
    bound = max(fbytes / HBM_BYTES_PER_S, flops / peak) * 1e3
    fmt = lambda v: "none" if v is None else f"{v:.4f} ms"
    sched = "no plan" if plan is None else (
        f"plan {plan['schedule']} split {plan['split']} group "
        f"{plan['group']} blocks {plan['blocks']}")
    log(f"[time] D {label:18s} {note} {dt}: kernel {ms:.4f} ms  plain "
        f"{fmt(plain_ms)}  sparse.mm {fmt(lib_ms)}  bound {bound:.4f} ms "
        f"({fbytes / 1e6:.2f} MB)  kernel/bound {ms / bound:.1f}x  {sched}"
        f"  host per call {host_ms:.3f} ms ({card})")
    entry = dict(shape=note, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                 bound_ms=bound, host_ms=host_ms, plan=plan,
                 bound_by="bytes" if fbytes / HBM_BYTES_PER_S
                 >= flops / peak else "operations")
    return entry, run(sets[0])


def fh_cases(states):
    """(label, kind, op, csr) of every level of (f) and (h) and of (f)'s
    f64 fine operator."""
    from mgtpu_torch.solvers.mg_solver import high_precision_fine_operator
    out = []
    for key, st in states.items():
        for l, lv in enumerate(st.hier.levels):
            out.append((f"({key}) level {l}", "grid", lv.A, st.As[l]))
        if key == "f":
            out.append(("(f) f64 fine", "grid",
                        high_precision_fine_operator(st), st.A_input))
    return out


def phase_stencil_timing(states, rows, card):
    """Kernel D, plain and torch.sparse.mm device times on every level of
    (f) and (h) (m = 1, four input sets so that the large levels come from
    device memory) and on the f64 fine operator of (f), with D's plan."""
    timer = Timer()
    for label, kind, op, csr in fh_cases(states):
        entry, _ = time_d(label, kind, op, csr, timer, card)
        name = f"stencil.{str(op.dtype).split('.')[-1]}"
        rows[name].setdefault("times", {})[label] = entry
        if label in ("(f) level 0", "(f) f64 fine"):
            rows[name].update(
                {k: entry[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms", "host_ms",
                                       "plan")},
                timed_shape=f"{label}: {entry['shape']} m=1",
                library_call="torch.sparse.mm(CSR, x)")


KRYLOV = [
    # key, label, state, solve, keywords, right-hand sides, mgtpu's count
    # on the CPU (f-block's from scripts/fblock_reference.py)
    ("f", "(f) 2D 1025^2 rough sigma, solve_cg_mg, Jacobi 0.8 V(1,1)",
     "f", "solve_cg_mg", {}, "b", 19),
    ("f-bicg", "(f-bicg) the same, solve_bicgstab_mg", "f",
     "solve_bicgstab_mg", {}, "b", 12),
    ("f-block", "(f-block) the same, 4 RHS, solve_cg_mg(block=True)", "f",
     "solve_cg_mg", dict(block=True), "B", 22),
    ("g", "(g) the same operator, Jac-GMRES 1.0 K-cycles, "
     "solve_gmres_mg(inner=5)", "g", "solve_gmres_mg", dict(inner=5), "b",
     4),
    ("h", "(h) 3D 129^3 rough sigma, solve_cg_mg, Jacobi 0.8 V(1,1)", "h",
     "solve_cg_mg", {}, "b", 16),
]


def krylov_states():
    """(f)/(g) on the 1024^2-cell operator (6 levels) and (h) on the
    128^3-cell one (5 levels), f32 hierarchies; right-hand sides as in the
    reference counts: b = A RandomState(4).rand(n) normalised, and
    RandomState(4).rand(n, 4) with normalised columns."""
    from mgtpu_torch import get_mg_param, mg_setup
    base = dict(max_outer_iter=100, relative_tol=1e-8, nu_pre=1, nu_post=1,
                dtype=np.float32)
    ops, states = {}, {}
    for key, dims, levels, opts in (
            ("f", (1024, 1024), 6, dict(relax_type="jacobi",
                                        relax_param=0.8)),
            ("g", None, 6, dict(relax_type="jac-gmres", relax_param=1.0,
                                cycle_type="K")),
            ("h", (128, 128, 128), 5, dict(relax_type="jacobi",
                                           relax_param=0.8))):
        t0 = time.perf_counter()
        # (g) runs on (f)'s operator
        M, A = ops[key] = ops["f"] if dims is None else divsig(dims)
        cfg, rp = get_mg_param(levels=levels, **base, **opts)
        states[key] = mg_setup(A, M, cfg, rp)
        log(f"[path] ({key}) operator + setup {time.perf_counter() - t0:.1f}"
            f" s, grids {[lv.A.grid for lv in states[key].hier.levels]}, "
            f"taps {[len(lv.A.offsets) for lv in states[key].hier.levels]}")
    rhs = {}
    for key in ("f", "h"):
        A = ops[key][1]
        b = A @ np.random.RandomState(4).rand(A.shape[0])
        B = np.random.RandomState(4).rand(A.shape[0], 4)
        rhs[key] = dict(b=b / np.linalg.norm(b),
                        B=B / np.linalg.norm(B, axis=0))
    rhs["g"] = rhs["f"]
    return ops, states, rhs


def phase_krylov(ops, states, rhs, card):
    """The Krylov solves inside one launch-counter window; returns kernel
    D's launches in the window."""
    import mgtpu_torch
    reset_counters()                       # ---- main path window ----
    for key, label, skey, fn, kw, which, want in KRYLOV:
        A, rh = ops[skey][1], rhs[skey][which]
        before = stencil_counters()[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, info = getattr(mgtpu_torch, fn)(states[skey], rh, **kw)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        xh = x.detach().cpu().numpy()
        require(xh.shape == rh.shape and xh.dtype == np.float64
                and np.isfinite(xh).all(), f"{key}: bad solution")
        rr = np.linalg.norm(rh - A @ xh, axis=0) / np.linalg.norm(rh, axis=0)
        iters = int(info["iters"])
        d_l = {k: v - before[k] for k, v in stencil_counters()[0].items()}
        log(f"[path] {label}: {iters} iterations (mgtpu {want}), true "
            f"f64 relres {np.array2string(np.atleast_1d(rr), precision=3)}, "
            f"time to 1e-8 {wall:.1f} ms (host clock, synchronised; {card})"
            f"; kernel D launches {d_l}")
        require(abs(iters - want) <= 1,
                f"{key}: {iters} iterations, want {want} +- 1")
        require(bool(np.all(rr < 1e-8)), f"{key}: true relres {rr} >= 1e-8")
    launches, plain = stencil_counters()   # ---- end of window ----
    more_l, more_p = counters()
    plain.update(more_p)
    log(f"[path] Krylov window kernel D launches: {launches}; other "
        f"kernels {more_l}")
    log(f"[path] Krylov window plain-version calls on the card: {plain}")
    for k in ("stencil.float32", "stencil.float64"):
        require(launches[k] > 0, f"{k} was never launched on the Krylov "
                "path")
    require(not any(plain.values()), f"plain versions ran: {plain}")
    return launches


def cg_iteration(st, b, card):
    """One CG iteration of (f) by CUDA events and the host clock, as the
    slope between a 2- and a 12-iteration solve (tol 0), and the device
    busy share of the 12-iteration solve (torch.profiler)."""
    from dataclasses import replace
    from torch.profiler import ProfilerActivity, profile
    from mgtpu_torch import solve_cg_mg
    cfg = st.config

    def run(k):
        st.config = replace(cfg, max_outer_iter=k, relative_tol=0.0)
        try:
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            _, info = solve_cg_mg(st, b)
            e1.record()
            torch.cuda.synchronize()
            require(int(info["iters"]) == k, "fixed-count CG stopped early")
            return e0.elapsed_time(e1), (time.perf_counter() - t0) * 1e3
        finally:
            st.config = cfg

    run(2)
    ev, host = [], []
    for _ in range(3):
        e12, h12 = run(12)
        e2, h2 = run(2)
        ev.append((e12 - e2) / 10)
        host.append((h12 - h2) / 10)
    ev_ms, host_ms = sorted(ev)[1], sorted(host)[1]
    log(f"[path] one CG iteration of (f) (V-cycle + f64 matvec + dots): "
        f"{ev_ms:.3f} ms CUDA events, {host_ms:.3f} ms host clock ({card})")
    st.config = replace(cfg, max_outer_iter=12, relative_tol=0.0)
    try:
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            e0.record()
            solve_cg_mg(st, b)
            e1.record()
            torch.cuda.synchronize()
    finally:
        st.config = cfg
    total = e0.elapsed_time(e1)
    device = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    events = [(e.key, e.self_device_time_total / 1e3) for e in device]
    busy = sum(ms for _, ms in events)
    if busy == 0:
        log("[path] CG device time: not measured (no device events)")
        return ev_ms, host_ms
    log(f"[path] 12-iteration CG solve of (f): device time {busy:.3f} ms of "
        f"{total:.3f} ms (busy share {busy / total:.2f}; {card}), "
        f"{sum(e.count for e in device)} device kernels; largest:")
    for key, ms in sorted(events, key=lambda e: -e[1])[:8]:
        log(f"[path]   {ms:.4f} ms  {key[:70]}")
    return ev_ms, host_ms


# ---------------------------------------------------------------------------
# smoothed-aggregation AMG
# ---------------------------------------------------------------------------

AMG_CELLS = 512
AMG = [
    # key, label, sigma seed (b's is seed + 1), structured (mesh), options,
    # max_iter, mgtpu's refined count and operator complexity on the CPU
    # (scripts/amg_reference.py)
    ("SA-s", "(SA-s) 512^2 rough sigma, structured SA, SPAI V(2,2), "
     "4 levels", 3, True, dict(relax_type="spai"), 60, 38, 2.40),
    ("SA-K", "(SA-K) the same operator, structured SA, Jac-GMRES 1.0 "
     "K-cycles", 3, True, dict(relax_type="jac-gmres", relax_param=1.0,
                              nu_pre=1, nu_post=1, cycle_type="K"), 70, 48,
     2.40),
    ("SA-f", "(SA-f) 512^2 rough sigma (seed 5), greedy SA on the flat "
     "engine, SPAI V(2,2)", 5, False, dict(relax_type="spai"), 60, 50, 1.63),
]


def amg_states():
    """The SA-s, SA-K and SA-f hierarchies (f32, 4 levels) on the card, with
    their operators and right-hand sides; SA-s and SA-K share the
    operator.  Checks each hierarchy's engine, coarsest solver and
    operator complexity."""
    from mgtpu_torch import get_mg_param, sa_amg_setup
    from mgtpu_torch.cycle.grid_cycle import DenseInverse, GridHierarchy
    from mgtpu_torch.cycle.coarse import DenseLU
    ops, runs = {}, []
    for key, label, seed, structured, opts, max_iter, want, opc in AMG:
        if seed not in ops:
            M, A = divsig((AMG_CELLS, AMG_CELLS), seed=seed)
            b = A @ np.random.RandomState(seed + 1).rand(A.shape[0])
            ops[seed] = (M, A, b / np.linalg.norm(b))
        M, A, b = ops[seed]
        cfg, rp = get_mg_param(levels=4, dtype=np.float32, **opts)
        t0 = time.perf_counter()
        st = sa_amg_setup(A, cfg, rp, mesh=M if structured else None)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        h = st.hier
        kinds = [type(lv.A).__name__ for lv in h.levels]
        taps = [len(lv.A.offsets) if hasattr(lv.A, "offsets") else None
                for lv in h.levels]
        sizes = [a.shape[0] for a in st.As]
        log(f"[amg] {label}: setup {setup:.1f} s (host clock), "
            f"{type(h).__name__}, levels {sizes}, operators {kinds}, taps "
            f"{taps}, coarsest {type(h.coarse).__name__} of {sizes[-1]} "
            f"dofs, operator complexity {st.operator_complexity():.4f} "
            f"(want {opc:.2f})")
        require(abs(st.operator_complexity() - opc) <= 0.01,
                f"{key}: operator complexity {st.operator_complexity():.4f}")
        if structured:
            require(isinstance(h, GridHierarchy)
                    and isinstance(h.coarse, DenseInverse)
                    and sizes[-1] == 4225,
                    f"{key}: want a grid hierarchy with a 4225-dof "
                    "device-built inverse")
        else:
            require(not isinstance(h, GridHierarchy)
                    and kinds[0] == "DIA" and set(kinds[1:]) == {"ELL"}
                    and isinstance(h.coarse, DenseLU),
                    f"{key}: want DIA + ELL levels and a DenseLU coarsest")
        runs.append((key, label, st, A, b, max_iter, want))
    return runs


def sa3d_levels():
    """The 3D smoothed-aggregation stencils: structured SA of the rough-sigma
    DivSigGrad at 32^3 cells, 4 levels, f32 (grids 33^3, 17^3, 9^3)."""
    from mgtpu_torch import get_mg_param, sa_amg_setup
    M, A = divsig((32, 32, 32))
    cfg, rp = get_mg_param(levels=4, relax_type="spai", dtype=np.float32)
    st = sa_amg_setup(A, cfg, rp, mesh=M)
    levels = [lv.A for lv in st.hier.levels if lv.A is not None]
    log(f"[amg] 3D SA 32^3: grids {[A.grid for A in levels]}, taps "
        f"{[len(A.offsets) for A in levels]}")
    return st, levels


def phase_amg_kernels(runs, st3, levels3, rows):
    """Kernel D against its plain version at the SA shapes: every level of
    SA-s (5 / 13 / 37 / 97 taps) and of the 3D hierarchy (7 / 33 / 179),
    the DIA form of SA-f's fine level (5 taps, offsets +-1, +-513), and
    both applies of every Stride2Transfer of SA-s against P @ x and
    P^T @ r of the CSR matrices; m = 1 and 3, f32 (2e-5) and f64 (1e-12).
    A 257-tap stencil must raise."""
    from mgtpu_torch.ops.cuda import stencil
    from mgtpu_torch.ops.grid_stencil import (grid_stencil_matvec,
                                              stride2_transfer_from_scipy)
    from mgtpu_torch.solvers.mg_solver import high_precision_fine_operator
    def check(label, out, ref):
        check_d(rows, label, out, ref)

    st_s = runs[0][2]
    grids = [("SA-s", l, lv.A) for l, lv in enumerate(st_s.hier.levels)
             if lv.A is not None] + [
        ("3D SA", l, A) for l, A in enumerate(levels3)]
    for name, l, A in grids:
        for dt in (torch.float32, torch.float64):
            coeff = A.coeff.to(dt)
            for m in (1, 3):
                x = torch.tensor(np.random.RandomState(SEED + m).rand(
                    m, *A.grid), dtype=dt, device="cuda")
                check(f"{name} level {l} m={m}",
                      stencil.grid_apply(coeff, A.offsets, x),
                      grid_stencil_matvec(coeff, A.offsets, x))
        log(f"[kernel] D {name} level {l}: grid {A.grid} nd="
            f"{len(A.offsets)}: matches its plain version, f32 and f64, "
            "m = 1, 3")
    st_f = runs[2][2]
    for D in (st_f.hier.levels[0].A, high_precision_fine_operator(st_f)):
        for m in (1, 3):
            x = torch.tensor(np.random.RandomState(SEED + m).rand(
                D.shape[0], m), dtype=D.dtype, device="cuda")
            check(f"SA-f DIA m={m}", stencil.dia_apply(D.data, D.offsets, x),
                  stencil.dia_apply_plain(D.data, D.offsets, x))
        log(f"[kernel] D DIA form of SA-f level 0 ({D.dtype}, offsets "
            f"{D.offsets}): matches its plain version, m = 1, 3")
    for l, lv in enumerate(st_s.hier.levels[:-1]):
        P = st_s.Ps[l].astype(np.float64)
        P_dev = sparse_mm_yardstick(P, torch.float64)
        PT_dev = sparse_mm_yardstick(P.T, torch.float64)
        for dt, T in ((torch.float32, lv.P1), (torch.float64,
                      stride2_transfer_from_scipy(
                          P, list(reversed(lv.P1.fine_grid)),
                          list(reversed(lv.P1.coarse_grid)),
                          dtype=np.float64, max_delta=7, device="cuda"))):
            for m in (1, 3):
                rng = np.random.RandomState(SEED + m)
                xc = torch.tensor(rng.rand(m, *T.coarse_grid), dtype=dt,
                                  device="cuda")
                r = torch.tensor(rng.rand(m, *T.fine_grid), dtype=dt,
                                 device="cuda")
                y_ref = torch.sparse.mm(P_dev, xc.double().reshape(m, -1).T)
                rc_ref = torch.sparse.mm(PT_dev, r.double().reshape(m, -1).T)
                check(f"SA-s prolong {l} m={m}",
                      T.prolong(xc).reshape(m, -1).T, y_ref.to(dt))
                check(f"SA-s restrict {l} m={m}",
                      T.restrict(r).reshape(m, -1).T, rc_ref.to(dt))
        log(f"[kernel] D as SA-s Stride2Transfer {l} ({len(lv.P1.offsets)} "
            f"taps on {lv.P1.fine_grid}): prolong and restrict match P @ x "
            "and P^T @ r, f32 and f64, m = 1, 3")
    coeff = torch.ones((257, 9, 9), device="cuda")
    offs = tuple((i // 17 - 8, i % 17 - 8) for i in range(257))
    try:
        stencil.grid_apply(coeff, offs, torch.ones((1, 9, 9), device="cuda"))
    except ValueError as e:
        log(f"[kernel] D refuses a 257-tap stencil: {e}")
    else:
        raise RuntimeError("kernel D took a 257-tap stencil")


def amg_cases(runs, st3):
    """(label, kind, op, csr) at the SA shapes: every SA-s level, both
    applies of each SA-s transfer (csr P for the prolong, P^T for the
    restrict), the 3D SA levels and SA-f's DIA level in f32 and f64."""
    from mgtpu_torch.solvers.mg_solver import high_precision_fine_operator
    st_s, st_f = runs[0][2], runs[2][2]
    out = []
    for l, lv in enumerate(st_s.hier.levels):
        if lv.A is not None:
            out.append((f"SA-s level {l}", "grid", lv.A, st_s.As[l]))
    for l, lv in enumerate(st_s.hier.levels[:-1]):
        P = st_s.Ps[l].tocsr()
        out.append((f"SA-s prolong {l}", "prolong", lv.P1, P))
        out.append((f"SA-s restrict {l}", "restrict", lv.P1, P.T.tocsr()))
    for l, lv in enumerate(st3.hier.levels):
        if lv.A is not None:
            out.append((f"3D SA level {l}", "grid", lv.A, st3.As[l]))
    for D in (st_f.hier.levels[0].A, high_precision_fine_operator(st_f)):
        out.append((f"SA-f DIA {str(D.dtype).split('.')[-1]}", "dia", D,
                    st_f.A_input if D.dtype == torch.float64
                    else st_f.As[0]))
    return out


def phase_amg_timing(runs, st3, rows, card):
    """Kernel D, plain and torch.sparse.mm device times (m = 1, four input
    sets) with D's plan at the SA shapes: SA-s's levels, prolongs and
    restricts (whose bound is P's own bytes), the 3D SA levels, SA-f's DIA
    level in f32 and f64."""
    timer = Timer()
    for label, kind, op, csr in amg_cases(runs, st3):
        entry, _ = time_d(label, kind, op, csr, timer, card)
        name = f"stencil.{str(op.dtype).split('.')[-1]}"
        rows[name].setdefault("times_amg", {})[label] = entry


def wide_stencil(ntaps, dim, grid, dtype, seed=0):
    """Random coefficients (on the card) of a stencil whose taps are the
    `ntaps` offsets nearest the centre of a radius-8 box (ties in order)."""
    r = range(-8, 9)
    offs = sorted(itertools.product(*[r] * dim),
                  key=lambda o: (sum(d * d for d in o), o))[:ntaps]
    coeff = np.random.RandomState(seed).rand(ntaps, *grid)
    return torch.tensor(coeff, dtype=dtype, device="cuda"), tuple(offs)


def random_stride2(fine, seed):
    """A random stride-2 prolongation on a fine node grid (slowest axis
    first) onto ceil(fine / 2): entries at f = 2c + d for a random half of
    the offsets d in [-3, 3]^dim."""
    rng = np.random.RandomState(seed)
    coarse = tuple((f + 1) // 2 for f in fine)
    offs = np.array([d for d in itertools.product(range(-3, 4),
                                                  repeat=len(fine))
                     if rng.rand() < 0.5])
    cs = np.stack(np.meshgrid(*map(np.arange, coarse), indexing="ij"),
                  -1).reshape(-1, len(fine))
    f = 2 * cs[:, None, :] + offs[None]
    ok = np.all((f >= 0) & (f < np.array(fine)), axis=-1)
    rows = np.ravel_multi_index(tuple(f[ok].T), fine)
    cols = np.broadcast_to(np.arange(len(cs))[:, None], ok.shape)[ok]
    P = sp.csr_matrix((rng.rand(len(rows)) + 0.5, (rows, cols)),
                      shape=(int(np.prod(fine)), len(cs)))
    return P, coarse


def phase_d_edges(rows):
    """Kernel D against its plain version at its plan's edges, f32 (2e-5)
    and f64 (1e-12): nd = 1, 9 (one past a group of 8) and 256 on 2D and
    3D grids at m = 1, 3, 8, 9, at the default plan and at splits 1, 2 and
    16; 97 taps on 1D fields of FILL - 1 nodes (split) and FILL (stream);
    the parity-form transfers on odd and even fine extents in 2D and 3D
    against P @ x and P^T @ r, m = 1 and 3, at the default plan and at
    splits 2 and 16."""
    from mgtpu_torch.ops.cuda import stencil
    from mgtpu_torch.ops.grid_stencil import (grid_stencil_matvec,
                                              stride2_transfer_from_scipy)
    for dt in (torch.float32, torch.float64):
        for ntaps, dim in ((1, 2), (9, 2), (256, 3)):
            grid = (37, 41) if dim == 2 else (13, 15, 17)
            coeff, offsets = wide_stencil(ntaps, dim, grid, dt)
            taps = tuple((0,) * (3 - dim) + o for o in offsets)
            for m in (1, 3, 8, 9):
                x = torch.tensor(np.random.RandomState(m).rand(m, *grid),
                                 dtype=dt, device="cuda")
                ref = grid_stencil_matvec(coeff, offsets, x)
                check_d(rows, f"{ntaps} taps on {grid} m={m}",
                        stencil.grid_apply(coeff, offsets, x), ref)
                for split in (1, 2, 16):
                    plan = stencil.stencil_plan(box3(grid), ntaps, m, dt,
                                                split=split)
                    check_d(rows, f"{ntaps} taps on {grid} m={m} split "
                            f"{split}", stencil._launch(
                                coeff, box3(grid), taps, x, plan=plan), ref)
        for n in (stencil.FILL - 1, stencil.FILL):
            coeff = torch.tensor(np.random.RandomState(n).rand(97, n),
                                 dtype=dt, device="cuda")
            offsets = tuple((k - 48,) for k in range(97))
            x = torch.tensor(np.random.RandomState(1).rand(1, n), dtype=dt,
                             device="cuda")
            plan = stencil.stencil_plan((1, 1, n), 97, 1, dt)
            require(plan.schedule == ("split" if n < stencil.FILL
                                      else "stream"),
                    f"kernel D plan on {n} nodes: {plan}")
            check_d(rows, f"97 taps on {n} nodes ({plan.schedule})",
                    stencil.grid_apply(coeff, offsets, x),
                    grid_stencil_matvec(coeff, offsets, x))
        for fine in ((37, 40), (40, 37), (17, 18, 19), (20, 15, 16)):
            P, coarse = random_stride2(fine, seed=sum(fine))
            T = stride2_transfer_from_scipy(
                P, list(reversed(fine)), list(reversed(coarse)),
                dtype=np.float32 if dt == torch.float32 else np.float64,
                device="cuda")
            fb, cb = box3(fine), box3(coarse)
            taps = tuple((0,) * (3 - len(fine)) + o for o in T.offsets)
            for m in (1, 3):
                rng = np.random.RandomState(m)
                xc, r = rng.rand(m, P.shape[1]), rng.rand(m, P.shape[0])
                xd = torch.tensor(xc.reshape((m,) + coarse), dtype=dt,
                                  device="cuda")
                rd = torch.tensor(r.reshape((m,) + fine), dtype=dt,
                                  device="cuda")
                y_ref = torch.tensor((P @ xc.T).T.reshape((m,) + fine),
                                     dtype=dt, device="cuda")
                rc_ref = torch.tensor((P.T @ r.T).T.reshape((m,) + coarse),
                                      dtype=dt, device="cuda")
                outs = [("prolong", T.prolong(xd), y_ref),
                        ("restrict", T.restrict(rd), rc_ref)]
                for split in (2, 16):
                    outs.append((f"prolong split {split}", stencil._launch(
                        T.pcoeff, fb, taps, xd, form="prolong", in_box=cb,
                        in_space=coarse, ptab=T.ptab,
                        plan=stencil.stencil_plan(
                            fb, T.pcoeff.shape[0], m, dt, "prolong",
                            split=split)), y_ref))
                    outs.append((f"restrict split {split}", stencil._launch(
                        T.rcoeff, cb, taps, rd, form="restrict", in_box=fb,
                        in_space=fine, plan=stencil.stencil_plan(
                            cb, len(taps), m, dt, "restrict",
                            split=split)), rc_ref))
                for what, out, ref in outs:
                    check_d(rows, f"random stride-2 {fine} {what} m={m}",
                            out, ref)
    log("[kernel] D at its plan's edges (1 / 9 / 256 taps, m = 1, 3, 8, 9, "
        "splits 1, 2, 16; 97 taps on FILL - 1 and FILL nodes; parity-form "
        "transfers on (37, 40), (40, 37), (17, 18, 19), (20, 15, 16) "
        "against P @ x and P^T @ r): matches, f32 and f64")


def phase_amg(runs, card):
    """SA-s, SA-K and SA-f through solve_mg_refined to a true f64 relres
    below 1e-8 inside one launch-counter window: kernel D in f32 and f64 in
    each solve, no plain version anywhere.  Returns D's launches."""
    reset_counters()                       # ---- main path window ----
    for key, label, st, A, b, max_iter, want in runs:
        before = stencil_counters()[0]
        refined(st, A, b, want, label, card, max_iter=max_iter)
        d_l = {k: v - before[k] for k, v in stencil_counters()[0].items()}
        log(f"[path] {key}: kernel D launches in this solve: {d_l}")
        for k in ("stencil.float32", "stencil.float64"):
            require(d_l[k] > 0, f"{key}: {k} was never launched")
    launches, plain = stencil_counters()   # ---- end of window ----
    more_l, more_p = counters()
    line_l, line_p = line_counters()
    plain.update(more_p, **line_p)
    log(f"[path] AMG window kernel D launches: {launches}; other kernels "
        f"{dict(more_l, **line_l)}")
    log(f"[path] AMG window plain-version calls on the card: {plain}")
    require(not any(plain.values()), f"plain versions ran: {plain}")
    for key, label, st, A, b, max_iter, want in runs:
        refined(st, A, b, want, label + " (warm)", card, max_iter=max_iter)
        ev_ms, _ = vcycle_ms(st, b, card, label=key)
        vcycle_profile(st, b, ev_ms, card, label=key)
    return launches


# ---------------------------------------------------------------------------
# classical AMG and the device-side AMG setup
# ---------------------------------------------------------------------------

CLASSICAL = [
    # key, label, setup, options, mgtpu's refined count, operator
    # complexity, level sizes, level formats and coarsest solver on the
    # CPU (scripts/classical_reference.py)
    ("C-cc", "(C-cc) classical AMG, common-C coloring (C++ kernels), "
     "direct interpolation", "classical", {}, 13, 2.7356,
     [263169, 131587, 50778, 23908], ["DIA", "DIA", "ELL", "ELL"],
     "SparseLUCoarse"),
    ("C-pmis", "(C-pmis) classical AMG, PMIS on the card + enforce_common_c",
     "classical", dict(coarsening="pmis"), 13, 3.1210,
     [263169, 153476, 70003, 31487], ["DIA", "ELL", "ELL", "ELL"],
     "SparseLUCoarse"),
    ("SA-dev", "(SA-dev) SA, MIS-2 aggregation on the card (MGTPU_AGG="
     "device)", "sa", {}, 20, 2.2391, [263169, 69425, 13952, 2153],
     ["DIA", "ELL", "ELL", "ELL"], "DenseLU"),
]
C_CG = 8        # (C-cg) C-cc's hierarchy under solve_cg_mg, mgtpu's count


def setup_counters():
    """Calls of the host C++ setup kernels and of their numpy versions."""
    from mgtpu_torch.setup import native
    return dict(native.CALLS), dict(native.PLAIN_CALLS)


def classical_setup(key, setup, opts, A):
    """One CLASSICAL setup on the card (f32, 4 levels, SPAI V(2,2)): the
    state, its host seconds and its device seconds (torch.profiler's
    device time over the setup)."""
    import os
    from torch.profiler import ProfilerActivity, profile
    from mgtpu_torch import classical_amg_setup, get_mg_param, sa_amg_setup
    cfg, rp = get_mg_param(levels=4, relax_type="spai", dtype=np.float32)
    if setup == "sa":
        os.environ["MGTPU_AGG"] = "device"
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            st = (sa_amg_setup(A, cfg, rp) if setup == "sa"
                  else classical_amg_setup(A, cfg, rp, **opts))
            torch.cuda.synchronize()
        host = time.perf_counter() - t0
    finally:
        os.environ.pop("MGTPU_AGG", None)
    dev = sum(e.self_device_time_total
              for e in prof.key_averages()) / 1e6
    return st, host, dev


def phase_classical(agg_ab, rows, card):
    """C-cc, C-pmis and SA-dev on bench.py's agg_ab problem (SA-f's: 512^2,
    sigma seed 5, b seed 6), set up and solved inside one launch-counter
    window: each to mgtpu's refined count +- 1 and a true f64 relres below
    1e-8, at its operator complexity +- 0.01, with its level sizes, formats
    and coarsest solver; (C-cg) C-cc's hierarchy under solve_cg_mg to 8 +-
    1 iterations and a true relres <= 1e-7.  The C++ setup kernels ran (the
    coloring on C-cc's levels, the greedy aggregation nowhere), kernel D
    ran in f32 and f64 in each solve, and no plain version ran.  Then
    kernel D against its plain version on C-cc's two DIA levels (f32 2e-5,
    f64 1e-12, m = 1, 3) and its times there; one cycle of each by CUDA
    events and the host clock, with the busy share.  Returns kernel D's
    launches in the window."""
    from dataclasses import replace
    from mgtpu_torch import solve_cg_mg
    from mgtpu_torch.ops.cuda import stencil
    from mgtpu_torch.ops.dia import DIA
    from mgtpu_torch.setup import device_agg
    from mgtpu_torch.solvers.mg_solver import high_precision_fine_operator
    _, _, _, A, b, _, _ = agg_ab
    reset_counters()                       # ---- main path window ----
    states = {}
    for key, label, setup, opts, _, opc, sizes, kinds, coarse in CLASSICAL:
        device_agg.ROUNDS.clear()
        c0 = setup_counters()[0]
        st, host_s, dev_s = classical_setup(key, setup, opts, A)
        states[key] = st
        got_sizes = [a.shape[0] for a in st.As]
        got_kinds = [type(lv.A).__name__ for lv in st.hier.levels]
        got_coarse = type(st.hier.coarse).__name__
        calls = {k: v - c0[k] for k, v in setup_counters()[0].items()}
        rounds = [{k: v for k, v in r.items() if k != "call"}
                  for r in device_agg.ROUNDS]
        log(f"[classical] {label}: setup {host_s:.2f} s host clock, "
            f"{dev_s:.4f} s device time (torch.profiler; {card}); levels "
            f"{got_sizes}, operators {got_kinds}, coarsest {got_coarse}, "
            f"operator complexity {st.operator_complexity():.4f} (want "
            f"{opc:.4f}); C++ kernel calls {calls}; device loops {rounds}")
        require(abs(st.operator_complexity() - opc) <= 0.01,
                f"{key}: operator complexity {st.operator_complexity():.4f}")
        require(got_sizes == sizes and got_kinds == kinds
                and got_coarse == coarse, f"{key}: want levels {sizes}, "
                f"operators {kinds} and a {coarse} coarsest")
        if key == "C-cc":
            require(calls["cf_coloring"] == len(sizes) - 1,
                    f"{key}: the C++ coloring ran {calls} times")
        else:
            require(len(rounds) == len(sizes) - 1
                    and all(r["seconds"] > 0 for r in rounds),
                    f"{key}: the device loops ran {len(rounds)} times")
    for key, label, _, _, want, *_ in CLASSICAL:
        st = states[key]
        before = stencil_counters()[0]
        refined(st, A, b, want, label, card, max_iter=60)
        d_l = {k: v - before[k] for k, v in stencil_counters()[0].items()}
        log(f"[path] {key}: kernel D launches in this solve: {d_l}")
        for k in ("stencil.float32", "stencil.float64"):
            require(d_l[k] > 0, f"{key}: {k} was never launched")
    st = states["C-cc"]
    cfg = st.config
    st.config = replace(cfg, max_outer_iter=100, relative_tol=1e-8)
    try:
        before = stencil_counters()[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, info = solve_cg_mg(st, b)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        st.config = cfg
    rr, iters = true_relres(A, b, x), int(info["iters"])
    d_l = {k: v - before[k] for k, v in stencil_counters()[0].items()}
    log(f"[path] (C-cg) C-cc's hierarchy, solve_cg_mg: {iters} iterations "
        f"(want {C_CG} +- 1), true f64 relres {rr:.3e}, time to 1e-8 "
        f"{wall:.1f} ms (host clock, synchronised; {card}); kernel D "
        f"launches {d_l}")
    require(abs(iters - C_CG) <= 1, f"C-cg: {iters} iterations")
    require(rr <= 1e-7, f"C-cg: true relres {rr:.3e} > 1e-7")
    for k in ("stencil.float32", "stencil.float64"):
        require(d_l[k] > 0, f"C-cg: {k} was never launched")
    launches, plain = stencil_counters()   # ---- end of window ----
    more_l, more_p = counters()
    line_l, line_p = line_counters()
    calls, setup_plain = setup_counters()
    plain.update(more_p, **line_p, **{f"setup.{k}": v
                                      for k, v in setup_plain.items()})
    log(f"[path] classical window kernel D launches: {launches}; other "
        f"kernels {dict(more_l, **line_l)}; C++ setup kernels {calls}")
    log(f"[path] classical window plain-version calls: {plain}")
    require(not any(plain.values()), f"plain versions ran: {plain}")
    require(calls["aggregate"] == 0 and calls["cf_coloring"] > 0,
            f"C++ setup kernel calls {calls}")

    levels = [("C-cc DIA level 0", st.hier.levels[0].A, st.As[0],
               high_precision_fine_operator(st), st.A_input)]
    D1 = st.hier.levels[1].A
    levels.append(("C-cc DIA level 1", D1, st.As[1],
                   DIA(D1.data.double(), D1.offsets, D1.shape), st.As[1]))
    timer = Timer()
    for label, D32, csr32, D64, csr64 in levels:
        for D in (D32, D64):
            for m in (1, 3):
                x = torch.tensor(np.random.RandomState(SEED + m).rand(
                    D.shape[0], m), dtype=D.dtype, device="cuda")
                check_d(rows, f"{label} m={m}",
                        stencil.dia_apply(D.data, D.offsets, x),
                        stencil.dia_apply_plain(D.data, D.offsets, x))
        log(f"[kernel] D {label} ({D32.shape[0]} rows, {len(D32.offsets)} "
            f"diagonals at offsets {D32.offsets}): matches its plain "
            "version, f32 and f64, m = 1, 3")
        for D, csr in ((D32, csr32), (D64, csr64)):
            dt = str(D.dtype).split(".")[-1]
            entry, _ = time_d(f"{label} {dt}", "dia", D, csr, timer, card)
            rows[f"stencil.{dt}"].setdefault("times_classical", {})[
                f"{label} {dt}"] = entry
    for key, st in states.items():
        ev_ms, _ = vcycle_ms(st, b, card, label=key)
        vcycle_profile(st, b, ev_ms, card, label=key)
        coarsest_ms(st, ev_ms, card, key)
    return launches


def coarsest_ms(st, cycle_ms, card, label):
    """One coarsest solve of the cycle's type on the card, by the host
    clock (synchronised; SparseLUCoarse is a round trip to the host's
    SuperLU), the median of five."""
    c = st.hier.coarse
    bc = torch.tensor(np.random.RandomState(SEED).rand(st.As[-1].shape[0], 1),
                      dtype=torch.float32, device="cuda")
    times = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c.solve(bc)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = sorted(times[1:])[2]
    log(f"[path] {label}: one coarsest solve ({type(c).__name__} of "
        f"{st.As[-1].shape[0]} dofs) {ms:.3f} ms host clock, of the "
        f"cycle's {cycle_ms:.3f} ms ({card})")


def main() -> int:
    t_start = time.perf_counter()
    smi, name = phase_card()
    card = f"{name}, {smi.split(',')[-1].strip()}"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()

    from mgtpu_torch import get_mg_param, mg_setup
    M3, L3 = shifted_laplacian((128, 128, 128))
    cfg, rp = get_mg_param(levels=5, relax_type="jacobi", relax_param=0.8,
                           nu_pre=1, nu_post=1, dtype=np.float32)
    t0 = time.perf_counter()
    st_jac = mg_setup(L3, M3, cfg, rp)
    log(f"[path] 3D 128^3 setup {time.perf_counter() - t0:.1f} s, grids "
        f"{[lv.A.grid for lv in st_jac.hier.levels]}")

    rows = {k: {"name": k, "route": "cuda", "source": src, "replaces": rep,
                "max_abs_err": 0.0, "max_rel_err": 0.0}
            for k, (rep, src, _) in KERNELS.items()}
    timed = phase_kernels(st_jac, rows)
    phase_timing(timed, rows)
    launches, b_by_grid = phase_path3d(M3, L3, st_jac, card)
    rows["jacobi_residual3d"]["launches_by_grid"] = b_by_grid
    phase_path2d(card)

    t0 = time.perf_counter()
    line_ops = {"a": aniso2d(1024, 100.0), "d": aniso3d([128] * 3, 0)}
    log(f"[kernel] line operators built in {time.perf_counter() - t0:.1f} s")
    timed_lines = phase_line_kernels(
        {"1025^2": line_ops["a"], "129^3": line_ops["d"],
         "(19,25,31)": aniso3d([30, 24, 18], 0)}, rows)
    phase_line_edges(rows)
    phase_line_timing(timed_lines, rows)
    aniso = phase_aniso(line_ops, card)
    phase_fmg(card)

    ops, kstates, rhs = krylov_states()
    timed_states = {"f": kstates["f"], "h": kstates["h"]}
    phase_stencil_kernels(timed_states, rows)
    phase_stencil_timing(timed_states, rows, card)
    krylov = phase_krylov(ops, kstates, rhs, card)
    cg_iteration(kstates["f"], rhs["f"]["b"], card)
    del ops, kstates, rhs, timed_states

    runs = amg_states()
    st3, levels3 = sa3d_levels()
    phase_amg_kernels(runs, st3, levels3, rows)
    phase_d_edges(rows)
    phase_amg_timing(runs, st3, rows, card)
    amg = phase_amg(runs, card)
    classical = phase_classical(runs[2], rows, card)
    for k, row in rows.items():
        # each kernel's launches from the window of its own path
        row["launches"] = (aniso[k] if k.startswith("tridiag") else
                           krylov[k] if k.startswith("stencil.") else
                           launches[k])
    for k in ("stencil3d_apply.matvec", "stencil.float32", "stencil.float64"):
        rows[k]["launches_aniso"] = aniso[k]
    for k in ("stencil.float32", "stencil.float64"):
        rows[k]["launches_amg"] = amg[k]
        rows[k]["launches_classical"] = classical[k]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {**{k: row[k] for k in keys},
         **{k: v for k, v in row.items() if k not in keys}}
        for row in rows.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        sys.exit(1)
    sys.exit(main())
