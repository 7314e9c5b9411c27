#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mgtpu_torch) end to end on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. card   — name and power limit (nvidia-smi) and torch's device name;
2. build  — compile every kernel from mgtpu_torch/csrc with nvcc (sm_90a),
            print ptxas's register, shared-memory and spill lines;
3. kernel — every kernel against its plain torch version on the card, on the
            3D bench operators (fine nd=7, Galerkin nd=27) at 129^3 (m=1, 2),
            on the hierarchy's coarser levels and on a non-cubic grid; then
            each kernel's device time (CUDA events, L2 cold at 129^3) per
            level beside its byte bound, its plain version and a conv3d
            yardstick;
4. path 3D — the 128^3 shifted nodal Laplacian (5 levels, float32):
            mg_setup + solve_mg, refined Jacobi 0.8 V(1,1) to 1e-8 (23 +- 1
            iterations), refined Chebyshev(3) V(1,0) (11 +- 1), and the
            library's default SPAI V(2,2) solve; true f64 residuals on the
            host; launch counters prove the kernels ran and no plain version
            did;
5. path 2D — the 1024^2 problem, refined Jacobi to 1e-8 (16 +- 1), plain
            torch on the card (no kernel on 2D levels).

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
}


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
    cases = [("129^3 fine", levels[0], (1, 2)),
             ("129^3 Galerkin", A129_27, (1, 2)),
             ("65^3 Galerkin", levels[1], (1, 2)),
             ("33^3", levels[2], (1,)), ("17^3", levels[3], (1,)),
             ("mesh (18,24,30)", An7, (1, 2)),
             ("mesh (18,24,30) Galerkin", An27, (1, 2))]
    for label, A, ms in cases:
        for m in ms:
            x, b, d, p = fields(A.grid, m, SEED)
            for name in KERNELS:
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
            log(f"[kernel] {label} grid {A.grid} nd={len(A.offsets)} m={m}: "
                "all kernels match their plain versions")
    return [(lbl, A) for lbl, A, _ in cases[:1] + cases[2:5]]


def conv3d_yardstick(A, x):
    """torch conv3d with the interior constants (no boundary band)."""
    w = torch.zeros((1, 1, 3, 3, 3), dtype=torch.float32, device="cuda")
    for k, (dx, dy, dz) in enumerate(A.offsets):
        w[0, 0, 1 + dx, 1 + dy, 1 + dz] = A.const[k]
    xc = x[:, None]
    return lambda: torch.nn.functional.conv3d(xc, w, padding=1)


def phase_timing(timed_levels, rows):
    """Kernel, plain and yardstick device times per level (m = 1)."""
    timer = Timer()
    for label, A in timed_levels:
        sets = [fields(A.grid, 1, SEED + 1 + j) for j in range(4)]
        nodes = int(np.prod(A.grid))
        band_bytes = 4 * int(A.band.numel())
        conv_ms, _ = timer([conv3d_yardstick(A, x) for x, _, _, _ in sets])
        for name, (_, _, nfields) in KERNELS.items():
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
            log(f"[time] {label:9s} nd={len(A.offsets):2d} {name:28s} "
                f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                f"bound {bound:.4f} ms ({fbytes / 1e6:.1f} MB fields, "
                f"+{band_bytes / 1e6:.2f} MB band)  conv3d {conv_ms:.4f} ms"
                f"  kernel/bound {ms / bound:.1f}x  host per call: kernel "
                f"{host_ms:.3f} ms, plain {plain_host_ms:.3f} ms")
            if label.startswith("129"):
                rows[name].update(
                    ms=ms, plain_ms=plain_ms, bound_ms=bound,
                    bound_by="bytes" if fbytes / HBM_BYTES_PER_S
                    >= flops / FP32_FLOPS else "operations",
                    band_bytes=band_bytes, conv3d_interior_ms=conv_ms,
                    host_ms=host_ms, plain_host_ms=plain_host_ms,
                    library_ms=conv_ms if name.endswith("matvec") else None)


def reset_counters():
    from mgtpu_torch.ops.cuda import const3d, fused3d
    for dct in (const3d.LAUNCHES, const3d.PLAIN_CALLS, fused3d.LAUNCHES,
                fused3d.PLAIN_CALLS):
        for k in dct:
            dct[k] = 0


def counters():
    from mgtpu_torch.ops.cuda import const3d, fused3d
    launches = {f"stencil3d_apply.{k}": v for k, v in const3d.LAUNCHES.items()}
    launches.update(fused3d.LAUNCHES)
    plain = dict(const3d.PLAIN_CALLS, **fused3d.PLAIN_CALLS)
    return launches, plain


def true_relres(L, b, x) -> float:
    xh = x.detach().cpu().numpy().astype(np.float64)
    require(xh.shape == b.shape and np.isfinite(xh).all(),
            "solution has the wrong shape or non-finite values")
    return float(np.linalg.norm(b - L @ xh) / np.linalg.norm(b))


def refined(st, L, b, want, label, card):
    """Certified refined solve: iteration count and host f64 residual."""
    from mgtpu_torch import solve_mg_refined
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, info = solve_mg_refined(st, b, tol=1e-8, max_iter=40)
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


def vcycle_ms(st, b, card):
    """One V-cycle from a zero guess on the fine grid: CUDA events and the
    synchronised host clock (the eager cycle is launch-bound at depth)."""
    from mgtpu_torch.cycle.grid_cycle import grid_cycle
    from mgtpu_torch.ops.grid_stencil import flat_to_grid
    bg = flat_to_grid(torch.as_tensor(b, dtype=torch.float32,
                                      device="cuda")[:, None],
                      st.hier.fine_grid)
    x0 = torch.zeros_like(bg)
    for _ in range(3):
        grid_cycle(st.config, st.hier, bg, x0)
    ev, host = [], []
    for _ in range(10):
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        grid_cycle(st.config, st.hier, bg, x0)
        e1.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        ev.append(e0.elapsed_time(e1))
    ev_ms, host_ms = sorted(ev)[5], sorted(host)[5]
    log(f"[path] V-cycle ({st.config.relax_type}, 129^3, 5 levels): "
        f"{ev_ms:.3f} ms CUDA events, {host_ms:.3f} ms host clock ({card})")
    return ev_ms, host_ms


def vcycle_profile(st, b, cycle_ms, card):
    """Device time of one V-cycle by torch.profiler (sum of kernel times
    over five cycles) against its CUDA-event time: the busy share."""
    from torch.profiler import ProfilerActivity, profile
    from mgtpu_torch.cycle.grid_cycle import grid_cycle
    from mgtpu_torch.ops.grid_stencil import flat_to_grid
    bg = flat_to_grid(torch.as_tensor(b, dtype=torch.float32,
                                      device="cuda")[:, None],
                      st.hier.fine_grid)
    x0 = torch.zeros_like(bg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            grid_cycle(st.config, st.hier, bg, x0)
        torch.cuda.synchronize()
    events = [(e.key, e.self_device_time_total / 5e3)
              for e in prof.key_averages() if e.self_device_time_total > 0]
    busy = sum(ms for _, ms in events)
    if busy == 0:
        log("[path] V-cycle device time: not measured (no device events)")
        return
    log(f"[path] V-cycle device time {busy:.3f} ms of {cycle_ms:.3f} ms "
        f"(busy share {busy / cycle_ms:.2f}; {card}); largest:")
    for key, ms in sorted(events, key=lambda e: -e[1])[:6]:
        log(f"[path]   {ms:.4f} ms  {key[:70]}")


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
    jac = refined(st_jac, L3, b, 23, "3D Jacobi 0.8 V(1,1)", card)
    cheb = refined(st_cheb, L3, bc, 11, "3D Chebyshev(3) V(1,0)", card)
    xs, info_s = solve_mg(st_spai, b)
    rr_s = true_relres(L3, b, xs)
    log(f"[path] 3D default config (SPAI 1.0 V(2,2)) solve_mg: "
        f"{info_s['iters']} cycles, relres {info_s['relres']:.3e} "
        f"(true f64 {rr_s:.3e})")
    require(info_s["relres"] < 1e-6, "3D SPAI solve_mg did not reach 1e-6")
    launches, plain = counters()           # ---- end of window ----
    log(f"[path] kernel launches: {launches}")
    log(f"[path] plain-version calls on the card: {plain}")
    require(all(v > 0 for v in launches.values()),
            f"a kernel of the path was never launched: {launches}")
    require(not any(plain.values()), f"plain versions ran: {plain}")

    # timings after the window (they do not count toward the launches)
    refined(st_jac, L3, b, 23, "3D Jacobi 0.8 V(1,1) (warm)", card)
    refined(st_cheb, L3, bc, 11, "3D Chebyshev(3) V(1,0) (warm)", card)
    jac_ms, _ = vcycle_ms(st_jac, b, card)
    vcycle_profile(st_jac, b, jac_ms, card)
    vcycle_ms(st_cheb, bc, card)
    per_cycle_launches(st_jac, b)
    return launches, jac, cheb


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
    launches, _, _ = phase_path3d(M3, L3, st_jac, card)
    phase_path2d(card)
    for k, row in rows.items():
        row["launches"] = launches[k]
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
