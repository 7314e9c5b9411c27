"""Stand-alone multigrid solves and Krylov-wrapped solves.

Counterpart of mgtpu/solvers/mg_solver.py, on every engine: the solve
loops keep their iterates as the engine's fields — (m, *grid) on the grid
engine, (m, N) rows on the systems engine (its components one after the
other in each row, systems_grid.py), (m, n) on the flat one (`_runtime`,
mgtpu's `_cycle_runtime`).
What mgtpu compiles runs here as recorded programs (cycle/capture.py: CUDA
graphs on the card, the plain functions on the CPU):

 * `solve_mg` iterates recorded cycles with a relative-tolerance stop
   checked every cycle on the host, a divergence stop at 1e3 * res0, and
   the residual history; `solve_mg_jit` runs a fixed number of cycles as
   one program, with no host read.
 * `solve_mg_refined` is mixed-precision iterative refinement: the residual
   b - A x in native float64 against the ORIGINAL operator (`A_input`), the
   correction one cycle of the (float32) hierarchy from a zero guess
   (`outer_dtype`, `cycle_dtype`: mgtpu's; a bfloat16 cycle runs a
   `cast_hierarchy` copy); `fmg=True` starts a grid-engine solve from one
   full-multigrid pass instead of zero.  With
   `device_loop` (mgtpu's default) the loop runs as recorded chunks of
   iterations masked by a device flag (mgtpu's `lax.while_loop`), else as
   the eager host loop.
 * `solve_cg_mg`, `solve_bicgstab_mg`, `solve_gmres_mg` run the Krylov
   methods of krylov/ on those fields with one cycle from zero as the
   preconditioner (reference SolveFuncs.jl:74-133); `block=True` shares one
   Krylov space between the right-hand sides.  A float64 b over a lower-
   precision hierarchy runs the Krylov iteration in float64 against the
   original operator and the cycle in the hierarchy's precision (the
   mixed-precision shim, SolveFuncs.jl:52-58).  The iterations, matvec and
   cycle included, run in recorded chunks with the stop test on the card
   (`device_loop=False`: the eager loop, for comparison).
 * `get_mg_preconditioner` and `get_afun` are the closures the reference
   hands to Krylov methods (SolveFuncs.jl:43-71).

All run on the state's device and return torch tensors there.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import spans
from ..config import double_variant, is_complex, torch_dtype
from ..cycle.capture import gate, run, static_config
from ..cycle.cycle import cycle_jit, recursive_cycle
from ..cycle.grid_cycle import (GridHierarchy, grid_cycle, grid_cycle_jit,
                                grid_fmg)
from ..krylov import _loop
from ..krylov import (bicgstab, block_bicgstab, block_fgmres, block_pcg,
                      fgmres, pcg)
from ..cycle.systems_grid import (SystemsGridHierarchy,
                                  block_operator_from_csr, fields_to_rows,
                                  rows_to_fields, systems_grid_cycle,
                                  systems_grid_cycle_jit)
from ..ops.grid_stencil import flat_to_grid, grid_to_flat, make_grid_stencil
from ..setup.hierarchy import MGState, _to_device_matrix

__all__ = ["solve_mg", "solve_mg_jit", "solve_mg_refined", "get_afun",
           "get_mg_preconditioner", "solve_cg_mg", "solve_bicgstab_mg",
           "solve_gmres_mg"]


def _as_2d(v: torch.Tensor):
    return (v[:, None], True) if v.ndim == 1 else (v, False)


def _norm(v: torch.Tensor) -> float:
    return spans.read(float, torch.linalg.vector_norm(v))


def _rows(matvec):
    """A flat operator's apply on (m, n) fields."""
    return lambda v: matvec(v.T).T


def _runtime(state: MGState, captured: bool = True, hier=None):
    """The engine's field form: (to_field, to_flat, cycle, matvec).

    to_field takes flat (n, m) columns to a field, to_flat back;
    cycle(b, x, x_zero) is one cycle of the hierarchy on fields — a
    recorded program (grid_cycle_jit / systems_grid_cycle_jit / cycle_jit)
    unless `captured` is False — and matvec the fine operator on fields.
    Grid fields are (m, *grid); the systems engine's are (m, N) rows, split
    into component fields around each cycle and matvec; the flat engine's
    are (m, n), whose transposes are the (n, m) columns its cycle takes.
    `hier` (default the state's) is the hierarchy the cycle runs: a
    `cycle_dtype` copy in the refined solve."""
    cfg, h = state.config, state.hier if hier is None else hier
    if isinstance(h, GridHierarchy):
        grid = h.fine_grid
        cyc = grid_cycle_jit if captured else grid_cycle
        return (lambda v: flat_to_grid(v, grid), grid_to_flat,
                lambda b, x, xz=False: cyc(cfg, h, b, x, x_zero=xz),
                h.levels[0].A.matvec)
    if isinstance(h, SystemsGridHierarchy):
        grids = h.fine_grids
        cyc = systems_grid_cycle_jit if captured else systems_grid_cycle
        return (lambda v: v.T.contiguous(), lambda v: v.T,
                lambda b, x, xz=False: fields_to_rows(cyc(
                    cfg, h, rows_to_fields(b, grids),
                    rows_to_fields(x, grids), x_zero=xz)),
                h.levels[0].A.rows_matvec)
    cyc = cycle_jit if captured else recursive_cycle
    return (lambda v: v.T.contiguous(), lambda v: v.T,
            lambda b, x, xz=False: cyc(cfg, h, b.T, x.T, x_zero=xz).T,
            _rows(h.levels[0].A.matvec))


@spans.spanned("driver.solve_mg")
def solve_mg(state: MGState, b, x=None, verbose: bool = False):
    """Iterate cycles until ||r||/||r0|| < relative_tol or max_outer_iter.

    b, x: (n,) or (n, m) arrays or tensors.  Returns (x, info) with x a
    tensor on the state's device and info = {"iters", "relres", "resvec"}.
    """
    t0 = time.perf_counter()
    cfg, dev = state.config, state.device
    dt = torch_dtype(cfg.dtype)
    with spans.span("driver.prepare"):
        b2, squeeze = _as_2d(torch.as_tensor(b, dtype=dt, device=dev))
        x2 = (torch.zeros_like(b2) if x is None
              else _as_2d(torch.as_tensor(x, dtype=dt, device=dev))[0])
        to_field, to_flat, cycle, matvec = _runtime(state)
        bv, xv = to_field(b2), to_field(x2)

    res0 = _norm(bv - matvec(xv)) if _norm(xv) > 0 else _norm(bv)
    res = res0
    resvec = [res0]
    iters = 0
    for count in range(cfg.max_outer_iter):
        xv = cycle(bv, xv)
        res_prev = res
        res = _norm(bv - matvec(xv))
        resvec.append(res)
        iters += 1
        if verbose:
            print(f"Cycle {count + 1} done with relres: {res / res0:.3e}. "
                  f"Convergence factor: {res / max(res_prev, 1e-300):.3f}")
        if res / max(res0, 1e-300) < cfg.relative_tol:
            break
        if not np.isfinite(res) or res > 1e3 * max(res0, 1e-300):
            break              # diverging
    spans.tail("driver.finish")
    state.n_iter += iters * b2.shape[1]
    state.time_solve += time.perf_counter() - t0
    x2 = to_flat(xv)
    return (x2[:, 0] if squeeze else x2), {
        "iters": iters, "relres": res / max(res0, 1e-300),
        "resvec": np.array(resvec)}


def _cycles_program(ctx, b2, x2):
    to_field, to_flat, cycle, n = ctx
    bv, xv = to_field(b2), to_field(x2)
    for _ in range(n):
        xv = cycle(bv, xv)
    return to_flat(xv)


def solve_mg_jit(state: MGState, b, x=None, num_cycles: int | None = None):
    """A fixed number of cycles (default max_outer_iter) as one recorded
    program, with no host read (mgtpu's solve_mg_jit, for benchmarking).
    b, x: (n,) or (n, m).  Returns x on the state's device."""
    cfg, dev = state.config, state.device
    dt = torch_dtype(cfg.dtype)
    b2, squeeze = _as_2d(torch.as_tensor(b, dtype=dt, device=dev))
    x2 = (torch.zeros_like(b2) if x is None
          else _as_2d(torch.as_tensor(x, dtype=dt, device=dev))[0])
    n = cfg.max_outer_iter if num_cycles is None else int(num_cycles)
    to_field, to_flat, cycle, _ = _runtime(state, captured=False)
    x2 = run(state.hier, ("solve_mg_jit", static_config(cfg), n),
             _cycles_program, (to_field, lambda v: to_flat(v).contiguous(),
                               cycle, n), b2, x2)
    return x2[:, 0] if squeeze else x2


def _fine_operator(state: MGState, dtype):
    """The ORIGINAL fine operator (`A_input`) in `dtype` on the state's
    device, in the engine's form: a grid stencil, a `BlockGridOperator` of
    cross stencils (systems), DIA or ELL (flat).  The conversions from the
    CSR add to the state's `setup_times` (grid_convert, cross_stencils)."""
    A_host = state.A_input if state.A_input is not None else state.As[0]
    if isinstance(state.hier, SystemsGridHierarchy):
        with spans.span("setup.cross_stencils", into=state.setup_times):
            return block_operator_from_csr(
                A_host, list(state.meshes[0].n), state.config.mixed,
                dtype=dtype, device=state.device)
    if isinstance(state.hier, GridHierarchy):
        grid = state.hier.fine_grid
        with spans.span("setup.grid_convert", into=state.setup_times,
                        timed=True):
            return make_grid_stencil(
                A_host, list(reversed(grid)), dtype=dtype,
                max_shift=(min(grid) - 1) // 2 if min(grid) < 7 else 3,
                device=state.device)
    return _to_device_matrix(A_host, dtype, device=state.device)


def high_precision_fine_operator(state: MGState, dtype=np.float64):
    """The ORIGINAL fine operator in float64 (or `dtype`: solve_mg_refined's
    `outer_dtype`), cached on the state (the hierarchy's fine matrix was
    cast to the cycle dtype): a grid stencil on the grid engine, a
    `BlockGridOperator` of cross stencils on the systems engine (kernel D
    in float64: mgtpu's double-single block operator becomes native f64),
    DIA or ELL (`_to_device_matrix`) on the flat one.  On the grid engines
    its matvec takes fields (block fields on the systems engine), on the
    flat engine (n, m) columns; `_hi_matvec` is the apply on the solve
    loops' fields for all."""
    key = np.dtype(dtype).name
    if key not in state._outer_ops:
        state._outer_ops[key] = _fine_operator(state, np.dtype(dtype).type)
    return state._outer_ops[key]


def _hi_matvec(state: MGState, dtype=np.float64):
    """The fine operator's apply (float64, or `dtype`) on the engine's
    fields."""
    op = high_precision_fine_operator(state, dtype)
    if isinstance(state.hier, SystemsGridHierarchy):
        return op.rows_matvec
    return op.matvec if isinstance(state.hier, GridHierarchy) \
        else _rows(op.matvec)


def cast_hierarchy(hier, dtype: torch.dtype):
    """A copy of a device hierarchy with every floating tensor in `dtype`
    (mgtpu's `_cast_hier`): the levels, transfers, smoother states and the
    coarsest solver's tables; integer tables and host objects are shared.
    For a complex `dtype` the complex tensors take it and the real ones
    (row norms, masks) its real variant.  Kernels A-F take float32 and
    float64 (C-F also complex64 and complex128), so a bfloat16 copy runs
    their counted plain versions."""
    if isinstance(hier, torch.Tensor):
        if hier.is_complex():
            return hier.to(dtype)
        if hier.is_floating_point():
            return hier.to(dtype.to_real() if dtype.is_complex else dtype)
        return hier
    if isinstance(hier, tuple):
        return tuple(cast_hierarchy(v, dtype) for v in hier)
    if dataclasses.is_dataclass(hier) and not isinstance(hier, type):
        return dataclasses.replace(hier, **{
            f.name: cast_hierarchy(getattr(hier, f.name), dtype)
            for f in dataclasses.fields(hier) if f.init})
    return hier


def _cycle_hierarchy(state: MGState, cd: torch.dtype):
    """The hierarchy a correction cycle in `cd` runs: the state's own, or
    its `cast_hierarchy` copy (made once, kept on the state)."""
    if cd == torch_dtype(state.config.dtype):
        return state.hier
    lo = state._lo_hier
    if lo is None or lo[0] != cd:
        state._lo_hier = lo = (cd, cast_hierarchy(state.hier, cd))
    return lo[1]


@spans.spanned("driver.solve_mg_refined")
def solve_mg_refined(state: MGState, b, x=None, tol: float = 1e-8,
                     max_iter: int | None = None, outer_dtype=None,
                     cycle_dtype=None, device_loop: bool = True,
                     fmg: bool = False, verbose: bool = False):
    """Iterative refinement x += Cycle(b - A x) to a relative residual
    below `tol` (mgtpu's signature).

    The residual is computed in `outer_dtype` (default float64, complex128
    for a complex hierarchy) against
    `A_input`; each correction is one cycle from a zero guess in
    `cycle_dtype` (default the hierarchy's; ``torch.bfloat16`` runs the
    cycles on a bfloat16 copy of the hierarchy, `cast_hierarchy`, whose
    kernels take their counted plain versions).  With `fmg` and no `x`, a
    grid-engine iterate starts from one full multigrid pass on b
    (grid_fmg) instead of zero; on the flat and systems engines the solve
    starts from zero, as mgtpu's does.  The loop stops at `tol`, at
    `max_iter` (default max_outer_iter), or once the residual exceeds
    1e3 * ||b||.

    `device_loop` (mgtpu's default) runs it as recorded programs of
    krylov/_loop.py's CHUNK iterations, each masked by the device flag of
    mgtpu's `cond`; the FMG start and the first residual run inside the
    first program, `tol` and `max_iter` are device scalars, and the host
    reads the flag once a chunk.  `device_loop=False` is the eager host
    loop, one host read an iteration.  Returns (x, info) with x an
    `outer_dtype` tensor on the state's device."""
    t0 = time.perf_counter()
    cfg, dev = state.config, state.device
    outer = torch_dtype(double_variant(cfg.dtype) if outer_dtype is None
                        else outer_dtype)
    cd = torch_dtype(cfg.dtype if cycle_dtype is None else cycle_dtype)
    if is_complex(cfg.dtype) and not cd.is_complex:
        raise NotImplementedError(
            f"cycle_dtype {cd} for a complex hierarchy: torch has no complex "
            "bfloat16, and a real cycle would drop the imaginary part")
    if max_iter is None:
        max_iter = cfg.max_outer_iter
    with spans.span("driver.prepare"):
        gh = _cycle_hierarchy(state, cd)
        b2, squeeze = _as_2d(torch.as_tensor(b, dtype=outer, device=dev))
        x2 = (torch.zeros_like(b2) if x is None
              else _as_2d(torch.as_tensor(x, dtype=outer, device=dev))[0])
        np_outer = np.dtype(str(outer).rsplit(".", 1)[-1])
        matvec_hi = _hi_matvec(state, np_outer)
        to_field, to_flat, cycle, _ = _runtime(state, captured=False,
                                               hier=gh)
        bv, xv = to_field(b2), to_field(x2)
    use_fmg = bool(fmg and x is None and isinstance(gh, GridHierarchy))
    if device_loop:
        xv, iters, res, res0, resvec = _refined_device_loop(
            state, (cfg, gh, cycle, matvec_hi, cd, use_fmg, _loop.CHUNK),
            bv, xv, tol, int(max_iter), np_outer)
        if verbose:
            _print_resvec(resvec)
    else:
        if use_fmg:
            xv = grid_fmg(cfg, gh, bv.to(cd)).to(outer)
        res0 = max(_norm(bv), 1e-300)
        r = bv - matvec_hi(xv)
        res = _norm(r)
        resvec = [res]
        iters = 0
        while iters < max_iter and tol * res0 <= res < 1e3 * res0:
            rl = r.to(cd)
            z = cycle(rl, torch.zeros_like(rl), True)
            xv = xv + z.to(outer)
            r = bv - matvec_hi(xv)
            res_prev, res = res, _norm(r)
            resvec.append(res)
            iters += 1
            if verbose:
                print(f"Refined cycle {iters} relres: {res / res0:.3e}. "
                      f"Factor: {res / max(res_prev, 1e-300):.3f}")
        spans.tail("driver.finish")
        resvec = np.array(resvec)
    state.n_iter += iters * b2.shape[1]
    state.time_solve += time.perf_counter() - t0
    x2 = to_flat(xv)
    return (x2[:, 0] if squeeze else x2), {
        "iters": iters, "relres": res / res0, "resvec": resvec}


def _refine_active(it, res, res0, tol, max_iter):
    """mgtpu's `cond` of the refinement loop, on the card."""
    return (it < max_iter) & (tol * res0 <= res) & (res < 1e3 * res0)


def _refine_chunk(ctx, bv, xv, r, res, res0, it, resvec, tol, max_iter):
    """CHUNK refinement iterations, each masked by the device flag: an
    inactive one leaves x, res, it and resvec as they were (the residual r
    is only read by active ones, and the flag never turns back on)."""
    _, _, cycle, matvec_hi, cd, _, chunk = ctx
    rows = torch.arange(resvec.shape[0], device=resvec.device)
    for _ in range(chunk):
        active = _refine_active(it, res, res0, tol, max_iter)
        rl = r.to(cd)
        with gate(active):              # a masked iteration skips host steps
            z = cycle(rl, torch.zeros_like(rl), True)
        xn = xv + z.to(xv.dtype)
        r = bv - matvec_hi(xn)
        rn = torch.linalg.vector_norm(r)
        xv = torch.where(active, xn, xv)
        res = torch.where(active, rn, res)
        resvec = torch.where(active & (rows == it + 1), rn, resvec)
        it = it + active.to(it.dtype)
    return (xv, r, res, res0, it, resvec,
            _refine_active(it, res, res0, tol, max_iter))


def _refine_first(ctx, bv, xv, resvec, tol, max_iter):
    """The first program: the FMG start, the first residual, a chunk."""
    cfg, gh, _, matvec_hi, cd, use_fmg, _ = ctx
    if use_fmg:
        xv = grid_fmg(cfg, gh, bv.to(cd)).to(bv.dtype)
    res0 = torch.clamp(torch.linalg.vector_norm(bv), min=1e-300)
    r = bv - matvec_hi(xv)
    res = torch.linalg.vector_norm(r)
    resvec = torch.cat([res[None], resvec[1:]])
    return _refine_chunk(ctx, bv, xv, r, res, res0,
                         torch.zeros_like(max_iter), resvec, tol, max_iter)


def _refined_device_loop(state, ctx, bv, xv, tol, max_iter, outer):
    """The refinement loop as recorded chunks (mgtpu's
    `_refined_device_loop`), kept with the cycle's hierarchy:
    (x, iters, res, res0, resvec)."""
    cfg, gh, _, _, cd, use_fmg, chunk = ctx
    hi = high_precision_fine_operator(state, outer)
    key = ("refine", static_config(cfg), cd, use_fmg, chunk, id(hi))
    dev, rdt = bv.device, bv.real.dtype         # norms are real
    scal = (torch.tensor(tol, dtype=rdt, device=dev),
            torch.tensor(max_iter, dtype=torch.int64, device=dev))
    out = run(gh, key + ("first",), _refine_first, ctx, bv, xv,
              torch.zeros(max_iter + 1, dtype=rdt, device=dev),
              *scal, keep=(hi,), clone=False)
    while spans.read(bool, out[-1]):
        out = run(gh, key + ("next",), _refine_chunk, ctx, bv,
                  *out[:-1], *scal, keep=(hi,), clone=False)
    spans.tail("driver.finish")
    xv, _, res, res0, it, resvec, _ = out
    iters = spans.read(int, it)
    return (xv.clone(), iters, spans.read(float, res),
            spans.read(float, res0),
            spans.read(torch.Tensor.cpu, resvec[:iters + 1]).numpy())


def _print_resvec(resvec):
    """Per-iteration report from a finished device loop (mgtpu's
    `_print_resvec`): verbose output on the same numeric path as silent."""
    res0 = max(float(resvec[0]), 1e-300)
    for k in range(1, len(resvec)):
        print(f"Refined cycle {k} relres: {resvec[k] / res0:.3e}. "
              f"Factor: {resvec[k] / max(float(resvec[k - 1]), 1e-300):.3f}")


def get_afun(A):
    """Matvec closure over a device operator (reference getAfun,
    SolveFuncs.jl:65-71)."""
    return A.matvec


def _field_preconditioner(state: MGState, captured: bool = True):
    """One cycle from a zero guess on the engine's fields.  The cycle runs
    in the hierarchy's precision; the correction comes back in r's (the
    mixed-precision shim, SolveFuncs.jl:52-58).  A recorded cycle unless
    `captured` is False (inside a recorded program it runs inline)."""
    cd = torch_dtype(state.config.dtype)
    cycle = _runtime(state, captured)[2]

    def prec(r):
        rl = r.to(cd)
        return cycle(rl, torch.zeros_like(rl), True).to(r.dtype)

    return prec


def get_mg_preconditioner(state: MGState, outer_dtype=None):
    """The one-cycle preconditioner as an operator on flat (n,) / (n, m)
    tensors (reference getMGPreconditioner, SolveFuncs.jl:43-63); each
    application replays the recorded cycle.  The cycle runs in the
    hierarchy's precision; the correction comes back in `outer_dtype`
    (default r's type: the mixed-precision shim, SolveFuncs.jl:52-58)."""
    prec = _field_preconditioner(state)
    to_field, to_flat = _runtime(state)[:2]
    out = None if outer_dtype is None else torch_dtype(outer_dtype)

    def flat_prec(r):
        r2, squeeze = _as_2d(r)
        if out is not None:
            r2 = r2.to(out)
        z = to_flat(prec(to_field(r2)))
        return z[:, 0] if squeeze else z

    return flat_prec


def _krylov_setup(state: MGState, b, x0, captured: bool = True):
    """Krylov operands on the engine's fields: b and x0 as fields, the fine
    matvec, the one-cycle preconditioner, the map back to flat, and the
    `cache` (owner, key, keep) under which the Krylov programs are kept.

    A float64 (complex128) b over a lower-precision hierarchy makes the
    outer iteration float64 (complex128 for a complex b or hierarchy): its
    matvec is that operator of `A_input` and each cycle runs on the
    residual cast to the hierarchy's precision."""
    cfg, dev = state.config, state.device
    cd = torch_dtype(cfg.dtype)
    bt = torch.as_tensor(b, device=dev)
    outer = (torch.promote_types(bt.dtype, cd)
             if bt.dtype in (torch.float64, torch.complex128) else cd)
    b2, squeeze = _as_2d(bt.to(outer))
    x2 = (torch.zeros_like(b2) if x0 is None
          else _as_2d(torch.as_tensor(x0, dtype=outer, device=dev))[0])
    to_field, to_flat2, _, matvec = _runtime(state)
    keep = ()
    if outer != cd:
        np_outer = np.dtype(str(outer).rsplit(".", 1)[-1])
        matvec = _hi_matvec(state, np_outer)
        keep = (high_precision_fine_operator(state, np_outer),)
    cache = (state.hier, ("krylov", static_config(cfg), outer,
                          tuple(map(id, keep))), keep)

    def to_flat(Xv):
        X2 = to_flat2(Xv)
        return X2[:, 0] if squeeze else X2

    return (to_field(b2), to_field(x2), matvec,
            _field_preconditioner(state, captured), to_flat, cache)


def _krylov_solve(state: MGState, name: str, fn, block_fn, block: bool, b,
                  x0, report: bool, device_loop: bool = True, **kw):
    """Run `fn` (or `block_fn` for block=True with several right-hand
    sides) on the Krylov operands of `_krylov_setup`; `device_loop=False`
    runs the eager loop with eager cycles (the comparison)."""
    t0 = time.perf_counter()
    with spans.span("driver.prepare"):
        bv, xv, matvec, prec, to_flat, cache = _krylov_setup(state, b, x0,
                                                             device_loop)
    cfg = state.config
    if block and bv.shape[0] > 1:
        fn = block_fn
    x, info = fn(matvec, bv, prec=prec, x0=xv, tol=cfg.relative_tol,
                 max_iter=cfg.max_outer_iter, device_loop=device_loop,
                 cache=cache, **kw)
    if report:
        rel = spans.read(float, torch.as_tensor(info["relres"]).max())
        print(f"{name}: {int(info['iters'])} iters, relres {rel:.3e}")
    state.n_iter += int(info["iters"]) * bv.shape[0]
    state.time_solve += time.perf_counter() - t0
    return to_flat(x), info


@spans.spanned("driver.solve_cg_mg")
def solve_cg_mg(state: MGState, b, x0=None, verbose: bool = False,
                block: bool = False, device_loop: bool = True):
    """MG-preconditioned CG (reference solveCG_MG, SolveFuncs.jl:103-116);
    block=True with several right-hand sides uses the shared-space block CG
    (SolveFuncs.jl:109-114).  b: (n,) or (n, m).  `device_loop=False` runs
    the eager loop (for comparison)."""
    return _krylov_solve(state, "solve_cg_mg", pcg, block_pcg, block, b, x0,
                         verbose, device_loop)


@spans.spanned("driver.solve_bicgstab_mg")
def solve_bicgstab_mg(state: MGState, b, x0=None, verbose: bool = False,
                      block: bool = False, device_loop: bool = True):
    """MG-preconditioned BiCGSTAB (reference solveBiCGSTAB_MG,
    SolveFuncs.jl:85-99); block=True uses the shared-space Bl-BiCGSTAB
    (SolveFuncs.jl:91-96).  `device_loop=False` runs the eager loop."""
    return _krylov_solve(state, "solve_bicgstab_mg", bicgstab,
                         block_bicgstab, block, b, x0, verbose, device_loop)


@spans.spanned("driver.solve_gmres_mg")
def solve_gmres_mg(state: MGState, b, x0=None, flexible: bool = True,
                   inner: int = 5, verbose: bool = False,
                   block: bool = False, device_loop: bool = True):
    """MG-preconditioned restarted (F)GMRES (reference solveGMRES_MG,
    SolveFuncs.jl:120-133): max_outer_iter restarts of `inner` steps;
    block=True shares one Krylov space between the right-hand sides.  Each
    restart is one recorded program (`device_loop=False`: eager restarts
    with eager cycles)."""
    return _krylov_solve(state, "solve_gmres_mg", fgmres, block_fgmres,
                         block, b, x0, False, device_loop, restart=inner,
                         flexible=flexible, verbose=verbose)
