"""One run of one cell: set-up, warm-up, the measured window, the check
against the reference, the result line.

Set-up (counted in setup_s): the program's kernels built (only the first
run in a checkout compiles; `build` in the result says what it built),
the operator and the program's set-up on the device (operators/<kind>.py),
the pool of right-hand sides (traffic.py), and warm-up solves of the
cell's own shapes (they record the CUDA graphs).  The window: one client
solves one call after another, closed loop, cycling through the pool, for
`seconds`; every call is timed by the host clock from the call to its
returned x after a device synchronise.  With `trace`, torch.profiler
records the calls of the window's first TRACE_SECONDS (again on the next
calls, where that trace lost a kernel's records: `_Tracer`).  After
the window: the memory peak is read, the program's state is freed, and
the reference (reference/<kind>.py) judges a sample of the window's
answers, drawn from the seed, and the set-up's level operators.
"""
from __future__ import annotations

import random
import time

import numpy as np
import torch

from . import counters, spec, traffic
from .reference import check
from .trace import Profile, Spans

TRACE_SECONDS = 2.0
TRACE_ATTEMPTS = 3
WARMUP_CALLS = 2


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_solve(state, cfg: dict, mix: dict, control: bool = False):
    """The call the window makes: (b) -> (x, iterations, converged per
    column), through the program entry the configuration names
    (`solve.entry`, with `solve.kwargs`; `block=True` where a call carries
    several columns and the entry takes it).  `control` switches on the
    program's own path one precision below the configuration's: a float32
    outer iteration (`outer_dtype`, or a float32 b for an entry without
    it)."""
    import inspect

    import mgtpu_torch as mt
    tol = float(cfg["tol"])
    entry = getattr(mt, cfg["solve"]["entry"])
    takes = inspect.signature(entry).parameters
    kw = dict(cfg["solve"].get("kwargs", {}))
    if int(mix["columns"]) > 1 and "block" in takes:
        kw["block"] = True
    cast = control and "outer_dtype" not in takes
    if control and not cast:
        kw["outer_dtype"] = torch.float32

    def call(b):
        x, info = entry(state, b.float() if cast else b, **kw)
        rel = np.atleast_1d(torch.as_tensor(info["relres"]).double()
                            .cpu().numpy())
        return x, int(info["iters"]), np.isfinite(rel) & (rel < tol)
    return call


class Cell:
    """A cell set up on a device: the program's state and its inputs."""

    def __init__(self, parts: dict, seed: int, device, spans: Spans):
        self.parts, self.seed = parts, int(seed)
        self.device = torch.device(device)
        cfg, root = parts["config"], parts["root"]
        self.ref = spec.reference(cfg["operator"], root)
        self.program = spec.assembly(cfg["operator"], root)
        self.inputs = self.ref.inputs(cfg, self.seed)
        self.state = self.program.setup(cfg, self.inputs, self.device, spans)
        with spans.span("setup.pool"):
            self.pool = self._pool()
            _sync(self.device)
        self.level_gaps: list[float] = []

    def _pool(self) -> list[torch.Tensor]:
        return traffic.make_pool(self.parts["traffic"], self.parts["config"],
                                 self.seed, self.device, self.parts["root"])

    def reseed(self, seed: int) -> None:
        """Another seed's traffic on the same state; only for an operator
        that draws nothing from the seed."""
        if not _same(self.ref.inputs(self.parts["config"], seed),
                     self.inputs):
            raise ValueError("this operator draws its inputs from the seed: "
                             "set the cell up again")
        self.seed = int(seed)
        self.pool = self._pool()


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                        for k in a)


class _Tracer:
    """torch.profiler over whole calls of the window, TRACE_SECONDS at a
    time.  A trace that lacks a device record of some launch of a counted
    kernel (kernels/; the profiler can drop whole graph replays) is set
    aside and the next calls are traced instead, up to TRACE_ATTEMPTS
    times; the last trace is kept either way, with `complete` saying which
    it is."""

    def __init__(self, dev):
        self.dev = dev
        self.open = False
        self.attempts = 0
        self.traced = None

    @property
    def done(self) -> bool:
        return bool(self.traced and self.traced["complete"]) or \
            self.attempts >= TRACE_ATTEMPTS

    def begin(self, calls: int, iters: list) -> None:
        self.prof = Profile()
        self.prof.start()
        # settle: device records of the first launches after the profiler
        # starts can be lost
        for _ in range(8):
            torch.ones(1, device=self.dev).add_(1)
        _sync(self.dev)
        self.win = torch.profiler.record_function("mgbench.window")
        self.win.__enter__()
        self.c0, self.calls0, self.iters0 = counters.snapshot(), calls, \
            len(iters)
        self.t0 = time.perf_counter()
        self.open = True
        self.attempts += 1

    def end(self, calls: int, iters: list) -> None:
        self.win.__exit__(None, None, None)
        _sync(self.dev)
        d = counters.delta(self.c0, counters.snapshot())
        self.traced = {"calls": calls - self.calls0,
                       "iters": list(iters[self.iters0:]), "counters": d,
                       "attempt": self.attempts, **self.prof.stop()}
        self.traced["complete"] = counters.complete(self.traced)
        self.open = False


def measure(cell: Cell, solve, seconds: float, spans: Spans,
            trace: bool = False, t_start: float | None = None) -> dict:
    """Warm-up, then the window; returns what the window saw."""
    dev, pool = cell.device, cell.pool
    mix = cell.parts["traffic"]
    m = int(mix["columns"])
    with spans.span("setup.record"):
        for i in range(WARMUP_CALLS):
            solve(pool[i % len(pool)])
        _sync(dev)
    setup_s = None if t_start is None else time.perf_counter() - t_start

    rng = random.Random(cell.seed)
    k = int(mix["sample"])
    sample: list[tuple[int, torch.Tensor]] = []
    lat, iters, good = [], [], 0
    tracer = _Tracer(dev) if trace else None
    if tracer is not None:
        tracer.begin(0, [])
    c0 = counters.snapshot()
    _sync(dev)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    i = 0
    t1 = t0
    while t1 < deadline:
        b_idx = i % len(pool)
        ts = time.perf_counter()
        with spans.span("solve"):
            x, it, ok = solve(pool[b_idx])
        with spans.span("sync"):
            _sync(dev)
        t1 = time.perf_counter()
        lat.extend([(t1 - ts) * 1e3] * m)
        iters.append(it)
        good += int(ok.sum())
        # a uniform sample of the window's answers (reservoir), from the seed
        if len(sample) < k:
            sample.append((b_idx, x))
        else:
            j = rng.randrange(i + 1)
            if j < k:
                sample[j] = (b_idx, x)
        i += 1
        if tracer is not None and tracer.open and \
                time.perf_counter() - tracer.t0 >= min(TRACE_SECONDS,
                                                      seconds):
            tracer.end(i, iters)
            if not tracer.done and t1 + TRACE_SECONDS < deadline:
                tracer.begin(i, iters)
    window_s = t1 - t0
    return {"setup_s": setup_s, "calls": i, "columns": i * m,
            "good": good, "iters": iters, "latency_ms": lat,
            "window_s": window_s,
            "counters": counters.delta(c0, counters.snapshot()),
            "traced": None if tracer is None else tracer.traced,
            "sample": sample}


def judge(cell: Cell, sample, levels, limits: dict) -> dict:
    """The numbers compared, each with its limit: the reference's true
    relative residual of the sampled answers, and the level operators'
    gap to the reference's coarsening of its own operator."""
    cfg = cell.parts["config"]
    op = cell.ref.operator(cfg, cell.inputs, cell.device)
    rel = [float(np.max(check.relres(op, cell.pool[j], x)))
           for j, x in sample]
    gaps = cell.ref.level_errors(op, levels, cell.seed)
    cell.level_gaps = gaps
    return {"relres_max": {"value": max(rel) if rel else float("inf"),
                           "limit": float(limits["relres_max"])},
            "level_gap_max": {"value": max(gaps) if gaps else float("inf"),
                              "limit": float(limits["level_gap_max"])}}


def correct(checks: dict) -> bool:
    return all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())


def run(workload: str, seed: int, seconds: float, trace: bool,
        device="cuda", chips: int = 1, t_start: float | None = None,
        bench: dict | None = None, wrap=None, root=spec.ROOT,
        control: str | None = None, cell: "Cell | None" = None) -> dict:
    """One run; returns the result line's object.  `wrap(solve)` replaces
    the timed call (the tests plant faults with it); `root` holds
    BENCHMARK.json, the configuration files and mgbench/traffic/.
    `control` puts the program's own lower-precision path in place (the
    checks' controls, never in a benchmark run): "outer", a float32 outer
    iteration; "levels", the level operators judged are the program's
    bfloat16 copy of the hierarchy.  `cell`: a set-up cell to reuse (its
    state is then kept)."""
    if t_start is None:
        t_start = time.perf_counter()
    bench = spec.benchmark(root) if bench is None else bench
    parts = spec.cell(bench, workload, root)
    device = torch.device(device)
    spans = Spans()
    if trace:
        counters.install_byte_counts()
        if device.type == "cuda":
            # the process's first profile can miss device events (CUPTI
            # starting up): spend it in set-up
            p = Profile()
            p.start()
            torch.ones(8, device=device).sum()
            _sync(device)
            p.stop()
    keep = cell is not None
    if keep and cell.seed != int(seed):
        cell.reseed(seed)
    elif not keep:
        built = build(device, spans)
        cell = Cell(parts, seed, device, spans)
    solve = make_solve(cell.state, parts["config"], parts["traffic"],
                       control == "outer")
    if wrap is not None:
        solve = wrap(solve)
    seen = measure(cell, solve, seconds, spans, trace, t_start)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    levels = cell.program.levels(
        cell.state, torch.bfloat16 if control == "levels" else None)
    if not keep:
        cell.state = None       # the program's state is freed here
        if device.type == "cuda":
            torch.cuda.empty_cache()
    checks = judge(cell, seen["sample"], levels, parts["config"]["checks"])
    checks["unconverged"] = {"value": seen["columns"] - seen["good"],
                             "limit": 0}
    record = {"workload": workload, "config": parts["config"],
              "traffic": parts["traffic"], "spans": dict(spans.seconds),
              "built": [] if keep else built,
              "level_gaps": cell.level_gaps,
              **{k: v for k, v in seen.items() if k != "sample"}}
    out = {"correct": correct(checks), "attempted": seen["columns"],
           "failed": seen["columns"] - seen["good"]}
    if trace:
        out["metrics"] = per_layer(parts["per_layer"], record, root)
    else:
        out["metrics"] = end_to_end(parts["end_to_end"], seen, peak)
    out["device"] = device_entry(device, chips, peak, seen.get("traced"))
    if trace and seen.get("traced"):
        out["breakdown"] = breakdown(seen["traced"])
    out["build"] = {"compiled": record["built"],
                    "seconds": spans.seconds.get("setup.build", 0.0)}
    out["checks"] = checks
    out["_record"] = record
    return out


def build(device, spans: Spans) -> list[str]:
    """Build every kernel of the program that has no library in the
    checkout's build directory yet (span setup.build): only a checkout's
    first run compiles, and never inside a later span.  Returns the
    sources this process compiled."""
    if device.type != "cuda":
        return []
    from mgtpu_torch.ops.cuda import _build
    with spans.span("setup.build"):
        return sorted(_build.build())


def end_to_end(entries, seen: dict, peak: int) -> dict:
    values = {
        "solve_rate": seen["good"] / seen["window_s"],
        "solve_ms_p95": float(np.percentile(seen["latency_ms"], 95)),
        "peak_mem_gib": peak / 2 ** 30,
        "setup_s": seen["setup_s"],
    }
    return {e["name"]: {"value": values[e["name"]], "unit": e["unit"]}
            for e in entries if values.get(e["name"]) is not None}


def per_layer(entries, record: dict, root=spec.ROOT) -> dict:
    out = {}
    for e in entries:
        v = spec.reader(e["name"], root)(record)
        if v is not None:
            out[e["name"]] = {"value": float(v), "unit": e["unit"]}
    return out


def device_entry(device, chips: int, peak: int, traced) -> dict:
    from . import trace as tr
    d = {"platform": "gpu" if device.type == "cuda" else device.type,
         "kind": (torch.cuda.get_device_name(device)
                  if device.type == "cuda" else "cpu"),
         "count": chips, "memory_peak_bytes": int(peak)}
    if traced is not None:
        lo, hi = tr.window(traced)
        d["busy_s"] = tr.busy_us(traced) * 1e-6
        d["window_s"] = (hi - lo) * 1e-6
    return d


def breakdown(traced: dict) -> dict:
    from . import trace as tr
    lo, hi = tr.window(traced)
    ops = [(tr.short_name(n), d) for n, ts, d in traced["device_ops"]
           if ts >= lo and ts + d <= hi]
    return {"device_ops": tr.top(ops), "idle_gaps": tr.top(tr.idle_gaps(
        traced))}
