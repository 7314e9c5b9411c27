"""Captured programs: the port's counterpart of `jax.jit` and
`lax.while_loop`.

mgtpu compiles its cycles, its solve loops and its Krylov iterations into
device programs (`grid_cycle_jit`, `cycle_jit`, `solve_mg_jit`, the refined
`lax.while_loop`).  Here a program is a function of tensors recorded into
CUDA graphs:

 * `Captured` wraps one function `fn(ctx, *tensors)`.  On the card its
   first call copies the inputs into static buffers, runs `fn` once on a
   side stream (the warm-up: launch plans built, the kernels' one-time
   `cudaFuncSetAttribute` calls made, cuBLAS / cuSOLVER workspaces chosen),
   then records it into `torch.cuda.CUDAGraph`s in the owner's memory pool;
   every call copies its inputs into the static buffers and replays.  On
   the CPU `fn` is called directly: the plain form, which the CPU tests
   check.  `ctx` carries the Python objects `fn` needs (configuration,
   hierarchy, closures); it is passed at every call and never stored, so a
   cached program holds no reference to its owner.
 * `Loop` (through `loop`) is a while loop as one program: a start
   `first(ctx, *args)` and an iteration `body(ctx, args, state)`, each
   returning the state and the loop's condition (a 0-dim bool tensor).  On
   the card the two are recorded (`CUDAGraph(keep_graph=True)`) and
   joined by ops/cuda/device_loop.py into one graph with a conditional
   WHILE node: a call copies its inputs into the static buffers, launches
   that graph once and reads the iteration count when the device is done —
   no host step between iterations.  The iteration writes its new state
   back into the loop's buffers (`_loop_step`: a `copy_` for each large
   entry, one `_foreach_copy_` a dtype for the small ones).  This form
   engages when the warm-up of the start and one iteration takes no host
   step and the two recordings hold only nodes a WHILE body takes
   (`device_loop.body_takes`: no memory-allocation node of a library's
   stream-ordered workspace); a loop with a host step (a host SuperLU
   coarsest) or such a node, a loop on the CPU and a loop inside an outer
   program give None, and the caller runs its chunked form of `run`
   programs (krylov/_loop.py).  Under torch.profiler's CUDA tracing,
   launches of the loop graph faulted in some traced runs on an H100
   (cause not found; csrc/device_loop.cu), so a call made while
   torch.profiler records replays the loop's two recordings from the host
   instead, one graph an iteration and a host read of the condition after
   each (`Loop._host_driven`): the loop graph's kernels but its set_cond.
 * Host steps.  A step that must run on the host (the SuperLU coarsest
   solves) is written `host_step(fn, x)`.  Inside a recording it splits
   the program: the graph so far ends with x computed; at replay x is
   copied to pinned host memory, `fn` runs on it, and the result is copied
   back before the next graph (mgtpu's `jax.pure_callback`).  A W- or
   F-cycle that visits the host coarsest twice has three graphs.  Under
   `gate(flag)` (a chunked loop's iteration flag) a step whose flag is
   false at replay is skipped.
 * Launch counters.  The kernels' wrappers count launches in Python
   dicts; recording runs the wrappers once without launching anything, so
   `Tally` takes the recording's increments back and adds them at every
   replay (a loop's: the start's once and the iteration's once an
   iteration run).  The host's own steps are spans (spans.py), not
   counters: "program.record" (warm-up and capture, timed), "program.load"
   (the inputs copied into the static buffers), "program.replay",
   "program.host_step" and "program.device_loop" (a loop's load, launch
   and count read).
 * `programs(owner)` keeps the programs of one owner (a hierarchy) in a
   `weakref.WeakKeyDictionary`, keyed by what they were recorded for
   (function, shapes, dtypes, static arguments), in one memory pool.
   Programs of one pool never run at the same time (one stream, one
   thread), so the temporaries of one may reuse those of another; what
   must outlive a replay — static inputs, outputs, a loop's state,
   tensors across a host step — is held by the program.

No fallback: on the card a recording that fails raises with torch's
message; nothing runs eagerly in its place.  A program called while another
is being warmed up or recorded runs inline, as part of the outer one.
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from dataclasses import dataclass, field, replace

import torch
from torch.autograd import profiler as _profiler

from .. import spans

__all__ = ["Captured", "Loop", "Tally", "Programs", "programs", "forget",
           "run", "loop", "host_step", "gate", "kernel_counters",
           "static_config"]

_STATE = threading.local()      # the program being warmed up or recorded


def _recording():
    """The `_Recorder` of the program being recorded on this thread, or
    None (also None during a warm-up)."""
    return getattr(_STATE, "recorder", None)


def _busy() -> bool:
    return getattr(_STATE, "busy", False)


def kernel_counters() -> list[dict]:
    """The launch and plain-call counters of every kernel wrapper."""
    from ..ops.cuda import (const3d, device_loop, fused3d, kaczmarz,
                            stencil, tridiag, vanka)
    return [const3d.LAUNCHES, const3d.PLAIN_CALLS, fused3d.LAUNCHES,
            fused3d.PLAIN_CALLS, tridiag.LAUNCHES, tridiag.PLAIN_CALLS,
            stencil.LAUNCHES, stencil.PLAIN_CALLS,
            stencil.CROSS_LAUNCHES, stencil.HALO_LAUNCHES,
            stencil.HALO_FORM_LAUNCHES, stencil.BLOCK_LAUNCHES,
            vanka.LAUNCHES, vanka.PLAIN_CALLS, vanka.FORMS,
            kaczmarz.LAUNCHES, kaczmarz.PLAIN_CALLS, device_loop.LAUNCHES]


class Tally:
    """Counter increments of one recording, added back at each replay.

    `begin` snapshots the dicts, `end` takes what the recording added back
    out (nothing launched), `replay(n)` adds it n times more."""

    def __init__(self, dicts):
        self.dicts = list(dicts)
        self.delta: list[dict] = []
        self._before: list[dict] = []

    def begin(self) -> None:
        self._before = [dict(d) for d in self.dicts]

    def end(self) -> None:
        self.delta = [{k: v - b.get(k, 0) for k, v in d.items()
                       if v != b.get(k, 0)}
                      for d, b in zip(self.dicts, self._before)]
        for d, b in zip(self.dicts, self._before):
            d.clear()
            d.update(b)

    def replay(self, times: int = 1) -> None:
        for d, inc in zip(self.dicts, self.delta):
            for k, v in inc.items():
                d[k] = d.get(k, 0) + times * v


@dataclass
class _HostStep:
    fn: object
    x: torch.Tensor             # device input, computed by the graph before
    pin_in: torch.Tensor
    pin_out: torch.Tensor
    out: torch.Tensor           # device output, read by the graph after
    flag: torch.Tensor | None   # the gate's device flag, None: always run
    pin_flag: torch.Tensor

    def run(self) -> None:
        with spans.span("program.host_step"):
            self.pin_in.copy_(self.x, non_blocking=True)
            if self.flag is not None:
                self.pin_flag.copy_(self.flag, non_blocking=True)
            torch.cuda.current_stream(self.x.device).synchronize()
            if self.flag is None or bool(self.pin_flag):
                self.pin_out.copy_(self.fn(self.pin_in))
                self.out.copy_(self.pin_out, non_blocking=True)


class _Recorder:
    """Records one program as graphs split at its host steps."""

    def __init__(self, pool, keep_graph: bool = False):
        self.pool = pool
        self.keep_graph = keep_graph    # the raw graphs kept (a Loop's)
        self.graphs: list[torch.cuda.CUDAGraph] = []
        self.steps: list[_HostStep] = []
        self._open: torch.cuda.CUDAGraph | None = None

    def begin(self) -> None:
        g = torch.cuda.CUDAGraph(keep_graph=self.keep_graph)
        g.capture_begin(pool=self.pool)
        self._open = g

    def end(self) -> None:
        g, self._open = self._open, None
        g.capture_end()
        self.graphs.append(g)

    def abort(self) -> None:
        """Leave capture mode after a failure (the graph is dropped)."""
        g, self._open = self._open, None
        if g is not None:
            try:
                g.capture_end()
            except RuntimeError:
                pass

    def host_step(self, fn, x: torch.Tensor) -> torch.Tensor:
        self.end()
        pinned = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                  for _ in range(2)]
        step = _HostStep(fn, x, *pinned, torch.empty_like(x),
                         getattr(_STATE, "gate", None),
                         torch.empty((), dtype=torch.bool, pin_memory=True))
        self.steps.append(step)
        self.begin()
        return step.out


@contextlib.contextmanager
def gate(flag: torch.Tensor):
    """Host steps recorded inside the block run at replay only where the
    0-dim bool device tensor `flag` is true: a masked iteration of a
    recorded loop, whose results are discarded, skips its host SuperLU
    solves (the step's output keeps its last values).  No effect outside a
    recording (and none in a `Loop`, whose iterations are never masked)."""
    prev = getattr(_STATE, "gate", None)
    _STATE.gate = flag
    try:
        yield
    finally:
        _STATE.gate = prev


def host_step(fn, x: torch.Tensor) -> torch.Tensor:
    """fn(x) for a host function `fn` of a CPU tensor (returning one of the
    same shape and dtype), on a tensor of any device: eagerly a round trip
    through the host; inside a recording a split of the program (gated by
    the enclosing `gate`, if any).  Each eager call adds one to the
    thread's count that `_warm` reads."""
    rec = _recording()
    if rec is None or x.device.type != "cuda":
        _STATE.host_steps = getattr(_STATE, "host_steps", 0) + 1
        return fn(x.detach().cpu()).to(x.device)
    return rec.host_step(fn, x)


def _flatten(out):
    return (out,) if isinstance(out, torch.Tensor) else tuple(out)


def _load(statics, args) -> None:
    """A call's inputs copied into a program's static buffers."""
    with spans.span("program.load"):
        for s, a in zip(statics, args):
            s.copy_(a)


def _capture(pool, side, fn, keep_graph: bool = False):
    """fn() recorded on the stream `side` into graphs of `pool`:
    (the `_Recorder`, the `Tally` of its counter increments, fn's
    result)."""
    tally = Tally(kernel_counters())
    rec = _Recorder(pool, keep_graph)
    tally.begin()
    with torch.cuda.stream(side):
        rec.begin()
        _STATE.recorder = rec
        try:
            out = fn()
            rec.end()
        except BaseException:
            rec.abort()
            raise
        finally:
            _STATE.recorder = None
            tally.end()
    return rec, tally, out


class Captured:
    """One function of tensors as a recorded program (module docstring).

    `fn(ctx, *tensors)` returns a tensor or a tuple of tensors and must not
    write its inputs.  `keep` holds objects whose device memory the graphs
    read but that the owner does not hold."""

    def __init__(self, fn, pool=None, keep=()):
        self.fn = fn
        self.pool = pool
        self.keep = keep
        self._rec: _Recorder | None = None
        self._inputs: tuple = ()
        self._outputs: tuple = ()
        self._single = True
        self._tally: Tally | None = None

    @property
    def segments(self) -> int:
        """Graphs of the recording (one more than its host steps)."""
        return 0 if self._rec is None else len(self._rec.graphs)

    def __call__(self, ctx, *args, clone: bool = True):
        if not any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
            return self.fn(ctx, *args)
        if _busy():
            return self.fn(ctx, *args)        # inside an outer program
        if self._rec is None:
            self._record(ctx, args)
        else:
            self._load(args)
        self._replay()
        outs = tuple(o.clone() for o in self._outputs) if clone \
            else self._outputs
        return outs[0] if self._single else outs

    def _load(self, args) -> None:
        _load(self._inputs, args)

    def _record(self, ctx, args) -> None:
        with spans.span("program.record", timed=True):
            self._warm_and_capture(ctx, args)

    def _warm_and_capture(self, ctx, args) -> None:
        dev = args[0].device
        self._inputs = tuple(a.detach().clone() for a in args)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        _STATE.busy = True
        try:
            with torch.cuda.stream(side):
                self.fn(ctx, *self._inputs)           # warm-up
            side.synchronize()
            rec, tally, out = _capture(
                self.pool, side, lambda: self.fn(ctx, *self._inputs))
        finally:
            _STATE.busy = False
        torch.cuda.current_stream(dev).wait_stream(side)
        self._single = isinstance(out, torch.Tensor)
        self._outputs = _flatten(out)
        self._rec, self._tally = rec, tally

    def _replay(self) -> None:
        graphs, steps = self._rec.graphs, self._rec.steps
        with spans.span("program.replay"):
            for i, g in enumerate(graphs):
                g.replay()
                if i < len(steps):
                    steps[i].run()
        self._tally.replay()


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _warm(first, body, ctx, args) -> bool:
    """A loop's warm-up: its start and one iteration run eagerly, as its
    programs run them (the inputs left as they were).  Whether either took
    a host step, which keeps the loop on chunks."""
    before = getattr(_STATE, "host_steps", 0)
    state, _ = _loop_start(first, ctx, args)
    body(ctx, args, state)
    return getattr(_STATE, "host_steps", 0) > before


def _loop_start(first, ctx, args):
    """A loop's start as its program runs it: first(ctx, *args) as (state,
    condition), every state tensor contiguous and in memory of its own
    (one that shares memory with an input or an earlier entry is cloned),
    so that the iterations can write each entry back in place."""
    *state, go = first(ctx, *args)
    held = {_storage(a) for a in args}
    own = []
    for t in state:
        if _storage(t) in held:
            t = t.clone(memory_format=torch.contiguous_format)
        elif not t.is_contiguous():
            t = t.contiguous()
        held.add(_storage(t))
        own.append(t)
    return tuple(own), go


BIG = 65_536    # elements: a state entry above it is written back alone


def _loop_step(body, ctx, args, state):
    """One iteration as a loop's program runs it: body(ctx, args, state),
    its new state written back into `state` in place, and its condition
    returned.  An entry the iteration returns as it got it (unchanged, or
    written in place) is skipped; one that shares memory with another
    entry of `state` is cloned first.  An entry above BIG elements takes a
    `copy_` of its own, the smaller ones one `_foreach_copy_` a dtype:
    `_foreach_copy_` gives each BIG-element piece of a tensor one block,
    too few to keep the card busy on a field."""
    *new, go = body(ctx, args, state)
    held = {_storage(t) for t in state}
    small: dict = {}
    for s, n in zip(state, new):
        if n is s:
            continue
        if n.shape != s.shape or n.dtype != s.dtype:
            raise ValueError(
                f"a loop's state keeps its shapes and types: {n.dtype} "
                f"{tuple(n.shape)} for {s.dtype} {tuple(s.shape)}")
        if _storage(n) in held:
            n = n.clone()
        if s.numel() > BIG:
            s.copy_(n)
        else:
            dst, src = small.setdefault(s.dtype, ([], []))
            dst.append(s)
            src.append(n)
    for dst, src in small.values():
        torch._foreach_copy_(dst, src)
    return go


class Loop:
    """A while loop as one program on the card (module docstring).

    `fns` = (first, body): `first(ctx, *args)` returns the start state and
    the condition, `body(ctx, args, state)` the next state and the
    condition.  Neither writes `args`; `body` may write entries of `state`
    in place and return them, which saves their copy back.  The state
    keeps its shapes and types.  A call returns (the state's buffers, the
    count read from state[count]: the iterations run, which the start sets
    to 0 and each iteration raises by one), or None where the loop takes a
    host step or its recordings hold a node the loop graph cannot take (the
    first call finds out; the loop stays on chunks).

    The loop graph is built at the first call made while torch.profiler
    is off, and runs there alone; a call made while it records replays the
    start's and the iteration's graphs from the host instead
    (`_host_driven`)."""

    def __init__(self, fns, pool=None, keep=()):
        self.first, self.body = fns
        self.pool = pool
        self.keep = keep
        self.chunked: bool | None = None    # None until the warm-up
        self._inputs: tuple = ()
        self._state: tuple = ()
        self._held: tuple = ()              # graphs and conditions
        self._tallies: tuple = ()
        self._exec = None

    @property
    def segments(self) -> int:
        """1 once the loop is recorded for the while form, else 0."""
        return 1 if self._held else 0

    def __call__(self, ctx, *args, count: int):
        from ..ops.cuda import device_loop
        fresh = self.chunked is None
        profiled = _profiler._is_profiler_enabled
        if fresh or (self._exec is None and self._held and not profiled):
            with spans.span("program.record", timed=True):
                try:
                    if fresh:
                        self._warm_and_capture(ctx, args)
                    if self._held and not profiled:
                        g0, g1, go0, go1 = self._held
                        self._exec = device_loop.build(
                            g0.raw_cuda_graph(), g1.raw_cuda_graph(), go0,
                            go1)
                except BaseException:
                    if fresh:
                        self.chunked, self._held = None, ()
                    raise
        if self.chunked:
            return None
        if profiled:
            if not fresh:
                _load(self._inputs, args)
            k = self._host_driven()
        else:
            with spans.span("program.device_loop"):
                if not fresh:
                    _load(self._inputs, args)
                with spans.span("program.replay"):
                    self._exec.launch()
                k = spans.read(int, self._state[count])
            device_loop.ran(k)
        start, step = self._tallies
        start.replay()
        step.replay(k)
        return self._state, k

    def _host_driven(self) -> int:
        """The loop while torch.profiler records, under whose CUDA tracing
        the loop graph's launches faulted (csrc/device_loop.cu): the
        start's graph, then the iteration's while the condition read after
        each holds — the kernels of the loop graph, with a host read of the
        condition an iteration.  Returns the iterations run."""
        g0, g1, go0, go1 = self._held
        with spans.span("program.replay"):
            g0.replay()
        go, k = go0, 0
        while spans.read(bool, go):
            with spans.span("program.replay"):
                g1.replay()
            go, k = go1, k + 1
        return k

    def _warm_and_capture(self, ctx, args) -> None:
        from ..ops.cuda import device_loop
        dev = args[0].device
        self._inputs = inputs = tuple(a.detach().clone() for a in args)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        _STATE.busy = True
        try:
            with torch.cuda.stream(side):
                self.chunked = _warm(self.first, self.body, ctx, inputs)
            side.synchronize()
            if self.chunked:
                self._inputs = ()
                return
            rec0, tally0, (state, go0) = _capture(
                self.pool, side,
                lambda: _loop_start(self.first, ctx, inputs), True)
            rec1, tally1, go1 = _capture(
                self.pool, side,
                lambda: _loop_step(self.body, ctx, inputs, state), True)
        finally:
            _STATE.busy = False
        torch.cuda.current_stream(dev).wait_stream(side)
        if len(rec0.graphs) != 1 or len(rec1.graphs) != 1:
            raise RuntimeError("a loop took a host step in its recording "
                               "but not in its warm-up")
        g0, g1 = rec0.graphs[0], rec1.graphs[0]
        if not all(device_loop.body_takes(device_loop.census(
                g.raw_cuda_graph())) for g in (g0, g1)):
            self.chunked, self._inputs = True, ()
            return
        for g in (g0, g1):              # for `_host_driven`, made here
            g.instantiate()             # rather than in a profiled call
        self._state, self._held = state, (g0, g1, go0, go1)
        self._tallies = (tally0, tally1)


@dataclass(eq=False)
class Programs:
    """The recorded programs of one owner, in one memory pool."""
    table: dict = field(default_factory=dict)
    pool: object = None

    def get(self, key, fn, keep=(), kind=Captured):
        """The program of `key`, a `kind` (Captured, or Loop with fn =
        (first, body)) made on first use."""
        cap = self.table.get(key)
        if cap is None:
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            cap = self.table[key] = kind(fn, pool=self.pool, keep=keep)
        return cap

    def drop_unrecorded(self, key) -> None:
        """Forget a program whose recording failed.  A pool whose graphs
        are all gone cannot take another recording, so an empty table
        starts a new pool."""
        cap = self.table.get(key)
        if cap is not None and cap.segments == 0:
            del self.table[key]
        if not self.table:
            self.pool = None


_PROGRAMS: "weakref.WeakKeyDictionary[object, Programs]" = \
    weakref.WeakKeyDictionary()


def programs(owner) -> Programs:
    """The program cache of `owner` (a hierarchy), made on first use."""
    p = _PROGRAMS.get(owner)
    if p is None:
        p = _PROGRAMS[owner] = Programs()
    return p


def forget(owner) -> None:
    """Drop the programs of `owner` (with their pool): the next calls
    record anew."""
    _PROGRAMS.pop(owner, None)


def static_config(cfg):
    """A configuration without its stop parameters (max_outer_iter,
    relative_tol), which no recorded cycle reads: the part of a program's
    key that a new tolerance leaves alone."""
    return replace(cfg, max_outer_iter=0, relative_tol=0.0)


def _signature(tensors) -> tuple:
    return tuple((tuple(t.shape), t.dtype, t.device) for t in tensors)


def run(owner, key, fn, ctx, *tensors, keep=(), clone: bool = True):
    """fn(ctx, *tensors) as a program: on the CPU (or inside an outer
    program) a direct call; on the card the program of `owner` recorded
    for (key, the tensors' shapes, dtypes and device), recorded on first
    use.  With owner None the program is recorded for this call alone.
    `key` must determine what `fn` does with `ctx`."""
    if _busy() or not any(t.is_cuda for t in tensors):
        return fn(ctx, *tensors)
    if owner is None:
        return Captured(fn, keep=keep)(ctx, *tensors, clone=clone)
    progs, full = programs(owner), (key, _signature(tensors))
    try:
        return progs.get(full, fn, keep)(ctx, *tensors, clone=clone)
    except BaseException:
        progs.drop_unrecorded(full)
        raise


def loop(owner, key, first, body, ctx, *args, count: int, keep=()):
    """A while loop (first, body: `Loop`) on `args` as one program of
    `owner`, recorded for (key, the tensors' shapes, dtypes and device) on
    first use (owner None: for this call alone).  Returns (the final
    state's buffers, which the next call overwrites, and the count read
    from state[count]), or None where the loop does not take this form —
    on the CPU, inside an outer program, or when it takes a host step or its recordings a node the loop graph
    refuses — and the caller runs its chunked form."""
    if _busy() or not any(t.is_cuda for t in args):
        return None
    if owner is None:
        return Loop((first, body), keep=keep)(ctx, *args, count=count)
    progs, full = programs(owner), (key, _signature(args))
    try:
        return progs.get(full, (first, body), keep, Loop)(ctx, *args,
                                                         count=count)
    except BaseException:
        progs.drop_unrecorded(full)
        raise
