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
 * Host steps.  A step that must run on the host (the SuperLU coarsest
   solves) is written `host_step(fn, x)`.  Inside a recording it splits
   the program: the graph so far ends with x computed; at replay x is
   copied to pinned host memory, `fn` runs on it, and the result is copied
   back before the next graph (mgtpu's `jax.pure_callback`).  A W- or
   F-cycle that visits the host coarsest twice has three graphs.  Under
   `gate(flag)` (a recorded loop's iteration flag) a step whose flag is
   false at replay is skipped.
 * Launch counters.  The kernels' wrappers count launches in Python
   dicts; recording runs the wrappers once without launching anything, so
   `Tally` takes the recording's increments back and adds them at every
   replay.
 * `programs(owner)` keeps the programs of one owner (a hierarchy) in a
   `weakref.WeakKeyDictionary`, keyed by what they were recorded for
   (function, shapes, dtypes, static arguments), in one memory pool.
   Programs of one pool never run at the same time (one stream, one
   thread), so the temporaries of one may reuse those of another; what
   must outlive a replay — static inputs, outputs, tensors across a host
   step — is held by the program.

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

__all__ = ["Captured", "Tally", "Programs", "programs", "forget", "run",
           "host_step", "gate", "kernel_counters", "static_config"]

_STATE = threading.local()      # the program being warmed up or recorded


def _recording():
    """The `_Recorder` of the program being recorded on this thread, or
    None (also None during a warm-up)."""
    return getattr(_STATE, "recorder", None)


def _busy() -> bool:
    return getattr(_STATE, "busy", False)


def kernel_counters() -> list[dict]:
    """The launch and plain-call counters of every kernel wrapper."""
    from ..ops.cuda import (const3d, fused3d, kaczmarz, stencil, tridiag,
                            vanka)
    return [const3d.LAUNCHES, const3d.PLAIN_CALLS, fused3d.LAUNCHES,
            fused3d.PLAIN_CALLS, fused3d.GRID_LAUNCHES, tridiag.LAUNCHES,
            tridiag.PLAIN_CALLS, stencil.LAUNCHES, stencil.PLAIN_CALLS,
            stencil.CROSS_LAUNCHES, stencil.HALO_LAUNCHES,
            stencil.HALO_FORM_LAUNCHES, stencil.BLOCK_LAUNCHES,
            vanka.LAUNCHES, vanka.PLAIN_CALLS, vanka.FORMS,
            kaczmarz.LAUNCHES, kaczmarz.PLAIN_CALLS]


class Tally:
    """Counter increments of one recording, added back at each replay.

    `begin` snapshots the dicts, `end` takes what the recording added back
    out (nothing launched), `replay` adds it once more."""

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

    def replay(self) -> None:
        for d, inc in zip(self.dicts, self.delta):
            for k, v in inc.items():
                d[k] = d.get(k, 0) + v


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
        self.pin_in.copy_(self.x, non_blocking=True)
        if self.flag is not None:
            self.pin_flag.copy_(self.flag, non_blocking=True)
        torch.cuda.current_stream(self.x.device).synchronize()
        if self.flag is None or bool(self.pin_flag):
            self.pin_out.copy_(self.fn(self.pin_in))
            self.out.copy_(self.pin_out, non_blocking=True)


class _Recorder:
    """Records one program as graphs split at its host steps."""

    def __init__(self, pool):
        self.pool = pool
        self.graphs: list[torch.cuda.CUDAGraph] = []
        self.steps: list[_HostStep] = []
        self._open: torch.cuda.CUDAGraph | None = None

    def begin(self) -> None:
        g = torch.cuda.CUDAGraph()
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
    recording."""
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
    the enclosing `gate`, if any)."""
    rec = _recording()
    if rec is None or x.device.type != "cuda":
        return fn(x.detach().cpu()).to(x.device)
    return rec.host_step(fn, x)


def _flatten(out):
    return (out,) if isinstance(out, torch.Tensor) else tuple(out)


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
        for s, a in zip(self._inputs, args):
            s.copy_(a)

    def _record(self, ctx, args) -> None:
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
            tally = Tally(kernel_counters())
            rec = _Recorder(self.pool)
            tally.begin()
            with torch.cuda.stream(side):
                rec.begin()
                _STATE.recorder = rec
                try:
                    out = self.fn(ctx, *self._inputs)
                    rec.end()
                except BaseException:
                    rec.abort()
                    raise
                finally:
                    _STATE.recorder = None
                    tally.end()
        finally:
            _STATE.busy = False
        torch.cuda.current_stream(dev).wait_stream(side)
        self._single = isinstance(out, torch.Tensor)
        self._outputs = _flatten(out)
        self._rec, self._tally = rec, tally

    def _replay(self) -> None:
        graphs, steps = self._rec.graphs, self._rec.steps
        for i, g in enumerate(graphs):
            g.replay()
            if i < len(steps):
                steps[i].run()
        self._tally.replay()


@dataclass(eq=False)
class Programs:
    """The recorded programs of one owner, in one memory pool."""
    table: dict = field(default_factory=dict)
    pool: object = None

    def get(self, key, fn, keep=()) -> Captured:
        cap = self.table.get(key)
        if cap is None:
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            cap = self.table[key] = Captured(fn, pool=self.pool, keep=keep)
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
