"""Spans of the program's host steps.

The device trace names kernels; it cannot say what the host was doing
while the device sat idle.  A span names such a step: a solve driver's
preparation of its operands, a recorded program's load and replay, a
blocking read of a device value, a stage of set-up.  Span names are
dotted: ``driver.*`` (the solve drivers, solvers/mg_solver.py),
``program.*`` (the recorded programs, cycle/capture.py), ``setup.*``
(setup/hierarchy.py, cycle/grid_cycle.py, cycle/systems_grid.py) and
``host_read``.

 * `span(name)` is a context manager.  Off (the default) it is one shared
   no-op: no clock is read and nothing is allocated.  On — after
   `enable()`, or while torch.profiler records anywhere in this process —
   it opens ``torch.profiler.record_function("mgtpu_torch." + name)``, so
   that the span sits on a profile beside the device's kernels, copies
   and memsets, and keeps a record ``(name, start_ns, end_ns, parent,
   call)``: `parent` is the index of the enclosing open span's record (-1
   for none), `call` a number shared by every span under one outermost
   ``driver.*`` span (-1 outside any).  Times are `time.perf_counter_ns`.
   At most CAP records are kept; past it ``COUNTS["spans_dropped"]``
   rises in place of a record.  `records()` returns the records kept;
   `drain()` returns them, clears them and sets ``spans_dropped`` back to
   0.  A span still open has end_ns -1.
 * Profiling turns the spans on: an application that profiles itself (and
   each profile window of chip_smoke.py) pays their host cost, which its
   busy shares then include, and keeps up to CAP records until it drains
   them.
 * `span(name, timed=True)` is also timed when off: its host seconds are
   added to ``SECONDS[name]``, the process's totals, which the benchmark
   reads.  `span(name, into=d)` adds them to ``d[key]`` (key: the name
   after its first dot; set-up passes `MGState.setup_times`).
 * `spanned(name)` decorates a function whose every call is `span(name)`:
   the solve drivers (``driver.solve_mg_refined``, ``driver.solve_cg_mg``,
   ...) and ``setup.mg_setup``.
 * `tail(name)` opens a span, when on and inside a driver call, that the
   enclosing span closes when it ends: the part of a driver after its last
   recorded program (``driver.finish``), which starts deep in a Krylov
   method and ends with the driver.
 * `read(fn, t)` is ``fn(t)`` for a blocking device-to-host read (``bool``,
   ``int``, ``float``, a ``.cpu()``), run inside ``span("host_read")``.

No span goes inside a function that is recorded into a CUDA graph: it would
run at the recording alone.  The spans assume the one thread that drives
the device.
"""
from __future__ import annotations

import contextlib
import functools
import time

from torch.autograd import profiler as _profiler

__all__ = ["span", "spanned", "tail", "read", "enable", "disable",
           "records", "drain", "COUNTS", "SECONDS", "CAP"]

CAP = 1 << 18
COUNTS = {"spans_dropped": 0}
SECONDS: dict[str, float] = {}

_NOOP = contextlib.nullcontext()
_ON = False
_RECORDS: list[tuple] = []
_STACK: list["_Span"] = []      # open spans, innermost last
_GEN = 0                        # bumped by drain(): open spans then
                                # leave the new list alone
_CALL = -1                      # the driver call open, or -1
_NEXT_CALL = 0


def enable() -> None:
    global _ON
    _ON = True


def disable() -> None:
    global _ON
    _ON = False


def records() -> list[tuple]:
    """The records kept so far (oldest first), left in place."""
    return list(_RECORDS)


def drain() -> list[tuple]:
    """The records kept so far (oldest first); clears them, and the count
    of those dropped."""
    global _RECORDS, _GEN
    out, _RECORDS = _RECORDS, []
    _GEN += 1
    COUNTS["spans_dropped"] = 0
    return out


class _Span:
    __slots__ = ("name", "into", "timed", "on", "t0", "idx", "gen", "call",
                 "parent", "opens_call", "rf")

    def __init__(self, name: str, into, timed: bool, on: bool):
        self.name, self.into, self.timed, self.on = name, into, timed, on

    def __enter__(self):
        if self.on:
            self._open()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        s = (t1 - self.t0) * 1e-9
        if self.into is not None:
            key = self.name.split(".", 1)[-1]
            self.into[key] = self.into.get(key, 0.0) + s
        if self.timed:
            SECONDS[self.name] = SECONDS.get(self.name, 0.0) + s
        if self.on and self in _STACK:
            while _STACK[-1] is not self:
                _STACK[-1]._close(t1)           # tails opened inside
            self._close(t1)
        return False

    def _open(self) -> None:
        global _CALL, _NEXT_CALL
        self.opens_call = _CALL < 0 and self.name.startswith("driver.")
        if self.opens_call:
            _CALL, _NEXT_CALL = _NEXT_CALL, _NEXT_CALL + 1
        self.parent = _STACK[-1].idx if _STACK else -1
        self.call, self.gen = _CALL, _GEN
        t0 = time.perf_counter_ns()
        if len(_RECORDS) < CAP:
            self.idx = len(_RECORDS)
            _RECORDS.append((self.name, t0, -1, self.parent, self.call))
        else:
            self.idx = -1
            COUNTS["spans_dropped"] += 1
        self.rf = _profiler.record_function("mgtpu_torch." + self.name)
        self.rf.__enter__()
        _STACK.append(self)

    def _close(self, t1: int) -> None:
        global _CALL
        _STACK.pop()
        self.rf.__exit__(None, None, None)
        if self.idx >= 0 and self.gen == _GEN:
            r = _RECORDS[self.idx]
            _RECORDS[self.idx] = (r[0], r[1], t1, r[3], r[4])
        if self.opens_call:
            _CALL = -1


def span(name: str, into: dict | None = None, timed: bool = False):
    """A span named `name` (module docstring); its host seconds, traced or
    not, go to SECONDS with `timed` and to the dict `into`."""
    on = _ON or _profiler._is_profiler_enabled
    if not on and into is None and not timed:
        return _NOOP
    return _Span(name, into, timed, on)


def spanned(name: str):
    """Decorator: each call of the function runs inside span(name)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def tail(name: str) -> None:
    """Open `name` until the enclosing span ends (when on, inside a driver
    call; else nothing)."""
    if (_ON or _profiler._is_profiler_enabled) and _CALL >= 0:
        _Span(name, None, False, True).__enter__()


def read(fn, t):
    """fn(t), a blocking device-to-host read, spanned."""
    if not (_ON or _profiler._is_profiler_enabled):
        return fn(t)
    with _Span("host_read", None, False, True):
        return fn(t)
