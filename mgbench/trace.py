"""Spans and the device trace.

`Spans` times the calls the benchmark's own files make into the program's
layers by the host clock, and marks them for torch.profiler
(record_function "mgbench.<name>").  `Profile` runs torch.profiler over
part of the window and reduces its trace to plain lists:

  device_ops  [name, start_us, dur_us] of every kernel, copy and memset;
  spans       [name, start_us, dur_us] of the benchmark's marked spans.

The functions below them turn those lists into busy time, idle gaps and
per-kernel time; the metric readers (mgbench/metrics/) use them, and the
tests feed them a recorded fixture.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "mgbench."


class Spans:
    """Host-clock seconds by span name (summed over repeats)."""

    def __init__(self):
        self.seconds: dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        from torch.profiler import record_function
        t0 = time.perf_counter()
        try:
            with record_function(PREFIX + name):
                yield
        finally:
            self.seconds[name] = self.seconds.get(name, 0.0) + \
                time.perf_counter() - t0


class Profile:
    """torch.profiler (host and CUDA activity) between start() and stop()."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])

    def start(self) -> None:
        self._prof.start()

    def stop(self) -> dict:
        self._prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json", prefix="mgbench_trace_")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.unlink(path)
        return reduce_chrome(events)


def reduce_chrome(events) -> dict:
    """A chrome trace (dict with traceEvents, or their list) -> the plain
    lists this module works on."""
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    ops, spans = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            ops.append([e.get("name", "?"), float(e["ts"]), float(e["dur"])])
        elif cat == "user_annotation" and \
                str(e.get("name", "")).startswith(PREFIX):
            spans.append([e["name"][len(PREFIX):], float(e["ts"]),
                          float(e["dur"])])
    return {"device_ops": ops, "spans": spans}


def window(trace: dict, name: str = "window") -> tuple[float, float]:
    """(start_us, end_us) of the traced window: its span, widened to the
    device operations the profiler recorded (it runs over the window
    alone; the device's clock may sit a little apart from the host's)."""
    for n, ts, dur in trace["spans"]:
        if n == name:
            lo, hi = ts, ts + dur
            for _, t, d in trace["device_ops"]:
                lo, hi = min(lo, t), max(hi, t + d)
            return lo, hi
    raise ValueError(f"no {name!r} span in the trace")


def merged(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The union of [start, end) intervals clipped to [lo, hi), sorted."""
    out: list[list[float]] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_us(trace: dict) -> float:
    """Microseconds of the traced window in which a device operation ran."""
    lo, hi = window(trace)
    return sum(e - s for s, e in merged(
        ((ts, ts + d) for _, ts, d in trace["device_ops"]), lo, hi))


def kernel_us(trace: dict, pattern: str) -> tuple[float, int]:
    """Summed time and count of the traced kernels whose name matches the
    regular expression `pattern`."""
    rx = re.compile(pattern)
    total, count = 0.0, 0
    for name, ts, d in trace["device_ops"]:
        if rx.search(name):
            total += d
            count += 1
    return total, count


def idle_gaps(trace: dict) -> list[tuple[str, float]]:
    """The device's idle stretches in the window, cut where the
    benchmark's spans begin and end, each piece named by the span open over
    it ("harness" where none but the window's own is: the benchmark's
    bookkeeping between calls).  The spans inside the window follow one
    another (solve, sync, ...); [name, microseconds] pieces."""
    lo, hi = window(trace)
    busy = merged(((ts, ts + d) for _, ts, d in trace["device_ops"]), lo, hi)
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < hi:
        gaps.append((t, hi))
    segs, t = [], lo                 # the window cut into named segments
    for a, b, n in sorted((ts, ts + d, n) for n, ts, d in trace["spans"]
                          if n != "window"):
        a, b = max(a, t), min(b, hi)
        if b <= a:
            continue
        if a > t:
            segs.append((t, a, "harness"))
        segs.append((a, b, n))
        t = b
    if t < hi:
        segs.append((t, hi, "harness"))
    out, j = [], 0
    for s, e in gaps:                # both lists sorted, disjoint
        while j < len(segs) and segs[j][1] <= s:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < e:
            a, b, n = segs[k]
            piece = min(b, e) - max(a, s)
            if piece > 0:
                out.append((n, piece))
            k += 1
    return out


def top(pairs, k: int = 10) -> list[list]:
    """[[name, seconds], ...] of the k names with most microseconds."""
    acc: dict[str, float] = {}
    for name, us in pairs:
        acc[name] = acc.get(name, 0.0) + us
    return [[n, us * 1e-6] for n, us in
            sorted(acc.items(), key=lambda kv: -kv[1])[:k]]


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without its argument list, cut to `width`."""
    name = name.replace("(anonymous namespace)", "{anon}")
    i = name.find("(")
    name = name[:i] if i > 0 else name
    return name[:width]
