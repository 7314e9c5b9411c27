"""The program's own spans (mgtpu_torch/spans.py), as the per-layer
readers of metrics/ take them.

The program keeps a record of each span while torch.profiler records (the
traced window's calls), and sums the host seconds of its set-up stages and
recordings always (`spans.SECONDS`).  `collect(record)` reads them as
they stand, without draining them: every reader sees the same, in
whatever order they run.  A record that carries record["program"] (the
tests' fixtures) is read from there instead.  A program without
mgtpu_torch.spans gives None, and the readers then read nothing.

The records are on the host's perf_counter clock, the trace on the
profiler's.  `window_calls` pairs the traced window's `solve` spans with
the program's calls, one outermost ``driver.*`` span each, and moves
those calls' records onto the trace's clock: by the one offset under
which every driver span starts inside its solve span, the tightest at its
start.  `idle_by_program` then puts each idle stretch of the device inside
a `solve` span down to the driver's step open over it.
"""
from __future__ import annotations

from . import trace

DRIVER = "driver."
TOL_US = 50.0           # a driver span may end this far past its solve span


def collect(record: dict) -> dict | None:
    """{"records": [(name, start_ns, end_ns, parent, call), ...],
    "seconds": {span: s}, "counts": {"spans_dropped": n}}: the program's,
    read and left in place, or record["program"] where the record carries
    it; None without mgtpu_torch.spans."""
    if "program" in record:
        return record["program"]
    try:
        from mgtpu_torch import spans
    except ImportError:
        return None
    return {"records": spans.records(), "seconds": dict(spans.SECONDS),
            "counts": dict(spans.COUNTS)}


def seconds(record: dict, name: str):
    """Host seconds of the program's span `name` summed over the run
    (set-up and warm-up; a recording inside the window would add its
    own: records_in_window), or None."""
    p = collect(record)
    if p is None:
        return None
    return float(p["seconds"].get(name, 0.0))


def _calls(records) -> list[list]:
    """The program's calls in start order: [start_ns, end_ns, records of
    the call] (the call's first record is its outermost driver span)."""
    by: dict[int, list] = {}
    for r in records:
        if r[4] >= 0:
            by.setdefault(r[4], []).append(r)
    out = []
    for rs in by.values():
        top = rs[0]
        if top[0].startswith(DRIVER) and top[2] >= 0:
            out.append([top[1], top[2], rs])
    return sorted(out, key=lambda c: c[0])


def window_calls(record: dict) -> list[list] | None:
    """The program's records of the traced window's calls, one list a
    `solve` span in order, each record [name, start_us, end_us] on the
    trace's clock; None where the calls cannot be paired."""
    t = record.get("traced")
    p = collect(record)
    if not t or p is None or p["counts"].get("spans_dropped", 0):
        return None
    lo, hi = trace.window(t)
    solves = sorted((ts, ts + d) for n, ts, d in t["spans"]
                    if n == "solve" and lo <= ts < hi)
    calls = _calls(p["records"])
    n = len(solves)
    if n == 0 or len(calls) < n:
        return None
    for i in range(len(calls) - n, -1, -1):      # the latest group first
        group = calls[i:i + n]
        off = max(s * 1e3 - c[0] for (s, _), c in zip(solves, group))
        if all(c[1] + off <= (e + TOL_US) * 1e3
               for (_, e), c in zip(solves, group)):
            return [[[r[0], (r[1] + off) * 1e-3, (r[2] + off) * 1e-3]
                     for r in c[2]] for c in group]
    return None


def per_call(record: dict, names) -> float | None:
    """Records named in `names` in the traced window's calls, per call."""
    calls = window_calls(record)
    if not calls:
        return None
    return sum(1 for c in calls for r in c if r[0] in names) / len(calls)


def _intersect(a, b) -> list[tuple[float, float]]:
    """The intersection of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _length(iv) -> float:
    return sum(e - s for s, e in iv)


def idle_by_program(record: dict) -> dict | None:
    """Microseconds of the traced window's idle device time inside the
    benchmark's `solve` spans, by the program's span open over it:
    prepare (under driver.prepare), finish (under driver.finish), chunk
    (under a driver span but neither: the recorded programs' loads and
    replays, the host reads between them, the driver's own code),
    unspanned (no driver span open); and the window's length."""
    t = record.get("traced")
    calls = window_calls(record)
    if calls is None:
        return None
    lo, hi = trace.window(t)
    busy = trace.merged(((ts, ts + d) for _, ts, d in t["device_ops"]),
                        lo, hi)
    gaps, at = [], lo
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if at < hi:
        gaps.append((at, hi))
    solve = trace.merged(((ts, ts + d) for n, ts, d in t["spans"]
                          if n == "solve"), lo, hi)
    idle = _intersect(gaps, solve)
    drv = trace.merged(((c[0][1], c[0][2]) for c in calls), lo, hi)
    in_drv = _intersect(idle, drv)

    def under(name):
        return _length(_intersect(in_drv, trace.merged(
            ((s, e) for c in calls for n, s, e in c if n == name), lo, hi)))

    prepare, finish = under("driver.prepare"), under("driver.finish")
    return {"prepare": prepare, "finish": finish,
            "chunk": _length(in_drv) - prepare - finish,
            "unspanned": _length(idle) - _length(in_drv),
            "window": hi - lo}


def idle_share(record: dict, part: str) -> float | None:
    """Percent of the traced window that `idle_by_program` puts under
    `part`."""
    d = idle_by_program(record)
    if d is None or d["window"] <= 0:
        return None
    return 100.0 * d[part] / d["window"]
