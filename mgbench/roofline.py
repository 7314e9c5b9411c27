"""A kernel's share of its memory roofline over the traced window: its
launches' least bytes (counted by kernels/<kernel>.py, mgbench/bytes.py)
at the HBM bandwidth, over the time the trace gives its kernels.  Nothing
is estimated: where the benchmark's byte counts do not cover every launch
the program counted, or the trace does not show every launch, there is no
reading."""
from __future__ import annotations

from . import counters, spec, trace
from .bytes import HBM_BYTES_PER_S


def share(record: dict, kernel: str):
    """Percent of the roofline of kernels/<kernel>.py's kernel, or None."""
    t = record.get("traced")
    if not t:
        return None
    nbytes, calls = counters.own_counts(t["counters"], kernel)
    ours, program, seen = counters.agree(t, kernel)
    if calls == 0 or not ours == program == seen:
        return None
    us, _ = trace.kernel_us(t, spec.code("kernels", kernel).TRACE)
    if us <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / (us * 1e-6)
