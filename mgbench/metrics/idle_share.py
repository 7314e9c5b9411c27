"""idle_share: percent of the traced window in which no device operation
ran (the complement of the union of kernel, copy and memset intervals)."""
from mgbench import trace


def read(record: dict):
    t = record.get("traced")
    if not t:
        return None
    lo, hi = trace.window(t)
    return 100.0 * (1.0 - trace.busy_us(t) / (hi - lo))
