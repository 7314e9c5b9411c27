"""cycle.device_ms: milliseconds of the traced window in which the device
ran an operation, per iteration the traced solves counted (one cycle an
iteration: a refinement step's V-cycle, a CG step's preconditioner)."""
from mgbench import trace


def read(record: dict):
    t = record.get("traced")
    if not t or not sum(t["iters"]):
        return None
    busy = trace.busy_us(t)
    return busy / sum(t["iters"]) / 1e3 if busy > 0 else None
