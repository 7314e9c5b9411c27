"""launches_per_solve: the hand-written kernels' launches over the window,
from the program's launch counters (a CUDA graph's replay adds back what
its recording counted), per solve call."""
from mgbench import counters


def read(record: dict):
    if not record["calls"]:
        return None
    return counters.launches(record["counters"]) / record["calls"]
