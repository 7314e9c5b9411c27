"""idle.finish_share: percent of the traced window in which the device was
idle inside the benchmark's solve span with the program under
driver.finish: after the last recorded program (the count and residual
reads, the clones, the map back to flat)."""
from mgbench import program


def read(record: dict):
    return program.idle_share(record, "finish")
