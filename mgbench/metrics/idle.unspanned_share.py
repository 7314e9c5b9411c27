"""idle.unspanned_share: percent of the traced window in which the device
was idle inside the benchmark's solve span with no span of the program
open: the benchmark's solve call outside the driver (its own read of the
returned residual)."""
from mgbench import program


def read(record: dict):
    return program.idle_share(record, "unspanned")
