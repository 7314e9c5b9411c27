"""idle.prepare_share: percent of the traced window in which the device was
idle inside the benchmark's solve span with the program under the solve
driver's preparation of its operands before its first recorded program
(span driver.prepare: _krylov_setup; the refined solve's casts, fine
operator and fields)."""
from mgbench import program


def read(record: dict):
    return program.idle_share(record, "prepare")
