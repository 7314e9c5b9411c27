"""idle.chunk_share: percent of the traced window in which the device was
idle inside the benchmark's solve span with the program under a solve
driver's span but neither driver.prepare nor driver.finish: the
boundaries of the recorded chunks (program.load, program.replay, the
host read of the stop flag, the driver's own code between them)."""
from mgbench import program


def read(record: dict):
    return program.idle_share(record, "chunk")
