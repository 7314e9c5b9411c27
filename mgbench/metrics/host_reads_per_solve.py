"""host_reads_per_solve: the program's blocking device-to-host reads (spans
"host_read": a recorded chunk's stop flag, the count and residuals read
at the end) per solve call, over the traced window's calls."""
from mgbench import program


def read(record: dict):
    return program.per_call(record, {"host_read"})
