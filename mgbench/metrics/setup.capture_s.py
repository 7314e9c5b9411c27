"""setup.capture_s: host seconds of the program's span "program.record"
over the run: the recordings of the CUDA graphs (each program's warm-up
run and capture, cycle/capture.py), made by the warm-up calls. The
program sums them itself (mgtpu_torch.spans.SECONDS)."""
from mgbench import program


def read(record: dict):
    return program.seconds(record, "program.record")
