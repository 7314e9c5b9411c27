"""setup.grid_convert_s: host seconds of the program's span
"setup.grid_convert" over the run: every CSR to grid-stencil conversion
of the program: mg_setup's of the fine operator, the grid engine's of a
level not coarsened by the structured RAP, and the solve drivers' of the
original fine operator in float64 at the first (warm-up) call. The
program sums them itself (mgtpu_torch.spans.SECONDS)."""
from mgbench import program


def read(record: dict):
    return program.seconds(record, "setup.grid_convert")
