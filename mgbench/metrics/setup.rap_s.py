"""setup.rap_s: host seconds of the program's span "setup.rap" over the
run: the host Galerkin products: the structured stencil RAP and its
scipy form, or scipy's triple product. The program sums them itself
(mgtpu_torch.spans.SECONDS)."""
from mgbench import program


def read(record: dict):
    return program.seconds(record, "setup.rap")
