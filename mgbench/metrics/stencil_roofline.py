"""stencil_roofline: kernel D's base form (csrc/stencil.cu: the grid
applies of the variable-coefficient levels, in float32 and float64, any
number of right-hand sides) against its least bytes at 3.35 TB/s, over
the traced window."""
from mgbench import roofline


def read(record: dict):
    return roofline.share(record, "stencil")
