"""Least bytes of one launch of the hand-written kernels on the cells'
solve paths (kernel D): every input read once, every output written once,
from the launch's dtype and shapes.  The roofline metrics divide them by
the device's memory bandwidth and the kernels' traced time.

Peaks of one NVIDIA H100 SXM (data sheet): HBM3 at 3.35 TB/s.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12


def stencil(taps: int, out_nodes: int, in_nodes: int, m: int,
            itemsize: int, table: int = 0) -> int:
    """Kernel D (csrc/stencil.cu): the per-node coefficients (taps on the
    output grid) and x (m on the input grid) read, y (m on the output
    grid) written; `table` bytes of a prolong's class table."""
    return itemsize * (taps * out_nodes + m * in_nodes + m * out_nodes) \
        + table
