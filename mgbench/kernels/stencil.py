"""Kernel D's base form (csrc/stencil.cu, entry `ops.cuda.stencil._launch`):
the grid applies of the variable-coefficient levels, any type and number
of right-hand sides.  Its halo and block forms are other entry points and
other kernels."""
from __future__ import annotations

import functools

from mgbench import bytes as nbytes

MODULE = "stencil"                    # the program's wrapper module
TRACE = r"\bstencil_kernel\b"         # its device kernel in a trace


def launches(d: dict) -> int:
    """The program's own count of these launches in a counters delta."""
    n = sum(v for k, v in d.items()
            if k.startswith("stencil.launches.") and ".mgbench." not in k)
    return n - sum(v for k, v in d.items()
                   if k.startswith(("stencil.halo.", "stencil.block.")))


def _in_nodes(coeff, in_space) -> int:
    space = tuple(coeff.shape[1:]) if in_space is None else tuple(in_space)
    n = 1
    for v in space:
        n *= int(v)
    return n


def install(add) -> None:
    """Wrap the entry point so that each launch also calls add(bytes)."""
    from mgtpu_torch.ops.cuda import stencil as st
    inner = st._launch

    @functools.wraps(inner)
    def launch(coeff, box, taps, x, form="apply", in_box=None,
               in_space=None, ptab=None, plan=None):
        y = inner(coeff, box, taps, x, form=form, in_box=in_box,
                  in_space=in_space, ptab=ptab, plan=plan)
        in_nodes = _in_nodes(coeff, in_space)
        m = x.numel() // in_nodes
        add(nbytes.stencil(coeff.shape[0], y.numel() // m, in_nodes, m,
                           x.element_size(),
                           0 if ptab is None
                           else ptab.numel() * ptab.element_size()))
        return y

    st._launch = launch
