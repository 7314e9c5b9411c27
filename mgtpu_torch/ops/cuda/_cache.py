"""Tables derived from tensors: which tensors, and a cache of them.

Kernels E and F read setup-time records with the tables' values baked in.
`Source` remembers which values a record was baked from, so that a wrapper
given the record beside other values refuses it.  A kernel wrapper called
without its record (kernel E's cells, kernel F's plan and records) builds
it from the tensors it was given and keeps it in a `PerTensor`, keyed by
the identity of one of them; the entry goes when that tensor does.  (A
WeakKeyDictionary cannot hold tensors: it compares keys with ==, which a
tensor answers elementwise.)
"""
from __future__ import annotations

import weakref


def _where(t) -> tuple:
    return (t.data_ptr(), t.dtype, tuple(t.shape), t.stride(), t.device)


class Source:
    """The values of a tensor, remembered without keeping it: a weak
    reference to the tensor that owns their memory (a view's base) and
    where in it they lie.  `holds(t)` while that tensor lives and t reads
    the same memory in the same type and layout (the memory cannot have
    been reused meanwhile); values written into it in place are not
    seen."""

    def __init__(self, t):
        self._ref = weakref.ref(t if t._base is None else t._base)
        self._where = _where(t)

    def holds(self, t) -> bool:
        return self._ref() is not None and _where(t) == self._where


class PerTensor:
    """{tensor identity: value}, each entry dropped with its tensor."""

    def __init__(self):
        self._d: dict = {}

    def get(self, t, build, valid=None):
        """The value kept for `t` (where `valid` of it holds), else
        `build()` kept for it."""
        key = id(t)
        hit = self._d.get(key)
        if (hit is not None and hit[0]() is t
                and (valid is None or valid(hit[1]))):
            return hit[1]
        value = build()
        self._d[key] = (weakref.ref(t, lambda _, k=key: self._d.pop(k, None)),
                        value)
        return value
