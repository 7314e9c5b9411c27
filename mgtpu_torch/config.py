"""Dtype helpers and the device rule of the PyTorch port.

Counterpart of mgtpu/config.py.  The port keeps the reference's value types
on the host (numpy dtypes in ``MGConfig``) and maps them to torch dtypes at
the device boundary.

Device rule: entry points take ``device=`` and default to ``"cuda"``.  A
CUDA device that is not present raises; nothing carries on silently on the
CPU.  Callers (the CPU tests) ask for the CPU by passing ``device="cpu"``.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"

_TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.complex128): torch.complex128,
}


def real_dtype(dtype) -> np.dtype:
    return np.zeros((), dtype=dtype).real.dtype


def is_complex(dtype) -> bool:
    return np.issubdtype(np.dtype(dtype), np.complexfloating)


def double_variant(dtype) -> np.dtype:
    """The double-precision type of a value type: float64, or complex128
    for a complex one (the refined solve's default outer type, mgtpu's
    solve_mg_refined; the host factorizations' type)."""
    return np.dtype(np.complex128 if is_complex(dtype) else np.float64)


def single_variant(dtype) -> np.dtype:
    """Single-precision companion of a dtype: Vanka block inverses are
    stored in single precision (the reference's `toSingle`,
    Vanka.jl:34-42)."""
    d = np.dtype(dtype)
    if d == np.float64:
        return np.dtype(np.float32)
    if d == np.complex128:
        return np.dtype(np.complex64)
    return d


def torch_dtype(dtype) -> torch.dtype:
    """numpy dtype (or type) -> torch dtype; torch dtypes pass through."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH_DTYPES[np.dtype(dtype)]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller says
    otherwise.  Raises when a CUDA device is asked for and none is present."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@contextlib.contextmanager
def full_fp32():
    """Float32 matrix products in full float32 inside the block, whatever
    the caller set: the coarsest solves (a dense inverse or LU applied to a
    residual) lose the digits the refined solves need in TF32, which keeps
    about three.  The caller's matmul precision ("high", "medium", ...) is
    restored on exit.  The setting is process-wide, so matmuls that other
    threads run inside the block also run in full float32."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)
