"""The RG-LRU scan: a CUDA kernel for Hopper, its wrapper and its launch
counter.

`rg_lru` computes h_t = a_t * h_{t-1} + b_t along time for [B, T, D]
inputs (float32 or bfloat16), with an optional [B, D] initial state.  On
CUDA tensors it launches ``csrc/rg_lru.cu`` (one thread per (b, d)
channel walking T; it replaces the Pallas TPU kernel
``repro/kernels/rg_lru.py::_rg_lru_kernel``); on CPU tensors it runs the
plain version `ref.ref_rg_lru`, which the kernel equals bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ref_rg_lru

Tensor = torch.Tensor

# Launches of the CUDA kernel (never of the plain version).
LAUNCH_COUNT = 0
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    lib.rg_lru_launch.restype = ctypes.c_int
    lib.rg_lru_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_void_p]


LIBRARY = build.KernelLibrary("rg_lru", _bind)


def _check(name: str, t: Tensor, shape, dtype, device) -> None:
    if not isinstance(t, Tensor):
        raise TypeError(f"rg_lru: {name!r} is not a tensor")
    if t.device != device:
        raise ValueError(f"rg_lru: {name!r} is on {t.device}, expected "
                         f"{device}")
    if t.dtype != dtype:
        raise TypeError(f"rg_lru: {name!r} has dtype {t.dtype}, expected "
                        f"{dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"rg_lru: {name!r} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"rg_lru: {name!r} is not contiguous")


def rg_lru(a: Tensor, b: Tensor, h0: Optional[Tensor] = None) -> Tensor:
    """The scan: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors.  a, b: [B, T, D]; h0: [B, D] or None; one dtype, float32
    or bfloat16, all contiguous on one device.  Raises on anything else.
    On the card it allocates the output, launches on the current stream
    without synchronizing, raises if the launch was refused, and counts
    the launch in `LAUNCH_COUNT`."""
    global LAUNCH_COUNT
    if not isinstance(a, Tensor) or a.ndim != 3:
        raise ValueError("rg_lru: 'a' must be a [B, T, D] tensor")
    if a.dtype not in DTYPES:
        raise TypeError(f"rg_lru: dtype {a.dtype} is not float32 or "
                        f"bfloat16")
    bsz, t_len, d = a.shape
    _check("a", a, a.shape, a.dtype, a.device)
    _check("b", b, a.shape, a.dtype, a.device)
    if h0 is not None:
        _check("h0", h0, (bsz, d), a.dtype, a.device)
    if a.device.type == "cpu":
        return ref_rg_lru(a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"rg_lru: no kernel for device {a.device}")

    lib = LIBRARY.load()
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.rg_lru_launch(DTYPES[a.dtype], a.data_ptr(), b.data_ptr(),
                               None if h0 is None else h0.data_ptr(),
                               out.data_ptr(), bsz, t_len, d, stream)
    build.check_launch("rg_lru", rc)
    LAUNCH_COUNT += 1
    return out
