"""The RG-LRU scan: a CUDA kernel for Hopper, its wrapper and its launch
counter.

`rg_lru` computes h_t = a_t * h_{t-1} + b_t along time for [B, T, D]
inputs (float32 or bfloat16), with an optional [B, D] initial state.  On
CUDA tensors it launches ``csrc/rg_lru.cu``, which replaces the Pallas TPU
kernel ``repro/kernels/rg_lru.py::_rg_lru_kernel``: a streamed scan in
which one warp walks one unit (`units`: 64 bytes of adjacent channels of
one batch row) over all of T, its a and b tiles arriving through a ring of
shared-memory stages.  The kernel has two specializations: 16-byte
``cp.async`` copies where every row of a and b is 16-byte aligned, plain
loads into the same ring otherwise.  The C entry picks one by its
``rg_lru_route``; `route` is the same rule in Python, which the wrapper
holds to the C one at every launch.  On CPU tensors it runs the plain
version `ref.ref_rg_lru`, which the kernel equals bit for bit.

The wrapper is a ``torch.autograd.Function`` (`RGLRU`).  The gradient of
h_t = a_t h_{t-1} + b_t is itself a linear scan, backwards in time:

    gh_t = a_{t+1} gh_{t+1} + g_t,   db_t = gh_t,
    da_t = gh_t h_{t-1} (h_{-1} = h0, or 0),   dh0 = a_0 gh_0,

so the backward runs the same scan (the kernel on the card, the plain
version on the CPU) on time-reversed operands: a shifted by one step and
flipped, g flipped.  Each sum has two terms and every product one
rounding, so the result equals autograd through the sequential plain loop
bit for bit.  The reference's ``custom_vjp`` recomputes through its
associative scan instead (``repro/kernels/ops.py::_rg_lru_vjp_bwd``); on
the card that recompute would be the host-bound loop.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ref_rg_lru

Tensor = torch.Tensor

# Launches of the CUDA kernel, both specializations (never of the plain
# version), and the same launches by specialization.
LAUNCH_COUNT = 0
ROUTE_LAUNCHES = {"general": 0, "aligned": 0}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/rg_lru.cu's UNIT_BYTES: the row width of one work unit
UNIT_BYTES = 64
ROUTES = {"general": 0, "aligned": 1}


def _bind(lib: ctypes.CDLL) -> None:
    lib.rg_lru_launch.restype = ctypes.c_int
    lib.rg_lru_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_void_p]
    lib.rg_lru_route.restype = ctypes.c_int
    lib.rg_lru_route.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_longlong]
    lib.rg_lru_attributes.restype = ctypes.c_int
    lib.rg_lru_attributes.argtypes = [
        ctypes.c_int, ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 4


LIBRARY = build.KernelLibrary("rg_lru", _bind)


def units(bsz: int, d: int, dtype: torch.dtype
          ) -> list[tuple[int, int, int]]:
    """The kernel's work units in launch order, one CTA (one warp) each:
    (batch row, first channel, end channel).  A unit is UNIT_BYTES of
    adjacent channels of one row; the last of a row is cut at D."""
    c = UNIT_BYTES // dtype.itemsize
    return [(bi, c0, min(c0 + c, d)) for bi in range(bsz)
            for c0 in range(0, d, c)]


def route(shape, dtype: torch.dtype, pointers) -> str:
    """The kernel's specialization for operands of ``shape`` [B, T, D] and
    ``dtype`` with a and b at the data pointers ``pointers``: "aligned"
    (16-byte ``cp.async``) when every row of a and b starts on a 16-byte
    boundary, i.e. D * element size and both pointers are multiples of 16,
    else "general" (plain loads).  The C entry's ``rg_lru_route`` is the
    same rule."""
    row_bytes = shape[-1] * dtype.itemsize
    if row_bytes % 16 == 0 and all(p % 16 == 0 for p in pointers):
        return "aligned"
    return "general"


def kernel_attributes(dtype: torch.dtype, which: str) -> dict:
    """One specialization's registers per thread, local memory per thread
    (spills), static and dynamic shared memory per CTA, as
    ``cudaFuncGetAttributes`` reports them; builds the kernel first if
    needed."""
    lib = LIBRARY.load()
    vals = [ctypes.c_int() for _ in range(4)]
    rc = lib.rg_lru_attributes(DTYPES[dtype], ROUTES[which],
                               *(ctypes.byref(v) for v in vals))
    build.check_launch("rg_lru_attributes", rc)
    return dict(zip(("registers", "local_bytes", "static_smem_bytes",
                     "dynamic_smem_bytes"), (v.value for v in vals)))


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


def _scan(a: Tensor, b: Tensor, h0: Optional[Tensor]) -> Tensor:
    """The kernel on CUDA tensors (counted), the plain version on CPU ones;
    the operands are checked."""
    global LAUNCH_COUNT
    bsz, t_len, d = a.shape
    if a.device.type == "cpu":
        return ref_rg_lru(a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"rg_lru: no kernel for device {a.device}")

    lib = LIBRARY.load()
    which = route(a.shape, a.dtype, (a.data_ptr(), b.data_ptr()))
    taken = lib.rg_lru_route(DTYPES[a.dtype], a.data_ptr(), b.data_ptr(), d)
    if taken != ROUTES[which]:
        raise RuntimeError(f"rg_lru: the C entry takes route {taken}, "
                           f"rg_lru.route says {which!r}")
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.rg_lru_launch(DTYPES[a.dtype], a.data_ptr(), b.data_ptr(),
                               None if h0 is None else h0.data_ptr(),
                               out.data_ptr(), bsz, t_len, d, stream)
    build.check_launch("rg_lru", rc)
    LAUNCH_COUNT += 1
    ROUTE_LAUNCHES[which] += 1
    return out


def reverse_scan(a: Tensor, g: Tensor) -> Tensor:
    """gh_t = a_{t+1} gh_{t+1} + g_t (gh_{T-1} = g_{T-1}): one `_scan` of
    the operands reversed in time, a shifted by one step (its first row 0,
    which multiplies the zero initial state)."""
    a_rev = torch.cat([torch.zeros_like(a[:, :1]), a[:, 1:].flip(1)], dim=1)
    return _scan(a_rev, g.flip(1), None).flip(1)


class RGLRU(torch.autograd.Function):
    """Forward: `_scan`.  Backward: `reverse_scan`, then one multiply for
    da and one for dh0 (see the module's docstring)."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h = _scan(a, b, h0)
        ctx.save_for_backward(a, h0, h)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h0, h = ctx.saved_tensors
        gh = reverse_scan(a, g.contiguous())
        da = dh0 = None
        if ctx.needs_input_grad[0]:
            first = torch.zeros_like(h[:, :1]) if h0 is None else h0[:, None]
            da = gh * torch.cat([first, h[:, :-1]], dim=1)
        if h0 is not None and ctx.needs_input_grad[2]:
            dh0 = gh[:, 0] * a[:, 0]
        return da, gh, dh0


def rg_lru(a: Tensor, b: Tensor, h0: Optional[Tensor] = None) -> Tensor:
    """The scan: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors.  a, b: [B, T, D]; h0: [B, D] or None; one dtype, float32
    or bfloat16, all contiguous on one device.  Raises on anything else.
    On the card it allocates the output, launches on the current stream
    without synchronizing, raises if the launch was refused, and counts the
    launch in `LAUNCH_COUNT` and, under the specialization the C entry
    took, in `ROUTE_LAUNCHES`.  Differentiable (`RGLRU`): the backward is
    one more scan, launched and counted the same way."""
    if not isinstance(a, Tensor) or a.ndim != 3:
        raise ValueError("rg_lru: 'a' must be a [B, T, D] tensor")
    if a.dtype not in DTYPES:
        raise TypeError(f"rg_lru: dtype {a.dtype} is not float32 or "
                        f"bfloat16")
    bsz, _, d = a.shape
    _check("a", a, a.shape, a.dtype, a.device)
    _check("b", b, a.shape, a.dtype, a.device)
    if h0 is not None:
        _check("h0", h0, (bsz, d), a.dtype, a.device)
    return RGLRU.apply(a, b, h0)
