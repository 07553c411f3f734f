"""Flash attention: a CUDA kernel for Hopper (the forward), its wrapper
(a ``torch.autograd.Function``) and its launch counter.

`flash_attention` computes softmax(q k^T * D^-1/2) v with grouped KV heads,
causal and sliding-window masks and an optional tanh logit softcap, with
float32 accumulation for float32 or bfloat16 inputs.  On CUDA tensors it
launches ``csrc/flash_attention.cu``, which replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::_flash_kernel``: one 8-warp CTA per
(batch, head, 64-query tile), each warp owning 16 query rows and half of
the head dim, an online softmax over 32-key tiles that ``cp.async``
streams through a two-stage ring in shared memory, and both products on
the tensor cores (``mma.sync``): split TF32 (three TF32 products per f32
product) for float32 inputs, bf16 MMA for bfloat16 ones.
The kernel is built with its own nvcc flags (`NVCC_FLAGS`: no
``--fmad=false``, since it is held by tolerance, not bit for bit).  On CPU
tensors it runs the dense plain version `ref.ref_attention`, which the
kernel matches within 2e-5 in float32 and 2e-2 for bf16 inputs.

On ``meta`` tensors (a dry run, `repro_torch.launch.dryrun`) the wrapper
computes nothing: it returns an empty output of the kernel's shape and
dtype, counts the launch it plans in `PLANNED_LAUNCHES` (never in
`LAUNCH_COUNT`) and adds the kernel's `cost` to `PLANNED_FLOP` and
`PLANNED_BYTES`.  A CUDA tensor never takes that branch.

The backward pass is the reference's ``custom_vjp``
(``repro/kernels/ops.py::_flash_vjp_bwd``): the vector-Jacobian product of
the dense attention, recomputed with ``torch.autograd.grad`` through
`ref.ref_attention` from the saved q, k and v.  The JAX package has no
backward kernel, so neither has the port; the forward stays on the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ref_attention

Tensor = torch.Tensor

# Launches of the CUDA kernel (never of the plain version).
LAUNCH_COUNT = 0
# Launches a dry run on meta tensors planned, and their `cost`
PLANNED_LAUNCHES = 0
PLANNED_FLOP = 0
PLANNED_BYTES = 0
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 192, 256)     # the kernel's instantiations
# build.NVCC_FLAGS without the two that fix the rounding: the kernel is
# held to its plain version by tolerance, so nvcc may contract a*b+c
NVCC_FLAGS = tuple(f for f in build.NVCC_FLAGS
                   if f not in ("--fmad=false", "-prec-div=true"))


def _bind_launch(lib: ctypes.CDLL) -> None:
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_launch.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p]


def _bind(lib: ctypes.CDLL) -> None:
    _bind_launch(lib)
    lib.flash_attention_attributes.restype = ctypes.c_int
    lib.flash_attention_attributes.argtypes = [
        ctypes.c_int, ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3


LIBRARY = build.KernelLibrary("flash_attention", _bind, flags=NVCC_FLAGS)


def _causal_prefix(t: int, s: int, c: int) -> int:
    """(q, k) pairs with 0 <= q < t, 0 <= k < s and k <= q + c: the sum
    over q of clamp(q + c + 1, 0, s), in closed form."""
    lo = min(max(-c, 0), t)             # first q with a key at all
    hi = min(max(s - c - 1, 0), t)      # first q that sees all s keys
    ramp = (hi - lo) * (lo + hi - 1) // 2 + (hi - lo) * (c + 1)
    return ramp + (t - hi) * s


def attention_pairs(t: int, s: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks leave, per (batch, head): key k is
    seen by query q when k <= q (causal) and k > q - window (window > 0),
    positions counted from 0 on both sides, as the kernel masks them."""
    upper = _causal_prefix(t, s, 0) if causal else t * s
    if window > 0:
        upper -= _causal_prefix(t, s, -window)
    return upper


def cost(b: int, t: int, s: int, h: int, kv: int, dh: int, causal: bool,
         window: int, dtype: torch.dtype) -> tuple[int, int]:
    """(FLOP, bytes) of one launch: q.k and p.v are 2 * D FLOP each per
    unmasked pair (`attention_pairs`); q, k and v read once and the
    output written once."""
    flop = 4 * dh * b * h * attention_pairs(t, s, causal, window)
    nbytes = dtype.itemsize * (2 * b * t * h * dh + 2 * b * s * kv * dh)
    return flop, nbytes


def _check(q: Tensor, k: Tensor, v: Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, Tensor) or t.ndim != 4:
            raise ValueError(f"flash_attention: {name!r} must be a 4-D "
                             f"tensor")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name!r} is on {t.device}, "
                             f"expected {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name!r} has dtype {t.dtype},"
                            f" expected {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name!r} is not contiguous")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype} is not float32 "
                        f"or bfloat16")
    b, _, h, dh = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit "
                         f"[B,T,H,D] / [B,S,K,D]")
    if k.shape[2] == 0 or h % k.shape[2] != 0:
        raise ValueError(f"flash_attention: {h} query heads are not a "
                         f"multiple of {k.shape[2]} KV heads")


def kernel_attributes(dtype: torch.dtype, head_dim: int) -> dict:
    """The compiled instantiation's registers per thread, local memory per
    thread (spills), and shared memory per CTA (static plus the dynamic size
    a launch is allowed, after the launch's own opt-in), as
    ``cudaFuncGetAttributes`` reports them; builds the kernel first if
    needed."""
    lib = LIBRARY.load()
    regs, local, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.flash_attention_attributes(DTYPES[dtype], head_dim,
                                        ctypes.byref(regs),
                                        ctypes.byref(local),
                                        ctypes.byref(smem))
    build.check_launch("flash_attention_attributes", rc)
    return dict(registers=regs.value, local_bytes=local.value,
                smem_bytes=smem.value)


def _launch(q: Tensor, k: Tensor, v: Tensor, causal: bool, window: int,
            softcap: Optional[float]) -> Tensor:
    """The kernel on CUDA tensors (counted), the plain version on CPU ones,
    the planned launch on meta ones."""
    global LAUNCH_COUNT, PLANNED_LAUNCHES, PLANNED_FLOP, PLANNED_BYTES
    if q.device.type == "cpu":
        return ref_attention(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    b, t, h, dh = q.shape
    s, kh = k.shape[1], k.shape[2]
    if q.device.type == "meta":
        flop, nbytes = cost(b, t, s, h, kh, dh, causal, window or 0,
                            q.dtype)
        PLANNED_LAUNCHES += 1
        PLANNED_FLOP += flop
        PLANNED_BYTES += nbytes
        return torch.empty_like(q)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {dh} is not one of "
                         f"{HEAD_DIMS}")

    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name!r} is not 16-byte "
                             f"aligned (the kernel copies 16-byte chunks)")

    lib = LIBRARY.load()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_launch(
            DTYPES[q.dtype], dh, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, t, s, h, kh, 1.0 / (dh ** 0.5), int(causal),
            int(window or 0), int(softcap is not None),
            float(softcap or 0.0), stream)
    build.check_launch("flash_attention", rc)
    LAUNCH_COUNT += 1
    return out


class FlashAttention(torch.autograd.Function):
    """Forward: `_launch`.  Backward: the VJP of `ref.ref_attention` at the
    saved inputs, as the reference's ``custom_vjp`` computes it."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        ctx.save_for_backward(q, k, v)
        ctx.options = (causal, window, softcap)
        return _launch(q, k, v, causal, window, softcap)

    @staticmethod
    def backward(ctx, g):
        causal, window, softcap = ctx.options
        wanted = [x.detach().requires_grad_(True) if need else x.detach()
                  for x, need in zip(ctx.saved_tensors,
                                     ctx.needs_input_grad[:3])]
        with torch.enable_grad():
            out = ref_attention(*wanted, causal=causal, window=window,
                                softcap=softcap)
            leaves = [x for x in wanted if x.requires_grad]
            grads = iter(torch.autograd.grad(out, leaves, g))
        return tuple(next(grads) if x.requires_grad else None
                     for x in wanted) + (None, None, None)


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: int = 0, softcap: Optional[float] = None
                    ) -> Tensor:
    """q: [B, T, H, D]; k/v: [B, S, K, D] -> [B, T, H, D] in q's dtype.

    The CUDA kernel for CUDA tensors (D one of `HEAD_DIMS`), the plain
    version for CPU tensors, a planned launch (an empty output) for meta
    tensors; raises on anything the kernel does not take.
    On the card it allocates the output, launches on the current stream
    without synchronizing, raises if the launch was refused, and counts the
    launch in `LAUNCH_COUNT`.  Differentiable (`FlashAttention`): the
    backward recomputes the dense attention's VJP and launches nothing."""
    _check(q, k, v)
    return FlashAttention.apply(q, k, v, causal, window, softcap)
