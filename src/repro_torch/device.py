"""Where the port runs.

Every entry point takes ``device=None``, which means the CUDA card.  A
caller who wants the CPU (the tests do) passes ``device="cpu"``.  If CUDA
is asked for and there is none, `resolve` raises: the port never carries
on on the CPU behind the caller's back.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """The torch device for ``device`` (None means ``cuda``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: CUDA was asked for (device=None means the card) "
            "but torch.cuda.is_available() is False; pass device='cpu' to "
            "run the plain PyTorch path on the CPU")
    return dev


def needs_grad(*tensors) -> bool:
    """Whether autograd would record an op on any of ``tensors`` (None
    entries are skipped): grad mode is on and one of them requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def use_kernels(use_kernel, *operands) -> bool:
    """Whether a model call runs the kernels on ``operands`` (the tensors it
    would hand them): ``use_kernel`` itself when it is given, else (None)
    the kernels when every operand is on a CUDA device, whether or not
    autograd records (each kernel's wrapper is a ``torch.autograd.Function``
    with its backward pass), the plain path otherwise."""
    if use_kernel is not None:
        return bool(use_kernel)
    return all(t.device.type == "cuda" for t in operands)
