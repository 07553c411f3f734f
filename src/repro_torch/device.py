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
