"""Learning-rate schedules (the port of ``repro/optim/schedule.py``)."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, warmup: int = 100, total: int = 10_000,
                    min_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_frac``: an lr *scale*, a
    float32 0-d tensor computed in float32 as the reference computes it,
    on the step's device (``step``: a tensor, or an int for the CPU)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup, warm, cos)
