"""AdamW with configurable state dtypes (the port of
``repro/optim/adamw.py``).

``state_dtype="bfloat16"`` halves the optimizer-state footprint.  All the
arithmetic runs in float32 whatever the state dtype, in the reference's
order of operations, one rounding per operation.  The update works in
place, leaf by leaf: the new moments go into the state's tensors, the new
parameters into the parameters' own storage, and the gradient tensors are
used as scratch (the caller hands them over and must not read them after).
A float32 leaf needs one temporary the size of the leaf; the reference's
pure version would hold several (recurrentgemma-2b's 2.6 GB embedding).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

Tensor = torch.Tensor

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"       # "bfloat16" halves m/v memory


class AdamWState(NamedTuple):
    step: Tensor                       # int32, 0-d
    m: dict                            # name -> first moment
    v: dict                            # name -> second moment


def adamw_init(cfg: AdamWConfig, params: dict) -> AdamWState:
    """Zero moments in the state dtype, on each parameter's device."""
    dt = _DTYPES[cfg.state_dtype]
    first = next(iter(params.values()))
    z = {name: torch.zeros(p.shape, dtype=dt, device=p.device)
         for name, p in params.items()}
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        m=z, v={name: torch.zeros_like(t) for name, t in z.items()})


def global_norm(tree: dict) -> Tensor:
    """sqrt of the sum over leaves, in the dict's order, of each leaf's sum
    of squares in float32."""
    total = None
    for x in tree.values():
        s = torch.sum(torch.square(x.to(torch.float32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, state: AdamWState, params: dict,
                 grads: dict, lr_scale=1.0) -> tuple[dict, AdamWState, dict]:
    """One AdamW step with global-norm clipping.  ``params`` and ``grads``
    are dicts by name with the same keys as the state's moments.  Returns
    (params, state, {"grad_norm": ...}): the same parameter tensors and
    state tensors, updated in place, and a new step count."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=step.device),
                          step.to(torch.float32))
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=step.device),
                          step.to(torch.float32))
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                  device=step.device)

    for name, p in params.items():
        g = grads[name]
        m, v = state.m[name], state.v[name]
        # .to returns a float32 tensor itself (updated in place), and a
        # float32 copy of any other
        g32 = g.to(torch.float32)
        g32.mul_(scale)                                 # g * scale
        m32, v32 = m.to(torch.float32), v.to(torch.float32)
        tmp = torch.mul(g32, 1 - cfg.b1)                # (1 - b1) * g
        m32.mul_(cfg.b1).add_(tmp)                      # b1 * m + ...
        torch.mul(g32, 1 - cfg.b2, out=tmp).mul_(g32)   # (1 - b2) * g * g
        v32.mul_(cfg.b2).add_(tmp)                      # b2 * v + ...
        torch.div(v32, b2c, out=tmp).sqrt_().add_(cfg.eps)  # sqrt(vhat) + eps
        mhat = torch.div(m32, b1c, out=g32)             # m / b1c (g32 done)
        mhat.div_(tmp)
        p32 = p.to(torch.float32)
        mhat.add_(torch.mul(p32, cfg.weight_decay, out=tmp))  # delta
        p32.sub_(mhat.mul_(lr))                         # p - lr * delta
        for dst, src in ((p, p32), (m, m32), (v, v32)):
            if dst is not src:
                dst.copy_(src)                          # round to its dtype
    return params, AdamWState(step=step, m=state.m, v=state.v), \
        {"grad_norm": gnorm}
