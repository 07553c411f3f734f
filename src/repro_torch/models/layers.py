"""Shared primitive layers: norms, rotary embeddings, MLPs, inits.

The port of ``repro/models/layers.py``.  Initialisers draw from an explicit
``torch.Generator`` (the reference splits a ``jax.random`` key); on the
``meta`` device they allocate nothing, so a full-size model can be built
to count its parameters.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.launch import layout

Tensor = torch.Tensor


def _device(generator: Optional[torch.Generator], device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if generator is None:
        raise ValueError("an initialiser needs a generator or a device")
    return generator.device


def dense_init(generator: Optional[torch.Generator], shape, in_axis: int = -2,
               device=None) -> Tensor:
    """LeCun-normal init (fan-in) — standard for transformer stacks."""
    dev = _device(generator, device)
    if dev.type == "meta":
        return torch.empty(shape, device=dev)
    fan_in = shape[in_axis]
    return (torch.randn(shape, generator=generator, device=dev)
            / math.sqrt(max(fan_in, 1)))


def embed_init(generator: Optional[torch.Generator], shape,
               device=None) -> Tensor:
    dev = _device(generator, device)
    if dev.type == "meta":
        return torch.empty(shape, device=dev)
    return torch.randn(shape, generator=generator, device=dev) * 0.02


def uniform_init(generator: Optional[torch.Generator], shape, lo: float,
                 hi: float, device=None) -> Tensor:
    dev = _device(generator, device)
    if dev.type == "meta":
        return torch.empty(shape, device=dev)
    return torch.rand(shape, generator=generator, device=dev) * (hi - lo) + lo


def rms_norm(x: Tensor, scale: Optional[Tensor], eps: float = 1e-6) -> Tensor:
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * (1.0 + scale)
    return y.to(x.dtype)


def nonparam_layer_norm(x: Tensor, eps: float = 1e-5) -> Tensor:
    """OLMo's non-parametric LayerNorm: no scale, no bias."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def norm(cfg, x: Tensor, scale: Optional[Tensor]) -> Tensor:
    if cfg.nonparam_norm:
        return nonparam_layer_norm(x, cfg.norm_eps)
    return rms_norm(x, scale, cfg.norm_eps)


def norm_param(cfg, d: int, device) -> Optional[nn.Parameter]:
    """None for non-parametric norms, zeros(d) otherwise (RMS 1+scale)."""
    if cfg.nonparam_norm:
        return None
    return nn.Parameter(torch.zeros((d,), device=device))


def rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """Rotary embedding. x: [..., T, H, D]; positions: [..., T]."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., :, None, None].float() * freqs   # [..., T, 1, half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def softcap(x: Tensor, cap: Optional[float]) -> Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def swiglu(x: Tensor, w_gate: Tensor, w_up: Tensor, w_down: Tensor) -> Tensor:
    # on a mesh, FSDP's weights gathered before use
    w_gate, w_up, w_down = (layout.gathered(w) for w in (w_gate, w_up, w_down))
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


class MLP(nn.Module):
    """SwiGLU feed-forward: ``gate``, ``up`` [d, d_ff] and ``down``
    [d_ff, d], as the reference's ``init_mlp`` lays them out."""

    def __init__(self, d: int, d_ff: int, generator=None, device=None):
        super().__init__()
        self.gate = nn.Parameter(dense_init(generator, (d, d_ff), device=device))
        self.up = nn.Parameter(dense_init(generator, (d, d_ff), device=device))
        self.down = nn.Parameter(dense_init(generator, (d_ff, d),
                                            device=device))

    def forward(self, x: Tensor) -> Tensor:
        return mlp(self, x)


def mlp(params: MLP, x: Tensor) -> Tensor:
    return swiglu(x, params.gate, params.up, params.down)
