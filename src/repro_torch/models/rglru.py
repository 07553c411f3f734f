"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

The port of ``repro/models/rglru.py``.  Recurrence (diagonal, gated):
    r_t = sigmoid(W_a x_t)                    (recurrence gate)
    i_t = sigmoid(W_x x_t)                    (input gate)
    a_t = exp(-c * softplus(L) * r_t)         (c = 8, L learned)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Block: two branches from the residual stream — a gelu-gated linear branch
and (temporal conv(width 4) -> RG-LRU) — multiplied and projected out.

Full-sequence path: `scan_rg_lru`, a log-depth associative scan in torch
(the reference's formulation), or the CUDA scan kernel
(`repro_torch.kernels.ops.rg_lru`, differentiable) where
`device.use_kernels` says so: by default on a CUDA device.  Decode path: a
single fused step.
``jax.nn.gelu`` defaults to the tanh approximation and ``jax.nn.softplus``
has no linear threshold; the port computes both the same way.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.device import use_kernels
from repro_torch.models.layers import dense_init, uniform_init

Tensor = torch.Tensor

_C = 8.0


class RGLRU(nn.Module):
    """``w_lin``, ``w_x`` [d, dr], ``w_out`` [dr, d], ``conv_w`` [W, dr],
    ``conv_b`` [dr], ``w_a``, ``w_i`` [dr, dr], ``lam`` [dr]; dr = d."""

    def __init__(self, cfg, generator=None, device=None):
        super().__init__()
        d = cfg.d_model
        dr = d  # lru width = d_model in RecurrentGemma
        dev = device if device is not None else generator.device

        def dense(shape):
            return nn.Parameter(dense_init(generator, shape, device=dev))

        self.w_lin = dense((d, dr))                 # gelu branch
        self.w_x = dense((d, dr))                   # recurrent branch in
        self.w_out = dense((dr, d))
        self.conv_w = nn.Parameter(dense_init(
            generator, (cfg.conv_width, dr), in_axis=0, device=dev) * 0.1)
        self.conv_b = nn.Parameter(torch.zeros((dr,), device=dev))
        self.w_a = dense((dr, dr))
        self.w_i = dense((dr, dr))
        # softplus(L) in (0.999, 0.001)-ish decay band at init
        self.lam = nn.Parameter(uniform_init(generator, (dr,), 0.2, 0.8,
                                             device=dev))


def init_rglru_block(cfg, generator=None, device=None) -> RGLRU:
    return RGLRU(cfg, generator, device)


def _softplus(x: Tensor) -> Tensor:
    """log(1 + exp(x)) with no linear cut-off (``jax.nn.softplus``)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _gates(params: RGLRU, u: Tensor):
    r = torch.sigmoid(u @ params.w_a)
    i = torch.sigmoid(u @ params.w_i)
    log_a = -_C * _softplus(params.lam) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * u)
    return a, gated


def scan_rg_lru(a: Tensor, b: Tensor, h0: Optional[Tensor] = None) -> Tensor:
    """h_t = a_t * h_{t-1} + b_t along axis 1. a/b: [B, T, D].

    An inclusive associative scan in log2(T) passes (Hillis-Steele) over
    the pairs (a, b) with combine((a1, b1), (a2, b2)) = (a1 a2, a2 b1 + b2),
    the reference's combine.  It rounds otherwise than the sequential
    kernel, so the two agree by tolerance.
    """
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    t = a.shape[1]
    off = 1
    while off < t:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], dim=1)
        off *= 2
    return b


def conv1d_causal(params, x: Tensor, state: Optional[Tensor] = None):
    """Depthwise causal temporal conv. x: [B, T, D]; state: [B, W-1, D].
    ``params``: anything with ``conv_w`` [W, D] and ``conv_b`` [D] (the
    RG-LRU block, the xLSTM blocks)."""
    w = params.conv_w                         # [W, D]
    width = w.shape[0]
    pad = (torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype,
                       device=x.device)
           if state is None else state)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i: i + x.shape[1]] * w[i] for i in range(width))
    new_state = xp[:, -(width - 1):] if width > 1 else pad
    return out + params.conv_b, new_state


def rglru_forward(params: RGLRU, cfg, x: Tensor,
                  use_kernel: Optional[bool] = None,
                  return_state: bool = False):
    """Full-sequence recurrent block. x: [B, T, D].  ``use_kernel``:
    `device.use_kernels` (None: the scan kernel on a CUDA device)."""
    lin = F.gelu(x @ params.w_lin, approximate="tanh")
    u_raw = x @ params.w_x
    u, conv_state = conv1d_causal(params, u_raw)
    a, b = _gates(params, u)
    if use_kernels(use_kernel, a, b):
        from repro_torch.kernels import ops as kernel_ops
        h = kernel_ops.rg_lru(a, b)
    else:
        h = scan_rg_lru(a, b)
    y = (h * lin) @ params.w_out
    if return_state:
        # copies: views would keep the whole [B, T, D] tensors alive
        return y, {"h": h[:, -1].clone(), "conv": conv_state.clone()}
    return y


def init_rglru_cache(cfg, batch: int, dtype=torch.float32,
                     device=None) -> dict:
    d = cfg.d_model
    return {
        "h": torch.zeros((batch, d), dtype=dtype, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, d), dtype=dtype,
                            device=device),
    }


def rglru_decode(params: RGLRU, cfg, x: Tensor, cache: dict
                 ) -> tuple[Tensor, dict]:
    """Single-token step. x: [B, 1, D].  The cache dict gets the new state
    (it is returned too)."""
    lin = F.gelu(x @ params.w_lin, approximate="tanh")
    u = x @ params.w_x
    u, conv_state = conv1d_causal(params, u, cache["conv"])
    a, b = _gates(params, u)
    h = a[:, 0] * cache["h"] + b[:, 0]
    y = (h[:, None] * lin) @ params.w_out
    cache["h"], cache["conv"] = h, conv_state
    return y, cache
