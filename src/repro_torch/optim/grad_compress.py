"""Gradient compression with error feedback (the port of
``repro/optim/grad_compress.py``).

Two schemes, both with error-feedback residual accumulation, so that the
compression error is re-injected next step:

  * "topk":  keep the entries of each tensor whose magnitude is at least
    its k-th largest (k = max(1, int(size * topk_frac))).
  * "int8":  per-tensor symmetric int8 quantization (round half to even).

`compress_gradients` returns the *decompressed* gradients (what the step
applies after the all-reduce) and the new residuals; `wire_bytes` reports
the bytes a NIC would carry, which feeds the cluster simulator's comm model.
"""
from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    scheme: str = "none"          # "none" | "topk" | "int8"
    topk_frac: float = 0.01


def init_error_feedback(params: dict) -> dict:
    """Zero float32 residuals, one per parameter."""
    return {name: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for name, p in params.items()}


def _topk_tensor(g: Tensor, frac: float) -> Tensor:
    flat = g.reshape(-1)
    k = max(1, int(flat.numel() * frac))
    thresh = torch.topk(torch.abs(flat), k).values[-1]
    return torch.where(torch.abs(g) >= thresh, g, torch.zeros_like(g))


def _int8_tensor(g: Tensor) -> Tensor:
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127)
    return q * scale


def compress_gradients(cfg: CompressionConfig, grads: dict, residual: dict
                       ) -> tuple[dict, dict]:
    """(sent, residual): per tensor, acc = grad + residual in float32, sent
    = the compressed acc in the gradient's dtype, residual = acc - sent."""
    if cfg.scheme == "none":
        return grads, residual
    if cfg.scheme not in ("topk", "int8"):
        raise ValueError(cfg.scheme)
    sent, resid = {}, {}
    for name, g in grads.items():
        acc = g.to(torch.float32) + residual[name]
        if cfg.scheme == "topk":
            s = _topk_tensor(acc, cfg.topk_frac)
        else:
            s = _int8_tensor(acc)
        sent[name] = s.to(g.dtype)
        resid[name] = acc - s
    return sent, resid


def wire_bytes(cfg: CompressionConfig, param_count: int,
               n_workers: int = 2) -> float:
    """Bytes per worker per iteration after compression (ring all-reduce)."""
    ring = 2.0 * (n_workers - 1) / n_workers
    if cfg.scheme == "none":
        return ring * param_count * 4.0
    if cfg.scheme == "int8":
        return ring * param_count * 1.0
    if cfg.scheme == "topk":
        # value + index per surviving entry
        return ring * param_count * cfg.topk_frac * 8.0
    raise ValueError(cfg.scheme)
