"""Serving steps: prefill (prompt -> cache) and decode (one token/step).

The port of ``repro/train/serve_step.py``; `generate` is a Python loop in
place of ``lax.scan``.  The steps run under ``torch.no_grad``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import api
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor


def make_prefill_step(cfg: ModelConfig, max_len: int,
                      use_kernel: Optional[bool] = None):
    @torch.no_grad()
    def prefill_step(model, batch: dict):
        logits, cache = api.prefill(cfg, model, batch, max_len,
                                    use_kernel=use_kernel)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, cache
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """A greedy decode step."""
    @torch.no_grad()
    def decode_step(model, cache: dict, token: Tensor, index: int):
        logits, cache = api.decode_step(cfg, model, cache, token, index)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, cache
    return decode_step


def prompt_length(cfg: ModelConfig, batch: dict) -> int:
    """Positions the prefill fills: the tokens, after any vision patches
    (an encoder-decoder's frames are the encoder's, not the decoder's)."""
    n = batch["tokens"].shape[1]
    if "patches" in batch:
        n += batch["patches"].shape[1]
    return n


def generate(cfg: ModelConfig, model, batch: dict, max_new: int,
             max_len: int, use_kernel: Optional[bool] = None) -> Tensor:
    """Greedy generation: [B, max_new] token ids."""
    tok, cache = make_prefill_step(cfg, max_len, use_kernel)(model, batch)
    start = prompt_length(cfg, batch)
    step = make_decode_step(cfg)
    out = [tok]
    for i in range(max_new - 1):
        tok, cache = step(model, cache, tok, start + i)
        out.append(tok)
    return torch.stack(out, dim=1)
