"""Unified model API over the decoder-only and encoder-decoder stacks.

The port of ``repro/models/api.py``.  A batch is a dict:
  tokens   [B, T] int                (always)
  frames   [B, T_enc, d] float       (audio family: stub frontend embeddings)
  patches  [B, n_vision, vit_dim]    (vlm family: stub patch embeddings)

``use_kernel=None`` (the default) runs the kernels (flash attention, the
RG-LRU scan) when the activations are on a CUDA device, and the plain path
on the CPU; True or False forces one (`repro_torch.device.use_kernels`).
Both kernels' wrappers are ``torch.autograd.Function``s, so a training
forward on the card runs them too.

``remat=True`` (the default of `forward`) rematerializes each group of
``block_pattern`` (`transformer.forward`), or each encoder and decoder
block (`encdec.forward`), in the backward pass.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import encdec, transformer
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor


def is_encdec(cfg: ModelConfig) -> bool:
    return cfg.enc_layers > 0


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None) -> torch.nn.Module:
    if is_encdec(cfg):
        return encdec.init_params(cfg, generator, device)
    return transformer.init_params(cfg, generator, device)


def forward(cfg: ModelConfig, model, batch: dict,
            use_kernel: Optional[bool] = None,
            remat: bool = True) -> tuple[Tensor, Tensor]:
    if is_encdec(cfg):
        return encdec.forward(cfg, model, batch["tokens"], batch["frames"],
                              use_kernel=use_kernel, remat=remat)
    return transformer.forward(cfg, model, batch["tokens"],
                               extra_embeds=batch.get("patches"),
                               use_kernel=use_kernel, remat=remat)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, device=None, enc_len: int = 0) -> dict:
    if is_encdec(cfg):
        return encdec.init_cache(
            cfg, batch, max_len,
            enc_len or max(max_len // cfg.enc_seq_divisor, 8), dtype, device)
    return transformer.init_cache(cfg, batch, max_len, dtype, device)


def decode_step(cfg: ModelConfig, model, cache: dict, token: Tensor,
                index: int) -> tuple[Tensor, dict]:
    if is_encdec(cfg):
        return encdec.decode_step(cfg, model, cache, token, index)
    return transformer.decode_step(cfg, model, cache, token, index)


def prefill(cfg: ModelConfig, model, batch: dict, max_len: int,
            use_kernel: Optional[bool] = None) -> tuple[Tensor, dict]:
    if is_encdec(cfg):
        return encdec.prefill(cfg, model, batch["tokens"], batch["frames"],
                              max_len, use_kernel=use_kernel)
    return transformer.prefill(cfg, model, batch["tokens"], max_len,
                               extra_embeds=batch.get("patches"),
                               use_kernel=use_kernel)
