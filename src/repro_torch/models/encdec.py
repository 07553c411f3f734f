"""Encoder-decoder stack (seamless-m4t family).

The port of ``repro/models/encdec.py``.  Encoder: bidirectional attention
blocks over precomputed modality frame embeddings (the speech frontend is
a stub: a batch carries ``frames`` [B, T_enc, d]).  Decoder: causal
self-attention + cross-attention + FFN blocks over target tokens.

Where the reference stacks each stack's blocks on a leading layer axis and
scans them, the port keeps them in the ``ModuleList``s ``enc`` and ``dec``
(`convert` maps the two layouts).  The cache keeps the reference's layout:
``{"self": {"k", "v"}, "cross": {"k", "v"}}``, each [L, B, S, K, D]; the
self-attention K/V are written in place at decode.  The self-attention
runs the flash kernel where `device.use_kernels` says so (bidirectional in
the encoder, causal in the decoder); cross-attention never does, as in the
reference.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve
from repro_torch.kernels.ref import f32_sqrt
from repro_torch.models import attention, layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, embed_init, norm, norm_param

Tensor = torch.Tensor


class EncBlock(nn.Module):
    """``norm1``, ``attn``, ``norm2``, ``ffn``."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        self.norm1 = norm_param(cfg, cfg.d_model, device)
        self.attn = attention.init_attn(cfg, generator, device)
        self.norm2 = norm_param(cfg, cfg.d_model, device)
        self.ffn = layers.MLP(cfg.d_model, cfg.d_ff, generator, device)


class DecBlock(nn.Module):
    """``norm1``, ``self_attn``, ``norm_x``, ``cross_attn``, ``norm2``,
    ``ffn``."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        self.norm1 = norm_param(cfg, cfg.d_model, device)
        self.self_attn = attention.init_attn(cfg, generator, device)
        self.norm_x = norm_param(cfg, cfg.d_model, device)
        self.cross_attn = attention.init_attn(cfg, generator, device)
        self.norm2 = norm_param(cfg, cfg.d_model, device)
        self.ffn = layers.MLP(cfg.d_model, cfg.d_ff, generator, device)


class EncDec(nn.Module):
    """``embed`` [vocab_padded, d], ``enc`` (an `EncBlock` each),
    ``enc_norm``, ``dec`` (a `DecBlock` each), ``final_norm``, ``head``
    [d, vocab_padded]."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        dev = device if device is not None else generator.device
        self.cfg = cfg
        d = cfg.d_model
        self.embed = nn.Parameter(embed_init(generator, (cfg.vocab_padded, d),
                                             device=dev))
        self.enc = nn.ModuleList(EncBlock(cfg, generator, dev)
                                 for _ in range(cfg.enc_layers))
        self.enc_norm = norm_param(cfg, d, dev)
        self.dec = nn.ModuleList(DecBlock(cfg, generator, dev)
                                 for _ in range(cfg.n_layers))
        self.final_norm = norm_param(cfg, d, dev)
        self.head = nn.Parameter(dense_init(generator, (d, cfg.vocab_padded),
                                            device=dev))


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None) -> EncDec:
    """As `transformer.init_params`, for the encoder-decoder."""
    dev = resolve(device)
    if dev.type == "meta":
        return EncDec(cfg, device=dev)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    return EncDec(cfg, generator, dev)


def _positions(h: Tensor) -> Tensor:
    return torch.arange(h.shape[1], device=h.device).expand(h.shape[:2])


def _run(fn, remat: bool, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` where ``remat`` and
    autograd records (the reference checkpoints every block)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def _enc_block(cfg, blk: EncBlock, h: Tensor, positions: Tensor,
               use_kernel: Optional[bool]) -> Tensor:
    x = norm(cfg, h, blk.norm1)
    h = h + attention.attn_forward(blk.attn, cfg, x, positions=positions,
                                   causal=False, use_kernel=use_kernel)
    return h + layers.mlp(blk.ffn, norm(cfg, h, blk.norm2))


def encode(cfg: ModelConfig, model: EncDec, frames: Tensor,
           use_kernel: Optional[bool] = None, remat: bool = True) -> Tensor:
    """frames: [B, T_enc, d] precomputed frontend embeddings."""
    h = frames.to(model.embed.dtype)   # match the compute dtype
    positions = _positions(h)
    for blk in model.enc:
        h = _run(_enc_block, remat, cfg, blk, h, positions, use_kernel)
    return norm(cfg, h, model.enc_norm)


def _dec_block(cfg, blk: DecBlock, h: Tensor, memory: Tensor,
               positions: Tensor, use_kernel: Optional[bool],
               return_kv: bool = False):
    x = norm(cfg, h, blk.norm1)
    y = attention.attn_forward(blk.self_attn, cfg, x, positions=positions,
                               use_kernel=use_kernel, return_kv=return_kv)
    if return_kv:
        y, kv = y
    h = h + y
    x = norm(cfg, h, blk.norm_x)
    h = h + attention.attn_forward(blk.cross_attn, cfg, x,
                                   positions=positions, kv_x=memory)
    h = h + layers.mlp(blk.ffn, norm(cfg, h, blk.norm2))
    return (h, kv) if return_kv else h


def forward(cfg: ModelConfig, model: EncDec, tokens: Tensor, frames: Tensor,
            use_kernel: Optional[bool] = None,
            remat: bool = True) -> tuple[Tensor, Tensor]:
    """Teacher-forced training forward.  Returns (logits [B, T, V],
    aux = 0).  ``remat``: each block runs under ``torch.utils.checkpoint``
    where autograd records."""
    memory = encode(cfg, model, frames, use_kernel, remat)
    h = model.embed[tokens]
    positions = _positions(h)
    for blk in model.dec:
        h = _run(_dec_block, remat, cfg, blk, h, memory, positions,
                 use_kernel)
    h = norm(cfg, h, model.final_norm)
    return h @ model.head, torch.zeros((), dtype=torch.float32,
                                       device=h.device)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int,
               dtype=torch.float32, device=None) -> dict:
    kh, dh, n = cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    dev = resolve(device)

    def zeros(s):
        return torch.zeros((n, batch, s, kh, dh), dtype=dtype, device=dev)

    # cross K/V are computed from the encoder memory at prefill
    return {"self": {"k": zeros(max_len), "v": zeros(max_len)},
            "cross": {"k": zeros(enc_len), "v": zeros(enc_len)}}


def prefill_cross(cfg: ModelConfig, model: EncDec, memory: Tensor,
                  cache: dict) -> dict:
    """Write every decoder layer's cross-attention K/V of ``memory`` into
    ``cache["cross"]`` (whose length must be memory's)."""
    for i, blk in enumerate(model.dec):
        p = blk.cross_attn
        k = torch.einsum("bsd,dhk->bshk", memory, p.wk)
        v = torch.einsum("bsd,dhk->bshk", memory, p.wv)
        if cfg.qkv_bias:
            k, v = k + p.bk, v + p.bv
        cache["cross"]["k"][i] = k
        cache["cross"]["v"][i] = v
    return cache


def prefill(cfg: ModelConfig, model: EncDec, tokens: Tensor, frames: Tensor,
            max_len: int, use_kernel: Optional[bool] = None
            ) -> tuple[Tensor, dict]:
    """Encode the source, teacher-force the target prefix, emit caches."""
    memory = encode(cfg, model, frames, use_kernel)
    h = model.embed[tokens]
    positions = _positions(h)
    t = h.shape[1]
    cache = init_cache(cfg, h.shape[0], max_len, memory.shape[1], h.dtype,
                       h.device)
    for i, blk in enumerate(model.dec):
        h, (k, v) = _dec_block(cfg, blk, h, memory, positions, use_kernel,
                               return_kv=True)
        cache["self"]["k"][i, :, :t] = k
        cache["self"]["v"][i, :, :t] = v
    h = norm(cfg, h, model.final_norm)
    logits = h[:, -1] @ model.head
    return logits, prefill_cross(cfg, model, memory, cache)


def _cross_decode(cfg, p: attention.Attention, x: Tensor, ck: Tensor,
                  cv: Tensor) -> Tensor:
    """Cross-attention of one token against the memory's K/V (no mask),
    softmax in f32."""
    q = torch.einsum("btd,dhk->bthk", x, p.wq)
    if cfg.qkv_bias:
        q = q + p.bq
    ke = attention._expand_kv(ck, q.shape[2])
    ve = attention._expand_kv(cv, q.shape[2])
    sc = torch.einsum("bthd,bshd->bths", q, ke) / f32_sqrt(q.shape[-1])
    pr = torch.softmax(sc.float(), dim=-1).to(q.dtype)
    o = torch.einsum("bths,bshd->bthd", pr, ve)
    return torch.einsum("bthk,hkd->btd", o, p.wo)


def decode_step(cfg: ModelConfig, model: EncDec, cache: dict, token: Tensor,
                index: int) -> tuple[Tensor, dict]:
    """token: [B] int; index: its position in the target.  Returns (logits
    [B, V], cache); the self-attention cache is updated in place."""
    index = int(index)
    h = model.embed[token][:, None, :]
    for i, blk in enumerate(model.dec):
        x = norm(cfg, h, blk.norm1)
        y, _ = attention.attn_decode(
            blk.self_attn, cfg, x,
            {"k": cache["self"]["k"][i], "v": cache["self"]["v"][i]}, index)
        h = h + y
        x = norm(cfg, h, blk.norm_x)
        h = h + _cross_decode(cfg, blk.cross_attn, x, cache["cross"]["k"][i],
                              cache["cross"]["v"][i])
        h = h + layers.mlp(blk.ffn, norm(cfg, h, blk.norm2))
    h = norm(cfg, h, model.final_norm)
    return h[:, 0] @ model.head, cache
