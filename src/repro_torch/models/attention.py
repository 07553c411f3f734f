"""GQA attention covering the assigned archs' feature matrix.

The port of ``repro/models/attention.py``: grouped KV heads, RoPE, qk-norm
(Qwen3), QKV bias (Qwen1.5), attention-logit softcap (Gemma-2), local
sliding window (Gemma-2 / RecurrentGemma), KV-cache decode against a
full or a ring cache, and cross-attention (the seamless-m4t decoder:
K/V projected from the encoder's memory, no rope, no mask).

On a device mesh (DTensor parameters, `train.sharding`) the reference's
knob `SEQ_SHARD_AXIS` shards the dense path's queries and scores on the
sequence axis (`_seq_shard`), and the caches a prefill makes and a decode
step writes stay sharded (`launch.layout`); on plain tensors both are
no-ops, so every one-card path is as it was.

The full-sequence self-attention path can route through the
flash-attention kernel (`repro_torch.kernels.ops.flash_attention`,
differentiable); `attend` here is its oracle.  Cross-attention never
takes the kernel, as in the reference.

Caches are plain dicts of tensors.  The decode steps write the new K/V
into the cache tensors in place (a cache is the size of the whole
context, and copying it every token would double decode's memory
traffic) and return the same dict.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from repro_torch.device import use_kernels
from repro_torch.kernels.ref import NEG_INF, f32_sqrt
from repro_torch.launch import layout
from repro_torch.models import layers
from repro_torch.models.layers import dense_init, rope, softcap

Tensor = torch.Tensor


class Attention(nn.Module):
    """Projections ``wq`` [d, H, dh], ``wk``/``wv`` [d, K, dh], ``wo``
    [H, dh, d]; ``bq``/``bk``/``bv`` with QKV bias, ``q_norm``/``k_norm``
    with qk-norm."""

    def __init__(self, cfg, generator=None, device=None):
        super().__init__()
        d, h, k, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

        def dense(shape):
            return nn.Parameter(dense_init(generator, shape, in_axis=0,
                                           device=device))

        def zeros(shape):
            dev = device if device is not None else generator.device
            return nn.Parameter(torch.zeros(shape, device=dev))

        self.wq = dense((d, h, dh))
        self.wk = dense((d, k, dh))
        self.wv = dense((d, k, dh))
        self.wo = dense((h, dh, d))
        if cfg.qkv_bias:
            self.bq, self.bk, self.bv = zeros((h, dh)), zeros((k, dh)), \
                zeros((k, dh))
        if cfg.qk_norm:
            self.q_norm, self.k_norm = zeros((dh,)), zeros((dh,))


def init_attn(cfg, generator=None, device=None) -> Attention:
    return Attention(cfg, generator, device)


def _project_qkv(params: Attention, cfg, x: Tensor, kv_x: Tensor):
    q = layout.project_heads(x, params.wq)
    k = layout.project_heads(kv_x, params.wk)
    v = layout.project_heads(kv_x, params.wv)
    if cfg.qkv_bias:
        q, k, v = q + params.bq, k + params.bk, v + params.bv
    if cfg.qk_norm:
        q = layers.rms_norm(q, params.q_norm, cfg.norm_eps)
        k = layers.rms_norm(k, params.k_norm, cfg.norm_eps)
    return q, k, v


# --- the reference's hillclimb knobs (`roofline.hillclimb` sets them) ---
# Shard the query/scores sequence axis over this mesh axis in the dense
# full-sequence path (the dry run sets it for
# `launch.dryrun.SEQ_SHARD_ARCHS`): it cuts the [T, S] probabilities by
# the axis size where the heads cannot shard.
SEQ_SHARD_AXIS: Optional[str] = None
# Decode GQA by a grouped einsum against the cache (True), or against the
# cache's KV heads repeated to the query heads (False, the reference's
# first formulation and the hillclimb's baseline B0).
DECODE_GROUPED_GQA: bool = True


def _seq_shard(x: Tensor, axis: int = 1) -> Tensor:
    """The reference's ``with_sharding_constraint`` of ``x`` to a spec
    naming `SEQ_SHARD_AXIS` on ``axis``: a redistribute on a DTensor, a
    no-op on a plain tensor or with the knob off."""
    if SEQ_SHARD_AXIS is None:
        return x
    spec = [None] * x.ndim
    spec[axis] = SEQ_SHARD_AXIS
    return layout.constrain(x, spec)


def _expand_kv(k: Tensor, n_heads: int) -> Tensor:
    """Repeat KV heads to match query heads (head h reads KV head
    h // group)."""
    g = n_heads // k.shape[2]
    return k if g == 1 else k.repeat_interleave(g, dim=2)


def _grouped_decode_attend(cfg, q, ck, cv, valid) -> Tensor:
    """Decode attention without expanding KV: q [B,1,H,D] reshaped to
    [B,1,K,g,D] against the cache [B,S,K,D] directly."""
    b, t, h, dh = q.shape
    kh = ck.shape[2]
    g = h // kh
    # a view cannot split heads that the model axis shards unevenly
    qg = layout.unshard(q, (2,)).reshape(b, t, kh, g, dh)
    scores = torch.einsum("btkgd,bskd->btkgs", qg, ck) / f32_sqrt(dh)
    scores = softcap(scores, cfg.attn_softcap)
    scores = torch.where(valid[None, None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("btkgs,bskd->btkgd", probs, cv)
    return out.reshape(b, t, h, dh)


def _expanded_decode_attend(cfg, q, ck, cv, valid) -> Tensor:
    """Decode attention against the cache's KV heads repeated to the
    query heads (`_expand_kv`): q [B,1,H,D], the cache [B,S,K,D]."""
    b, t, h, dh = q.shape
    ke = _expand_kv(ck, h)
    ve = _expand_kv(cv, h)
    scores = layout.head_einsum("bthd,bshd->bths", q, ke,
                                (b, t, h, ke.shape[1])) / f32_sqrt(dh)
    scores = softcap(scores, cfg.attn_softcap)
    scores = torch.where(valid[None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return layout.head_einsum("bths,bshd->bthd", probs, ve, (b, t, h, dh))


def _decode_attend(cfg, q, ck, cv, valid) -> Tensor:
    """The decode step's attention, as `DECODE_GROUPED_GQA` picks it."""
    if DECODE_GROUPED_GQA:
        return _grouped_decode_attend(cfg, q, ck, cv, valid)
    return _expanded_decode_attend(cfg, q, ck, cv, valid)


# a [T, S] probability matrix above this many entries is not materialized:
# queries go in _Q_CHUNK slices instead
_CHUNK_THRESHOLD = 2 ** 24
_Q_CHUNK = 1024


def _attend_dense(cfg, q, k, v, *, causal, window, q_offset):
    b, t, h, dh = q.shape
    s = k.shape[1]
    q = _seq_shard(q)
    scores = layout.query_einsum("bthd,bshd->bths", q, k,
                                 (b, t, h, s)) / f32_sqrt(dh)
    scores = softcap(scores, cfg.attn_softcap)
    qpos = q_offset + torch.arange(t, device=q.device)
    kpos = torch.arange(s, device=q.device)
    mask = torch.ones((t, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window and window > 0:
        mask &= kpos[None, :] > (qpos[:, None] - window)
    scores = torch.where(mask[None, :, None, :], scores, NEG_INF)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return layout.query_einsum("bths,bshd->bthd", probs, v, (b, t, h, dh))


def attend(cfg, q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
           window: int = 0, q_offset: int = 0) -> Tensor:
    """Reference scaled-dot-product GQA attention.

    q: [B, T, H, D];  k/v: [B, S, K, D];  H = K * group.
    ``q_offset``: absolute position of q[0].

    For large T*S the [T, S] probability matrix is never materialized:
    queries are processed in _Q_CHUNK slices.
    """
    b, t, h, dh = q.shape
    s = k.shape[1]
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    if t * s <= _CHUNK_THRESHOLD or t % _Q_CHUNK != 0:
        return _attend_dense(cfg, q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
    return torch.cat([
        _attend_dense(cfg, q[:, off: off + _Q_CHUNK], k, v, causal=causal,
                      window=window, q_offset=q_offset + off)
        for off in range(0, t, _Q_CHUNK)], dim=1)


def attn_forward(params: Attention, cfg, x: Tensor, *, positions: Tensor,
                 kv_x: Optional[Tensor] = None, causal: bool = True,
                 window: int = 0, use_kernel: Optional[bool] = None,
                 return_kv: bool = False):
    """Full-sequence attention (training / prefill / encoder / cross).
    ``use_kernel``: `device.use_kernels` (None: the flash kernel on a CUDA
    device).  With ``kv_x`` it is cross-attention: K/V come from
    ``kv_x``, without rope or mask, and always through `attend`."""
    cross = kv_x is not None
    q, k, v = _project_qkv(params, cfg, x, x if kv_x is None else kv_x)
    if not cross:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if not cross and use_kernels(use_kernel, q, k, v):
        from repro_torch.kernels import ops as kernel_ops
        out = kernel_ops.flash_attention(q, k, v, causal=causal,
                                         window=window,
                                         softcap=cfg.attn_softcap)
    else:
        out = attend(cfg, q, k, v, causal=causal and not cross,
                     window=window)
    y = layout.project_out(out, params.wo)
    if return_kv:
        return y, (k, v)
    return y


# ---------------------------------------------------------------------------
# Decode with KV cache
# ---------------------------------------------------------------------------

def init_kv_cache(cfg, batch: int, max_len: int, dtype=torch.float32,
                  device=None, like: Optional[Tensor] = None) -> dict:
    """Zeroed [B, S, K, D] K/V caches; with ``like``, a DTensor K of
    [B, T, K, D], laid out as it (`layout.full_like_layout`)."""
    k, dh = cfg.n_kv_heads, cfg.head_dim
    if layout.is_sharded(like):
        dims = {d: d for d in range(4)}
        return {name: layout.full_like_layout((batch, max_len, k, dh), 0.0,
                                              dtype, like, dims)
                for name in ("k", "v")}
    return {
        "k": torch.zeros((batch, max_len, k, dh), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, k, dh), dtype=dtype, device=device),
    }


def init_ring_cache(cfg, batch: int, window: int, dtype=torch.float32,
                    device=None, like: Optional[Tensor] = None) -> dict:
    """Fixed-size rotating KV cache for sliding-window layers: O(window)
    memory regardless of sequence length.  With ``like`` (a DTensor K),
    laid out as `init_kv_cache` lays it, ``pos`` replicated."""
    k, dh = cfg.n_kv_heads, cfg.head_dim
    if layout.is_sharded(like):
        dims = {d: d for d in range(4)}
        kv = {name: layout.full_like_layout((batch, window, k, dh), 0.0,
                                            dtype, like, dims)
              for name in ("k", "v")}
        kv["pos"] = layout.full_like_layout((window,), -1, torch.int32,
                                            like, {})
        return kv
    return {
        "k": torch.zeros((batch, window, k, dh), dtype=dtype, device=device),
        "v": torch.zeros((batch, window, k, dh), dtype=dtype, device=device),
        "pos": torch.full((window,), -1, dtype=torch.int32, device=device),
    }


def fill_kv_cache(cache: dict, k: Tensor, v: Tensor) -> dict:
    """Write prefill K/V [B, T, K, D] into a full cache at [0:T]."""
    t = k.shape[1]
    cache["k"][:, :t] = k
    cache["v"][:, :t] = v
    return cache


def fill_ring_cache(cache: dict, k: Tensor, v: Tensor, t: int) -> dict:
    """Write the last `window` prefill K/V into a ring cache, slot = pos % W."""
    w = cache["k"].shape[1]
    take = min(w, t)
    tail_pos = torch.arange(t - take, t, device=k.device)
    slots = tail_pos % w
    layout.put_rows(cache["k"], 1, slots, k[:, t - take: t])
    layout.put_rows(cache["v"], 1, slots, v[:, t - take: t])
    layout.put_rows(cache["pos"], 0, slots, tail_pos.to(torch.int32))
    return cache


def _decode_qkv(params: Attention, cfg, x: Tensor, index: int):
    positions = torch.full((x.shape[0], 1), index, dtype=torch.int32,
                           device=x.device)
    q, k_new, v_new = _project_qkv(params, cfg, x, x)
    q = rope(q, positions, cfg.rope_theta)
    k_new = rope(k_new, positions, cfg.rope_theta)   # rotate at write time
    return q, k_new, v_new


def attn_decode(params: Attention, cfg, x: Tensor, cache: dict, index: int,
                *, window: int = 0) -> tuple[Tensor, dict]:
    """One-token decode step at position ``index``. x: [B, 1, D]; cache
    k/v: [B, S, K, D], updated in place."""
    q, k_new, v_new = _decode_qkv(params, cfg, x, index)
    layout.write_at(cache["k"], 1, index, k_new[:, 0])
    layout.write_at(cache["v"], 1, index, v_new[:, 0])
    kpos = torch.arange(cache["k"].shape[1], device=x.device)
    valid = kpos <= index
    if window and window > 0:
        valid &= kpos > (index - window)
    out = _decode_attend(cfg, q, cache["k"], cache["v"], valid)
    y = layout.project_out(out, params.wo)
    return y, cache


def attn_decode_ring(params: Attention, cfg, x: Tensor, cache: dict,
                     index: int, *, window: int) -> tuple[Tensor, dict]:
    """One-token decode against a ring KV cache (updated in place).
    x: [B, 1, D]."""
    q, k_new, v_new = _decode_qkv(params, cfg, x, index)
    slot = index % cache["k"].shape[1]
    layout.write_at(cache["k"], 1, slot, k_new[:, 0])
    layout.write_at(cache["v"], 1, slot, v_new[:, 0])
    layout.write_at(cache["pos"], 0, slot, index)
    pos = cache["pos"]
    valid = (pos >= 0) & (pos <= index) & (pos > index - window)
    out = _decode_attend(cfg, q, cache["k"], cache["v"], valid)
    y = layout.project_out(out, params.wo)
    return y, cache
