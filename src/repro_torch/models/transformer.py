"""The decoder stack driving every decoder-only architecture.

The port of ``repro/models/transformer.py``.  The layer plan is the
reference's:

    [lead blocks]  first_k_dense DeepSeekMoE-style dense layers
    [groups]       n_groups repetitions of cfg.block_pattern
    [tail blocks]  pattern remainder when n_layers % len(pattern) != 0

but the model is an ``nn.Module`` whose blocks sit one after another in a
``ModuleList`` (lead, then the groups' blocks in order, then the tail), not
stacked on a leading group axis for ``lax.scan``.  A cache is a plain dict
from layer index to that layer's dict of tensors.

Block kinds: "attn" (global), "attn_local" (sliding window), "rec"
(RG-LRU), "mlstm", "slstm".  FFN kinds per position: "dense" | "moe" |
"none".  The encoder-decoder stack is `encdec.py`.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve
from repro_torch.kernels.ref import f32_sqrt
from repro_torch.launch import layout
from repro_torch.models import attention, layers, rglru, xlstm
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, embed_init, norm, norm_param

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

MIXERS = ("attn", "attn_local", "rec", "mlstm", "slstm")


class Block(nn.Module):
    """One residual block: ``norm1``, the mixer (``attn``, ``rec``,
    ``mlstm`` or ``slstm``), ``postnorm1`` with post-norm, then with a
    dense or MoE FFN ``norm2``, ``ffn`` or ``moe``, and ``postnorm2`` — the
    reference's parameter names.  A norm of a non-parametric config is
    None."""

    def __init__(self, cfg: ModelConfig, kind: str, ffn_kind: str, d_ff: int,
                 generator=None, device=None):
        super().__init__()
        if kind not in MIXERS:
            raise ValueError(f"unknown block kind {kind!r}")
        dev = device if device is not None else generator.device
        self.kind, self.ffn_kind = kind, ffn_kind
        d = cfg.d_model
        self.norm1 = norm_param(cfg, d, dev)
        if kind in ("attn", "attn_local"):
            self.attn = attention.init_attn(cfg, generator, dev)
        elif kind == "rec":
            self.rec = rglru.init_rglru_block(cfg, generator, dev)
        elif kind == "mlstm":
            self.mlstm = xlstm.init_mlstm_block(cfg, generator, dev)
        else:
            self.slstm = xlstm.init_slstm_block(cfg, generator, dev)
        if cfg.post_norm:
            self.postnorm1 = norm_param(cfg, d, dev)
        if ffn_kind in ("dense", "moe"):
            self.norm2 = norm_param(cfg, d, dev)
            if ffn_kind == "dense":
                self.ffn = layers.MLP(d, d_ff, generator, dev)
            else:
                self.moe = moe_mod.init_moe(cfg, generator, dev)
            if cfg.post_norm:
                self.postnorm2 = norm_param(cfg, d, dev)

    def finish(self, cfg, h: Tensor, y: Tensor
               ) -> tuple[Tensor, Optional[Tensor]]:
        """Post-norm the mixer output y, add it to h, then the FFN.
        Returns (h, the MoE auxiliary loss, None without a MoE FFN)."""
        aux = None
        if cfg.post_norm:
            y = norm(cfg, y, self.postnorm1)
        h = layout.residual(h, y)
        if self.ffn_kind in ("dense", "moe"):
            x = norm(cfg, h, self.norm2)
            if self.ffn_kind == "dense":
                y = layers.mlp(self.ffn, x)
            else:
                y, aux = moe_mod.moe_forward(self.moe, cfg, x)
            if cfg.post_norm:
                y = norm(cfg, y, self.postnorm2)
            h = layout.residual(h, y)
        return h, aux


def _apply_block(cfg: ModelConfig, blk: Block, h: Tensor, positions: Tensor,
                 use_kernel: Optional[bool]
                 ) -> tuple[Tensor, Optional[Tensor]]:
    x = norm(cfg, h, blk.norm1)
    if blk.kind == "attn":
        y = attention.attn_forward(blk.attn, cfg, x, positions=positions,
                                   use_kernel=use_kernel)
    elif blk.kind == "attn_local":
        y = attention.attn_forward(blk.attn, cfg, x, positions=positions,
                                   window=cfg.window, use_kernel=use_kernel)
    elif blk.kind == "rec":
        y = rglru.rglru_forward(blk.rec, cfg, x, use_kernel=use_kernel)
    elif blk.kind == "mlstm":
        y = xlstm.mlstm_forward(blk.mlstm, cfg, x)
    else:
        y = xlstm.slstm_forward(blk.slstm, cfg, x)
    return blk.finish(cfg, h, y)


def _apply_block_prefill(cfg: ModelConfig, blk: Block, h: Tensor,
                         positions: Tensor, use_kernel: Optional[bool],
                         max_len: int) -> tuple[Tensor, dict]:
    t, batch = h.shape[1], h.shape[0]
    x = norm(cfg, h, blk.norm1)
    if blk.kind in ("attn", "attn_local"):
        window = cfg.window if blk.kind == "attn_local" else 0
        y, (k, v) = attention.attn_forward(
            blk.attn, cfg, x, positions=positions, window=window,
            use_kernel=use_kernel, return_kv=True)
        cache = _init_block_cache(cfg, blk.kind, batch, max_len, h.dtype,
                                  h.device, like=k)
        if blk.kind == "attn":
            attention.fill_kv_cache(cache, k, v)
        else:
            attention.fill_ring_cache(cache, k, v, t)
    elif blk.kind == "rec":
        y, cache = rglru.rglru_forward(blk.rec, cfg, x,
                                       use_kernel=use_kernel,
                                       return_state=True)
    elif blk.kind == "mlstm":
        y, cache = xlstm.mlstm_forward(blk.mlstm, cfg, x, return_state=True)
    else:
        y, cache = xlstm.slstm_forward(blk.slstm, cfg, x, return_state=True)
    h, _ = blk.finish(cfg, h, y)
    return h, cache


def _decode_block(cfg: ModelConfig, blk: Block, h: Tensor, cache: dict,
                  index: int) -> tuple[Tensor, dict]:
    x = norm(cfg, h, blk.norm1)
    if blk.kind == "attn":
        y, cache = attention.attn_decode(blk.attn, cfg, x, cache, index)
    elif blk.kind == "attn_local":
        y, cache = attention.attn_decode_ring(blk.attn, cfg, x, cache, index,
                                              window=cfg.window)
    elif blk.kind == "rec":
        y, cache = rglru.rglru_decode(blk.rec, cfg, x, cache)
    elif blk.kind == "mlstm":
        y, cache = xlstm.mlstm_decode(blk.mlstm, cfg, x, cache)
    else:
        y, cache = xlstm.slstm_decode(blk.slstm, cfg, x, cache)
    h, _ = blk.finish(cfg, h, y)
    return h, cache


def _block_plan(cfg: ModelConfig):
    """(lead, pattern, n_groups, tail) block/ffn kind lists."""
    pattern = list(zip(cfg.block_pattern, cfg.ffn_kinds))
    lead = [("attn", "dense")] * cfg.first_k_dense
    n_rest = cfg.n_layers - len(lead)
    n_groups = n_rest // len(pattern)
    tail = pattern[: n_rest - n_groups * len(pattern)]
    return lead, pattern, n_groups, tail


def layer_plan(cfg: ModelConfig) -> list[tuple[str, str, int]]:
    """(kind, ffn_kind, d_ff) of every layer, in the model's order."""
    lead, pattern, n_groups, tail = _block_plan(cfg)
    lead_ff = cfg.dense_d_ff or cfg.d_ff
    return ([(k, f, lead_ff) for k, f in lead]
            + [(k, f, cfg.d_ff) for k, f in pattern] * n_groups
            + [(k, f, cfg.d_ff) for k, f in tail])


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

class Model(nn.Module):
    """``embed`` [vocab_padded, d], ``proj_vision`` [vit_dim, d] for vision
    configs, ``layers`` (a `Block` each), ``final_norm``, and ``head``
    [d, vocab_padded] unless the embeddings are tied."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        dev = device if device is not None else generator.device
        self.cfg = cfg
        d = cfg.d_model
        self.embed = nn.Parameter(embed_init(generator, (cfg.vocab_padded, d),
                                             device=dev))
        if cfg.vit_dim:
            self.proj_vision = nn.Parameter(
                dense_init(generator, (cfg.vit_dim, d), device=dev))
        self.layers = nn.ModuleList(
            Block(cfg, kind, ffn, d_ff, generator, dev)
            for kind, ffn, d_ff in layer_plan(cfg))
        self.final_norm = norm_param(cfg, d, dev)
        if not cfg.tie_embeddings:
            self.head = nn.Parameter(
                dense_init(generator, (d, cfg.vocab_padded), device=dev))

    def head_matrix(self) -> Tensor:
        return layout.gathered(self.embed.T if self.cfg.tie_embeddings
                               else self.head)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None) -> Model:
    """The model with freshly initialised parameters on ``device`` (None:
    the CUDA card; "meta" allocates nothing).  ``generator`` must live on
    that device; None seeds one with 0."""
    dev = resolve(device)
    if dev.type == "meta":
        return Model(cfg, device=dev)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    return Model(cfg, generator, dev)


def embed_inputs(cfg: ModelConfig, model: Model, tokens: Tensor,
                 extra_embeds: Optional[Tensor] = None) -> Tensor:
    h = layout.lookup(model.embed, tokens)
    if cfg.embed_scale:
        h = h * f32_sqrt(cfg.d_model)
    if extra_embeds is not None:
        if cfg.vit_dim:
            # float32 patches against bf16 weights multiply in float32, as
            # jnp's type promotion has them
            w = model.proj_vision
            extra_embeds = extra_embeds @ w.to(
                torch.promote_types(extra_embeds.dtype, w.dtype))
        h = torch.cat([extra_embeds.to(h.dtype), h], dim=1)
    return h


def _positions(h: Tensor) -> Tensor:
    return torch.arange(h.shape[1], device=h.device).expand(h.shape[:2])


def _apply_blocks(cfg: ModelConfig, blocks, h: Tensor, aux: Tensor,
                  positions: Tensor, use_kernel: Optional[bool]
                  ) -> tuple[Tensor, Tensor]:
    for blk in blocks:
        h, a = _apply_block(cfg, blk, h, positions, use_kernel)
        if a is not None:   # a block without MoE adds the reference's 0
            aux = aux + a
    return h, aux


def forward(cfg: ModelConfig, model: Model, tokens: Tensor,
            extra_embeds: Optional[Tensor] = None,
            use_kernel: Optional[bool] = None,
            remat: bool = True) -> tuple[Tensor, Tensor]:
    """Returns (logits [B, T, V], aux_loss scalar: the MoE layers'
    load-balance losses summed in layer order, 0 without MoE).

    ``remat``: where the reference wraps its layer-group scan body in
    ``jax.checkpoint``, each group of ``block_pattern`` runs under
    ``torch.utils.checkpoint.checkpoint`` (non-reentrant): the backward
    pass recomputes the group from its input, kernels included, so only
    the groups' inputs are kept.  The lead and tail blocks are not
    rematerialized, as in the reference.  It matters only where autograd
    records.  The reference's ``unroll`` has no counterpart: there is no
    ``lax.scan`` to unroll, the groups are a Python loop either way."""
    lead, pattern, n_groups, _ = _block_plan(cfg)
    h = embed_inputs(cfg, model, tokens, extra_embeds)
    positions = _positions(h)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    blocks = list(model.layers)
    n_lead, width = len(lead), len(pattern)
    h, aux = _apply_blocks(cfg, blocks[:n_lead], h, aux, positions,
                           use_kernel)
    for g in range(n_groups):
        group = blocks[n_lead + g * width: n_lead + (g + 1) * width]
        if remat and torch.is_grad_enabled():
            # the blocks draw no random numbers: no RNG state to replay
            h, aux = checkpoint(_apply_blocks, cfg, group, h, aux, positions,
                                use_kernel, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            h, aux = _apply_blocks(cfg, group, h, aux, positions, use_kernel)
    h, aux = _apply_blocks(cfg, blocks[n_lead + n_groups * width:], h, aux,
                           positions, use_kernel)
    h = norm(cfg, h, model.final_norm)
    logits = layers.softcap(h @ model.head_matrix(), cfg.logit_softcap)
    return logits, aux


def prefill(cfg: ModelConfig, model: Model, tokens: Tensor, max_len: int,
            extra_embeds: Optional[Tensor] = None,
            use_kernel: Optional[bool] = None) -> tuple[Tensor, dict]:
    """Process a prompt, returning (last-position logits [B, V], cache)."""
    h = embed_inputs(cfg, model, tokens, extra_embeds)
    positions = _positions(h)
    cache: dict = {}
    for i, blk in enumerate(model.layers):
        h, cache[i] = _apply_block_prefill(cfg, blk, h, positions,
                                           use_kernel, max_len)
    h = norm(cfg, h, model.final_norm)
    logits = layers.softcap(h[:, -1] @ model.head_matrix(),
                            cfg.logit_softcap)
    return logits, cache


# ---------------------------------------------------------------------------
# Decode (single token, KV/recurrent caches)
# ---------------------------------------------------------------------------

def _init_block_cache(cfg, kind: str, batch: int, max_len: int, dtype,
                      device, like: Optional[Tensor] = None) -> dict:
    """One block's zeroed cache; an attention block's laid out as ``like``
    (its prefill's K) where that is a DTensor."""
    if kind == "attn":
        return attention.init_kv_cache(cfg, batch, max_len, dtype, device,
                                       like)
    if kind == "attn_local":
        w = min(cfg.window or max_len, max_len)
        return attention.init_ring_cache(cfg, batch, w, dtype, device, like)
    if kind == "rec":
        return rglru.init_rglru_cache(cfg, batch, dtype, device)
    if kind == "mlstm":
        return xlstm.init_mlstm_cache(cfg, batch, dtype, device)
    return xlstm.init_slstm_cache(cfg, batch, dtype, device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, device=None) -> dict:
    dev = resolve(device)
    return {i: _init_block_cache(cfg, kind, batch, max_len, dtype, dev)
            for i, (kind, _, _) in enumerate(layer_plan(cfg))}


def decode_step(cfg: ModelConfig, model: Model, cache: dict, token: Tensor,
                index: int) -> tuple[Tensor, dict]:
    """token: [B] int; index: the token's position.  Returns (logits
    [B, V], cache); the cache is updated in place."""
    index = int(index)
    h = layout.lookup(model.embed, token)[:, None, :]
    if cfg.embed_scale:
        h = h * f32_sqrt(cfg.d_model)
    for i, blk in enumerate(model.layers):
        h, cache[i] = _decode_block(cfg, blk, h, cache[i], index)
    h = norm(cfg, h, model.final_norm)
    logits = layers.softcap(h[:, 0] @ model.head_matrix(), cfg.logit_softcap)
    return logits, cache


# ---------------------------------------------------------------------------
# Parameter accounting (for MODEL_FLOPS = 6*N*D)
# ---------------------------------------------------------------------------

def param_count(cfg: ModelConfig) -> int:
    """Parameters of the model (the encoder-decoder's for an encdec
    config), counted on the ``meta`` device: nothing is allocated, so a
    full-size config costs nothing."""
    if cfg.enc_layers > 0:
        from repro_torch.models import encdec
        model = encdec.EncDec(cfg, device=torch.device("meta"))
    else:
        model = Model(cfg, device=torch.device("meta"))
    return sum(p.numel() for p in model.parameters())


def active_param_count(cfg: ModelConfig) -> int:
    """Params touched per token: total minus the routed experts not selected
    and minus the embedding lookup table (gather, not matmul)."""
    total = param_count(cfg)
    embed = 0 if cfg.tie_embeddings else cfg.vocab * cfg.d_model
    if cfg.moe is None:
        return total - embed
    m = cfg.moe
    per_expert = 3 * cfg.d_model * (m.d_expert or cfg.d_ff)
    n_moe = sum(1 for _, ffn, _ in layer_plan(cfg) if ffn == "moe")
    return total - n_moe * (m.n_experts - m.top_k) * per_expert - embed
