"""Model configuration — one dataclass drives every assigned architecture.

The port's own copy of the reference package's `models/config.py`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int                 # routed experts
    top_k: int
    n_shared: int = 0              # always-on shared experts (DeepSeekMoE)
    d_expert: int = 0              # per-expert FFN width
    every_k_layers: int = 1        # MoE every k-th block (Llama-4 interleaves)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                        # 0 -> d_model // n_heads
    # repeating block group, e.g. ("attn",), ("rec","rec","attn_local"),
    # ("mlstm","mlstm","mlstm","slstm"), ("attn_local","attn")
    block_pattern: tuple[str, ...] = ("attn",)
    # FFN kind per pattern position: "dense" | "moe" | "none" (xLSTM blocks
    # carry their own projections). Empty -> auto: "moe" if cfg.moe else
    # "dense" for attn/rec blocks, "none" for mlstm/slstm blocks.
    ffn_pattern: tuple[str, ...] = ()
    # --- attention features ---
    rope_theta: float = 10_000.0
    qk_norm: bool = False                  # Qwen3
    qkv_bias: bool = False                 # Qwen1.5
    attn_softcap: Optional[float] = None   # Gemma-2 (50.0)
    logit_softcap: Optional[float] = None  # Gemma-2 final logits (30.0)
    window: int = 0                        # local-attention window (0 = full)
    # --- FFN / MoE ---
    moe: Optional[MoEConfig] = None
    capacity_factor: float = 1.25          # GShard expert-capacity factor
    first_k_dense: int = 0                 # DeepSeekMoE: first k layers dense
    dense_d_ff: int = 0                    # width of those dense layers
    # --- norm / embeddings ---
    norm_eps: float = 1e-6
    nonparam_norm: bool = False            # OLMo non-parametric LN
    post_norm: bool = False                # Gemma-2 pre+post norm sandwich
    embed_scale: bool = False              # Gemma family scales by sqrt(d)
    tie_embeddings: bool = False
    # --- recurrent blocks ---
    conv_width: int = 4                    # temporal conv (RG-LRU / xLSTM)
    rec_heads: int = 0                     # RG-LRU block heads (0 -> n_heads)
    # --- encoder-decoder (seamless-m4t) ---
    enc_layers: int = 0                    # >0 enables cross-attention decoder
    enc_seq_divisor: int = 4               # encoder frames = seq // divisor
    # --- multimodal frontends (stubs; embeddings arrive as inputs) ---
    vision_tokens: int = 0                 # InternVL patch tokens per sample
    vit_dim: int = 0                       # raw patch-embedding width
    # --- dtypes ---
    param_dtype: str = "float32"
    # --- metadata ---
    family: str = "dense"                  # dense|moe|hybrid|ssm|audio|vlm
    subquadratic: bool = False             # supports long_500k

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def vocab_padded(self) -> int:
        """Embedding/head tables pad the vocab to a multiple of 256 so the
        vocab axis shards over the model mesh axis (true vocab sizes like
        seamless's 256206 or internvl's 151655 are indivisible — unpadded
        they force replicated [B, T, V] logits). Targets always use true
        vocab ids; the padding rows are inert."""
        return -(-self.vocab // 256) * 256

    @property
    def ffn_kinds(self) -> tuple[str, ...]:
        if self.ffn_pattern:
            return self.ffn_pattern
        out = []
        for b in self.block_pattern:
            if b in ("mlstm", "slstm"):
                out.append("none")
            elif self.moe is not None and self.moe.every_k_layers == 1:
                out.append("moe")
            else:
                out.append("dense")
        return tuple(out)

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def remainder_blocks(self) -> tuple[str, ...]:
        """Blocks beyond the scanned groups (pattern-truncated tail)."""
        rem = self.n_layers - self.n_groups * len(self.block_pattern)
        return self.block_pattern[:rem]

    def validate(self) -> "ModelConfig":
        assert self.n_layers >= len(self.block_pattern) >= 1
        assert self.n_heads % max(self.n_kv_heads, 1) == 0
        if self.moe is not None:
            assert self.moe.top_k <= self.moe.n_experts
        return self

    def scaled_down(self, **overrides) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        pattern = self.block_pattern
        n_layers = max(len(pattern), 2 * len(pattern))
        small = dict(
            d_model=128,
            n_layers=n_layers,
            n_heads=4,
            n_kv_heads=max(1, 4 * self.n_kv_heads // max(self.n_heads, 1)),
            d_ff=256 if self.d_ff else 0,
            vocab=512,
            d_head=32,
            enc_layers=2 if self.enc_layers else 0,
            vision_tokens=8 if self.vision_tokens else 0,
            vit_dim=64 if self.vit_dim else 0,
            first_k_dense=min(self.first_k_dense, 1),
            dense_d_ff=256 if self.dense_d_ff else 0,
        )
        if self.moe is not None:
            small["moe"] = MoEConfig(
                n_experts=4, top_k=min(self.moe.top_k, 2),
                n_shared=min(self.moe.n_shared, 1), d_expert=64,
                every_k_layers=self.moe.every_k_layers)
        small.update(overrides)
        return dataclasses.replace(self, **small).validate()
