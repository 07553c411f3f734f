"""gemma2-27b [arXiv:2408.00118]: local+global alternating attention,
attn/final logit softcaps, pre+post norm sandwich, window 4096."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b",
        d_model=4608, n_layers=46, n_heads=32, n_kv_heads=16, d_head=128,
        d_ff=36_864, vocab=256_000,
        block_pattern=("attn_local", "attn"),
        window=4096,
        attn_softcap=50.0, logit_softcap=30.0,
        post_norm=True, embed_scale=True, tie_embeddings=True,
        family="dense",
    ).validate()
