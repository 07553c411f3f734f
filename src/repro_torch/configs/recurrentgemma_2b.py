"""recurrentgemma-2b [arXiv:2402.19427]: Griffin — RG-LRU blocks with local
attention every third block (pattern rec,rec,attn_local; window 2048)."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        d_model=2560, n_layers=26, n_heads=10, n_kv_heads=1, d_head=256,
        d_ff=7680, vocab=256_000,
        block_pattern=("rec", "rec", "attn_local"),
        window=2048,
        embed_scale=True, tie_embeddings=True,
        conv_width=4,
        family="hybrid", subquadratic=True,
    ).validate()
