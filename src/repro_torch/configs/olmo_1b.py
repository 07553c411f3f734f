"""olmo-1b [arXiv:2402.00838]: non-parametric LayerNorm, tied embeddings."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b",
        d_model=2048, n_layers=16, n_heads=16, n_kv_heads=16, d_head=128,
        d_ff=8192, vocab=50_304,
        block_pattern=("attn",),
        nonparam_norm=True, tie_embeddings=True,
        family="dense",
    ).validate()
