"""qwen3-1.7b [hf:Qwen/Qwen3 family]: GQA + qk-norm, tied embeddings."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-1.7b",
        d_model=2048, n_layers=28, n_heads=16, n_kv_heads=8, d_head=128,
        d_ff=6144, vocab=151_936,
        block_pattern=("attn",),
        qk_norm=True, rope_theta=1_000_000.0, tie_embeddings=True,
        family="dense",
    ).validate()
