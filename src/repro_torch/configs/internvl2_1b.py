"""internvl2-1b [arXiv:2404.16821]: Qwen2-0.5B LM backbone + InternViT
frontend stub (input_specs provides precomputed patch embeddings that a
learned projector maps into the LM width)."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b",
        d_model=896, n_layers=24, n_heads=14, n_kv_heads=2, d_head=64,
        d_ff=4864, vocab=151_655,
        block_pattern=("attn",),
        rope_theta=1_000_000.0, tie_embeddings=True,
        vision_tokens=256, vit_dim=1024,
        family="vlm",
    ).validate()
