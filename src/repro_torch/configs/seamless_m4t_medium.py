"""seamless-m4t-medium [arXiv:2308.11596]: encoder-decoder; the speech
frontend is a stub (input_specs provides precomputed frame embeddings)."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium",
        d_model=1024, n_layers=12, n_heads=16, n_kv_heads=16, d_head=64,
        d_ff=4096, vocab=256_206,
        block_pattern=("attn",),
        enc_layers=12, enc_seq_divisor=4,
        family="audio",
    ).validate()
