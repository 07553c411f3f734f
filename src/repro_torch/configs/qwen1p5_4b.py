"""qwen1.5-4b [hf:Qwen/Qwen1.5 family]: QKV bias, full MHA (kv=heads)."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b",
        d_model=2560, n_layers=40, n_heads=20, n_kv_heads=20, d_head=128,
        d_ff=6912, vocab=151_936,
        block_pattern=("attn",),
        qkv_bias=True, rope_theta=5_000_000.0,
        family="dense",
    ).validate()
