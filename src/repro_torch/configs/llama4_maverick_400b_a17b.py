"""llama4-maverick-400b-a17b [hf:meta-llama/Llama-4 family; unverified tier]:
48L, 128 routed experts top-1 + 1 shared, MoE on alternating layers."""
from repro_torch.models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b",
        d_model=5120, n_layers=48, n_heads=40, n_kv_heads=8, d_head=128,
        d_ff=8192, vocab=202_048,
        block_pattern=("attn", "attn"),
        ffn_pattern=("dense", "moe"),     # MoE interleaved every other layer
        moe=MoEConfig(n_experts=128, top_k=1, n_shared=1, d_expert=8192,
                      every_k_layers=2),
        rope_theta=500_000.0,
        family="moe",
    ).validate()
