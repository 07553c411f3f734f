"""deepseek-moe-16b [arXiv:2401.06066]: fine-grained MoE, 2 shared + 64
routed top-6 experts, first layer dense."""
from repro_torch.models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b",
        d_model=2048, n_layers=28, n_heads=16, n_kv_heads=16, d_head=128,
        d_ff=1408, vocab=102_400,
        block_pattern=("attn",),
        moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_expert=1408),
        first_k_dense=1, dense_d_ff=10_944,
        rope_theta=10_000.0,
        family="moe",
    ).validate()
