"""xlstm-125m [arXiv:2405.04517]: mLSTM + sLSTM blocks (3:1 ratio), no
separate FFN (d_ff=0; width lives in the block projections)."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m",
        d_model=768, n_layers=12, n_heads=4, n_kv_heads=4, d_head=192,
        d_ff=0, vocab=50_304,
        block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
        tie_embeddings=True,
        conv_width=4,
        family="ssm", subquadratic=True,
    ).validate()
