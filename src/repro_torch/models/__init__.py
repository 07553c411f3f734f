"""models — the decoder-only architectures as ``nn.Module``s.

The port of ``repro/models``: one config-driven stack (`transformer.py`)
covers the dense and hybrid-recurrent decoder families through a
repeating ``block_pattern``; vision patches arrive as precomputed
embeddings.  `convert` carries parameters over from the reference's
parameter tree.  MoE, xLSTM and the encoder-decoder stack are not ported
yet (ROADMAP.md queue 1).
"""

from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.transformer import (
    Model,
    init_params,
    forward,
    prefill,
    init_cache,
    decode_step,
    param_count,
    active_param_count,
)

__all__ = [
    "ModelConfig", "MoEConfig", "Model", "init_params", "forward", "prefill",
    "init_cache", "decode_step", "param_count", "active_param_count",
]
