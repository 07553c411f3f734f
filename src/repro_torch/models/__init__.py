"""models — the ten assigned architectures as ``nn.Module``s.

The port of ``repro/models``: one config-driven decoder stack
(`transformer.py`) covers the dense, MoE (`moe.py`), hybrid-recurrent
(`rglru.py`) and xLSTM (`xlstm.py`) families through a repeating
``block_pattern``; `encdec.py` is the encoder-decoder (audio) stack, and
`api` dispatches between the two.  Vision patches and audio frames arrive
as precomputed embeddings.  `convert` carries parameters over from the
reference's parameter tree.
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
