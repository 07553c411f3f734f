"""optim — AdamW, the learning-rate schedule and gradient compression.

The port of ``repro/optim``.  A parameter set is a dict from name to
tensor (``dict(model.named_parameters())``, or any such dict): the port's
counterpart of the reference's pytree.
"""

from repro_torch.optim.adamw import (AdamWConfig, AdamWState, adamw_init,
                                     adamw_update, global_norm)
from repro_torch.optim.grad_compress import (CompressionConfig,
                                             compress_gradients,
                                             init_error_feedback, wire_bytes)
from repro_torch.optim.schedule import cosine_schedule

__all__ = [
    "AdamWConfig", "AdamWState", "adamw_init", "adamw_update", "global_norm",
    "cosine_schedule", "CompressionConfig", "compress_gradients",
    "init_error_feedback", "wire_bytes",
]
