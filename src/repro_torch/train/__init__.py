"""train — the training step (loss, gradients, AdamW), the serving steps,
and `sharding` (the port of ``repro/train/sharding.py``: the partition
specs of parameters, batches and caches over the production mesh, and
their DTensor placements).  The steps run on one card, or on a mesh when
the parameters are DTensors.
"""

from repro_torch.train.serve_step import (generate, make_decode_step,
                                          make_prefill_step)
from repro_torch.train.train_step import (TrainHyper, TrainState,
                                          init_train_state, loss_fn,
                                          make_train_step)

__all__ = ["TrainState", "TrainHyper", "init_train_state", "make_train_step",
           "loss_fn", "make_prefill_step", "make_decode_step", "generate"]
