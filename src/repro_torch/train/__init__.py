"""train — the training step (loss, gradients, AdamW) and the serving steps.

The reference's ``train/sharding.py`` (partition specs of parameters and
batches over a TPU mesh) has no counterpart: the port trains and serves
on one card.
"""

from repro_torch.train.serve_step import (generate, make_decode_step,
                                          make_prefill_step)
from repro_torch.train.train_step import (TrainHyper, TrainState,
                                          init_train_state, loss_fn,
                                          make_train_step)

__all__ = ["TrainState", "TrainHyper", "init_train_state", "make_train_step",
           "loss_fn", "make_prefill_step", "make_decode_step", "generate"]
