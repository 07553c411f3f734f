"""train — the serving steps (the training steps are not ported yet)."""

from repro_torch.train.serve_step import (generate, make_decode_step,
                                          make_prefill_step)

__all__ = ["make_prefill_step", "make_decode_step", "generate"]
