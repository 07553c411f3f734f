"""data — deterministic, host-shardable synthetic token pipeline."""

from repro_torch.data.pipeline import (DataConfig, make_batch_iterator,
                                       synthetic_batch)

__all__ = ["DataConfig", "make_batch_iterator", "synthetic_batch"]
