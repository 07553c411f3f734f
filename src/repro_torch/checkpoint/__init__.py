"""checkpoint — atomic, keep-N save and restore of training state."""

from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
