"""repro_torch.checkpoint — atomic, asynchronous checkpoints in the
reference's on-disk format."""

from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
