"""repro_torch.serving — continuous batching and the replica cost model."""

from .engine import ContinuousBatcher, ReplicaCostModel

__all__ = ["ContinuousBatcher", "ReplicaCostModel"]
