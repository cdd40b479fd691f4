"""repro_torch.kernels — hand-written CUDA kernels for Hopper (sm_90a) with
their plain PyTorch versions."""

from .event_loop import (event_finish, event_finish_fused,
                         event_finish_fused_ref, event_finish_ref,
                         launch_counts, reset_launch_counts)

__all__ = [
    "event_finish", "event_finish_fused", "event_finish_fused_ref",
    "event_finish_ref", "launch_counts", "reset_launch_counts",
]
