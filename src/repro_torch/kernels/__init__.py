"""repro_torch.kernels — hand-written CUDA kernels for Hopper (sm_90a) with
their plain PyTorch versions, one module each: ``event_loop``, ``rmsnorm``
(with its backward ``rmsnorm_bwd``), ``flash_attention`` (with
``flash_attention_bwd``) and ``ssd_scan``.

Each wrapper counts its kernel launches in ``<wrapper>.launches``;
:func:`launch_counts` reads all seven and :func:`reset_launch_counts` sets
them to 0.
"""

from typing import Dict

from . import event_loop, flash_attention, rmsnorm, ssd_scan
from .event_loop import (event_finish, event_finish_fused,
                         event_finish_fused_ref, event_finish_ref)

WRAPPERS = (event_loop.WRAPPERS + rmsnorm.WRAPPERS
            + flash_attention.WRAPPERS + ssd_scan.WRAPPERS)


def launch_counts() -> Dict[str, int]:
    return {fn.__name__: fn.launches for fn in WRAPPERS}


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


__all__ = [
    "event_finish", "event_finish_fused", "event_finish_fused_ref",
    "event_finish_ref", "launch_counts", "reset_launch_counts",
]
