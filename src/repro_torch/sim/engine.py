"""The reference engine under its historical name — re-exports of
``repro_torch.sim.backends.python``, as ``repro.sim.engine`` re-exports the
reference's."""

from __future__ import annotations

from .backends.base import EVENT_CAP
from .backends.python import (H_ATOMIC_ADAPTIVE, MUTEX_ADAPTIVE,
                              InstanceResult, PythonBackend, run_instance)

__all__ = [
    "EVENT_CAP", "H_ATOMIC_ADAPTIVE", "MUTEX_ADAPTIVE", "InstanceResult",
    "PythonBackend", "run_instance",
]
