"""Pluggable simulation backends of the port.

>>> from repro_torch.sim.backends import get_backend
>>> get_backend("torch")       # batched engine on the card (CUDA kernels)
>>> get_backend("python")      # reference event-loop engine (host numpy)

``get_backend(None)`` resolves the default from the ``REPRO_SIM_BACKEND``
environment variable, falling back to ``"torch"`` — the port's entry points
run on the card (the reference falls back to its ``"python"`` engine).  A
name that is not registered raises ``ValueError``.  Backends are
process-wide singletons, so the schedule caches persist across sweeps.  An
instance of ``SimBackend`` passes through unchanged, which is how a caller
picks the device or the plain event core:
``sweep_portfolio(..., backend=TorchBatchedBackend(device="cpu"))``.

The batched engine's event core is itself selectable
(``TorchBatchedBackend(event_core=...)`` / ``REPRO_EVENT_CORE``): the CUDA
kernels through their wrappers, or their plain versions.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Union

from .base import (EVENT_CAP, BatchResult, InstancePerturb, InstanceSpec,
                   LockstepRequest, SimBackend, combined_pe_scale,
                   needs_closed_form, sigma_scale_of)

_FACTORIES: Dict[str, Callable[[], SimBackend]] = {}
_INSTANCES: Dict[str, SimBackend] = {}

#: env var naming the default backend
BACKEND_ENV = "REPRO_SIM_BACKEND"
DEFAULT_BACKEND = "torch"


def register_backend(name: str, factory: Callable[[], SimBackend]) -> None:
    _FACTORIES[name] = factory


def backend_names():
    return sorted(_FACTORIES)


def get_backend(name: Union[str, SimBackend, None] = None) -> SimBackend:
    """Resolve a backend by name (or pass an instance through)."""
    if isinstance(name, SimBackend):
        return name
    if name is None:
        name = os.environ.get(BACKEND_ENV, DEFAULT_BACKEND)
    name = name.lower()
    if name not in _FACTORIES:
        raise ValueError(
            f"unknown simulation backend {name!r}; "
            f"available: {backend_names()}")
    if name not in _INSTANCES:
        _INSTANCES[name] = _FACTORIES[name]()
    return _INSTANCES[name]


def _make_torch() -> SimBackend:
    from .torch_batched import TorchBatchedBackend
    return TorchBatchedBackend()


def _make_python() -> SimBackend:
    from .python import PythonBackend
    return PythonBackend()


register_backend("torch", _make_torch)
register_backend("python", _make_python)

__all__ = [
    "EVENT_CAP", "BatchResult", "InstancePerturb", "InstanceSpec",
    "LockstepRequest", "SimBackend", "combined_pe_scale", "needs_closed_form",
    "sigma_scale_of", "get_backend", "register_backend", "backend_names",
    "BACKEND_ENV", "DEFAULT_BACKEND",
]
