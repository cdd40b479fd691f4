"""repro_torch — the PyTorch/CUDA port of the OpenMP scheduling-selection
simulator, beside the JAX reference package ``repro``.

The port imports torch, numpy and the standard library only.  Its entry
points run on the card (``torch.device("cuda")``) and raise when there is
none; the CPU is used only when a caller passes ``device="cpu"``.
"""

from .device import KERNEL_CAPABILITY, resolve_device
from .sim.backends import get_backend, register_backend
from .sim.backends.torch_batched import TorchBatchedBackend
from .sim.campaign import PortfolioSweep, run_fixed, sweep_portfolio

__all__ = [
    "KERNEL_CAPABILITY", "resolve_device", "get_backend",
    "register_backend", "TorchBatchedBackend", "PortfolioSweep",
    "run_fixed", "sweep_portfolio",
]
