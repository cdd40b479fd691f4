"""What every kernel wrapper of the port shares: argument checks, the
dtype codes of the C entry points, the launch on the current stream, and
the device a wrapper runs on (the card, or the meta device of the dry
run)."""

from __future__ import annotations

from typing import Sequence

import torch

#: dtype codes the C entry points take
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    """Raise unless ``t`` lies on ``device`` with ``dtype`` (one dtype or a
    tuple of them) and ``shape``, contiguous."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected "
                        f"{' or '.join(map(str, dtypes))}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(source: str, fn_name: str, args: Sequence, device) -> None:
    """Call one C entry point of ``source`` on the device's current stream;
    raise if it reports a CUDA error (a refused launch never runs)."""
    from .build import load
    lib = load(source)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = getattr(lib, fn_name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} failed with CUDA error {rc}")


def cuda_device(name: str, t: torch.Tensor) -> torch.device:
    """The CUDA device of ``t``; raises for any other device type."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {t.device}")
    return t.device


def kernel_device(name: str, t: torch.Tensor) -> torch.device:
    """The device a model kernel's wrapper runs ``t`` on: its CUDA device,
    or the ``meta`` device, where the wrapper takes the card's route and,
    where the card would launch, reports its kernel's work to the open
    cost count (``repro_torch.launch.cost_analysis.kernel_cost``); raises
    for any other device type."""
    if t.device.type == "meta":
        return t.device
    return cuda_device(name, t)
