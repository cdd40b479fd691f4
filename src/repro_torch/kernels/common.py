"""What every kernel wrapper of the port shares: argument checks, the
dtype codes of the C entry points, the launch on the current stream, the
device a wrapper runs on (the card, or the meta device of the dry run),
and the call of a wrapper on each rank's shards of DTensor arguments."""

from __future__ import annotations

import sys
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


def is_dtensor(t) -> bool:
    """Whether ``t`` is a ``torch.distributed.tensor.DTensor``.  On the
    model's hot path with no mesh: a plain tensor is answered by its type
    alone, and nothing is imported (no DTensor exists before its module
    is)."""
    if type(t) is torch.Tensor:
        return False
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def on_shards(fn, args, in_placements, out_placements,
              in_grad_placements=None):
    """``fn`` on each rank's local shards of the DTensor ``args``, laid
    out as ``in_placements`` declares (an argument laid out otherwise
    raises: nothing is redistributed here), its results DTensors laid out
    as ``out_placements``; autograd goes through ``fn``'s own, and a
    gradient comes back as ``in_grad_placements`` declares (default: the
    argument's own)."""
    from torch.distributed.tensor import Placement
    from torch.distributed.tensor.experimental import local_map
    if out_placements and isinstance(out_placements[0], Placement):
        out_placements = (tuple(out_placements),)     # one result

    def dense(*local):
        # a DTensor's shard must be laid out as its global strides say:
        # results and gradients of fn (a plain version's einsum on the
        # CPU) are made contiguous, which the kernels' already are
        local = [_ContiguousGrad.apply(t)
                 if isinstance(t, torch.Tensor) and t.requires_grad else t
                 for t in local]
        return fn(*local)

    return local_map(dense, out_placements=out_placements,
                     in_placements=in_placements,
                     in_grad_placements=in_grad_placements,
                     device_mesh=args[0].device_mesh)(*args)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()
