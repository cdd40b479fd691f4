"""RMSNorm: one CUDA kernel and its plain PyTorch version.

``y = x * rsqrt(mean(x**2, -1) + eps) * w`` over the last axis, computed in
float32 and cast back to ``x.dtype`` — the function of the Pallas TPU
kernel ``repro.kernels.rmsnorm.rmsnorm``.  The wrapper takes the plain
version for tensors on the CPU and launches the kernel (``csrc/rmsnorm.cu``)
for tensors on a CUDA device; it never falls back from one to the other.
``rmsnorm.launches`` counts the kernel launches.
"""

from __future__ import annotations

import torch

from .common import DTYPE_CODES, check, cuda_device, launch

_SOURCE = "rmsnorm.cu"


def rmsnorm_ref(x, w, *, eps: float = 1e-5):
    """Plain version: x (..., D) float32 or bfloat16, w (D,)."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * w.float()).to(x.dtype)


def rmsnorm(x, w, *, eps: float = 1e-5, block_rows: int = 256):
    """RMSNorm over the last axis of x (..., D) with weight w (D,); returns
    x's shape and dtype.  ``block_rows`` is the TPU kernel's row tile, kept
    for parity: the CUDA kernel takes one row per block."""
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps=eps)
    device = cuda_device("rmsnorm", x)
    D = x.shape[-1]
    rows = x.numel() // max(D, 1)
    types = (torch.float32, torch.bfloat16)
    check("x", x, types, x.shape, device)
    check("w", w, types, (D,), device)
    out = torch.empty_like(x)
    if rows:
        launch(_SOURCE, "rmsnorm_launch",
               [x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, D,
                DTYPE_CODES[x.dtype], DTYPE_CODES[w.dtype], float(eps)],
               device)
        rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
WRAPPERS = (rmsnorm,)
