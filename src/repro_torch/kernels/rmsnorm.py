"""RMSNorm: one CUDA kernel and its plain PyTorch version.

``y = x * rsqrt(mean(x**2, -1) + eps) * w`` over the last axis, computed in
float32 and cast back to ``x.dtype`` — the function of the Pallas TPU
kernel ``repro.kernels.rmsnorm.rmsnorm``.  The wrapper takes the plain
version for tensors on the CPU and launches the kernel (``csrc/rmsnorm.cu``)
for tensors on a CUDA device; it never falls back from one to the other.
``rmsnorm.launches`` counts the kernel launches.  The kernel's launch
geometry is :func:`layout`'s, a pure function of the row count, the row
width and x's element size.

Gradients: the reference trains through XLA's autodiff of the same
function (``repro.models.layers.rms_norm``).  Here, on a CUDA device and
with autograd recording (``torch.is_grad_enabled()`` and an input that
requires grad), the forward kernel runs inside an autograd ``Function``
whose backward is the ``rmsnorm_bwd`` kernel of the same source
(``rmsnorm_bwd.launches``); otherwise the forward launches as it is.  On
the CPU autograd goes through the plain version.

On a DTensor x (the model stack on a device mesh) the wrapper runs
the same kernels on each rank's rows through ``local_map``: x's rows may
be split over any mesh axes, its last dim must be whole and w
replicated, and w's gradient comes back as partial sums over the axes
that split the rows; any other layout raises.

On the ``meta`` device (the dry run, ``repro_torch.launch.dryrun``) the
wrappers take the card's route, checks and allocations included, and
where the card would launch they count the launch and report the
kernel's work (:func:`rmsnorm_cost`, :func:`rmsnorm_bwd_cost`) to the open
cost count instead, with no arithmetic.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from ..launch.cost_analysis import kernel_cost
from .common import (DTYPE_CODES, check, is_dtensor, kernel_device, launch,
                     on_shards)

_SOURCE = "rmsnorm.cu"

#: streaming multiprocessors of the H100
SMS = 132
#: 16-byte chunks of a row a thread of the forward's row path holds (the
#: kernel takes 1 to 3)
MAX_CHUNKS = 3
#: the largest block of the forward's row path
ROW_THREADS = 512
#: the forward's wide path: a block of 256 threads a row, at most this many
#: blocks an SM
WIDE_THREADS, WIDE_BLOCKS_PER_SM = 256, 8


@dataclass(frozen=True)
class Layout:
    """The forward kernel's launch geometry.

    ``path``: ``"rows"`` (a row to each group of ``tpr`` threads,
    ``threads // tpr`` groups a block), ``"few"`` (too few rows to fill
    the SMs that way: a block a row, the row in one trip) or ``"wide"``
    (rows of more chunks than a block's threads hold: a block a row, the
    row walked twice).
    ``nv``: the 16-byte chunks of a row a thread holds (0 on the wide
    path); ``vec``: the elements of a chunk."""
    path: str
    tpr: int
    threads: int
    grid: int
    nv: int
    vec: int

    @property
    def groups(self) -> int:
        return self.threads // self.tpr


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def layout(rows: int, D: int, itemsize: int) -> Layout:
    """The forward's geometry for ``rows`` rows of ``D`` elements of
    ``itemsize`` bytes: a row to the fewest threads that hold it in at most
    ``MAX_CHUNKS`` 16-byte chunks each (a power of two below a warp, a
    multiple of 32 above), a few such groups a block; a whole block a row
    when that grid would leave SMs idle; and the wide path for rows of more
    than ``MAX_CHUNKS * ROW_THREADS`` chunks."""
    vec = 16 // itemsize
    chunks = _cdiv(D, vec)
    if chunks > MAX_CHUNKS * ROW_THREADS:
        return Layout("wide", WIDE_THREADS, WIDE_THREADS,
                      min(rows, SMS * WIDE_BLOCKS_PER_SM), 0, vec)
    need = _cdiv(chunks, MAX_CHUNKS)
    if need <= 32:
        tpr = 1 << (need - 1).bit_length()
    else:
        tpr = 32 * _cdiv(need, 32)
    groups = ROW_THREADS // tpr
    if _cdiv(rows, groups) < SMS:
        tpr = min(ROW_THREADS, 32 * _cdiv(chunks, 32))
        return Layout("few", tpr, tpr, rows, _cdiv(chunks, tpr), vec)
    return Layout("rows", tpr, groups * tpr, _cdiv(rows, groups),
                  _cdiv(chunks, tpr), vec)


def rmsnorm_cost(rows: int, D: int, itemsize: int, w_itemsize: int):
    """(operations, bytes) of one forward over ``rows`` rows of ``D``: x
    read and y written once in x's ``itemsize``, w read once; four
    operations an element (square, sum, scale, weight), on the CUDA
    cores."""
    return 4 * rows * D, 2 * rows * D * itemsize + D * w_itemsize


def rmsnorm_bwd_cost(rows: int, D: int, itemsize: int, w_itemsize: int):
    """(operations, bytes) of one backward: x and dy read and dx written
    once, w read and dw written once; ten operations an element."""
    return 10 * rows * D, 3 * rows * D * itemsize + 2 * D * w_itemsize


def rmsnorm_ref(x, w, *, eps: float = 1e-5):
    """Plain version: x (..., D) float32 or bfloat16, w (D,)."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * w.float()).to(x.dtype)


def rmsnorm(x, w, *, eps: float = 1e-5, block_rows: int = 256):
    """RMSNorm over the last axis of x (..., D) with weight w (D,); returns
    x's shape and dtype.  ``block_rows`` is the TPU kernel's row tile, kept
    for parity: the CUDA kernel's geometry is :func:`layout`'s."""
    if is_dtensor(x):
        return _on_rows(x, w, eps)
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps=eps)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _RMSNorm.apply(x, w, eps)
    return _forward(x, w, eps)


def _on_rows(x, w, eps):
    """:func:`rmsnorm` on each rank's rows of a DTensor x, w replicated."""
    from torch.distributed.tensor import Partial, Replicate
    pl = tuple(x.placements)
    if any(p.is_partial() or p.is_shard(x.ndim - 1) for p in pl):
        raise ValueError(f"rmsnorm runs on shards of the rows, not on {pl}")
    if not is_dtensor(w) or not all(p.is_replicate() for p in w.placements):
        raise ValueError("rmsnorm on shards needs w replicated")
    dw = tuple(Partial() if p.is_shard() else Replicate() for p in pl)
    return on_shards(functools.partial(rmsnorm, eps=eps), (x, w),
                     (pl, tuple(w.placements)), pl, (pl, dw))


def _forward(x, w, eps):
    device = kernel_device("rmsnorm", x)
    D = x.shape[-1]
    rows = x.numel() // max(D, 1)
    types = (torch.float32, torch.bfloat16)
    check("x", x, types, x.shape, device)
    check("w", w, types, (D,), device)
    out = torch.empty_like(x)
    if rows and device.type == "meta":
        kernel_cost("rmsnorm", *rmsnorm_cost(
            rows, D, x.element_size(), w.element_size()), None)
        rmsnorm.launches += 1
    elif rows:
        lay = layout(rows, D, x.element_size())
        launch(_SOURCE, "rmsnorm_launch",
               [x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, D,
                DTYPE_CODES[x.dtype], DTYPE_CODES[w.dtype], float(eps),
                lay.tpr, lay.threads, lay.grid, lay.nv], device)
        rmsnorm.launches += 1
    return out


def rmsnorm_bwd_ref(x, w, dy, *, eps: float = 1e-5):
    """Plain version of the backward: (dx, dw) from autograd through
    :func:`rmsnorm_ref`."""
    with torch.enable_grad():
        xg, wg = x.detach().requires_grad_(), w.detach().requires_grad_()
        return torch.autograd.grad(rmsnorm_ref(xg, wg, eps=eps), (xg, wg),
                                   dy)


#: the largest D of the backward kernel: rows wider than its registers
#: hold (12,288 bf16, 6,144 float32) keep their float32 partial sums of dw
#: in one block's shared memory
MAX_BWD_D = 227 * 1024 // 4 - 64
#: blocks of the backward's persistent grid, each summing its rows' share
#: of dw (one an SM of the H100)
_BWD_BLOCKS = SMS


def rmsnorm_bwd(x, w, dy, *, eps: float = 1e-5):
    """The gradient of :func:`rmsnorm` at (x, w) for the output gradient dy
    (x's shape and dtype): returns dx in x's dtype and dw (summed over the
    rows in float32) in w's."""
    if x.device.type == "cpu":
        return rmsnorm_bwd_ref(x, w, dy, eps=eps)
    device = kernel_device("rmsnorm_bwd", x)
    D = x.shape[-1]
    rows = x.numel() // max(D, 1)
    if D > MAX_BWD_D:
        raise ValueError(f"D={D} exceeds the backward kernel's {MAX_BWD_D}")
    types = (torch.float32, torch.bfloat16)
    check("x", x, types, x.shape, device)
    check("w", w, types, (D,), device)
    check("dy", dy, x.dtype, x.shape, device)
    dx = torch.empty_like(x)
    if not rows:
        return dx, torch.zeros_like(w)
    dw = torch.empty_like(w)
    parts = min(rows, _BWD_BLOCKS)
    ws = torch.empty((parts, D), dtype=torch.float32, device=device)
    if device.type == "meta":
        kernel_cost("rmsnorm_bwd", *rmsnorm_bwd_cost(
            rows, D, x.element_size(), w.element_size()), None)
        rmsnorm_bwd.launches += 1
        return dx, dw
    launch(_SOURCE, "rmsnorm_bwd_launch",
           [x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            dw.data_ptr(), ws.data_ptr(), rows, D, parts,
            DTYPE_CODES[x.dtype], DTYPE_CODES[w.dtype], float(eps)], device)
    rmsnorm_bwd.launches += 1
    return dx, dw


class _RMSNorm(torch.autograd.Function):
    """The forward kernel, differentiated by the backward kernel."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _forward(x, w, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(x, w, dy.contiguous(), eps=ctx.eps)
        return dx, dw, None


rmsnorm.launches = 0
rmsnorm_bwd.launches = 0
WRAPPERS = (rmsnorm, rmsnorm_bwd)
