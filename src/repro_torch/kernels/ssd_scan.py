"""Mamba2 SSD chunked scan: one CUDA kernel and its plain PyTorch version.

For x (b, S, nh, hp), positive steps dt (b, S, nh) float32, decay rates
A (nh,), and B, C (b, S, st) float32 shared by all heads (ngroups = 1), the
scan of ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T``, ``y_t = h_t C_t``
in its chunked form: within a chunk of ``chunk`` steps
``y = (C B^T ∘ L)(dt·x) + (C h_prev)·exp(cumsum dA)`` with
``L[i, j] = exp(cumsum dA_i - cumsum dA_j)`` for j <= i, and between chunks
``h = h·exp(Σ dA) + (x·exp(ΣdA - cumsum dA)·dt)^T B``.  Returns y in x's
dtype and the final state (b, nh, hp, st) in float32 — the function of the
Pallas TPU kernel ``repro.kernels.ssd_scan.ssd_scan`` and of the model's
XLA twin ``repro.models.ssm.ssd_chunked``, whose formulation the plain
version keeps.

The wrapper takes the plain version for tensors on the CPU and launches the
kernel (``csrc/ssd_scan.cu``) for tensors on a CUDA device; it never falls
back from one to the other.  ``ssd_scan.launches`` counts the wrapper's
calls that reach the card: one for a float32 x (one kernel), and one for a
bfloat16 x, whose chunk-parallel design runs three kernels in order on the
stream (chunk states, the pass over chunks, the output).

The gradient is the port's own kernel (``csrc/ssd_scan_bwd.cu``; the
reference differentiates ``ssd_chunked`` with XLA): ``ssd_scan_bwd`` gives
(dx, ddt, dA, dB, dC) from the inputs, the output's gradient and the final
state's, and counts ``ssd_scan_bwd.launches`` (one a call: three kernels in
order for a float32 x, five on the tensor cores for a bfloat16 x).  On the card, with autograd recording and an input that requires
grad, ``ssd_scan`` runs as a ``torch.autograd.Function`` whose backward is
that kernel; under ``no_grad`` it launches the forward alone, as serving
does.  ``ssd_scan_bwd_ref`` is its plain version, autograd through
:func:`ssd_scan_ref`.

On the ``meta`` device (the dry run, ``repro_torch.launch.dryrun``) the
wrappers take the card's route, checks and allocations included (but the
backward's workspace, whose size only the built library gives), and
where the card would launch they count the launch and report the
kernels' work (:func:`ssd_scan_cost`, :func:`ssd_scan_bwd_cost`) to the
open cost count instead, with no arithmetic.
"""

from __future__ import annotations

import ctypes

import torch

from ..launch.cost_analysis import kernel_cost
from .common import DTYPE_CODES, check, kernel_device, launch

_SOURCE = "ssd_scan.cu"
_BWD_SOURCE = "ssd_scan_bwd.cu"
#: the largest head width the kernel's 64-row tiles hold, the largest
#: state (its tiles hold 64 or 128 state columns, as the TPU kernel's), and
#: the longest chunk its shared cumulative sums hold
MAX_HEADDIM = 64
MAX_STATE = 128
MAX_CHUNK = 1024


def state_columns(st: int) -> int:
    """The state columns of the kernels' tiles for a state of ``st``: 64,
    or 128 above 64 (the narrower state zero-filled)."""
    return 64 if st <= 64 else 128


def _workspace_floats(b, S, nh, hp, st, chunk) -> int:
    """float32 values of the bfloat16 kernels' scratch (``Workspace`` in
    ``csrc/ssd_scan.cu``, which checks the size): each chunk's own state,
    each chunk's total decay, the state before each chunk as a bf16 hi/lo
    plane of 64 rows, B and C as planes (a plane row of kS state columns
    is kS float32 values), and cum and dt by head; each part rounded up to
    64 values."""
    def up(n):
        return -(-n // 64) * 64

    nc = S // chunk
    ks = state_columns(st)
    return (up(b * nc * nh * hp * st) + up(b * nc * nh)
            + b * nc * nh * 64 * ks + 2 * b * S * ks + 2 * up(b * S * nh))


def _bwd_workspace_floats(b, S, nh, hp, st, chunk, dtype) -> int:
    """float32 values of the backward kernels' scratch for x's ``dtype``:
    the end of that dtype's ``Workspace`` in ``csrc/ssd_scan_bwd.cu``, as
    its ``ssd_scan_bwd_workspace_floats`` gives it (the library is built
    at first use)."""
    from .build import load
    n = ctypes.c_longlong()
    rc = load(_BWD_SOURCE).ssd_scan_bwd_workspace_floats(
        b, S, nh, hp, st, chunk, DTYPE_CODES[dtype], ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"ssd_scan_bwd_workspace_floats failed with "
                           f"CUDA error {rc}")
    return n.value


def ssd_scan_cost(b, S, nh, hp, st, chunk, itemsize):
    """(operations, bytes) of one forward: per chunk C B^T over the causal
    pairs, per head and chunk the masked M x over them, C h and the
    chunk's state (2 operations a multiply-add); x read and y written in
    ``itemsize``, dt, A, B, C read and the final state written in
    float32, each once."""
    tri = chunk * (chunk + 1) // 2
    n_chunk = S // chunk
    ops = (b * n_chunk * tri * st * 2
           + b * n_chunk * nh * (tri * hp * 2 + 2 * chunk * st * hp * 2))
    nbytes = (2 * b * S * nh * hp * itemsize + b * S * nh * 4 + nh * 4
              + 2 * b * S * st * 4 + b * nh * hp * st * 4)
    return ops, nbytes


def ssd_scan_bwd_cost(b, S, nh, hp, st, chunk, itemsize):
    """(operations, bytes) of one backward: the gradient's own products,
    each counted once: per chunk C B^T and the two products of the heads'
    summed Pm with B and C over the causal pairs; per head and chunk dy
    x^T and (s o L)^T dy over the pairs, and the five state-wide products
    (the chunk's state, its gradient's part, H^T dy, G B and G^T x).  The
    bf16 kernels' hi/lo passes are not counted: the bound is the
    gradient's work, whatever the kernels' operand plan.  x, dy read and
    dx written in ``itemsize``; dt, A, B, C read and ddt, dA, dB, dC
    written in float32."""
    tri = chunk * (chunk + 1) // 2
    n_chunk = S // chunk
    ops = b * n_chunk * (3 * tri * st * 2
                         + nh * (2 * tri * hp * 2 + 5 * chunk * hp * st * 2))
    nbytes = (3 * b * S * nh * hp * itemsize + 2 * b * S * nh * 4
              + 2 * nh * 4 + 4 * b * S * st * 4)
    return ops, nbytes


def ssd_scan_ref(x, dt, A, B, C, *, chunk: int = 256):
    """Plain version: the chunked SSD of ``repro.models.ssm.ssd_chunked``,
    chunk = min(chunk, S), S a multiple of it.  It computes in float32 (in
    float64 for a float64 x, so that gradients can be checked
    numerically)."""
    b, S, nh, hp = x.shape
    st = B.shape[-1]
    chunk = min(chunk, S)
    nc = S // chunk
    if nc * chunk != S:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}")
    work = torch.promote_types(x.dtype, torch.float32)

    xc = x.reshape(b, nc, chunk, nh, hp)
    dtc = dt.reshape(b, nc, chunk, nh)
    Bc = B.reshape(b, nc, chunk, st)
    Cc = C.reshape(b, nc, chunk, st)

    dA = dtc * A[None, None, None, :]                      # (b,nc,Q,nh)
    dA_cum = torch.cumsum(dA, dim=2)
    dA_total = dA_cum[:, :, -1]                             # (b,nc,nh)
    xdt = xc.to(work) * dtc[..., None]                      # (b,nc,Q,nh,hp)

    # intra-chunk: L[i, j] = exp(cum_i - cum_j), lower-triangular
    cum = dA_cum.permute(0, 1, 3, 2)                        # (b,nc,nh,Q)
    tril = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                 device=x.device))
    seg = (cum[..., :, None] - cum[..., None, :]).masked_fill(
        ~tril, float("-inf"))
    L = torch.exp(seg)                                      # (b,nc,nh,Q,Q)
    scores = torch.einsum("bcis,bcjs->bcij", Cc, Bc)        # (b,nc,Q,Q)
    M = scores[:, :, None] * L
    Y_diag = torch.einsum("bchij,bcjhp->bcihp", M, xdt)

    # chunk states
    decay_to_end = torch.exp(dA_total[:, :, None, :] - dA_cum)
    S_c = torch.einsum("bcjs,bcjh,bcjhp->bchps", Bc, decay_to_end * dtc,
                       xc.to(work))                         # (b,nc,nh,hp,st)

    # inter-chunk recurrence: the state before each chunk
    h = torch.zeros((b, nh, hp, st), dtype=work, device=x.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * torch.exp(dA_total[:, c])[..., None, None] + S_c[:, c]
    h_prev = torch.stack(h_prevs, dim=1)                    # (b,nc,nh,hp,st)

    Y_off = torch.einsum("bcis,bchps,bcih->bcihp", Cc, h_prev,
                         torch.exp(dA_cum))
    y = (Y_diag + Y_off).reshape(b, S, nh, hp)
    return y.to(x.dtype), h


def _check_args(name, x, dt, A, B, C, chunk):
    """The device, the chunk cut to S and the widths, as the kernels take
    them; raises past the kernels' limits."""
    device = kernel_device(name, x)
    b, S, nh, hp = x.shape
    st = B.shape[-1]
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}")
    if hp > MAX_HEADDIM or st > MAX_STATE or chunk > MAX_CHUNK:
        raise ValueError(f"hp={hp}, st={st}, chunk={chunk} exceed the "
                         f"kernel's {MAX_HEADDIM}, {MAX_STATE}, {MAX_CHUNK}")
    f32 = torch.float32
    check("x", x, (f32, torch.bfloat16), (b, S, nh, hp), device)
    check("dt", dt, f32, (b, S, nh), device)
    check("A", A, f32, (nh,), device)
    check("B", B, f32, (b, S, st), device)
    check("C", C, f32, (b, S, st), device)
    return device, (b, S, nh, hp, st), chunk


def ssd_scan(x, dt, A, B, C, *, chunk: int = 256, head_block: int = 8):
    """x (b, S, nh, hp) float32 or bfloat16, dt (b, S, nh), A (nh,) and
    B, C (b, S, st) float32; hp <= 64, st <= 128, chunk = min(chunk, S)
    <= 1024 and a divisor of S.  Returns (y (b, S, nh, hp) in x's dtype, state
    (b, nh, hp, st) float32).  ``head_block`` is the TPU kernel's head
    tile, kept for parity: the bfloat16 kernels fix theirs at 4 heads a
    block, the float32 kernel runs one block per (batch, head).  On the
    card under autograd (an input requires grad) it is differentiated by
    :func:`ssd_scan_bwd`."""
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, A, B, C, chunk=chunk)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, dt, A, B, C)):
        return _SSDScan.apply(x, dt, A, B, C, chunk)
    return _forward(x, dt, A, B, C, chunk)


def _forward(x, dt, A, B, C, chunk):
    device, (b, S, nh, hp, st), chunk = _check_args("ssd_scan", x, dt, A, B,
                                                    C, chunk)
    f32 = torch.float32
    y = torch.empty_like(x)
    state = torch.empty((b, nh, hp, st), dtype=f32, device=device)
    if x.numel():
        n_ws = (_workspace_floats(b, S, nh, hp, st, chunk)
                if x.dtype == torch.bfloat16 else 0)
        ws = torch.empty(max(n_ws, 1), dtype=f32, device=device)
        if device.type == "meta":
            kernel_cost("ssd_scan", *ssd_scan_cost(
                b, S, nh, hp, st, chunk, x.element_size()), x.dtype)
        else:
            launch(_SOURCE, "ssd_scan_launch",
                   [t.data_ptr() for t in (x, dt, A, B, C, y, state, ws)]
                   + [n_ws, b, S, nh, hp, st, chunk, DTYPE_CODES[x.dtype]],
                   device)
        ssd_scan.launches += 1
    return y, state


def ssd_scan_bwd_ref(x, dt, A, B, C, dy, dstate=None, *, chunk: int = 256):
    """Plain version of the backward: (dx, ddt, dA, dB, dC) from autograd
    through :func:`ssd_scan_ref`, for the output gradient ``dy`` and the
    final state's gradient ``dstate`` (None: zero)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, dt, A, B, C)]
        y, state = ssd_scan_ref(*leaves, chunk=chunk)
        outs, grads = [y], [dy]
        if dstate is not None:
            outs.append(state)
            grads.append(dstate)
        return torch.autograd.grad(outs, leaves, grads)


def ssd_scan_bwd(x, dt, A, B, C, dy, dstate=None, *, chunk: int = 256):
    """The gradient of :func:`ssd_scan` at (x, dt, A, B, C) for the output
    gradient ``dy`` (x's shape and dtype) and the final state's gradient
    ``dstate`` ((b, nh, hp, st) float32, or None for zero): returns dx in
    x's dtype and ddt, dA, dB, dC in float32.  The limits are the
    forward's."""
    if x.device.type == "cpu":
        return ssd_scan_bwd_ref(x, dt, A, B, C, dy, dstate, chunk=chunk)
    device, (b, S, nh, hp, st), chunk = _check_args("ssd_scan_bwd", x, dt, A,
                                                    B, C, chunk)
    check("dy", dy, x.dtype, x.shape, device)
    if dstate is not None:
        check("dstate", dstate, torch.float32, (b, nh, hp, st), device)
    dx = torch.empty_like(x)
    ddt, dA, dB, dC = (torch.empty_like(t) for t in (dt, A, B, C))
    if not x.numel():
        return dx, ddt.zero_(), dA.zero_(), dB.zero_(), dC.zero_()
    if device.type == "meta":
        kernel_cost("ssd_scan_bwd", *ssd_scan_bwd_cost(
            b, S, nh, hp, st, chunk, x.element_size()), x.dtype)
        ssd_scan_bwd.launches += 1
        return dx, ddt, dA, dB, dC
    n_ws = _bwd_workspace_floats(b, S, nh, hp, st, chunk, x.dtype)
    ws = torch.empty(n_ws, dtype=torch.float32, device=device)
    launch(_BWD_SOURCE, "ssd_scan_bwd_launch",
           [t.data_ptr() for t in (x, dt, A, B, C, dy)]
           + [None if dstate is None else dstate.data_ptr()]
           + [t.data_ptr() for t in (dx, ddt, dA, dB, dC, ws)]
           + [n_ws, b, S, nh, hp, st, chunk, DTYPE_CODES[x.dtype]], device)
    ssd_scan_bwd.launches += 1
    return dx, ddt, dA, dB, dC


class _SSDScan(torch.autograd.Function):
    """The forward kernel, differentiated by the backward kernel (on CPU
    tensors, both plain versions)."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        return ssd_scan(x, dt, A, B, C, chunk=chunk)

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, B, C = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        if dstate is not None:
            dstate = dstate.contiguous()
        grads = ssd_scan_bwd(x, dt, A, B, C, dy, dstate, chunk=ctx.chunk)
        return (*grads, None)


ssd_scan.launches = 0
ssd_scan_bwd.launches = 0
WRAPPERS = (ssd_scan, ssd_scan_bwd)
