"""Flash attention: one CUDA kernel and its plain PyTorch version.

Causal or non-causal grouped-query attention of q (B, S, H, hd) over k, v
(B, T, K, hd), H % K == 0, query head h reading kv head ``h // (H / K)``:
scores in float32 scaled by ``1 / sqrt(hd)``, the causal mask
``kpos <= qpos`` with no offset, an online softmax, the sum in float32 and
the output in ``q.dtype``; a row with no key gives 0 (the denominator is
floored at 1e-30).  That is the function of the Pallas TPU kernel
``repro.kernels.flash_attention.flash_attention``.

The wrapper takes the plain version for tensors on the CPU and launches the
kernel (``csrc/flash_attention.cu``) for tensors on a CUDA device; it never
falls back from one to the other.  ``flash_attention.launches`` counts the
kernel launches.

Gradients: the reference trains through XLA's autodiff of the same
function (``repro.models.layers.full_attention``).  Here, on a CUDA device
and with autograd recording (``torch.is_grad_enabled()`` and an input that
requires grad), the forward kernel runs inside an autograd ``Function``: it
also stores each row's log-sum-exp (:func:`flash_attention_lse`), keeps q,
k, v, the output and that lse, and its backward is the
``flash_attention_bwd`` kernels (``csrc/flash_attention_bwd.cu``: p from
the saved lse, every product on the tensor cores in bf16, 1.4–1.6 ms
against a 0.26 ms bound at llama3.2-3b's training call on an H100 80GB
HBM3; ``flash_attention_bwd.launches``).  Otherwise (serving, under
``no_grad``) the forward launches as it is and stores no lse.  On the CPU
autograd goes through the plain version.

On DTensor arguments (the model stack on a device mesh,
``repro_torch.distributed.ctx``) the wrappers run the same kernels on
each rank's shards of q, k and v through ``local_map``: the batch may be
split over some mesh axes and the heads over others (k and v laid out as
q, so each rank holds the kv heads of its query heads), and the sequence
and the head dim are whole; any other layout raises.  The cost functions
then report the shards' work.

On the ``meta`` device (the dry run, ``repro_torch.launch.dryrun``) the
wrappers take the card's route, checks and allocations included, and
where the card would launch they count the launch and report the
kernel's work (:func:`flash_attention_cost`,
:func:`flash_attention_bwd_cost`) to the open cost count instead, with
no arithmetic.  The work is the kernels' own, not the plain version's:
masked (query, key) pairs are skipped, as the kernels skip masked tiles,
and the backward's five products include the recomputed scores.
"""

from __future__ import annotations

import functools
import math

import torch

from ..launch.cost_analysis import kernel_cost
from .common import (DTYPE_CODES, check, is_dtensor, kernel_device, launch,
                     on_shards)

_SOURCE = "flash_attention.cu"
_BWD_SOURCE = "flash_attention_bwd.cu"
#: the largest head dim the kernel holds (its tiles are sized for it)
MAX_HEAD_DIM = 128
NEG_INF = -1e30


def attention_pairs(S: int, T: int, causal: bool) -> int:
    """The (query, key) pairs S queries attend over T keys: all S x T, or
    under the causal mask (key <= query, no offset) each query q's
    min(q + 1, T)."""
    if not causal:
        return S * T
    m = min(S, T)
    return m * (m + 1) // 2 + (S - m) * T


def flash_attention_cost(B, S, T, H, K, hd, causal, itemsize,
                         with_lse=False):
    """(operations, bytes) of one forward: the score and value products,
    2 * hd operations each per attended pair and head; q, k, v read and o
    written once in ``itemsize``, and the float32 lse when it is
    stored."""
    ops = 4 * B * H * hd * attention_pairs(S, T, causal)
    nbytes = (2 * B * S * H * hd + 2 * B * T * K * hd) * itemsize
    return ops, nbytes + (4 * B * H * S if with_lse else 0)


def flash_attention_bwd_cost(B, S, T, H, K, hd, causal, itemsize):
    """(operations, bytes) of one backward: its five products (the scores
    recomputed, dp, dv, dq, dk), 2 * hd operations each per attended pair
    and head; q, k, v, o, do and the lse read and dq, dk, dv written
    once."""
    ops = 10 * B * H * hd * attention_pairs(S, T, causal)
    nbytes = (4 * B * S * H * hd + 4 * B * T * K * hd) * itemsize
    return ops, nbytes + 4 * B * H * S


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """Plain version: the whole (S, T) score matrix in float32."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    qg = (q.float() * scale).reshape(B, S, K, G, hd)
    s = torch.einsum("bskgh,btkh->bkgst", qg, k.float())
    if causal:
        valid = (torch.arange(T, device=q.device)[None, :]
                 <= torch.arange(S, device=q.device)[:, None])
        s = s.masked_fill(~valid, NEG_INF)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * valid
    else:
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgst,btkh->bskgh", p / den, v.float())
    return o.reshape(B, S, H, hd).to(q.dtype)


def flash_attention_lse_ref(q, k, v, *, causal: bool = True):
    """Plain version of the row log-sum-exp: float32 (B, H, S), the
    natural-log logsumexp of each row's masked, scaled scores, +inf for a
    row with no key."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    qg = (q.float() * scale).reshape(B, S, K, G, hd)
    s = torch.einsum("bskgh,btkh->bkgst", qg, k.float())
    if causal:
        valid = (torch.arange(T, device=q.device)[None, :]
                 <= torch.arange(S, device=q.device)[:, None])
        s = s.masked_fill(~valid, -math.inf)
    lse = torch.logsumexp(s, dim=-1)
    return lse.masked_fill(lse == -math.inf, math.inf).reshape(B, H, S)


def flash_attention(q, k, v, *, causal: bool = True, block_q: int = 256,
                    block_kv: int = 512):
    """q (B, S, H, hd), k/v (B, T, K, hd) with H % K == 0 and hd <= 128,
    float32 or bfloat16; returns (B, S, H, hd) in q's dtype.
    ``block_q``/``block_kv`` are the TPU kernel's tiles, kept for parity:
    the CUDA kernels' tiles are fixed (bfloat16: 128 queries by 64 keys on
    the tensor cores; float32: 64 by 32 on the CUDA cores)."""
    if is_dtensor(q):
        pl = _shard_placements(q, k, v)
        return on_shards(functools.partial(flash_attention, causal=causal),
                         (q, k, v), (pl, pl, pl), pl)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal)
    return _forward(q, k, v, causal)


def _check(name, q, k, v):
    """The device of q, k, v after the kernels' checks."""
    device = kernel_device(name, q)
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    if K == 0 or H % K:
        raise ValueError(f"H={H} is not a multiple of K={K}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} exceeds the kernel's "
                         f"{MAX_HEAD_DIM}")
    check("q", q, (torch.float32, torch.bfloat16), (B, S, H, hd), device)
    check("k", k, q.dtype, (B, T, K, hd), device)
    check("v", v, q.dtype, (B, T, K, hd), device)
    return device


def _shard_placements(q, k, v):
    """The placements of DTensor q, k and v, which must be one layout:
    on each mesh axis the whole tensor, or a shard of the batch (dim 0)
    or of the heads (dim 2)."""
    pl = tuple(q.placements)
    for p in pl:
        if not (p.is_replicate() or (p.is_shard() and p.dim in (0, 2))):
            raise ValueError(f"flash_attention runs on shards of the batch "
                             f"or the heads, not on {pl}")
    for name, t in (("k", k), ("v", v)):
        if not is_dtensor(t) or tuple(t.placements) != pl:
            raise ValueError(f"{name} must be laid out as q, {pl}")
    return pl


def _lse_placements(pl):
    """The row lse (B, H, S)'s placements for q's (B, S, H, hd)."""
    from torch.distributed.tensor import Shard
    return tuple(Shard(1) if p.is_shard(2) else p for p in pl)


def flash_attention_lse(q, k, v, *, causal: bool = True):
    """:func:`flash_attention` and the row log-sum-exp of its masked,
    scaled scores, float32 (B, H, S) (+inf for a row with no key): on a
    CUDA device one launch of the forward kernel that stores it, on the
    CPU the plain versions."""
    if is_dtensor(q):
        pl = _shard_placements(q, k, v)
        return on_shards(functools.partial(flash_attention_lse,
                                           causal=causal),
                         (q, k, v), (pl, pl, pl), (pl, _lse_placements(pl)))
    if q.device.type == "cpu":
        return (flash_attention_ref(q, k, v, causal=causal),
                flash_attention_lse_ref(q, k, v, causal=causal))
    return _forward(q, k, v, causal, with_lse=True)


def _forward(q, k, v, causal, with_lse=False):
    """The output, and with ``with_lse`` also the kernel's row lse."""
    device = _check("flash_attention", q, k, v)
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=device)
           if with_lse else None)
    if out.numel() and device.type == "meta":
        kernel_cost("flash_attention", *flash_attention_cost(
            B, S, T, H, K, hd, causal, q.element_size(), with_lse), q.dtype)
        flash_attention.launches += 1
    elif out.numel():
        launch(_SOURCE, "flash_attention_launch",
               [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), B, S, T, H, K, hd,
                DTYPE_CODES[q.dtype], int(causal), 1.0 / math.sqrt(hd)],
               device)
        flash_attention.launches += 1
    return (out, lse) if with_lse else out


def flash_attention_bwd_ref(q, k, v, o, do, *, causal: bool = True):
    """Plain version of the backward: (dq, dk, dv) from autograd through
    :func:`flash_attention_ref`, which recomputes the output (``o`` is not
    read)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = flash_attention_ref(*leaves, causal=causal)
        return torch.autograd.grad(out, leaves, do)


def flash_attention_bwd(q, k, v, o, do, lse, *, causal: bool = True):
    """The gradient of :func:`flash_attention` at (q, k, v), whose output
    is ``o`` and row log-sum-exp ``lse`` (:func:`flash_attention_lse`), for
    the output gradient ``do`` (q's shape and dtype): returns (dq, dk, dv)
    in q's dtype.  On a CUDA device ``lse`` is required (the kernels take p
    from it); the plain version on the CPU does not read it."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, do, causal=causal)
    device = _check("flash_attention_bwd", q, k, v)
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    check("o", o, q.dtype, q.shape, device)
    check("do", do, q.dtype, q.shape, device)
    if lse is None:
        raise ValueError("flash_attention_bwd on the card needs the "
                         "forward's lse (flash_attention_lse)")
    check("lse", lse, torch.float32, (B, H, S), device)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if not (S and T and B):
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty(B * H * S, dtype=torch.float32, device=device)
    if device.type == "meta":
        kernel_cost("flash_attention_bwd", *flash_attention_bwd_cost(
            B, S, T, H, K, hd, causal, q.element_size()), q.dtype)
        flash_attention_bwd.launches += 1
        return dq, dk, dv
    launch(_BWD_SOURCE, "flash_attention_bwd_launch",
           [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), B, S, T, H, K, hd,
            DTYPE_CODES[q.dtype], int(causal), 1.0 / math.sqrt(hd)], device)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The forward kernel, differentiated by the backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = _forward(q, k, v, causal, with_lse=True)
        # saved, not kept on ctx: a recomputed forward (remat) saves its own
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do.contiguous(), lse,
                                         causal=ctx.causal)
        return dq, dk, dv, None


flash_attention.launches = 0
flash_attention_bwd.launches = 0
WRAPPERS = (flash_attention, flash_attention_bwd)
