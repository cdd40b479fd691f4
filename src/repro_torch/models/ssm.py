"""Mamba2 — SSD (state-space duality) blocks [arXiv:2405.21060].

The port of ``repro.models.ssm``.  The full-sequence scan goes to the
``ssd_scan`` kernel (its plain version is the reference's chunked
formulation ``ssd_chunked``), the block's two RMSNorms to the ``rmsnorm``
kernel; the one-token decode recurrence and the causal conv stay plain
PyTorch, as the reference leaves them to XLA.

Training differentiates the block as the reference's ``jax.grad`` does,
with the kernels' backwards where it has kernels: on the card the scan's
gradient (x, dt, A, B, C) is the ``ssd_scan_bwd`` kernel and the norms'
the ``rmsnorm_bwd`` kernel (their autograd Functions); everything else —
``in_proj`` and ``out_proj``, the causal conv and its SiLU, the softplus
of dt, ``A = -exp(A_log)``, the skip ``D`` and the gate — is plain
autograd, as the reference leaves it to XLA.  On the CPU all of it is
autograd through the plain versions.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..kernels.rmsnorm import rmsnorm
from ..kernels.ssd_scan import ssd_scan
from .layers import matmul


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """SSD scan on the ``ssd_scan`` kernel.

    x:  (b, S, nh, hp)   per-head inputs
    dt: (b, S, nh)       positive step sizes (softplus'd)
    A:  (nh,)            negative decay rates
    B:  (b, S, st)       input projection (ngroups=1, shared across heads)
    C:  (b, S, st)       output projection
    Returns y: (b, S, nh, hp) and final state (b, nh, hp, st); the chunk
    is cut to S, which must be a multiple of it."""
    return ssd_scan(x, dt, A, B, C, chunk=chunk)


def ssd_decode_step(state, x_t, dt_t, A, B_t, C_t):
    """One-token recurrence.  state: (b, nh, hp, st); x_t: (b, nh, hp);
    dt_t: (b, nh); B_t/C_t: (b, st)."""
    dA = torch.exp(dt_t * A[None, :])                      # (b, nh)
    inc = torch.einsum("bhp,bs,bh->bhps", x_t, B_t, dt_t)
    state = state * dA[..., None, None] + inc
    y = torch.einsum("bhps,bs->bhp", state, C_t)
    return state, y.to(x_t.dtype)


def causal_conv1d(x, w, conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv.  x: (b, S, ch), w: (k, ch).
    Full-sequence path: returns (silu(y), the last k-1 inputs).  Decode
    path: pass conv_state (b, k-1, ch) and S == 1; returns
    (silu(y), new_state)."""
    k = w.shape[0]
    if conv_state is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
        S = x.shape[1]
        y = sum(xp[:, i:i + S] * w[i][None, None] for i in range(k))
        return F.silu(y), xp[:, -(k - 1):] if k > 1 else None
    window = torch.cat([conv_state, x], dim=1)             # (b, k, ch)
    y = torch.einsum("bkc,kc->bc", window, w.to(window.dtype))[:, None]
    return F.silu(y), window[:, 1:]


def rms_norm_local(x, w, eps):
    return rmsnorm(x, w, eps=eps)


def ssm_layer_apply(p: Dict, x, cfg, decode_cache: Optional[Dict] = None,
                    collect_state: bool = False):
    """One Mamba2 block. x: (b, S, D).

    p: {ln, in_proj, conv_w, A_log, D, gate_norm, out_proj, dt_bias}
    decode_cache: {"conv": (b, k-1, ch), "state": (b, nh, hp, st)} for
    S == 1.  collect_state: the full-sequence (prefill) path also returns
    the final {"conv", "state"} cache.  Returns (y, new_cache_or_None)."""
    b, S, _ = x.shape
    di, st, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads
    hp = cfg.ssm_headdim

    h = rms_norm_local(x, p["ln"], cfg.norm_eps)
    proj = matmul(h, p["in_proj"])
    z, xbc, dt_raw = torch.split(proj, [di, di + 2 * st, nh], dim=-1)
    if decode_cache is None:
        xbc, new_conv = causal_conv1d(xbc, p["conv_w"])
    else:
        xbc, new_conv = causal_conv1d(xbc, p["conv_w"], decode_cache["conv"])
    xs, B, C = torch.split(xbc, [di, st, st], dim=-1)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float()[None, None])
    A = -torch.exp(p["A_log"].float())                      # (nh,)
    xh = xs.reshape(b, S, nh, hp)

    if decode_cache is None:
        y, last_state = ssd_chunked(xh.contiguous(), dt.contiguous(), A,
                                    B.float().contiguous(),
                                    C.float().contiguous(), cfg.ssm_chunk)
        new_cache = ({"conv": new_conv, "state": last_state}
                     if collect_state else None)
    else:
        state, y1 = ssd_decode_step(decode_cache["state"], xh[:, 0].float(),
                                    dt[:, 0], A, B[:, 0].float(),
                                    C[:, 0].float())
        y = y1[:, None]
        new_cache = {"conv": new_conv, "state": state}

    y = y + xh * p["D"][None, None, :, None]
    y = y.reshape(b, S, di)
    # gated RMSNorm (Mamba2): norm(y * silu(z))
    y = rms_norm_local(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    out = matmul(y, p["out_proj"])
    return x + out.to(x.dtype), new_cache


def init_ssm_layer(gen: torch.Generator, cfg, dtype, device=None) -> Dict:
    """One Mamba2 block's parameters, drawn from ``gen`` (on ``device``,
    default the generator's)."""
    di, st, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads
    D = cfg.d_model
    device = gen.device if device is None else device
    d_proj = 2 * di + 2 * st + nh
    scale = 1.0 / math.sqrt(D)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)

    return {
        "ln": torch.ones((D,), dtype=dtype, device=device),
        "in_proj": (normal(D, d_proj) * scale).to(dtype),
        "conv_w": (normal(cfg.ssm_conv, di + 2 * st) * 0.5).to(dtype),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, device=device)
                           ).to(dtype),
        "D": torch.ones((nh,), dtype=dtype, device=device),
        "dt_bias": torch.zeros((nh,), dtype=dtype, device=device),
        "gate_norm": torch.ones((di,), dtype=dtype, device=device),
        "out_proj": (normal(di, D) * scale).to(dtype),
    }


__all__ = ["ssd_chunked", "ssd_decode_step",
           "causal_conv1d", "rms_norm_local", "ssm_layer_apply",
           "init_ssm_layer"]
