"""Neural-net building blocks of the dense and hybrid (Zamba2) paths.

The port of the subset of ``repro.models.layers`` that the dense and
hybrid families use, and ``gelu_mlp``, the block of the learned-selection
policy net.  RMSNorm goes to the ``rmsnorm`` kernel and prefill / training
attention to the ``flash_attention`` kernel; under autograd on the card
both run as ``torch.autograd.Function``s whose backwards are the
``rmsnorm_bwd`` and ``flash_attention_bwd`` kernels (the reference trains
through XLA's autodiff of these twins); the attention forward then also
keeps each row's log-sum-exp, from which its backward takes the softmax
(bf16 products on the tensor cores).  Single-token decode attention,
RoPE and the SwiGLU and GELU products stay plain PyTorch (and plain
autograd), as the reference leaves them to XLA.  Layouts are the
reference's: q (B, S, H, hd), k and v (B, T, K, hd).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import flash_attention
from ..kernels.rmsnorm import rmsnorm


def rms_norm(x, w, eps: float = 1e-5):
    return rmsnorm(x, w, eps=eps)


def matmul(x, w):
    """``x @ w`` in the promoted dtype of the two, as ``jnp.einsum`` does
    for mixed float32/bfloat16 operands."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt))


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    ang = positions[..., :, None].float() * freqs        # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def full_attention(q, k, v, *, causal: bool, q_offset=0):
    """Attention of q (B, S, H, hd) over k, v (B, T, K, hd), H = K * G, on
    the ``flash_attention`` kernel.  The kernel's causal mask has no query
    offset, which is the prefill from position 0."""
    if q_offset != 0:
        raise NotImplementedError("the flash_attention kernel has no query "
                                  "offset; prefill starts at position 0")
    return flash_attention(q, k, v, causal=causal)


def chunked_attention(q, k, v, *, causal: bool, q_offset=0,
                      kv_chunk: int = 2048):
    """The reference's memory-bounded online-softmax attention; here the
    ``flash_attention`` kernel, which never forms the (S, T) scores either
    (``kv_chunk`` is the reference's kv tile, kept for parity)."""
    return full_attention(q, k, v, causal=causal, q_offset=q_offset)


def decode_attention(q, k_cache, v_cache, cache_len):
    """Single-token decode: q (B, 1, H, hd) against (B, Smax, K, hd) caches
    with ``cache_len`` valid entries (a 0-d or (B,) tensor, or an int)."""
    B, _, H, hd = q.shape
    Smax, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    qg = (q.float() * scale).reshape(B, 1, K, G, hd)
    s = torch.einsum("bskgh,btkh->bkgst", qg, k_cache.float())
    pos = torch.arange(Smax, device=q.device)
    n = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    valid = pos[None, :] < n                              # (B or 1, Smax)
    s = s.masked_fill(~valid[:, None, None, None], float("-inf"))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", w, v_cache.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def swiglu(x, w_gate, w_up, w_down):
    g = matmul(x, w_gate)
    u = matmul(x, w_up)
    return matmul(F.silu(g) * u, w_down)


def gelu_mlp(x, w1, b1, w2, b2):
    """``gelu(x @ w1 + b1) @ w2 + b2`` with the tanh-approximate GELU, as
    ``jax.nn.gelu`` computes it by default."""
    h = F.gelu(matmul(x, w1) + b1, approximate="tanh")
    return matmul(h, w2) + b2
