"""Architecture assembly: init / forward / logits for the hybrid family.

The port of ``repro.models.model`` for Zamba2 (family ``hybrid``): a stack
of Mamba2 layers with one *shared* attention + SwiGLU block applied after
every ``attn_every`` of them.  Parameters are plain dicts of tensors; the
Mamba2 layers are stacked with a leading L, as the reference stacks them,
and a Python loop over L takes the place of ``lax.scan``.  The reference's
sharding hints are no-ops on one device and are left out, as is remat
(this port serves; it does not train yet).  The other families wait for
their slice (ROADMAP queue 1).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Union

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from .layers import (apply_rope, decode_attention, full_attention, matmul,
                     rms_norm, swiglu)
from .ssm import init_ssm_layer, ssm_layer_apply

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


def _require_hybrid(cfg: ModelConfig) -> None:
    if cfg.family != "hybrid":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP queue 1); "
            "the port runs the hybrid family")


# ===========================================================================
# init
# ===========================================================================

def _normal(gen, shape, device):
    return torch.randn(shape, generator=gen, device=device)


def _init_attn(gen, cfg: ModelConfig, dtype, device):
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = 1.0 / math.sqrt(D)
    p = {
        "wq": (_normal(gen, (D, H * hd), device) * s).to(dtype),
        "wk": (_normal(gen, (D, K * hd), device) * s).to(dtype),
        "wv": (_normal(gen, (D, K * hd), device) * s).to(dtype),
        "wo": (_normal(gen, (H * hd, D), device) * s
               / math.sqrt(2 * max(cfg.n_layers, 1))).to(dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


def _init_dense_layer(gen, cfg: ModelConfig, dtype, device):
    D, Fd = cfg.d_model, cfg.d_ff
    s = 1.0 / math.sqrt(D)
    return {
        "ln1": torch.ones((D,), dtype=dtype, device=device),
        "ln2": torch.ones((D,), dtype=dtype, device=device),
        **_init_attn(gen, cfg, dtype, device),
        "w_gate": (_normal(gen, (D, Fd), device) * s).to(dtype),
        "w_up": (_normal(gen, (D, Fd), device) * s).to(dtype),
        "w_down": (_normal(gen, (Fd, D), device) * s
                   / math.sqrt(2 * max(cfg.n_layers, 1))).to(dtype),
    }


def padded_vocab(cfg: ModelConfig) -> int:
    """Embedding tables padded to a multiple of 256, as the reference pads
    them; padded ids are valid but unused."""
    return -(-cfg.vocab_size // 256) * 256


def init_params(cfg: ModelConfig, key: Union[int, torch.Generator], *,
                device: Optional[Union[str, torch.device]] = None) -> Dict:
    """Random parameters from ``key`` (a seed, or a ``torch.Generator`` on
    ``device``), on ``device`` (default the card).  The Mamba2 layers are
    stacked with a leading L: each layer is drawn and written into its slot
    of the stack, so the peak is one layer's float32 draw."""
    _require_hybrid(cfg)
    dev = resolve_device(device)
    gen = key
    if not isinstance(key, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(key))
    dtype = _dtype(cfg)
    D, V = cfg.d_model, padded_vocab(cfg)
    params: Dict = {
        "embed": (_normal(gen, (V, D), dev) / math.sqrt(D)).to(dtype),
        "final_norm": torch.ones((D,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = (_normal(gen, (D, V), dev)
                             / math.sqrt(D)).to(dtype)
    layers: Dict[str, torch.Tensor] = {}
    for i in range(cfg.n_layers):
        layer = init_ssm_layer(gen, cfg, dtype, dev)
        for name, t in layer.items():
            if name not in layers:
                layers[name] = torch.empty((cfg.n_layers,) + t.shape,
                                           dtype=t.dtype, device=dev)
            layers[name][i] = t
    params["layers"] = layers
    params["shared_attn"] = _init_dense_layer(gen, cfg, dtype, dev)
    return params


def layer_params(params: Dict, i: int) -> Dict:
    """Layer ``i`` of the stacked Mamba2 parameters (views, no copy)."""
    return {name: t[i] for name, t in params["layers"].items()}


# ===========================================================================
# attention block application
# ===========================================================================

def _attn_apply(p, cfg: ModelConfig, x, positions, *, causal=True,
                cache=None, cache_len=None):
    """Shared attention application.  Returns (out, (k, v)).

    Without a cache, the flash kernel (the reference picks its full or its
    chunked attention by length; both are the kernel's function).
    cache: (k_cache, v_cache) for decode (x is a single step); the step's
    k and v are written into the caches at ``cache_len`` in place, and the
    caches are returned."""
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = matmul(x, p["wq"]).reshape(B, S, H, hd)
    k = matmul(x, p["wk"]).reshape(B, S, K, hd)
    v = matmul(x, p["wv"]).reshape(B, S, K, hd)
    if cfg.qk_norm and "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if cache is not None:
        k_cache, v_cache = cache
        idx = torch.as_tensor(cache_len, device=x.device).reshape(1).long()
        k_cache.index_copy_(1, idx, k.to(k_cache.dtype))
        v_cache.index_copy_(1, idx, v.to(v_cache.dtype))
        o = decode_attention(q, k_cache, v_cache, idx + 1)
        kv_out = (k_cache, v_cache)
    else:
        o = full_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal)
        kv_out = (k, v)
    out = matmul(o.reshape(B, S, H * hd), p["wo"])
    return out, kv_out


def _dense_block(p, cfg, x, positions, collect_kv=False, cache=None,
                 cache_len=None):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    o, kv = _attn_apply(p, cfg, h, positions, cache=cache,
                        cache_len=cache_len)
    x = x + o
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    x = x + swiglu(h2, p["w_gate"], p["w_up"], p["w_down"])
    return (x, kv) if (collect_kv or cache is not None) else (x, None)


# ===========================================================================
# forward (prefill trunk)
# ===========================================================================

def forward(cfg: ModelConfig, params: Dict, tokens, *,
            attn_impl: str = "auto", collect_cache: bool = False):
    """Token trunk -> final hidden states (B, S, D).

    collect_cache: also return the per-segment caches (prefill path).
    ``attn_impl`` is the reference's choice of attention, kept for parity:
    every choice is the flash kernel here.
    Returns (hidden, cache_or_None, aux dict)."""
    _require_hybrid(cfg)
    B, S = tokens.shape
    x = params["embed"][tokens]
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x, cache = _hybrid_forward(cfg, params, x, positions, collect_cache)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, cache, {}


def _hybrid_forward(cfg, params, x, positions, collect_cache):
    """Zamba2: segments of ``attn_every`` Mamba2 layers, the *shared*
    attention block after each segment.  With collect_cache, returns
    ({"conv": (n_seg, attn_every, ...), "state": ...}, (k, v)) with k, v
    (n_seg, B, S, K, hd), the reference's layout."""
    n_seg = cfg.n_layers // cfg.attn_every
    if n_seg * cfg.attn_every != cfg.n_layers:
        raise ValueError("attn_every must divide n_layers")
    shared = params["shared_attn"]
    convs, states, ks, vs = [], [], [], []
    for s in range(n_seg):
        for j in range(cfg.attn_every):
            p = layer_params(params, s * cfg.attn_every + j)
            x, st = ssm_layer_apply(p, x, cfg, collect_state=collect_cache)
            if collect_cache:
                convs.append(st["conv"])
                states.append(st["state"])
        x, kv = _dense_block(shared, cfg, x, positions,
                             collect_kv=collect_cache)
        if collect_cache:
            ks.append(kv[0])
            vs.append(kv[1])
    if not collect_cache:
        return x, None
    seg = (n_seg, cfg.attn_every)
    conv = torch.stack(convs).reshape(seg + convs[0].shape)
    state = torch.stack(states).reshape(seg + states[0].shape)
    return x, ({"conv": conv, "state": state},
               (torch.stack(ks), torch.stack(vs)))


# ===========================================================================
# logits
# ===========================================================================

def _head(cfg, params):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def logits_fn(cfg, params, hidden):
    return matmul(hidden, _head(cfg, params))
