"""Serving paths for the hybrid family: cache init, prefill, and
single-token decode.

The port of ``repro.models.decode`` (hybrid branch).  Cache layout, as the
reference's (leading L = layer-stacked):

    {"conv": (L, B, k-1, ch), "state": (L, B, nh, hp, st) float32,
     "k": (n_seg, B, Smax, K, hd), "v": ..., "len": int32 0-d tensor}

the shared attention block keeping one KV cache per segment.  Unlike the
reference, whose arrays are immutable, ``decode_step`` writes the new conv
windows, states and KV entries into the cache's tensors in place (a copy
of the 1.2 GB state stack per token at full width would be pure traffic)
and returns the same dict with ``len`` advanced.  ``len`` stays on the
device, so a decode loop never waits for the host.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from .layers import rms_norm
from .model import (_dense_block, _dtype, _require_hybrid, forward,
                    layer_params, logits_fn)
from .ssm import ssm_layer_apply


class TensorSpec(NamedTuple):
    """Shape and dtype of one cache entry (the reference's
    ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def decode_cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                       dtype=None) -> Dict[str, TensorSpec]:
    """The cache's entries as shapes and dtypes."""
    _require_hybrid(cfg)
    dt = dtype or _dtype(cfg)
    L, B = cfg.n_layers, batch
    n_seg = cfg.n_layers // cfg.attn_every
    ch = cfg.d_inner + 2 * cfg.ssm_state
    kv = (n_seg, B, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "len": TensorSpec((), torch.int32),
        "conv": TensorSpec((L, B, cfg.ssm_conv - 1, ch), dt),
        "state": TensorSpec((L, B, cfg.ssm_nheads, cfg.ssm_headdim,
                             cfg.ssm_state), torch.float32),
        "k": TensorSpec(kv, dt),
        "v": TensorSpec(kv, dt),
    }


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=None, *, device=None) -> Dict:
    """Zero-filled cache on ``device`` (default the card)."""
    dev = resolve_device(device)
    return {name: torch.zeros(s.shape, dtype=s.dtype, device=dev)
            for name, s in decode_cache_specs(cfg, batch, max_len,
                                              dtype).items()}


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def prefill(cfg: ModelConfig, params: Dict, tokens, *,
            attn_impl: str = "auto"):
    """Full-sequence pass that materializes the caches and the
    last-position logits.  Returns (logits (B, V), cache)."""
    hidden, (states, (k, v)), _ = forward(cfg, params, tokens,
                                          attn_impl=attn_impl,
                                          collect_cache=True)
    S = tokens.shape[1]
    flat = lambda a: a.reshape((-1,) + a.shape[2:])  # noqa: E731
    cache = {
        "len": torch.tensor(S, dtype=torch.int32, device=tokens.device),
        "conv": flat(states["conv"]),
        "state": flat(states["state"]),
        "k": k,
        "v": v,
    }
    logits = logits_fn(cfg, params, hidden[:, -1:, :])[:, 0]
    return logits, cache


def pad_cache(cache: Dict, max_len: int) -> Dict:
    """The cache with its KV entries zero-padded along the sequence to
    ``max_len`` slots, so that decode can append to a prefill's cache."""
    out = dict(cache)
    for name in ("k", "v"):
        a = cache[name]
        pad = max_len - a.shape[2]
        if pad < 0:
            raise ValueError(f"cache holds {a.shape[2]} > {max_len} slots")
        out[name] = torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
    return out


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def decode_step(cfg: ModelConfig, params: Dict, cache: Dict, token,
                ) -> Tuple[torch.Tensor, Dict]:
    """One new token for every sequence in the batch.

    token: (B,) integer.  Returns (logits (B, V), cache), the cache updated
    in place (see the module docstring)."""
    _require_hybrid(cfg)
    B = token.shape[0]
    x = params["embed"][token.long()][:, None, :]          # (B, 1, D)
    pos = cache["len"].reshape(1, 1).expand(B, 1)
    n_seg = cfg.n_layers // cfg.attn_every
    shared = params["shared_attn"]
    for s in range(n_seg):
        for j in range(cfg.attn_every):
            i = s * cfg.attn_every + j
            x, c2 = ssm_layer_apply(layer_params(params, i), x, cfg,
                                    decode_cache={"conv": cache["conv"][i],
                                                  "state": cache["state"][i]})
            cache["conv"][i].copy_(c2["conv"])
            cache["state"][i].copy_(c2["state"])
        x, _ = _dense_block(shared, cfg, x, pos,
                            cache=(cache["k"][s], cache["v"][s]),
                            cache_len=cache["len"])
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_fn(cfg, params, x)[:, 0]
    cache["len"] = cache["len"] + 1
    return logits, cache


__all__ = ["TensorSpec", "decode_cache_specs", "init_decode_cache",
           "prefill", "pad_cache", "decode_step"]
