"""Serving paths for every family: cache init, prefill, and single-token
decode.

The port of ``repro.models.decode``.  Cache layouts, as the reference's
(leading L = layer-stacked):

    dense/moe : {"k": (L, B, Smax, K, hd), "v": ..., "len": int32 0-d}
    ssm       : {"conv": (L, B, k-1, ch), "state": (L, B, nh, hp, st)
                 float32, "len"}
    hybrid    : the ssm entries, then "k", "v": (n_seg, B, Smax, K, hd)
    encdec    : the decoder's "k", "v" (L, B, Smax, K, hd), then the cross
                attention's "xk", "xv" (L, B, encoder_seq, K, hd)

the hybrid's shared attention block keeping one KV cache per segment.
Unlike the reference, whose arrays are immutable, ``decode_step`` writes
the new KV entries (and conv windows and states) into the cache's tensors
in place (a copy of a 4 GB KV stack, or of the 1.3 GB state stack, per
token at full width would be pure traffic) and returns the same dict with
``len`` advanced.  ``len`` stays on the device, so a decode loop never
waits for the host.  ``prefill(..., max_len=n)`` builds the cache with n
positions at once (see ``model.forward``).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from .layers import layer_norm, rms_norm
from .model import (_check_family, _decoder_layer, _dense_block, _dtype,
                    _moe_block_apply, _sinusoid_at, forward, layer_params,
                    last_hidden, logits_fn)
from .ssm import ssm_layer_apply


class TensorSpec(NamedTuple):
    """Shape and dtype of one cache entry (the reference's
    ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def decode_cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                       dtype=None) -> Dict[str, TensorSpec]:
    """The cache's entries as shapes and dtypes, in the reference's
    order."""
    _check_family(cfg)
    dt = dtype or _dtype(cfg)
    L, B = cfg.n_layers, batch
    out = {"len": TensorSpec((), torch.int32)}
    if cfg.family in ("ssm", "hybrid"):
        ch = cfg.d_inner + 2 * cfg.ssm_state
        out["conv"] = TensorSpec((L, B, cfg.ssm_conv - 1, ch), dt)
        out["state"] = TensorSpec((L, B, cfg.ssm_nheads, cfg.ssm_headdim,
                                   cfg.ssm_state), torch.float32)
    if cfg.family == "ssm":
        return out
    n_kv = cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else L
    kv = (n_kv, B, max_len, cfg.n_kv_heads, cfg.head_dim)
    out["k"] = TensorSpec(kv, dt)
    out["v"] = TensorSpec(kv, dt)
    if cfg.family == "encdec":
        xkv = (L, B, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim)
        out["xk"] = TensorSpec(xkv, dt)
        out["xv"] = TensorSpec(xkv, dt)
    return out


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

def prefill(cfg: ModelConfig, params: Dict, tokens, *, embeds=None,
            attn_impl: str = "auto", max_len: Optional[int] = None):
    """Full-sequence pass that materializes the caches and the
    last-position logits.  The KV caches hold ``max_len`` positions
    (default the prompt's S), zero past S; the enc-dec family's cross
    caches hold the encoder's ``embeds`` frames.  Returns (logits (B, V),
    cache)."""
    hidden, kvs, _ = forward(cfg, params, tokens, embeds=embeds,
                             attn_impl=attn_impl, collect_cache=True,
                             max_len=max_len)
    S = tokens.shape[1]
    cache = {"len": torch.tensor(S, dtype=torch.int32, device=tokens.device)}
    if cfg.family == "ssm":
        cache["conv"], cache["state"] = kvs["conv"], kvs["state"]
    elif cfg.family == "hybrid":
        states, kvs = kvs
        flat = lambda a: a.reshape((-1,) + a.shape[2:])  # noqa: E731
        cache["conv"] = flat(states["conv"])
        cache["state"] = flat(states["state"])
        cache["k"], cache["v"] = kvs
    elif cfg.family == "encdec":
        (cache["k"], cache["v"]), cache["xk"], cache["xv"] = kvs
    else:
        cache["k"], cache["v"] = kvs
    logits = logits_fn(cfg, params, last_hidden(hidden))[:, 0]
    return logits, cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def decode_step(cfg: ModelConfig, params: Dict, cache: Dict, token,
                ) -> Tuple[torch.Tensor, Dict]:
    """One new token for every sequence in the batch.

    token: (B,) integer.  Returns (logits (B, V), cache), the cache updated
    in place (see the module docstring)."""
    _check_family(cfg)
    B = token.shape[0]
    x = params["embed"][token.long()][:, None, :]          # (B, 1, D)
    pos = cache["len"].reshape(1, 1).expand(B, 1)          # rotary families
    if cfg.family == "encdec":
        x = _encdec_decode(cfg, params, cache, x)
        x = layer_norm(x, params["final_norm"], params["final_norm_b"],
                       cfg.norm_eps)
    else:
        if cfg.family == "ssm":
            for i in range(cfg.n_layers):
                x = _ssm_decode_layer(cfg, params, cache, i, x)
        elif cfg.family == "hybrid":
            x = _hybrid_decode(cfg, params, cache, x, pos)
        else:
            block = (_dense_block if cfg.family == "dense"
                     else _moe_block_apply)
            for i in range(cfg.n_layers):
                x = block(layer_params(params, i), cfg, x, pos,
                          cache=(cache["k"][i], cache["v"][i]),
                          cache_len=cache["len"])[0]
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_fn(cfg, params, x)[:, 0]
    cache["len"] = cache["len"] + 1
    return logits, cache


def _ssm_decode_layer(cfg, params, cache, i, x):
    """Mamba2 layer ``i`` on one step, its conv window and state written
    into the cache in place."""
    x, c2 = ssm_layer_apply(layer_params(params, i), x, cfg,
                            decode_cache={"conv": cache["conv"][i],
                                          "state": cache["state"][i]})
    cache["conv"][i].copy_(c2["conv"])
    cache["state"][i].copy_(c2["state"])
    return x


def _hybrid_decode(cfg, params, cache, x, pos):
    """The hybrid stack's decode: each Mamba2 layer's conv window and state
    and each segment's KV entry written into the cache in place."""
    n_seg = cfg.n_layers // cfg.attn_every
    shared = params["shared_attn"]
    for s in range(n_seg):
        for j in range(cfg.attn_every):
            x = _ssm_decode_layer(cfg, params, cache, s * cfg.attn_every + j,
                                  x)
        x, _ = _dense_block(shared, cfg, x, pos,
                            cache=(cache["k"][s], cache["v"][s]),
                            cache_len=cache["len"])
    return x


def _encdec_decode(cfg, params, cache, x):
    """Whisper's decoder on one step: the sinusoid at ``len`` added in x's
    dtype, then each layer's self-attention over its KV cache (the step's
    k, v written in place) and cross attention over its (xk, xv), on the
    flash kernel with one query, as the reference's full attention."""
    x = x + _sinusoid_at(cache["len"].reshape(1), cfg.d_model)[None].to(
        x.dtype)
    for i in range(cfg.n_layers):
        x, _ = _decoder_layer(cfg, layer_params(params, i, "dec_layers"), x,
                              (cache["xk"][i], cache["xv"][i]),
                              cache=(cache["k"][i], cache["v"][i]),
                              cache_len=cache["len"])
    return x


__all__ = ["TensorSpec", "decode_cache_specs", "init_decode_cache",
           "prefill", "decode_step"]
