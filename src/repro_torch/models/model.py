"""Architecture assembly: init / forward / logits / loss for the dense,
MoE and hybrid families.

The port of ``repro.models.model`` for three families: ``dense``
(llama-style: a stack of attention + SwiGLU blocks, served, and trained
here; qwen2-vl's backbone is one, with M-RoPE), ``moe`` (the same
attention with a top-k mixture of SwiGLU experts, served) and ``hybrid``
(Zamba2: a stack of Mamba2 layers with one *shared* attention + SwiGLU
block applied after every ``attn_every`` of them, served).  Parameters are
plain dicts of tensors; the layers are stacked with a leading L, as the
reference stacks them, and a Python loop over L takes the place of
``lax.scan``: a forward takes each stack apart once with ``unbind(0)``
(views, and one stacked gradient in the backward).  With ``cfg.remat``
each block runs under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint``), and the loss is the reference's blockwise
cross-entropy, each sequence chunk checkpointed.  The reference's sharding
hints are no-ops on one device and are left out
(``repro_torch.distributed.ctx``).  The ssm and encdec families wait for
their slice (ROADMAP queue 1).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Union

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..distributed.ctx import moe_groups
from .layers import (apply_mrope, apply_rope, decode_attention,
                     full_attention, matmul, moe_block, rms_norm, swiglu)
from .ssm import init_ssm_layer, ssm_layer_apply

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: the families whose init, forward, loss, caches, prefill and decode are
#: ported
PORTED_FAMILIES = ("dense", "moe", "hybrid")
CE_CHUNK = 512                # sequence chunk for the blockwise CE loss


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP queue 1); "
            f"the port runs and serves the {', '.join(PORTED_FAMILIES)} "
            "families")


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


def _init_moe_layer(gen, cfg: ModelConfig, dtype, device):
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    s = 1.0 / math.sqrt(D)
    return {
        "ln1": torch.ones((D,), dtype=dtype, device=device),
        "ln2": torch.ones((D,), dtype=dtype, device=device),
        **_init_attn(gen, cfg, dtype, device),
        "router": (_normal(gen, (D, E), device) * s).to(dtype),
        "we_gate": (_normal(gen, (E, D, Fd), device) * s).to(dtype),
        "we_up": (_normal(gen, (E, D, Fd), device) * s).to(dtype),
        "we_down": (_normal(gen, (E, Fd, D), device) * s
                    / math.sqrt(2 * cfg.n_layers)).to(dtype),
    }


_INIT_LAYER = {"dense": _init_dense_layer, "moe": _init_moe_layer,
               "hybrid": init_ssm_layer}


def padded_vocab(cfg: ModelConfig) -> int:
    """Embedding tables padded to a multiple of 256, as the reference pads
    them; padded ids are valid but unused."""
    return -(-cfg.vocab_size // 256) * 256


def init_params(cfg: ModelConfig, key: Union[int, torch.Generator], *,
                device: Optional[Union[str, torch.device]] = None) -> Dict:
    """Random parameters from ``key`` (a seed, or a ``torch.Generator`` on
    ``device``), on ``device`` (default the card).  The layers (dense or
    MoE blocks, or Mamba2 layers) are stacked with a leading L: each layer is
    drawn and written into its slot of the stack, so the peak is one
    layer's float32 draw (an expert stack's, for the MoE family).
    ``device="meta"`` gives the tree's structure, shapes and dtypes alone,
    holding no memory (a restore's template)."""
    _require_ported(cfg)
    meta = device is not None and torch.device(device).type == "meta"
    dev = torch.device("meta") if meta else resolve_device(device)
    gen = key
    if not isinstance(key, torch.Generator):
        gen = torch.Generator(device="cpu" if meta else dev
                              ).manual_seed(int(key))
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
        layer = _INIT_LAYER[cfg.family](gen, cfg, dtype, dev)
        for name, t in layer.items():
            if name not in layers:
                layers[name] = torch.empty((cfg.n_layers,) + t.shape,
                                           dtype=t.dtype, device=dev)
            layers[name][i] = t
    params["layers"] = layers
    if cfg.family == "hybrid":
        params["shared_attn"] = _init_dense_layer(gen, cfg, dtype, dev)
    return params


def layer_params(params: Dict, i: int) -> Dict:
    """Layer ``i`` of the stacked parameters (views, no copy)."""
    return {name: t[i] for name, t in params["layers"].items()}


def unstack_layers(params: Dict) -> List[Dict]:
    """Every layer of the stacked parameters, from one ``unbind(0)`` a
    stack (views).  Under autograd the backward of ``unbind`` stacks the
    layers' gradients once, where indexing each layer (``t[i]``) would
    write a zero-filled copy of the whole stack per layer."""
    names = list(params["layers"])
    slices = [params["layers"][n].unbind(0) for n in names]
    return [dict(zip(names, ts)) for ts in zip(*slices)]


# ===========================================================================
# attention block application
# ===========================================================================

def _positions3(positions):
    """M-RoPE's (temporal, height, width) streams of text-only input: the
    token positions, three times."""
    return torch.stack([positions, positions, positions])


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
    if positions is not None and cfg.mrope:
        q = apply_mrope(q, _positions3(positions), cfg.rope_theta)
        k = apply_mrope(k, _positions3(positions), cfg.rope_theta)
    elif positions is not None:
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


def _moe_block_apply(p, cfg, x, positions, cache=None, cache_len=None):
    """The MoE block: attention as the dense block's, then the top-k
    mixture of SwiGLU experts over the B * S tokens, dispatched in
    ``moe_groups()`` groups in prefill and in one in decode, as the
    reference does.  Returns (x, (k, v), the dispatch's aux)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    o, kv = _attn_apply(p, cfg, h, positions, cache=cache,
                        cache_len=cache_len)
    x = x + o
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    B, S, D = h2.shape
    y, aux = moe_block(h2.reshape(B * S, D), p["router"], p["we_gate"],
                       p["we_up"], p["we_down"], k=cfg.experts_per_token,
                       capacity_factor=cfg.capacity_factor,
                       groups=(moe_groups() if cache is None else 1))
    return x + y.reshape(B, S, D), kv, aux


# ===========================================================================
# forward (prefill trunk)
# ===========================================================================

def forward(cfg: ModelConfig, params: Dict, tokens, *,
            attn_impl: str = "auto", collect_cache: bool = False,
            max_len: Optional[int] = None):
    """Token trunk -> final hidden states (B, S, D).

    collect_cache: also return the caches (the prefill path): the layers'
    (k, v) stacks (L, B, S, K, hd) for the dense and MoE families, the
    segments' states and (k, v) for the hybrid one, in the reference's
    layouts.  Each layer's k and v are written into stacks allocated once
    with ``max_len`` (default S) positions, zero past S: the port's
    addition, so that a full-width prefill never holds the cache twice
    and decode can append to it.  ``attn_impl`` is the reference's choice
    of attention, kept for parity: every choice is the flash kernel here.
    Returns (hidden, cache_or_None, aux dict); the MoE family's aux holds
    ``expert_load`` (L, E), the tokens routed to each expert of each layer
    (the MoE's LIB signal)."""
    _require_ported(cfg)
    B, S = tokens.shape
    x = params["embed"][tokens]
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    kv = None
    if collect_cache:
        n_kv = (cfg.n_layers // cfg.attn_every if cfg.family == "hybrid"
                else cfg.n_layers)
        kv = _kv_stacks(cfg, n_kv, x, max_len)
    if cfg.family == "hybrid":
        x, states = _hybrid_forward(cfg, params, x, positions, kv)
        cache = (states, kv) if collect_cache else None
        aux = {}
    else:
        x, aux = _stack_forward(cfg, params, x, positions, kv)
        cache = kv
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, cache, aux


def _kv_stacks(cfg, n, x, max_len):
    """The prefill's zero (k, v) stacks (n, B, max_len or S, K, hd) in
    x's dtype, which is the k and v's."""
    B, S, _ = x.shape
    T = S if max_len is None else max_len
    if T < S:
        raise ValueError(f"max_len {T} < the prompt's {S} tokens")
    shape = (n, B, T, cfg.n_kv_heads, cfg.head_dim)
    return x.new_zeros(shape), x.new_zeros(shape)


def _write_kv(kv, i, kv_i):
    for stack, t in zip(kv, kv_i):
        stack[i, :, :t.shape[1]] = t


def _block(p, cfg, x, positions, collect):
    """One dense or MoE block: (x, its (k, v) if ``collect``, the MoE's
    expert_load)."""
    if cfg.family == "moe":
        x, kv, aux = _moe_block_apply(p, cfg, x, positions)
        return x, (kv if collect else None), aux["expert_load"]
    x, kv = _dense_block(p, cfg, x, positions, collect_kv=collect)
    return x, kv, None


def _stack_forward(cfg, params, x, positions, kv):
    """The dense or MoE stack, each layer's (k, v) written into ``kv``
    when given; else, with ``cfg.remat``, each block is checkpointed, so
    the backward recomputes it from its input (the reference's
    ``jax.checkpoint`` around the scanned body).  Returns (x, aux)."""
    loads = []
    for i, p in enumerate(unstack_layers(params)):
        if kv is None and cfg.remat:
            x, _, load = checkpoint(_block, p, cfg, x, positions, False,
                                    use_reentrant=False)
        else:
            x, kv_i, load = _block(p, cfg, x, positions, kv is not None)
            if kv is not None:
                _write_kv(kv, i, kv_i)
                del kv_i
        if load is not None:
            loads.append(load)
    return x, ({"expert_load": torch.stack(loads)} if loads else {})


def _hybrid_forward(cfg, params, x, positions, kv):
    """Zamba2: segments of ``attn_every`` Mamba2 layers, the *shared*
    attention block after each segment.  With ``kv`` (collecting the
    cache), each segment's (k, v) is written into it, and the states are
    returned: {"conv": (n_seg, attn_every, ...), "state": ...}, the
    reference's layout."""
    n_seg = cfg.n_layers // cfg.attn_every
    if n_seg * cfg.attn_every != cfg.n_layers:
        raise ValueError("attn_every must divide n_layers")
    collect = kv is not None
    shared = params["shared_attn"]
    convs, states = [], []
    for s in range(n_seg):
        for j in range(cfg.attn_every):
            p = layer_params(params, s * cfg.attn_every + j)
            x, st = ssm_layer_apply(p, x, cfg, collect_state=collect)
            if collect:
                convs.append(st["conv"])
                states.append(st["state"])
        x, kv_s = _dense_block(shared, cfg, x, positions, collect_kv=collect)
        if collect:
            _write_kv(kv, s, kv_s)
    if not collect:
        return x, None
    seg = (n_seg, cfg.attn_every)
    conv = torch.stack(convs).reshape(seg + convs[0].shape)
    state = torch.stack(states).reshape(seg + states[0].shape)
    return x, {"conv": conv, "state": state}


# ===========================================================================
# logits
# ===========================================================================

def _head(cfg, params):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def logits_fn(cfg, params, hidden):
    return matmul(hidden, _head(cfg, params))


def _ce_chunk(h, labels, head, z_loss: float):
    """Summed loss and count of valid labels of one sequence chunk: the
    (B, chunk, V) logits in float32 exist only inside this call."""
    lg = matmul(h, head).float()
    lse = torch.logsumexp(lg, dim=-1)
    gold = lg.gather(-1, labels.clamp(min=0)[..., None].long())[..., 0]
    valid = (labels >= 0).float()
    nll = ((lse - gold) + z_loss * lse ** 2) * valid
    return nll.sum(), valid.sum()


def chunked_ce_loss(cfg, params, hidden, labels, z_loss: float = 1e-4):
    """Blockwise cross-entropy over ``CE_CHUNK``-token chunks of the
    sequence, each checkpointed so that the backward recomputes its logits
    instead of keeping them: one (B, chunk, V) float32 block lives at a
    time.  Labels < 0 are masked; a z-loss of ``z_loss * lse**2`` is added.
    hidden (B, S, D), labels (B, S).  Returns the scalar mean loss."""
    B, S, _ = hidden.shape
    head = _head(cfg, params)
    n_chunks = -(-S // CE_CHUNK)
    pad = n_chunks * CE_CHUNK - S
    if pad:
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(n_chunks):
        sl = slice(c * CE_CHUNK, (c + 1) * CE_CHUNK)
        nll, n = checkpoint(_ce_chunk, hidden[:, sl], labels[:, sl], head,
                            z_loss, use_reentrant=False)
        tot = tot + nll
        cnt = cnt + n
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(cfg: ModelConfig, params, batch):
    """batch: {"tokens": (B, S), "labels": (B, S)}.  Returns (loss, aux)."""
    hidden, _, aux = forward(cfg, params, batch["tokens"])
    return chunked_ce_loss(cfg, params, hidden, batch["labels"]), aux
