"""Architecture assembly: init / forward / logits / loss for every
family.

The port of ``repro.models.model``: ``dense`` (llama-style: a stack of
attention + SwiGLU blocks; qwen2-vl's backbone is one, with M-RoPE),
``moe`` (the same attention with a top-k mixture of SwiGLU experts),
``ssm`` (Mamba2: a stack of Mamba2 layers), ``hybrid`` (Zamba2: a stack of
Mamba2 layers with one *shared* attention + SwiGLU block applied after
every ``attn_every`` of them) and ``encdec`` (the Whisper backbone: a
LayerNorm / GELU encoder over stub frame embeddings and a decoder with
causal self-attention and cross-attention to the encoder's output,
sinusoidal positions in both); all are served and trained here.
Parameters are plain dicts of tensors;
the layers are stacked with a leading L, as the reference stacks them,
and a Python loop over L takes the place of ``lax.scan``: a forward takes
each stack apart once with ``unbind(0)`` (views, and one stacked gradient
in the backward).  With ``cfg.remat`` each dense, MoE or Mamba2 block, and
each Zamba2 segment (its Mamba2 layers and the shared block), runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``; the
enc-dec family has none in either package, so it reads no remat), and the
loss is the reference's blockwise cross-entropy, each sequence chunk
checkpointed.

On a device mesh (parameters and batch as DTensors laid out by
``distributed.sharding``'s specs: ``distribute``) the dense family's
(the VL backbone's, M-RoPE's positions replicated) and the MoE family's
train and prefill steps run partitioned, as the reference's run under
GSPMD: the block-boundary activations are constrained where the
reference constrains them (``ctx.constrain_boundary``: batch on the data
axes, sequence on ``model``), each product's weights are FSDP-gathered
on the data axes first, attention and the SwiGLU run Megatron-SP
(sequence gathered, heads and hidden split over ``model``, the partial
sums reduce-scattered back; the MoE's experts split along F the same
way, their dispatch groups on the data ranks, ``layers.moe_block``), and
the kernels run on each rank's shards.
The embedding lookup, the loss's log-sum-exp and gold logit over the
vocabulary-split head, and the prefill's last position are done by hand
where DTensor has no strategy but a whole gather.  With plain tensors
none of this runs: each of those functions is the identity.  The SSM,
hybrid and enc-dec families' partitioned stacks are later slices and
raise.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Union

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..distributed import ctx
from ..distributed.ctx import constrain_boundary, is_dtensor, moe_groups
from .layers import (apply_mrope, apply_rope, decode_attention,
                     full_attention, gelu_mlp, layer_norm, matmul, moe_block,
                     rms_norm, swiglu)
from .ssm import init_ssm_layer, ssm_layer_apply

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec")
CE_CHUNK = 512                # sequence chunk for the blockwise CE loss


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)


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


def _init_encdec_layer(gen, cfg: ModelConfig, dtype, device, cross: bool):
    """One Whisper layer: LayerNorms with biases, attention, the GELU MLP
    with biases; a decoder layer (``cross``) adds the cross-attention's
    ``x``-prefixed projections and its LayerNorm ``lnx``."""
    D, Fd = cfg.d_model, cfg.d_ff
    s = 1.0 / math.sqrt(D)

    def const(v, n):
        return torch.full((n,), v, dtype=dtype, device=device)

    p = {
        "ln1": const(1.0, D), "ln1_b": const(0.0, D),
        "ln2": const(1.0, D), "ln2_b": const(0.0, D),
        **_init_attn(gen, cfg, dtype, device),
        "w1": (_normal(gen, (D, Fd), device) * s).to(dtype),
        "b1": const(0.0, Fd),
        "w2": (_normal(gen, (Fd, D), device) * s).to(dtype),
        "b2": const(0.0, D),
    }
    if cross:
        p.update({"x" + k: v
                  for k, v in _init_attn(gen, cfg, dtype, device).items()})
        p["lnx"] = const(1.0, D)
        p["lnx_b"] = const(0.0, D)
    return p


_INIT_LAYER = {"dense": _init_dense_layer, "moe": _init_moe_layer,
               "ssm": init_ssm_layer, "hybrid": init_ssm_layer}


def padded_vocab(cfg: ModelConfig) -> int:
    """Embedding tables padded to a multiple of 256, as the reference pads
    them; padded ids are valid but unused."""
    return -(-cfg.vocab_size // 256) * 256


def init_params(cfg: ModelConfig, key: Union[int, torch.Generator], *,
                device: Optional[Union[str, torch.device]] = None) -> Dict:
    """Random parameters from ``key`` (a seed, or a ``torch.Generator`` on
    ``device``), on ``device`` (default the card), in the reference's
    layout.  The layers (dense or MoE blocks, Mamba2 layers, or the
    enc-dec family's ``enc_layers`` and ``dec_layers``) are stacked with a
    leading L: each layer is drawn and written into its slot of the stack,
    so the peak is one layer's float32 draw (an expert stack's, for the
    MoE family).  ``device="meta"`` gives the tree's structure, shapes and
    dtypes alone, holding no memory (a restore's template)."""
    _check_family(cfg)
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
    if cfg.family == "encdec":
        params["enc_layers"] = _stack_layers(
            cfg.encoder_layers, lambda: _init_encdec_layer(
                gen, cfg, dtype, dev, cross=False), dev)
        params["dec_layers"] = _stack_layers(
            cfg.n_layers, lambda: _init_encdec_layer(
                gen, cfg, dtype, dev, cross=True), dev)
        params["enc_final_norm"] = torch.ones((D,), dtype=dtype, device=dev)
        params["enc_final_norm_b"] = torch.zeros((D,), dtype=dtype,
                                                 device=dev)
        params["final_norm_b"] = torch.zeros((D,), dtype=dtype, device=dev)
        return params
    params["layers"] = _stack_layers(
        cfg.n_layers, lambda: _INIT_LAYER[cfg.family](gen, cfg, dtype, dev),
        dev)
    if cfg.family == "hybrid":
        params["shared_attn"] = _init_dense_layer(gen, cfg, dtype, dev)
    return params


def _stack_layers(n: int, draw, device) -> Dict[str, torch.Tensor]:
    """n layers from ``draw()``, each written into its slot of stacks
    with a leading n."""
    layers: Dict[str, torch.Tensor] = {}
    for i in range(n):
        for name, t in draw().items():
            if name not in layers:
                layers[name] = torch.empty((n,) + t.shape, dtype=t.dtype,
                                           device=device)
            layers[name][i] = t
    return layers


def layer_params(params: Dict, i: int, group: str = "layers") -> Dict:
    """Layer ``i`` of the stacked parameters ``params[group]`` (views, no
    copy)."""
    return {name: t[i] for name, t in params[group].items()}


def unstack_layers(params: Dict, group: str = "layers") -> List[Dict]:
    """Every layer of the stacked parameters ``params[group]``, from one
    ``unbind(0)`` a stack (views).  Under autograd the backward of
    ``unbind`` stacks the layers' gradients once, where indexing each
    layer (``t[i]``) would write a zero-filled copy of the whole stack per
    layer."""
    names = list(params[group])
    slices = [params[group][n].unbind(0) for n in names]
    return [dict(zip(names, ts)) for ts in zip(*slices)]


# ===========================================================================
# attention block application
# ===========================================================================

def _positions3(positions):
    """M-RoPE's (temporal, height, width) streams of text-only input: the
    token positions, three times."""
    return torch.stack([positions, positions, positions])


def _attn_apply(p, cfg: ModelConfig, x, positions, *, causal=True,
                kv=None, cache=None, cache_len=None, prefix=""):
    """Shared attention application.  Returns (out, (k, v)).

    Without a cache, the flash kernel (the reference picks its full or its
    chunked attention by length; both are the kernel's function).
    kv: precomputed (k, v) for cross attention, taken as they are (no
    norm, no rotation).
    cache: (k_cache, v_cache) for decode (x is a single step); the step's
    k and v are written into the caches at ``cache_len`` in place, and the
    caches are returned.
    prefix: of the projections' names (``"x"``: the cross attention's).
    A DTensor x (self-attention on a mesh) goes to :func:`_attn_sharded`."""
    if is_dtensor(x):
        if kv is not None or cache is not None or prefix:
            raise NotImplementedError("cross attention and decode on a "
                                      "mesh are a later slice of the port")
        return _attn_sharded(p, cfg, x, positions, causal)
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = lambda n: p[prefix + n]  # noqa: E731
    q = matmul(x, g("wq")).reshape(B, S, H, hd)
    if kv is None:
        k = matmul(x, g("wk")).reshape(B, S, K, hd)
        v = matmul(x, g("wv")).reshape(B, S, K, hd)
    else:
        k, v = kv
    if cfg.qk_norm and (prefix + "q_norm") in p:
        q = rms_norm(q, g("q_norm"), cfg.norm_eps)
        if kv is None:
            k = rms_norm(k, g("k_norm"), cfg.norm_eps)
    if positions is not None and kv is None:
        if cfg.mrope:
            q = apply_mrope(q, _positions3(positions), cfg.rope_theta)
            k = apply_mrope(k, _positions3(positions), cfg.rope_theta)
        else:
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
    out = matmul(o.reshape(B, S, H * hd), g("wo"))
    return out, kv_out


def _attn_sharded(p, cfg, x, positions, causal):
    """Self-attention of a DTensor x (B, S, D) on its mesh, Megatron-SP:
    x's sequence gathered over ``model``, the projections gathered on the
    data axes (FSDP), the heads split over ``model`` (``ctx.head_groups``):
    q column-parallel (its groups padded with zero heads where they do not
    split evenly, ``ctx.pad_heads``), the kv heads through
    ``ctx.kv_weight``, the output projection row-parallel, its partial
    sums reduce-scattered back to x's layout.  ``positions``: (1, S),
    the same on every rank (M-RoPE's three streams of text-only input are
    those positions: the rotation needs no layout of its own).  Returns
    (out, (k, v)), k and v with the kv heads the kernel read."""
    B, S, _ = x.shape
    K, hd = cfg.n_kv_heads, cfg.head_dim
    group = ctx.head_groups(cfg, x.device_mesh)
    wq = ctx.pad_heads(p["wq"], K, group, hd, 1)
    wo = ctx.pad_heads(p["wo"], K, group, hd, 0)
    wk, wv = (ctx.kv_weight(p[n], K, hd) for n in ("wk", "wv"))
    H = wq.shape[1] // hd
    h = ctx.gather_model(x)
    q = matmul(h, wq).reshape(B, S, H, hd)
    k = matmul(h, wk).reshape(B, S, wk.shape[1] // hd, hd)
    v = matmul(h, wv).reshape(B, S, wv.shape[1] // hd, hd)
    if cfg.qk_norm and "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.mrope:
        q = apply_mrope(q, _positions3(positions), cfg.rope_theta)
        k = apply_mrope(k, _positions3(positions), cfg.rope_theta)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    o = full_attention(q, k, v, causal=causal)
    return ctx.like(matmul(o.reshape(B, S, H * hd), wo), x), (k, v)


def _swiglu(p, h):
    """The block's SwiGLU of h; for a DTensor h, Megatron-SP's column- then
    row-parallel products: h's sequence gathered over ``model``, the
    weights gathered on the data axes (FSDP), the down product's partial
    sums reduce-scattered back to h's layout."""
    if not is_dtensor(h):
        return swiglu(h, p["w_gate"], p["w_up"], p["w_down"])
    g = ctx.gather_weight
    out = swiglu(ctx.gather_model(h), g(p["w_gate"]), g(p["w_up"]),
                 g(p["w_down"]))
    return ctx.like(out, h)


def _dense_block(p, cfg, x, positions, collect_kv=False, cache=None,
                 cache_len=None):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    o, kv = _attn_apply(p, cfg, h, positions, cache=cache,
                        cache_len=cache_len)
    x = x + o
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    x = x + _swiglu(p, h2)
    return (x, kv) if (collect_kv or cache is not None) else (x, None)


def _moe_block_apply(p, cfg, x, positions, cache=None, cache_len=None,
                     groups=1):
    """The MoE block: attention as the dense block's, then the top-k
    mixture of SwiGLU experts over the B * S tokens, dispatched in
    ``groups`` groups (the stack's forward passes ``moe_groups()``; decode
    one), as the reference does.  Returns (x, (k, v), the dispatch's
    aux).  For a DTensor x, Megatron-SP around the experts, as
    :func:`_swiglu` around the dense MLP: h2's sequence gathered over
    ``model``, the router and the expert weights gathered on the data axes
    (FSDP), each ``model`` rank routing the same tokens through its F
    columns of every expert (``layers.moe_block`` on the mesh), the
    partial sums reduce-scattered back to x's layout."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    o, kv = _attn_apply(p, cfg, h, positions, cache=cache,
                        cache_len=cache_len)
    x = x + o
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    B, S, D = h2.shape
    g = ctx.gather_weight
    y, aux = moe_block(ctx.gather_model(h2).reshape(B * S, D),
                       g(p["router"]), g(p["we_gate"]), g(p["we_up"]),
                       g(p["we_down"]), k=cfg.experts_per_token,
                       capacity_factor=cfg.capacity_factor,
                       groups=groups)
    return x + ctx.like(y.reshape(B, S, D), h2), kv, aux


# ===========================================================================
# forward (prefill trunk)
# ===========================================================================

def forward(cfg: ModelConfig, params: Dict, tokens, *, embeds=None,
            attn_impl: str = "auto", collect_cache: bool = False,
            max_len: Optional[int] = None):
    """Token trunk -> final hidden states (B, S, D).

    embeds: the enc-dec family's encoder input, (B, encoder_seq, D) stub
    frame embeddings; unused by the other families.
    collect_cache: also return the caches (the prefill path): the layers'
    (k, v) stacks (L, B, S, K, hd) for the dense and MoE families, the
    layers' conv windows and states for the SSM one, the segments' states
    and (k, v) for the hybrid one, the decoder's (k, v) and the cross
    attention's (xk, xv) stacks for the enc-dec one, in the reference's
    layouts.  Each layer's k and v are written into stacks allocated once
    with ``max_len`` (default S) positions, zero past S: the port's
    addition, so that a full-width prefill never holds the cache twice
    and decode can append to it.  ``attn_impl`` is the reference's choice
    of attention, kept for parity: every choice is the flash kernel here.
    Returns (hidden, cache_or_None, aux dict); the MoE family's aux holds
    ``expert_load`` (L, E), the tokens routed to each expert of each layer
    (the MoE's LIB signal), the enc-dec family's ``enc_out``, the
    encoder's output."""
    _check_family(cfg)
    if cfg.family == "encdec":
        return _encdec_forward(cfg, params, tokens, embeds=embeds,
                               collect_cache=collect_cache, max_len=max_len)
    B, S = tokens.shape
    if is_dtensor(tokens):
        _check_sharded(cfg, S, max_len)
        x = _embed_sharded(params["embed"], tokens)
        positions = torch.arange(S, device=tokens.device)[None]
    else:
        x = params["embed"][tokens]
        positions = torch.arange(S, device=tokens.device).expand(B, S)
    aux: Dict = {}
    if cfg.family == "ssm":
        x, cache = _ssm_forward(cfg, params, x, collect_cache)
    else:
        kv = None
        if collect_cache:
            n_kv = (cfg.n_layers // cfg.attn_every
                    if cfg.family == "hybrid" else cfg.n_layers)
            kv = _kv_stacks(cfg, n_kv, x, max_len)
        if cfg.family == "hybrid":
            x, states = _hybrid_forward(cfg, params, x, positions, kv)
            cache = (states, kv) if collect_cache else None
        else:
            x, aux = _stack_forward(cfg, params, x, positions, kv)
            cache = kv
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, cache, aux


def _check_sharded(cfg, S, max_len):
    """Raise unless the partitioned stack covers the step: the dense
    family (the VL backbone's M-RoPE too) and the MoE one, caches of the
    prompt's length."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"the {cfg.family} family's partitioned stack is a later slice "
            f"of the port")
    if max_len is not None and max_len != S:
        raise NotImplementedError("a partitioned prefill's caches hold the "
                                  "prompt's length")


def _embed_sharded(table, tokens):
    """``table[tokens]`` of a DTensor table (V, D), its rows on ``model``
    and D on the data axes (``Spec(model, data)``), and tokens (B, S) on
    the data axes.  DTensor has no strategy for an index into a sharded
    table but gathering it whole, so it is done by hand, as Megatron's
    vocab-parallel embedding: the table gathered on the data axes, each
    ``model`` rank looks the tokens up in its rows (zeros for the
    others), and the partial sums are left to the boundary constraint's
    reduce-scatter.  Its gradient: partial over the data axes, this
    rank's rows on ``model``."""
    from torch.distributed.tensor import Partial, Replicate
    t = ctx.gather_weight(table)
    m = t.device_mesh
    tp = ctx.model_dim(m)
    split = tp is not None and t.placements[tp].is_shard(0)
    rows = t.to_local().shape[0]
    lo = ctx.model_rank(m) * rows if split else 0

    def look(tab, tok):
        idx = tok - lo
        ok = (idx >= 0) & (idx < rows)
        return torch.where(ok[..., None], tab[idx.clamp(0, rows - 1)], 0)

    tok_pl, tab_pl = tuple(tokens.placements), tuple(t.placements)
    out = tuple(Partial() if (split and i == tp) else p
                for i, p in enumerate(tok_pl))
    grad = tuple(p if i == tp else
                 (Partial() if tok_pl[i].is_shard() else Replicate())
                 for i, p in enumerate(tab_pl))
    return ctx.on_shards(look, (t, tokens), (tab_pl, tok_pl), out,
                         (grad, tok_pl))


def _kv_stacks(cfg, n, x, max_len):
    """The prefill's zero (k, v) stacks (n, B, max_len or S, K, hd) in
    x's dtype, which is the k and v's; for a DTensor x laid out as the
    reference's cache specs (batch on the data axes, sequence on
    ``model``)."""
    B, S, _ = x.shape
    T = S if max_len is None else max_len
    if T < S:
        raise ValueError(f"max_len {T} < the prompt's {S} tokens")
    shape = (n, B, T, cfg.n_kv_heads, cfg.head_dim)
    if is_dtensor(x):
        return _sharded_zeros(shape, x), _sharded_zeros(shape, x)
    return x.new_zeros(shape), x.new_zeros(shape)


def _sharded_zeros(shape, x):
    from ..distributed.sharding import (Spec, _dp_tp, fit_spec, from_shards,
                                        mesh_axes)
    from .decode import TensorSpec
    axes = mesh_axes(x.device_mesh)
    dp, tp = _dp_tp(axes)
    return from_shards(TensorSpec(shape, x.dtype),
                       fit_spec(Spec(None, dp, tp), shape, axes),
                       x.device_mesh, lambda leaf, local: torch.zeros(
                           local, dtype=leaf.dtype, device=x.device))


def _write_kv(kv, i, kv_i):
    for stack, t in zip(kv, kv_i):
        if is_dtensor(stack):
            stack[i].copy_(_cache_slot(t, stack))
        else:
            stack[i, :, :t.shape[1]] = t


def _cache_slot(t, stack):
    """A layer's k or v (B, S, Kx, hd), as the kernel read them, laid out
    as its slot of a sharded cache stack (L, B, S, K, hd): redistributed
    to the slot's placements, and the kv heads repeated by whole copies
    (``ctx.kv_weight``) taken back to the stack's K."""
    from torch.distributed.tensor import Shard
    slot = tuple(Shard(p.dim - 1) if p.is_shard() else p
                 for p in stack.placements)
    t = ctx.redistribute(t, slot)
    r = t.shape[2] // stack.shape[3]
    return t[:, :, ::r] if r > 1 else t


def _block(p, cfg, x, positions, collect, groups):
    """One dense or MoE block, the MoE's dispatch in ``groups`` groups:
    (x, its (k, v) if ``collect``, the MoE's expert_load); x leaves it
    constrained as the reference's scanned body returns it."""
    if cfg.family == "moe":
        x, kv, aux = _moe_block_apply(p, cfg, x, positions, groups=groups)
        return constrain_boundary(x), (kv if collect else None), \
            aux["expert_load"]
    x, kv = _dense_block(p, cfg, x, positions, collect_kv=collect)
    return constrain_boundary(x), kv, None


def _stack_forward(cfg, params, x, positions, kv):
    """The dense or MoE stack, each layer's (k, v) written into ``kv``
    when given; else, with ``cfg.remat``, each block is checkpointed, so
    the backward recomputes it from its input (the reference's
    ``jax.checkpoint`` around the scanned body).  The MoE's token groups
    are read from the context here, once, and passed in: a recompute in
    the backward, which may run after the context has closed, routes as
    the forward did.  x enters constrained, as the reference's scan's
    carry does.  Returns (x, aux)."""
    loads, groups = [], moe_groups()
    x = constrain_boundary(x)
    for i, p in enumerate(unstack_layers(params)):
        if kv is None and cfg.remat:
            x, _, load = checkpoint(_block, p, cfg, x, positions, False,
                                    groups, use_reentrant=False)
        else:
            x, kv_i, load = _block(p, cfg, x, positions, kv is not None,
                                   groups)
            if kv is not None:
                _write_kv(kv, i, kv_i)
                del kv_i
        if load is not None:
            loads.append(load)
    return x, ({"expert_load": torch.stack(loads)} if loads else {})


def _hybrid_segment(layers, shared, cfg, x, positions):
    """One Zamba2 segment: its Mamba2 layers, then the shared block."""
    for p in layers:
        x, _ = ssm_layer_apply(p, x, cfg)
    x, _ = _dense_block(shared, cfg, x, positions, collect_kv=False)
    return x


def _hybrid_forward(cfg, params, x, positions, kv):
    """Zamba2: segments of ``attn_every`` Mamba2 layers, the *shared*
    attention block after each segment.  With ``kv`` (collecting the
    cache), each segment's (k, v) is written into it, and the states are
    returned: {"conv": (n_seg, attn_every, ...), "state": ...}, the
    reference's layout.  Else, with ``cfg.remat``, each whole segment is
    checkpointed (the reference's ``jax.checkpoint`` around its segment
    body), so the backward recomputes it from its input."""
    n_seg = cfg.n_layers // cfg.attn_every
    if n_seg * cfg.attn_every != cfg.n_layers:
        raise ValueError("attn_every must divide n_layers")
    collect = kv is not None
    shared = params["shared_attn"]
    layers = unstack_layers(params)
    convs, states = [], []
    for s in range(n_seg):
        seg = layers[s * cfg.attn_every:(s + 1) * cfg.attn_every]
        if not collect:
            x = (checkpoint(_hybrid_segment, seg, shared, cfg, x, positions,
                            use_reentrant=False)
                 if cfg.remat else
                 _hybrid_segment(seg, shared, cfg, x, positions))
            continue
        for p in seg:
            x, st = ssm_layer_apply(p, x, cfg, collect_state=True)
            convs.append(st["conv"])
            states.append(st["state"])
        x, kv_s = _dense_block(shared, cfg, x, positions, collect_kv=True)
        _write_kv(kv, s, kv_s)
    if not collect:
        return x, None
    seg = (n_seg, cfg.attn_every)
    conv = torch.stack(convs).reshape(seg + convs[0].shape)
    state = torch.stack(states).reshape(seg + states[0].shape)
    return x, {"conv": conv, "state": state}


def _ssm_forward(cfg, params, x, collect):
    """Mamba2: the stack of Mamba2 layers.  Collecting the cache, each
    layer's conv window and final state are written into stacks allocated
    at the first layer: {"conv": (L, B, k-1, ch), "state": (L, B, nh, hp,
    st) float32}, the reference's layout.  Else, with ``cfg.remat``, each
    layer is checkpointed (the reference's ``jax.checkpoint`` around the
    scanned body)."""
    cache = None
    for i, p in enumerate(unstack_layers(params)):
        if not collect and cfg.remat:
            x, _ = checkpoint(ssm_layer_apply, p, x, cfg,
                              use_reentrant=False)
            continue
        x, st = ssm_layer_apply(p, x, cfg, collect_state=collect)
        if collect:
            if cache is None:
                cache = {k: t.new_empty((cfg.n_layers,) + t.shape)
                         for k, t in st.items()}
            for k, t in st.items():
                cache[k][i] = t
    return x, cache


def _sinusoid(S: int, D: int, device=None):
    """Whisper's sinusoidal positions of 0 .. S-1: (S, D) float32."""
    return _sinusoid_at(torch.arange(S, device=device), D)


def _sinusoid_at(positions, D: int):
    """The rows of ``_sinusoid`` at ``positions`` (a 1-d tensor, on any
    device): sin of pos / 10000^(2i/D) for i < D/2, then cos, each row
    computed as the whole table computes it."""
    pos = positions.float()[:, None]
    i = torch.arange(D // 2, device=positions.device).float()[None, :]
    ang = pos / torch.pow(torch.tensor(10000.0, device=positions.device),
                          2 * i / D)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _encoder_input(cfg, embeds):
    """The encoder's input: the stub frame embeddings (B, Senc, D) plus
    the positions, each in the parameters' dtype, as the reference adds
    them."""
    dtype = _dtype(cfg)
    _, Senc, D = embeds.shape
    return embeds.to(dtype) + _sinusoid(Senc, D, embeds.device).to(dtype)


def _encoder_layer(cfg, p, h):
    """One Whisper encoder layer: LayerNorm, non-causal self-attention,
    LayerNorm, GELU MLP."""
    a = layer_norm(h, p["ln1"], p["ln1_b"], cfg.norm_eps)
    h = h + _attn_apply(p, cfg, a, None, causal=False)[0]
    m = layer_norm(h, p["ln2"], p["ln2_b"], cfg.norm_eps)
    return h + gelu_mlp(m, p["w1"], p["b1"], p["w2"], p["b2"])


def _encoder(cfg, params, embeds):
    """Whisper's encoder over the stub frame embeddings (B, Senc, D): its
    layers, then the final LayerNorm.  Returns its output (B, Senc, D)."""
    h = _encoder_input(cfg, embeds)
    for p in unstack_layers(params, "enc_layers"):
        h = _encoder_layer(cfg, p, h)
    return layer_norm(h, params["enc_final_norm"],
                      params["enc_final_norm_b"], cfg.norm_eps)


def _cross_kv(cfg, p, enc_out):
    """A decoder layer's cross-attention k and v of the encoder's output:
    (B, Senc, K, hd) each."""
    B, Senc, _ = enc_out.shape
    shape = (B, Senc, cfg.n_kv_heads, cfg.head_dim)
    return (matmul(enc_out, p["xwk"]).reshape(shape),
            matmul(enc_out, p["xwv"]).reshape(shape))


def _decoder_layer(cfg, p, x, xkv, cache=None, cache_len=None):
    """One Whisper decoder layer: LayerNorm, causal self-attention (on a
    decode step, over the cache), LayerNorm, cross-attention over the
    encoder's (xk, xv), LayerNorm, GELU MLP.  Returns (x, its (k, v))."""
    a = layer_norm(x, p["ln1"], p["ln1_b"], cfg.norm_eps)
    o, kv = _attn_apply(p, cfg, a, None, causal=True, cache=cache,
                        cache_len=cache_len)
    x = x + o
    c = layer_norm(x, p["lnx"], p["lnx_b"], cfg.norm_eps)
    o2, _ = _attn_apply(p, cfg, c, None, causal=False, kv=xkv, prefix="x")
    x = x + o2
    m = layer_norm(x, p["ln2"], p["ln2_b"], cfg.norm_eps)
    return x + gelu_mlp(m, p["w1"], p["b1"], p["w2"], p["b2"]), kv


def _encdec_forward(cfg, params, tokens, *, embeds, collect_cache,
                    max_len=None):
    """Whisper backbone.  embeds: (B, encoder_seq, D) stub frame
    embeddings.  No layer is checkpointed whatever ``cfg.remat`` says, as
    in the reference's ``_encdec_forward``: under remat a step of this
    family computes what it computes without.  Each decoder layer projects
    the encoder's output to its own cross (xk, xv), so the encoder's
    gradient is the sum of every decoder layer's cross attention's.
    Collecting the cache, each decoder layer's (k, v) is
    written into stacks of ``max_len`` positions and its cross (xk, xv)
    into stacks of the encoder's length, all allocated once: returns
    (hidden, ((k, v), xk, xv) or None, {"enc_out": ...})."""
    if embeds is None:
        raise ValueError("the encdec family needs frontend embeddings "
                         "(embeds)")
    enc_out = _encoder(cfg, params, embeds)
    B, S = tokens.shape
    D = cfg.d_model
    x = (params["embed"][tokens]
         + _sinusoid(S, D, tokens.device).to(_dtype(cfg)))
    kv = xk = xv = None
    if collect_cache:
        kv = _kv_stacks(cfg, cfg.n_layers, x, max_len)
        xshape = (cfg.n_layers,) + enc_out.shape[:2] + (cfg.n_kv_heads,
                                                         cfg.head_dim)
        xk, xv = enc_out.new_empty(xshape), enc_out.new_empty(xshape)
    for i, p in enumerate(unstack_layers(params, "dec_layers")):
        xkv = _cross_kv(cfg, p, enc_out)
        x, kv_i = _decoder_layer(cfg, p, x, xkv)
        if collect_cache:
            _write_kv(kv, i, kv_i)
            xk[i], xv[i] = xkv
        del kv_i, xkv
    x = layer_norm(x, params["final_norm"], params["final_norm_b"],
                   cfg.norm_eps)
    cache = ((kv, xk, xv) if collect_cache else None)
    return x, cache, {"enc_out": enc_out}


# ===========================================================================
# logits
# ===========================================================================

def _head(cfg, params):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def logits_fn(cfg, params, hidden):
    """hidden @ the head; on a mesh the head is gathered on the data axes
    first, its vocabulary left on ``model`` (:func:`_mesh_head`)."""
    if is_dtensor(hidden):
        return matmul(hidden, _mesh_head(cfg, params))
    return matmul(hidden, _head(cfg, params))


def _mesh_head(cfg, params, whole: bool = False):
    """The head of a DTensor parameter tree gathered on the data axes
    (and, ``whole``, over ``model``), a tied embedding before its
    transpose, so that a product reads the head as the unsharded model
    reads it (the embedding's transposed view)."""
    if not cfg.tie_embeddings:
        head = ctx.gather_weight(params["lm_head"])
        return ctx.gather_model(head) if whole else head
    table = ctx.gather_weight(params["embed"])
    return (ctx.gather_model(table) if whole else table).T


def last_hidden(hidden):
    """``hidden[:, -1:, :]``.  Of a DTensor with its sequence on
    ``model`` (DTensor would gather the whole sequence to slice it) by
    hand: the last ``model`` rank gives its last row, the others zeros,
    and the sum over ``model`` replicates it."""
    if not is_dtensor(hidden):
        return hidden[:, -1:, :]
    from torch.distributed.tensor import Partial
    m = hidden.device_mesh
    tp = ctx.model_dim(m)
    if tp is None or not hidden.placements[tp].is_shard(1):
        return hidden[:, -1:, :]
    last = ctx.model_rank(m) == ctx.model_size(m) - 1
    pl = tuple(hidden.placements)
    out = tuple(Partial() if i == tp else p for i, p in enumerate(pl))

    def pick(h):
        return h[:, -1:] if last else torch.zeros_like(h[:, -1:])

    return ctx.gather_model(ctx.on_shards(pick, (hidden,), (pl,), out))


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
    if is_dtensor(hidden):
        return _ce_sharded(cfg, params, hidden, labels, z_loss)
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


def _ce_sharded(cfg, params, hidden, labels, z_loss):
    """:func:`chunked_ce_loss` of a DTensor hidden on its mesh: the
    sequence gathered over ``model`` and the head gathered on the data
    axes, its vocabulary left on ``model``; over a split vocabulary each
    chunk's log-sum-exp and gold logit by :func:`_ce_chunk_vocab`, else by
    :func:`_ce_chunk`.  The sums are partial over the data axes until the
    mean, which is replicated."""
    B, S, _ = hidden.shape
    hidden = ctx.gather_model(hidden)
    m = hidden.device_mesh
    tp = ctx.model_dim(m)
    split = (tp is not None and ctx.model_size(m) > 1
             and _head(cfg, params).placements[tp].is_shard(1))
    head = _mesh_head(cfg, params, whole=not split)
    chunk_fn = _ce_chunk
    if split:
        chunk_fn = functools.partial(
            _ce_chunk_vocab, lo=ctx.model_rank(m) * head.to_local().shape[1])
    n_chunks = -(-S // CE_CHUNK)
    pad = n_chunks * CE_CHUNK - S
    if pad:                 # the sequence is whole on every rank: pad shards
        pad_h = functools.partial(torch.nn.functional.pad, pad=(0, 0, 0, pad))
        pad_l = functools.partial(torch.nn.functional.pad, pad=(0, pad),
                                  value=-1)
        hidden = ctx.on_shards(pad_h, (hidden,), (hidden.placements,),
                               hidden.placements)
        labels = ctx.on_shards(pad_l, (labels,), (labels.placements,),
                               labels.placements)
    tot = cnt = None
    for c in range(n_chunks):
        sl = slice(c * CE_CHUNK, (c + 1) * CE_CHUNK)
        nll, n = checkpoint(chunk_fn, hidden[:, sl], labels[:, sl], head,
                            z_loss, use_reentrant=False)
        tot = nll if tot is None else tot + nll
        cnt = n if cnt is None else cnt + n
    tot, cnt = ctx.replicate(tot), ctx.replicate(cnt)
    return tot / torch.clamp(cnt, min=1.0)


def _ce_chunk_vocab(h, labels, head, z_loss: float, lo: int):
    """:func:`_ce_chunk` over a head (D, V) split over ``model``, this
    rank's columns from ``lo``: the log-sum-exp from the partial max
    (all-reduced) and partial sums of exponentials, the gold logit from
    the rank that holds it (zeros elsewhere, summed), where DTensor would
    gather the (B, chunk, V) logits whole for both."""
    from torch.distributed.tensor import Partial
    lg = matmul(h, head).float()
    m = ctx.gather_model(lg.detach().amax(dim=-1, keepdim=True))
    lse = torch.log(ctx.gather_model(torch.exp(lg - m).sum(dim=-1))) \
        + m[..., 0]
    cols = lg.to_local().shape[-1]

    def pick(lg_, lab):
        idx = lab.long() - lo
        ok = (idx >= 0) & (idx < cols)
        g = lg_.gather(-1, idx.clamp(0, cols - 1)[..., None])[..., 0]
        return torch.where(ok, g, 0.0)

    tp = ctx.model_dim(lg.device_mesh)
    lab_pl = tuple(labels.placements)
    out = tuple(Partial() if i == tp else p for i, p in enumerate(lab_pl))
    gold = ctx.gather_model(ctx.on_shards(
        pick, (lg, labels), (tuple(lg.placements), lab_pl), out))
    valid = (labels >= 0).float()
    nll = ((lse - gold) + z_loss * lse ** 2) * valid
    return nll.sum(), valid.sum()


def loss_fn(cfg: ModelConfig, params, batch):
    """batch: {"tokens": (B, S), "labels": (B, S), ["embeds"]}.  Returns
    (loss, aux)."""
    hidden, _, aux = forward(cfg, params, batch["tokens"],
                             embeds=batch.get("embeds"))
    return chunked_ce_loss(cfg, params, hidden, batch["labels"]), aux
