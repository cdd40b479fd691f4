"""Neural-net building blocks shared by all architecture families.

The port of ``repro.models.layers``: RMSNorm and the enc-dec family's
LayerNorm, RoPE and Qwen2-VL's M-RoPE, the attentions, SwiGLU, the
sort-based MoE dispatch, and ``gelu_mlp`` (Whisper's MLP, also the block
of the learned-selection policy net).  RMSNorm goes to the
``rmsnorm`` kernel and prefill / training attention to the
``flash_attention`` kernel; under autograd on the card
both run as ``torch.autograd.Function``s whose backwards are the
``rmsnorm_bwd`` and ``flash_attention_bwd`` kernels (the reference trains
through XLA's autodiff of these twins); the attention forward then also
keeps each row's log-sum-exp, from which its backward takes the softmax
(bf16 products on the tensor cores).  Single-token decode attention,
RoPE, LayerNorm (the reference has no Pallas kernel for it), the SwiGLU
and GELU products and the MoE's routing and batched expert products stay
plain PyTorch (and plain autograd, but for the dispatch's gather, whose
backward sums a token's copies in a fixed order), as the reference leaves
them to XLA.  On a device mesh the MoE dispatch keeps the reference's
groups, a rank's whole groups or a group spread over several data ranks
(:func:`_moe_mesh`).
Layouts are the reference's: q (B, S, H, hd), k and v (B, T, K, hd).
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from ..distributed import ctx
from ..distributed.ctx import is_dtensor, replicated
from ..kernels.flash_attention import flash_attention
from ..kernels.rmsnorm import rmsnorm


def rms_norm(x, w, eps: float = 1e-5):
    return rmsnorm(x, w, eps=eps)


def layer_norm(x, w, b, eps: float = 1e-5):
    """LayerNorm over the last axis, spelled as the reference's: in
    float32, the mean, the variance of ``x - mean``, then ``rsqrt``; the
    result in x's dtype."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


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


def _rotate(x, ang):
    """x (..., S, H, hd) rotated by the angles ang (..., S, hd/2); for a
    DTensor x the rotations, the same on every rank, are replicated."""
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    cos, sin = replicated(cos, x), replicated(sin, x)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    return _rotate(x, positions[..., :, None].float() * freqs)


def apply_mrope(x, positions3, theta: float,
                sections=(0.25, 0.375, 0.375)):
    """Qwen2-VL M-RoPE: the rotary frequencies split into (temporal,
    height, width) sections, each driven by its own position stream.

    x: (..., S, H, hd); positions3: (3, ..., S).  For text-only input the
    three streams are equal and the angles are RoPE's, bit for bit."""
    half = x.shape[-1] // 2
    n_t = int(half * sections[0])
    n_h = int(half * sections[1])
    n_w = half - n_t - n_h
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    sec_pos = torch.cat([
        p[..., :, None].expand(*p.shape, n)
        for p, n in zip(positions3, (n_t, n_h, n_w))], dim=-1).float()
    return _rotate(x, sec_pos * freqs)


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


# ---------------------------------------------------------------------------
# Mixture of Experts (sort-based capacity dispatch)
# ---------------------------------------------------------------------------

def top_k(probs, k: int):
    """``lax.top_k`` along the last axis: the k largest values and their
    indices, largest first, equal values lower index first (a stable
    descending sort; ``torch.topk`` promises no order on ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _token_sums(pairs, by_token, T: int, k: int):
    """Each token's k rows of ``pairs`` (T * k, D), the (token, choice)
    pairs in the dispatch's sorted order, summed one by one in that order
    (``by_token``: a stable argsort of the pairs' tokens): a fixed order,
    with no atomics, so reruns and recomputes are bit-equal."""
    per_token = pairs[by_token].reshape(T, k, -1)
    out = torch.zeros_like(per_token[:, 0])
    for j in range(k):
        out = out + per_token[:, j]
    return out


class _DispatchGather(torch.autograd.Function):
    """``x[t_sorted[keep]]``, the dispatch's gather of each kept pair's
    token, which takes a token up to k times.  Its backward sums a token's
    kept copies by ``_token_sums``, as the combine sums its k outputs, in
    ``x``'s dtype, where autograd of the gather would add them with an
    indexed accumulate (``index_put_(accumulate=True)``): on the CPU that
    adds float32 with atomics from several threads above 32,768 elements,
    so reruns differ; on the card it happens to add in this order, one
    rounding an addition, which PyTorch does not promise."""

    @staticmethod
    def forward(ctx, x, t_sorted, keep, by_token, k):
        ctx.save_for_backward(keep, by_token)
        ctx.k = k
        return x[t_sorted[keep]]

    @staticmethod
    def backward(ctx, grad):
        keep, by_token = ctx.saved_tensors
        pairs = grad.new_zeros((by_token.shape[0], grad.shape[-1]))
        pairs[keep] = grad
        dx = _token_sums(pairs, by_token, by_token.shape[0] // ctx.k, ctx.k)
        return dx, None, None, None, None


def _kept(keep, slots: int):
    """The kept pairs as the dispatch indexes them: the mask ``keep`` on
    the CPU and the card.  On the ``meta`` device (the dry run) a mask
    selects a count that depends on the data, so the kept pairs are the
    upper bound instead, the first min(T * k, E * C) pairs, every slot of
    the buffer filled: the gather's and scatter's bytes are counted at
    that bound (the expert products run on the static (E, C, D) buffer
    either way)."""
    if keep.device.type != "meta":
        return keep
    return torch.arange(min(keep.shape[0], slots), device=keep.device)


def _route(x, router_w, k: int):
    """The router of a token group x (T, D): float32 logits (T, E), their
    softmax, the top-k weights renormalized (T, k), and the (token,
    choice) pairs' experts ``flat_e`` (T * k,), a stable sort of them by
    expert (``order``), the sorted experts and each sorted pair's
    token."""
    logits = x.float() @ router_w.float()                  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    topw, topi = top_k(probs, k)                           # (T, k)
    topw = topw / topw.sum(-1, keepdim=True).clamp_min(1e-9)
    flat_e = topi.reshape(-1)                              # (T * k,)
    order = torch.argsort(flat_e, stable=True)
    return logits, probs, topw, flat_e, order, flat_e[order], order // k


def _keep(order, e_sorted, k: int, E: int, C: int, base=None):
    """Each sorted pair's rank within its expert's pairs, and whether it
    is kept (rank < C).  ``base`` (E,): the pairs of the same group routed
    to each expert on lower data ranks, which come first in the group's
    stable order (none: the group is this rank's)."""
    first = torch.searchsorted(e_sorted, torch.arange(E, device=e_sorted.device))
    rank = torch.arange(e_sorted.shape[0], device=e_sorted.device) \
        - first[e_sorted]
    if base is not None:
        rank = rank + base[e_sorted]
    return rank, rank < C


def _experts(buf, w_gate, w_up, w_down):
    """The SwiGLU experts on the dispatch buffer (E, C, D)."""
    h = matmul(buf, w_gate)
    u = matmul(buf, w_up)
    return matmul(F.silu(h) * u, w_down)


def moe_block(x, router_w, w_gate, w_up, w_down, *, k: int,
              capacity_factor: float = 1.25, groups: int = 1):
    """Top-k MoE with sort-based dispatch into a static-capacity buffer.

    x: (T, D); router_w: (D, E); expert weights (E, D, F) / (E, F, D).
    Each expert takes at most ``C = max(1, int(capacity_factor * k * T /
    E))`` tokens, in the order of a stable sort of the (token, choice)
    pairs by expert; the rest are dropped (they add nothing).  Returns
    (out (T, D), aux): ``expert_load`` (E,) int32, the tokens routed to
    each expert (the MoE's LIB signal), ``dropped_frac``, ``router_z`` and
    ``load_balance``.

    The k expert outputs of a token are summed in ``x.dtype`` in that
    sorted order, as the reference's scatter-add sums them, with no
    atomics, and so are the gradients of a token's dispatched copies
    (``_DispatchGather``): reruns of the forward and the backward are
    bit-equal.  groups > 1 dispatches each of
    ``groups`` equal slices of the tokens on its own (per-group
    capacity); the loads add up, the other statistics are the groups'
    means.

    A DTensor x (its rows on the data axes, replicated over ``model``)
    with the router replicated and the expert weights split over
    ``model`` along F (column-parallel up, row-parallel down) is
    dispatched on its mesh by :func:`_moe_mesh`; ``out`` is then partial
    over ``model``.

    On the ``meta`` device (the dry run) the gather and scatter of the kept
    pairs are counted at their upper bound, every one of min(T * k, E * C)
    slots filled (:func:`_kept`); ``expert_load`` is a stand-in of its
    shape."""
    if is_dtensor(x):
        return _moe_mesh(x, router_w, w_gate, w_up, w_down, k=k,
                         capacity_factor=capacity_factor, groups=groups)
    if groups > 1:
        T, D = x.shape
        if T % groups:
            raise ValueError(f"{T} tokens do not split into {groups} groups")
        outs, auxes = zip(*(
            moe_block(xg, router_w, w_gate, w_up, w_down, k=k,
                      capacity_factor=capacity_factor)
            for xg in x.reshape(groups, T // groups, D)))
        stat = lambda n: torch.stack([a[n] for a in auxes])  # noqa: E731
        return torch.cat(outs), {
            "expert_load": stat("expert_load").sum(0, dtype=torch.int32),
            "dropped_frac": stat("dropped_frac").mean(),
            "router_z": stat("router_z").mean(),
            "load_balance": stat("load_balance").mean()}
    T, D = x.shape
    E = router_w.shape[-1]
    C = max(1, int(capacity_factor * k * T / E))

    logits, probs, topw, flat_e, order, e_sorted, t_sorted = _route(
        x, router_w, k)
    rank, keep = _keep(order, e_sorted, k, E, C)
    slot = e_sorted * C + rank

    # each token's pairs, in sorted order, brought together k a token
    by_token = torch.argsort(t_sorted, stable=True)
    kept = _kept(keep, E * C)
    buf = torch.zeros((E * C, D), dtype=x.dtype, device=x.device)
    buf[slot[kept]] = _DispatchGather.apply(x, t_sorted, kept, by_token, k)
    y = _experts(buf.reshape(E, C, D), w_gate, w_up, w_down).reshape(E * C, D)

    gathered = y[slot.clamp(max=E * C - 1)].masked_fill(~keep[:, None], 0)
    contrib = (gathered * topw.reshape(-1)[order][:, None]).to(x.dtype)
    out = _token_sums(contrib, by_token, T, k)

    load = torch.bincount(flat_e, minlength=E).to(torch.int32)
    aux = {
        "expert_load": load,
        "dropped_frac": 1.0 - keep.float().mean(),
        "router_z": (torch.logsumexp(logits, -1) ** 2).mean(),
        "load_balance": E * (probs.mean(0) * (
            load.float() / load.sum().clamp_min(1).float())).mean(),
    }
    return out, aux


# ---------------------------------------------------------------------------
# the MoE dispatch on a device mesh
# ---------------------------------------------------------------------------

def _moe_mesh(x, router_w, w_gate, w_up, w_down, *, k: int,
              capacity_factor: float, groups: int):
    """:func:`moe_block` of a DTensor x (T, D), its rows on the P data
    ranks (``Shard(0)``; P = 1 where they are replicated), replicated over
    ``model``, with the router replicated and the expert weights split
    over ``model`` along F.  Each ``model`` rank routes the same tokens
    and runs its F columns of every expert, so ``out`` is partial over
    ``model``; ``expert_load`` and the statistics are summed over the data
    ranks (replicated).  The G = ``groups`` dispatch groups are the
    reference's: G equal slices of the T tokens in order.

    * G a multiple of P: each rank's rows are G / P whole groups
      (``ctx.constrain_tokens_grouped`` lays the (G, T / G, D) groups over
      the data axes), each dispatched locally (:func:`_moe_groups`).
    * P a multiple of G: a group spans R = P / G data ranks
      (:func:`_moe_span`), its capacity buffer split over them.
    * Otherwise: ``NotImplementedError``."""
    from torch.distributed.tensor import Partial, Replicate
    m = x.device_mesh
    dp, tp = ctx.data_dims(m), ctx.model_dim(m)
    T, D = x.shape
    if T % groups:
        raise ValueError(f"{T} tokens do not split into {groups} groups")
    P = math.prod(m.size(i) for i in dp if x.placements[i].is_shard(0))
    if groups % P == 0:
        xin = ctx.constrain_tokens_grouped(
            x.reshape(groups, T // groups, D))
        local = functools.partial(
            _moe_groups, k=k, cf=capacity_factor,
            P=math.prod(m.size(i) for i in dp
                        if xin.placements[i].is_shard(0)))
    elif P % groups == 0:
        xin = x
        span = ctx.span_group(m, [i for i in dp
                                  if x.placements[i].is_shard(0)],
                              P // groups)
        local = functools.partial(_moe_span, k=k, cf=capacity_factor,
                                  span=span, P=P)
    else:
        raise NotImplementedError(
            f"{groups} MoE groups over {P} data ranks: a group that "
            f"neither holds whole ranks' tokens nor spans whole ranks is "
            f"not dispatched on a mesh")
    split = [i for i in dp if xin.placements[i].is_shard(0)]
    x_pl = tuple(xin.placements)
    out_pl = tuple(Partial() if i == tp else p for i, p in enumerate(x_pl))
    sums = tuple(Partial() if i in split else Replicate()
                 for i in range(m.ndim))
    w_grad = [tuple(Partial() if i in split else p
                    for i, p in enumerate(w.placements))
              for w in (w_gate, w_up, w_down)]
    r_grad = tuple(Partial() if (i in split or i == tp) else Replicate()
                   for i in range(m.ndim))
    args = (xin, router_w, w_gate, w_up, w_down)
    out, load, stats = ctx.on_shards(
        local, args, tuple(tuple(a.placements) for a in args),
        (out_pl, sums, sums), (out_pl, r_grad, *w_grad))
    stats = ctx.replicate(stats)
    return out.reshape(T, D), {
        "expert_load": ctx.replicate(load), "dropped_frac": stats[0],
        "router_z": stats[1], "load_balance": stats[2]}


def _moe_groups(xg, router_w, w_gate, w_up, w_down, *, k: int, cf: float,
                P: int):
    """A rank's whole groups xg (G_rank, T / G, D), dispatched by
    :func:`moe_block` as the reference dispatches them: (out, the rank's
    expert_load, its groups' mean statistics / P, so that their sum over
    the P ranks is the groups' mean)."""
    n, T, D = xg.shape
    out, aux = moe_block(xg.reshape(n * T, D), router_w, w_gate, w_up,
                         w_down, k=k, capacity_factor=cf, groups=n)
    stats = torch.stack([aux["dropped_frac"], aux["router_z"],
                         aux["load_balance"]]).detach()
    return out.reshape(n, T, D), aux["expert_load"], stats / P


def _moe_span(x, router_w, w_gate, w_up, w_down, *, k: int, cf: float,
              span, P: int):
    """This rank's T tokens x (T, D) of a dispatch group that spans the R
    data ranks of ``span`` (``ctx.span_group``: the group's name, R, this
    rank's place j), dispatched as the reference dispatches the group's R
    * T tokens, without gathering them.  Each rank routes its own tokens;
    the R ranks' pairs a expert (an all-gather of E counts) give each pair
    its rank within its expert's pairs in the group's stable order (the
    pairs of lower ranks first), so ``keep`` and the slots are the
    reference's, with no global sort.  The (E, C, D) buffer's C slots are
    split over the ranks, c = ceil(C / R) each, and each kept pair's row
    moves to the rank that holds its slot by an all-to-all, in the order
    of (expert, rank in expert), from which the receiver places the rows;
    the experts' rows come back by the reverse all-to-all, and each
    token's k outputs are summed in the sorted order, as one rank would.
    Returns (out, the rank's expert_load, the group's statistics / P).

    On the ``meta`` device the split sizes, which depend on the data, are
    counted at their upper bound: each rank sends and receives min(T * k,
    E * c) rows, evenly over the R ranks (:func:`_span_routes`)."""
    name, R, j = span
    T, D = x.shape
    E = router_w.shape[-1]
    C = max(1, int(cf * k * T * R / E))            # the group's capacity
    c = -(-C // R)                                 # its slots a rank
    logits, probs, topw, flat_e, order, e_sorted, t_sorted = _route(
        x, router_w, k)
    counts = torch.bincount(flat_e, minlength=E)
    every = ctx.group_all_gather(counts, name, R).reshape(R, E)
    rank, keep = _keep(order, e_sorted, k, E, C, every[:j].sum(0))
    by_token = torch.argsort(t_sorted, stable=True)
    kept, send, recv, at = _span_routes(rank, keep, every, j, c, C, T * k)
    rows = _DispatchGather.apply(x, t_sorted, kept, by_token, k)
    buf = x.new_zeros((E * c, D))
    buf[at] = ctx.all_to_all(rows, recv, send, name)
    y = _experts(buf.reshape(E, c, D), w_gate, w_up, w_down).reshape(E * c, D)
    gathered = y.new_zeros((T * k, D))
    gathered[kept] = ctx.all_to_all(y[at], send, recv, name)
    contrib = (gathered * topw.reshape(-1)[order][:, None]).to(x.dtype)
    out = _token_sums(contrib, by_token, T, k)
    with torch.no_grad():
        sums = ctx.group_all_reduce(torch.cat([
            keep.float().sum()[None],
            (torch.logsumexp(logits, -1) ** 2).sum()[None],
            probs.sum(0)]), name)
        load = every.sum(0).float()
        n = T * R
        stats = torch.stack([
            1.0 - sums[0] / (n * k), sums[1] / n,
            E * ((sums[2:] / n) * (load / load.sum().clamp_min(1))).mean()])
    return out, counts.to(torch.int32), stats / P


def _span_routes(rank, keep, every, j: int, c: int, C: int, pairs: int):
    """The all-to-all's routes of a spanning group, for the rank at place
    j of R: (``kept``, the kept sorted pairs in the order they are sent,
    by destination rank, then expert and rank in expert; ``send`` and
    ``recv``, the rows sent to and received from each rank; ``at``, the
    buffer slot of each received row).  Rank i sends rank j its pairs of
    expert e whose rank in e lies in j's slots [j c, (j + 1) c) (and below
    C), and its pairs of e have ranks [O_ie, O_ie + n_ie) after the pairs
    of lower ranks (``every``: n, (R, E)); so j knows what arrives, and
    where, from the counts alone.  On ``meta``, the upper bound of
    :func:`_moe_span`."""
    R, E = every.shape
    dev = rank.device
    if dev.type == "meta":
        n = min(pairs, E * c)
        even = [n // R + (i < n % R) for i in range(R)]
        idx = torch.arange(n, device=dev)
        return idx, even, even, idx
    dst = rank // c
    kept = keep.nonzero()[:, 0]
    kept = kept[torch.argsort(dst[kept], stable=True)]
    send = torch.bincount(dst[kept], minlength=R)
    first = every.cumsum(0) - every                # (R, E)
    lo = first.clamp(min=j * c)
    hi = (first + every).clamp(max=min((j + 1) * c, C))
    lens = (hi - lo).clamp(min=0)
    start = torch.arange(E, device=dev)[None] * c + lo - j * c
    flat = lens.reshape(-1)
    at = torch.repeat_interleave(start.reshape(-1) - (flat.cumsum(0) - flat),
                                 flat)
    at = at + torch.arange(at.shape[0], device=dev)
    sizes = torch.cat([send, lens.sum(1)]).tolist()
    return kept, sizes[:R], sizes[R:], at
