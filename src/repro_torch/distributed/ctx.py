"""Activation-sharding context: the model stack's flags, and the layout
of its tensors on a device mesh.

The port of ``repro.distributed.ctx``.  The reference installs a context
that constrains the block-boundary activations, the grouped MoE tokens
and the expert weights to a device mesh, and carries three flags to the
model: ``moe_groups`` (the MoE dispatch's token groups), ``attn_bf16``
and ``attn_remat`` (its chunked attention's score dtype and per-chunk
rematerialization).

On a mesh the port's tensors are DTensors (``distributed.sharding.
distribute`` over ``launch.mesh.device_mesh``), and where the reference
leaves the rest of the layout to GSPMD the port places every product's
operands itself, so that DTensor never picks a strategy that shards a
contraction (a ``Partial`` activation and an all-reduce of activations,
the reference's §Perf B2 case):

* :func:`constrain_boundary` is the reference's rule: a block-boundary
  activation (B, S, D) has its batch on the data axes where B divides
  and its sequence on ``model`` where S divides (Megatron-SP).
* :func:`gather_weight` gathers a weight's shards on the data axes
  (FSDP's all-gather before a layer's products, the expert weights'
  too) and keeps its ``model`` placement; :func:`gather_model` gathers an
  activation's sequence over ``model`` before the column-parallel
  products; :func:`like` takes a row-parallel product's partial sums
  back to the residual's layout (a reduce-scatter).
* :func:`head_groups` says how attention's heads split over ``model``;
  :func:`kv_weight` repeats the kv heads' columns where fewer kv heads
  than ``model`` ranks would leave a rank without its group, and
  :func:`pad_heads` pads the groups with zero heads where they do not
  split evenly.
* The MoE dispatch (``models/layers.py::_moe_mesh``):
  :func:`constrain_tokens_grouped` lays its groups over the data axes;
  a group that spans several data ranks moves its rows by
  :func:`all_to_all` over the process group :func:`span_group` makes,
  and sums its counts with :func:`group_all_gather` and
  :func:`group_all_reduce`.

Each is the identity on a plain tensor, so with no mesh every path
computes what it computed before.  ``moe_groups`` is read by the MoE
block (``models/model.py::_moe_block_apply``).  Nothing in the port
reads ``attn_bf16`` or ``attn_remat``: they feed only the reference's
chunked attention, and the port's attention is the flash kernel, whose
scores are always float32 and never stored.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import List, Optional, Tuple

import torch

from ..kernels.common import is_dtensor, on_shards

_STATE: dict = {"mesh": None, "attn_bf16": False, "attn_remat": False,
                "moe_groups": 1}

#: the mesh axes a batch is split over, major first
DATA_AXES = ("pod", "data")
MODEL_AXIS = "model"


@contextmanager
def activation_sharding(mesh=None, tp: Optional[str] = None,
                        dp_size: int = 1, tp_size: int = 1,
                        attn_bf16: bool = False, attn_remat: bool = False,
                        moe_groups: int = 1):
    """Install the mesh and the flags until the context closes.  ``mesh``
    is the ``DeviceMesh`` the model's DTensors lie on, or ``None`` (one
    device).  ``tp``, ``dp_size`` and ``tp_size`` are the reference's
    arguments; on a ``DeviceMesh`` the axes' names and sizes are read
    from the mesh, and nothing reads them.  Where ``moe_groups`` groups
    each span several of the mesh's data ranks, their process groups are
    made here (:func:`span_group`), by every rank, before any step."""
    if mesh is not None and not hasattr(mesh, "mesh_dim_names"):
        raise TypeError(f"activation_sharding takes a DeviceMesh or None, "
                        f"not {type(mesh).__name__}")
    if mesh is not None:
        dp, _ = _dims(mesh)
        P = math.prod(mesh.size(i) for i in dp)
        if moe_groups < P and P % moe_groups == 0:
            span_group(mesh, dp, P // moe_groups)
    prev = dict(_STATE)
    _STATE.update(mesh=mesh, attn_bf16=attn_bf16, attn_remat=attn_remat,
                  moe_groups=moe_groups)
    try:
        yield
    finally:
        _STATE.update(prev)


def mesh():
    """The installed ``DeviceMesh``, or ``None``."""
    return _STATE["mesh"]


def attn_bf16() -> bool:
    return _STATE["attn_bf16"]


def attn_remat() -> bool:
    return _STATE["attn_remat"]


def moe_groups() -> int:
    return _STATE["moe_groups"]


def _dims(device_mesh) -> Tuple[List[int], Optional[int]]:
    """The indices of the data axes and of the model axis of a mesh."""
    names = tuple(device_mesh.mesh_dim_names)
    dp = [i for i, n in enumerate(names) if n in DATA_AXES]
    return dp, (names.index(MODEL_AXIS) if MODEL_AXIS in names else None)


def model_size(device_mesh) -> int:
    _, tp = _dims(device_mesh)
    return 1 if tp is None else device_mesh.size(tp)


def data_dims(device_mesh) -> List[int]:
    """The indices of the data axes of a mesh, major first."""
    return _dims(device_mesh)[0]


def model_rank(device_mesh) -> int:
    """This rank's coordinate on the model axis (0 without one)."""
    _, tp = _dims(device_mesh)
    return 0 if tp is None else device_mesh.get_local_rank(tp)


def strides(shape) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape``."""
    out, n = [], 1
    for d in reversed(tuple(shape)):
        out.append(n)
        n *= d
    return tuple(reversed(out))


def model_dim(device_mesh) -> Optional[int]:
    """The index of the model axis of a mesh, or ``None``."""
    return _dims(device_mesh)[1]


def redistribute(x, placements):
    """A DTensor laid out as ``placements`` (itself when it is)."""
    placements = tuple(placements)
    if placements == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def constrain_expert_weights(w, kind: str):
    """Identity, as the reference's stack leaves it (it never calls its
    version: forcing the expert weights' FSDP gather made GSPMD replicate
    the expert gradients' products over the data axes).  On a mesh the
    expert weights are gathered on the data axes by :func:`gather_weight`
    like every other weight, their F left on ``model``."""
    return w


def constrain_tokens_grouped(xg):
    """The MoE's dispatch groups xg (G, T / G, D): a DTensor has its
    groups laid over the data axes where G is a multiple of their size,
    the rest replicated, as the reference constrains them; otherwise, or
    for a plain tensor, xg as it is."""
    if not is_dtensor(xg) or xg.ndim != 3:
        return xg
    from torch.distributed.tensor import Replicate, Shard
    m = xg.device_mesh
    dp, _ = _dims(m)
    if not dp or xg.shape[0] % math.prod(m.size(i) for i in dp):
        return xg
    return redistribute(xg, [Shard(0) if i in dp else Replicate()
                             for i in range(m.ndim)])


def constrain_boundary(x):
    """x: (B, S, D) hidden states at a block boundary.  A DTensor is laid
    out as the reference constrains it: batch over the data axes where B
    divides their size, sequence over ``model`` where S divides it (and is
    at least it), D replicated; left as it is when neither divides.  A
    plain tensor is returned as it is."""
    if not is_dtensor(x) or x.ndim != 3:
        return x
    from torch.distributed.tensor import Replicate, Shard
    m = x.device_mesh
    dp, tp = _dims(m)
    if tp is None:
        return x
    B, S, _ = x.shape
    dp_size = math.prod(m.size(i) for i in dp)
    tp_size = m.size(tp)
    shard_b = bool(dp) and B % dp_size == 0
    shard_s = S % tp_size == 0 and S >= tp_size
    if not (shard_b or shard_s):
        return x
    out = []
    for i in range(m.ndim):
        if i in dp and shard_b:
            out.append(Shard(0))
        elif i == tp and shard_s:
            out.append(Shard(1))
        else:
            out.append(Replicate())
    return redistribute(x, out)


def gather_weight(w):
    """A weight with its shards on the data axes gathered (``Replicate``)
    and its ``model`` placement kept: FSDP's all-gather before a layer's
    products.  The gradient comes back through a reduce-scatter onto the
    data axes.  A plain tensor is returned as it is."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate
    dp, _ = _dims(w.device_mesh)
    split = {p.dim for i, p in enumerate(w.placements)
             if i in dp and p.is_shard()}
    if len(split) == 1 and sum(w.placements[i].is_shard() for i in dp) > 1:
        return _GatherData.apply(w, split.pop())
    return redistribute(w, [Replicate() if i in dp else p
                            for i, p in enumerate(w.placements)])


def replicate(w):
    """A DTensor gathered whole on every rank (its data axes first, as
    :func:`gather_weight` gathers them)."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate
    return redistribute(gather_weight(w), [Replicate()] * w.device_mesh.ndim)


def _collective(name: str, t, dim: int, n: int, group_name: str):
    """An all-gather or a sum's reduce-scatter of ``t`` along ``dim`` over
    a process group of ``n`` ranks, by the functional collective ops
    (which move dim 0)."""
    c10d = torch.ops._c10d_functional
    x = t.movedim(dim, 0).contiguous()
    args = (x,) if name == "all_gather_into_tensor" else (x, "sum")
    out = getattr(c10d, name)(*args, n, group_name)
    return c10d.wait_tensor(out).movedim(0, dim).contiguous()


def group_all_gather(t, group_name: str, n: int):
    """The ``n`` ranks' ``t`` of a process group, concatenated along dim 0
    in their order (no gradient)."""
    return _collective("all_gather_into_tensor", t, 0, n, group_name)


def group_all_reduce(t, group_name: str):
    """The sum of ``t`` over a process group's ranks (no gradient)."""
    c10d = torch.ops._c10d_functional
    return c10d.wait_tensor(c10d.all_reduce(t.contiguous(), "sum",
                                            group_name))


def _all_to_all(t, out_splits, in_splits, group_name: str):
    c10d = torch.ops._c10d_functional
    return c10d.wait_tensor(c10d.all_to_all_single(
        t.contiguous(), list(out_splits), list(in_splits), group_name))


class _AllToAll(torch.autograd.Function):
    """An all-to-all of rows over a process group: ``in_splits[i]`` rows
    of ``t`` go to rank i, ``out_splits[i]`` arrive from it, in rank
    order.  Its gradient is the reverse all-to-all."""

    @staticmethod
    def forward(ctx, t, out_splits, in_splits, group_name):
        ctx.routes = (out_splits, in_splits, group_name)
        return _all_to_all(t, out_splits, in_splits, group_name)

    @staticmethod
    def backward(ctx, grad):
        out_splits, in_splits, group_name = ctx.routes
        return (_all_to_all(grad, in_splits, out_splits, group_name),
                None, None, None)


def all_to_all(t, out_splits, in_splits, group_name: str):
    """Rows of ``t`` exchanged over a process group (:class:`_AllToAll`):
    ``in_splits[i]`` rows to rank i, ``out_splits[i]`` from it."""
    return _AllToAll.apply(t, out_splits, in_splits, group_name)


#: id(DeviceMesh) -> {(data dims, ranks): span_group's answer}
_SPANS: dict = {}


def span_group(device_mesh, dims, ranks: int) -> Tuple[str, int, int]:
    """The process group of the ``ranks`` consecutive data ranks (over the
    mesh dims ``dims``, major first) that hold this rank's MoE dispatch
    group, at this rank's ``model`` coordinate: (its name, ``ranks``, this
    rank's place in it).  Made once a mesh: a group is made by every rank
    of the mesh together (``activation_sharding`` makes the stack's own
    before a step)."""
    import weakref
    from torch.distributed.device_mesh import DeviceMesh
    key = (tuple(dims), ranks)
    spans = _SPANS.get(id(device_mesh))
    if spans is None:
        spans = _SPANS[id(device_mesh)] = {}
        weakref.finalize(device_mesh, _SPANS.pop, id(device_mesh), None)
    if key not in spans:
        t = device_mesh.mesh
        rest = [i for i in range(t.ndim) if i not in dims]
        t = t.permute(*dims, *rest).reshape(
            -1, ranks, math.prod(t.shape[i] for i in rest))
        rows = t.transpose(1, 2).reshape(-1, ranks)
        sub = DeviceMesh(device_mesh.device_type, rows,
                         mesh_dim_names=("moe_rows", "moe_span"))["moe_span"]
        spans[key] = (sub.get_group().group_name, ranks,
                      sub.get_local_rank())
    return spans[key]


def span_groups(device_mesh) -> List[Tuple[str, int, int]]:
    """Every :func:`span_group` made on a mesh so far."""
    return list(_SPANS.get(id(device_mesh), {}).values())


class _GatherData(torch.autograd.Function):
    """FSDP's gather of a weight dim split over several data axes (``pod``
    major, then ``data``) as one all-gather over their flattened group,
    and its gradient's partial sums as one reduce-scatter over it, as XLA
    does over the replica group; DTensor would all-reduce over one axis
    and reduce-scatter over the other, twice the wire bytes."""

    @staticmethod
    def forward(ctx, w, dim):
        from torch.distributed.tensor import DTensor, Replicate
        m = w.device_mesh
        dp, _ = _dims(m)
        flat = m[tuple(m.mesh_dim_names[i] for i in dp)]._flatten()
        ctx.mesh, ctx.dim, ctx.dp, ctx.flat = m, dim, dp, flat
        ctx.placements = tuple(w.placements)
        ctx.out = tuple(Replicate() if i in dp else p
                        for i, p in enumerate(w.placements))
        full = _collective("all_gather_into_tensor", w.to_local(), dim,
                           flat.size(), flat.get_group().group_name)
        return DTensor.from_local(full, m, ctx.out, run_check=False)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Replicate
        dp = ctx.dp
        g = redistribute(g, [g.placements[i] if i in dp else p
                             for i, p in enumerate(ctx.out)])
        if not all(g.placements[i].is_partial() for i in dp):
            g = redistribute(g, [Replicate() if i in dp else p
                                 for i, p in enumerate(g.placements)])
            n, r = ctx.flat.size(), ctx.flat.get_local_rank()
            local = g.to_local().chunk(n, ctx.dim)[r].contiguous()
        else:
            local = _collective("reduce_scatter_tensor", g.to_local(),
                                ctx.dim, ctx.flat.size(),
                                ctx.flat.get_group().group_name)
        return DTensor.from_local(local, ctx.mesh, ctx.placements,
                                  run_check=False), None


def gather_model(x):
    """An activation with its ``model`` placement gathered (the sequence
    all-gather before Megatron-SP's column-parallel products)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    _, tp = _dims(x.device_mesh)
    if tp is None:
        return x
    return redistribute(x, [Replicate() if i == tp else p
                            for i, p in enumerate(x.placements)])


def like(x, ref):
    """``x`` redistributed to ``ref``'s placements: a row-parallel
    product's partial sums reduce-scattered onto the residual's
    sequence shards, or a replicated result sliced to them."""
    if not is_dtensor(x):
        return x
    return redistribute(x, ref.placements)


def replicated(t, ref):
    """A plain tensor (the same on every rank: positions' rotations) as a
    replicated DTensor on ``ref``'s mesh; ``t`` itself when ``ref`` is
    plain."""
    if not is_dtensor(ref):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    m = ref.device_mesh
    return DTensor.from_local(t, m, [Replicate()] * m.ndim, run_check=False)


def head_groups(cfg, device_mesh) -> int:
    """The query heads a kv head's group holds when attention runs
    head-parallel over ``model``.  The groups split over the model ranks
    where the kv heads do (kv heads a multiple of the model size) or
    where each rank's query heads lie in one group (the model size a
    multiple of the kv heads, ``model / kv`` dividing the group); else a
    group is padded with heads of zero weights up to the next such size
    (llama3.2-3b: 24 heads in 8 groups of 3 over 16 ranks, padded to
    groups of 4, two heads a rank, so a rank runs 2 of the 24 heads' work
    where the even split would run 1.5).  Kv heads that neither divide
    nor are divided by the model size raise."""
    tp = model_size(device_mesh)
    K = cfg.n_kv_heads
    G = cfg.n_heads // K
    if K % tp == 0:
        return G
    if tp % K:
        raise ValueError(f"{K} kv heads do not split over {tp} model ranks")
    r = tp // K
    return -(-G // r) * r


def pad_heads(w, n_kv: int, group: int, head_dim: int, dim: int):
    """A q projection (D, H * hd; ``dim`` 1) or an output projection
    (H * hd, D; ``dim`` 0) for head-parallel attention: FSDP-gathered,
    and where :func:`head_groups` pads the groups, gathered whole, each
    kv head's query heads followed by zero heads up to ``group``, then
    split over ``model`` along ``dim``.  The zero heads add nothing to
    the output, and the gradient drops their part."""
    if not is_dtensor(w):
        return w
    H = w.shape[dim] // head_dim
    if H == n_kv * group:
        return gather_weight(w)
    from torch.distributed.tensor import Replicate, Shard
    full = replicate(w)
    other = w.shape[1 - dim]
    heads = (n_kv, H // n_kv, head_dim)
    full = full.reshape((other,) + heads if dim else heads + (other,))
    gdim = 2 if dim else 1
    pad = list(full.shape)
    pad[gdim] = group - H // n_kv
    wide = torch.cat([full, full.new_zeros(pad)], dim=gdim)
    shape = (other, -1) if dim else (-1, other)
    wide = wide.reshape(shape)
    _, t = _dims(w.device_mesh)
    return redistribute(wide, [Shard(dim) if i == t else Replicate()
                               for i in range(w.device_mesh.ndim)])


def kv_weight(w, n_kv: int, head_dim: int):
    """A k or v projection (D, n_kv * head_dim) for head-parallel
    attention: FSDP-gathered, and where there are fewer kv heads than
    ``model`` ranks, gathered whole and each head's columns repeated
    model / n_kv times, so that rank r holds the kv head of its query
    heads, ``r * n_kv // model``; the repeated heads (model of them) are
    a GQA layout equal to the original.  The gradient sums the copies."""
    if not is_dtensor(w):
        return w
    tp = model_size(w.device_mesh)
    if n_kv % tp == 0:
        return gather_weight(w)
    from torch.distributed.tensor import Replicate, Shard
    r = tp // n_kv
    D = w.shape[0]
    full = replicate(w).reshape(D, n_kv, 1, head_dim)
    wide = full.expand(D, n_kv, r, head_dim).reshape(D, tp * head_dim)
    _, t = _dims(w.device_mesh)
    return redistribute(wide, [Shard(1) if i == t else Replicate()
                               for i in range(w.device_mesh.ndim)])


__all__ = ["activation_sharding", "attn_bf16", "attn_remat", "moe_groups",
           "mesh", "constrain_expert_weights", "constrain_tokens_grouped",
           "constrain_boundary", "gather_weight", "gather_model", "like",
           "replicate", "replicated", "head_groups", "pad_heads",
           "kv_weight", "data_dims", "span_group", "span_groups",
           "all_to_all",
           "group_all_gather", "group_all_reduce",
           "is_dtensor", "model_size", "model_rank", "model_dim",
           "redistribute", "on_shards", "strides"]
