"""Sharding rules: the campaign's lane split, and the parameter, optimizer,
batch and cache partition specs of the model stack.

The port of ``repro.distributed.sharding``.  Its two halves:

* Lanes (the reference's lines 28-57): a campaign mesh
  (``repro_torch.launch.mesh.campaign_mesh``) is an ordered list of devices
  along one ``data`` axis, and every batched lane dimension (instances,
  what-if candidate rows) is cut into one contiguous shard a device.
* The model stack (lines 60-185), on an abstract production mesh
  (``repro_torch.launch.mesh.production_mesh``: the (16, 16) ``data,
  model`` pod or the (2, 16, 16) ``pod, data, model`` pair):

  - TP over the ``model`` axis: attention heads, FFN hidden, vocab.
  - FSDP (ZeRO-3-style weight sharding) over the data axes for the other
    matrix dimension, so that grok-1-314b's parameters and Adam moments
    are spread over all 256 or 512 chips.
  - Batch over (``pod``, ``data``); KV caches shard their sequence axis
    over ``model``; SSM decode state shards heads over ``model``.

  A :class:`Spec` stands for JAX's ``PartitionSpec``.  :func:`named`
  turns one into ``torch.distributed.tensor`` placements, which is what
  ``distribute_tensor`` takes on a ``DeviceMesh``;
  :func:`shard_shape` and :func:`shard_slices` give what JAX's
  ``NamedSharding`` gives: the shape, and the index ranges, that one
  device holds.  :func:`distribute` lays a tree out as DTensors on a
  ``DeviceMesh`` (``launch.mesh.device_mesh``) by its specs, the layout
  the model stack's partitioned step runs on; :func:`gather` gives the
  full tensors back.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Sequence, Tuple

import torch

from ..launch.mesh import AbstractMesh

#: the axes a campaign batch is split over: a campaign mesh has one
DATA_AXES = ("data",)


def data_axes(mesh) -> Tuple[str, ...]:
    """The composed batch axes: the present axes of ``("pod", "data")`` on
    an :class:`AbstractMesh`; ``("data",)`` on a campaign mesh (a device
    list)."""
    if isinstance(mesh, AbstractMesh):
        return tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return DATA_AXES


def lane_spec(mesh: Sequence) -> Tuple[str, ...]:
    """Leading-axis lane sharding for campaign batches: instances / what-if
    candidate rows shard over the data axis, everything trailing (schedule
    slots, PEs) stays on the lane's device."""
    return data_axes(mesh)


def lane_count(mesh: Sequence) -> int:
    """Extent of the data axis — the number of lane shards."""
    return len(mesh)


def pad_lanes(n: int, mesh: Sequence) -> int:
    """Round a lane count up to a multiple of the mesh's data extent so the
    leading axis divides evenly.  Padding lanes carry ``count == 0``
    schedules (the event cores never execute them) and are sliced off
    host-side, so the split results equal the unsplit ones bit for bit."""
    d = lane_count(mesh)
    return -(-n // d) * d


def shard_bounds(n: int, mesh: Sequence) -> Tuple[Tuple[int, int], ...]:
    """The ``[lo, hi)`` rows of each device's contiguous shard of ``n``
    lanes, ``n`` a multiple of the mesh's extent (:func:`pad_lanes`)."""
    d = lane_count(mesh)
    if n % d:
        raise ValueError(f"{n} lanes do not split evenly over {d} devices")
    s = n // d
    return tuple((i * s, (i + 1) * s) for i in range(d))


# ---------------------------------------------------------------------------
# the model stack's specs
# ---------------------------------------------------------------------------

class Spec(tuple):
    """A partition spec, JAX's ``PartitionSpec``: one entry a tensor dim,
    each ``None`` (not split), an axis name, or a tuple of axis names (the
    dim split over their product, the first axis major).  Dims past the
    last entry are not split; trailing ``None`` entries are trimmed."""

    def __new__(cls, *entries):
        entries = list(entries)
        while entries and entries[-1] is None:
            entries.pop()
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"Spec({', '.join(map(repr, self))})"


def _axes(entry) -> Tuple[str, ...]:
    """The mesh axes a spec entry names, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _axis_size(mesh: AbstractMesh, entry) -> int:
    n = 1
    for a in _axes(entry):
        n *= mesh.shape[a]
    return n


def _entries(spec: Spec, shape: Tuple[int, ...]) -> List:
    if len(spec) > len(shape):
        raise ValueError(f"{spec} has more entries than {tuple(shape)}")
    return list(spec) + [None] * (len(shape) - len(spec))


def fit_spec(spec: Spec, shape: Tuple[int, ...],
             mesh: AbstractMesh) -> Spec:
    """Drop sharding on axes whose size doesn't divide the mesh extent —
    odd vocabularies (whisper's 51865), batch=1 decode, 12-head models.
    Tuple entries are reduced one axis at a time before giving up: the
    major axis goes first, to the one minor axis when two are left."""
    out = []
    for dim, entry in zip(shape, _entries(spec, shape)):
        while entry is not None and dim % _axis_size(mesh, entry) != 0:
            if isinstance(entry, tuple) and len(entry) > 1:
                entry = entry[1:] if len(entry) > 2 else entry[1]
            else:
                entry = None
        out.append(entry)
    return Spec(*out)


def _spec_for(name: str, ndim: int, dp, tp, fsdp: bool) -> Spec:
    """Partition spec by parameter name.  Leading layer-stack dims (ndim
    larger than the logical rank) are never sharded; ``embed`` and
    ``lm_head`` are not lifted."""
    d = dp if fsdp else None

    def lift(*tail):
        """Pad with None for layer-stack leading dims."""
        return Spec(*([None] * (ndim - len(tail)) + list(tail)))

    if name in ("embed",):
        return Spec(tp, d)
    if name in ("lm_head",):
        return Spec(d, tp)
    if name in ("wq", "wk", "wv", "xwq", "xwk", "xwv", "w_gate", "w_up",
                "w1", "in_proj"):
        return lift(d, tp)
    if name in ("wo", "xwo", "w_down", "w2", "out_proj"):
        return lift(tp, d)
    if name in ("router",):
        return lift(d, None)
    if name in ("we_gate", "we_up"):
        return lift(None, d, tp)      # (L, E, D, F)
    if name in ("we_down",):
        return lift(None, tp, d)      # (L, E, F, D)
    if name in ("b1",):
        return lift(tp)
    if name in ("conv_w",):
        return lift(None, tp)         # (L, k, channels)
    if name in ("gate_norm",):
        return lift(tp)
    # norms, biases, A_log, D, dt_bias, scalars: replicate
    return Spec()


def _dp_tp(mesh: AbstractMesh):
    """The batch entry (one axis name, or the tuple of data axes) and the
    tensor-parallel axis of ``mesh``."""
    dp = data_axes(mesh)
    dp = dp if len(dp) > 1 else (dp[0] if dp else None)
    return dp, ("model" if "model" in mesh.axis_names else None)


def param_specs(cfg, mesh: AbstractMesh, params_shape: Dict,
                fsdp: bool = True, fit: bool = True) -> Dict:
    """Spec tree matching ``params_shape`` (nested dicts of leaves with a
    ``shape``: ``launch.steps.params_shape``'s meta tensors).  ``fit=False``
    gives the specs before :func:`fit_spec` (for :func:`unsharded`)."""
    dp, tp = _dp_tp(mesh)

    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        spec = _spec_for(path[-1], len(tree.shape), dp, tp, fsdp)
        return fit_spec(spec, tuple(tree.shape), mesh) if fit else spec

    return walk(params_shape)


def batch_specs(cfg, mesh: AbstractMesh) -> Dict:
    """The train batch: ``tokens`` and ``labels`` (B, S) over the data
    axes, and the audio frontend's ``embeds`` (B, frames, D)."""
    dp, _ = _dp_tp(mesh)
    out = {"tokens": Spec(dp, None), "labels": Spec(dp, None)}
    if cfg.frontend == "audio":
        out["embeds"] = Spec(dp, None, None)
    return out


def cache_specs(cfg, mesh: AbstractMesh, cache_shape: Dict,
                fit: bool = True) -> Dict:
    """KV caches (``k``, ``v``, the enc-dec family's ``xk`` / ``xv``; (L,
    B, S, K, hd)): sequence over ``model``, batch over the data axes; SSM
    ``conv`` (L, B, k-1, ch): channels over ``model``; ``state`` (L, B,
    nh, hp, st): heads over ``model``; ``len`` replicated.  ``fit=False``
    gives the specs before :func:`fit_spec`."""
    dp, tp = _dp_tp(mesh)
    out: Dict = {}
    for k, leaf in cache_shape.items():
        if k in ("k", "v", "xk", "xv", "state"):
            spec = Spec(None, dp, tp, None, None)
        elif k == "conv":
            spec = Spec(None, dp, None, tp)
        else:
            spec = Spec()
        out[k] = fit_spec(spec, tuple(leaf.shape), mesh) if fit else spec
    return out


def _map_specs(fn, tree):
    """``fn`` over every :class:`Spec` of a tree of dicts and named
    tuples."""
    if isinstance(tree, Spec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_specs(fn, v) for v in tree))
    raise TypeError(f"not a spec tree: {type(tree).__name__}")


def opt_specs(param_spec_tree: Dict):
    """Adam moments inherit the parameter sharding (ZeRO: fully sharded);
    the step count is replicated."""
    from ..optim.adamw import AdamWState
    return AdamWState(step=Spec(),
                      m=_map_specs(lambda s: s, param_spec_tree),
                      v=_map_specs(lambda s: s, param_spec_tree))


def placements(spec: Spec, mesh: AbstractMesh) -> Tuple:
    """``spec`` as ``torch.distributed.tensor`` placements, one a mesh
    axis in the mesh's order: ``Shard(dim)`` where tensor dim ``dim``'s
    entry names the axis, ``Replicate()`` elsewhere.  A dim split over
    several axes takes them major to minor in the mesh's order, as
    ``Shard`` on each does; so its tuple must list them in that order."""
    from torch.distributed.tensor import Replicate, Shard
    dims: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        if list(axes) != sorted(axes, key=mesh.axis_names.index):
            raise ValueError(f"{spec}: {axes} are not in the mesh's order "
                             f"{mesh.axis_names}")
        for a in axes:
            if a in dims:
                raise ValueError(f"{spec} names axis {a!r} twice")
            dims[a] = d
    return tuple(Shard(dims[a]) if a in dims else Replicate()
                 for a in mesh.axis_names)


def named(mesh: AbstractMesh, spec_tree):
    """Every spec of ``spec_tree`` as its :func:`placements`."""
    return _map_specs(lambda s: placements(s, mesh), spec_tree)


def mesh_axes(mesh) -> AbstractMesh:
    """The axes of a ``DeviceMesh`` (or an :class:`AbstractMesh`) as an
    :class:`AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return mesh
    return AbstractMesh(tuple(mesh.mesh_dim_names), tuple(mesh.shape))


def _map_tree(fn, tree, spec_tree):
    """``fn(leaf, spec)`` over a tree of dicts and named tuples and its
    spec tree, by key."""
    if isinstance(spec_tree, Spec):
        return fn(tree, spec_tree)
    if isinstance(spec_tree, dict):
        return {k: _map_tree(fn, tree[k], s) for k, s in spec_tree.items()}
    if isinstance(spec_tree, tuple) and hasattr(spec_tree, "_fields"):
        return type(tree)(*(_map_tree(fn, getattr(tree, k), s)
                            for k, s in zip(spec_tree._fields, spec_tree)))
    raise TypeError(f"not a spec tree: {type(spec_tree).__name__}")


def distribute(tree, spec_tree, mesh):
    """Every leaf of ``tree`` as a DTensor on the ``DeviceMesh`` ``mesh``,
    laid out by its spec in ``spec_tree`` (:func:`placements`).  Each rank
    keeps its own shard of the full leaf it holds, so every rank must
    hold the same tree (the same seed): nothing is sent.  A leaf on the
    meta device gives meta shards."""
    from torch.distributed.tensor import distribute_tensor
    axes = mesh_axes(mesh)
    return _map_tree(lambda t, s: distribute_tensor(
        t, mesh, placements(s, axes), src_data_rank=None), tree, spec_tree)


def from_shards(tree, spec_tree, mesh, make):
    """Every leaf of ``tree`` (anything with a shape and a dtype: the meta
    stand-ins, ``TensorSpec`` records) as a DTensor on the ``DeviceMesh``
    ``mesh`` laid out by its spec, its local shard ``make(leaf,
    shard_shape)``: the shards of a step too large for one card made
    where they run, with no full leaf anywhere."""
    from torch.distributed.tensor import DTensor
    from .ctx import strides
    axes = mesh_axes(mesh)

    def one(leaf, spec):
        local = make(leaf, shard_shape(spec, tuple(leaf.shape), axes))
        return DTensor.from_local(local, mesh, placements(spec, axes),
                                  run_check=False,
                                  shape=torch.Size(leaf.shape),
                                  stride=strides(leaf.shape))

    return _map_tree(one, tree, spec_tree)


def gather(tree):
    """``tree`` (dicts, named tuples, lists and tuples) with every DTensor
    leaf gathered into the full tensor on each rank; other leaves as they
    are."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, DTensor):
        return tree.full_tensor()
    if isinstance(tree, dict):
        return {k: gather(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(gather(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather(v) for v in tree)
    return tree


def shard_shape(spec: Spec, shape: Tuple[int, ...],
                mesh: AbstractMesh) -> Tuple[int, ...]:
    """The shape of the shard that each device holds of a ``shape`` tensor
    laid out by ``spec``; raises where an axis does not divide its dim."""
    out = []
    for dim, entry in zip(shape, _entries(spec, shape)):
        n = _axis_size(mesh, entry)
        if dim % n:
            raise ValueError(f"dim {dim} does not split over {entry} ({n})")
        out.append(dim // n)
    return tuple(out)


def shard_slices(spec: Spec, shape: Tuple[int, ...], mesh: AbstractMesh,
                 coord: Tuple[int, ...]) -> Tuple[slice, ...]:
    """The index ranges of a ``shape`` tensor laid out by ``spec`` that the
    device at mesh coordinate ``coord`` (one index an axis, in the mesh's
    order) holds: one slice a dim.  A dim split over a tuple of axes is
    split major to minor in the tuple's order, as JAX splits it."""
    if len(coord) != len(mesh.axis_names) or not all(
            0 <= c < n for c, n in zip(coord, mesh.axis_sizes)):
        raise ValueError(f"{coord} is not a coordinate of {mesh}")
    at = dict(zip(mesh.axis_names, coord))
    sizes = shard_shape(spec, shape, mesh)
    out = []
    for size, entry in zip(sizes, _entries(spec, shape)):
        i = 0
        for a in _axes(entry):
            i = i * mesh.shape[a] + at[a]
        out.append(slice(i * size, (i + 1) * size))
    return tuple(out)


def spec_leaves(tree, spec_tree, path: Tuple[str, ...] = ()
                ) -> Iterator[Tuple[Tuple[str, ...], object, Spec]]:
    """(key path, leaf, spec) of a tree (dicts and named tuples of leaves
    with a ``shape`` and a ``dtype``) and its spec tree, by key."""
    if isinstance(spec_tree, Spec):
        yield path, tree, spec_tree
    elif isinstance(spec_tree, dict):
        for k, s in spec_tree.items():
            yield from spec_leaves(tree[k], s, path + (k,))
    elif isinstance(spec_tree, tuple) and hasattr(spec_tree, "_fields"):
        for k, s in zip(spec_tree._fields, spec_tree):
            yield from spec_leaves(getattr(tree, k), s, path + (k,))
    else:
        raise TypeError(f"not a spec tree: {type(spec_tree).__name__}")


def device_bytes(tree, spec_tree, mesh: AbstractMesh) -> int:
    """The bytes one device holds of ``tree`` laid out by ``spec_tree``
    (every device holds as many: the specs split evenly)."""
    return sum(math.prod(shard_shape(s, tuple(leaf.shape), mesh))
               * leaf.dtype.itemsize
               for _, leaf, s in spec_leaves(tree, spec_tree))


def unsharded(spec_tree, tree, mesh: AbstractMesh) -> List[Dict]:
    """Where :func:`fit_spec` drops an axis from the specs before fitting
    (``spec_tree``): ``{"leaf": "a/b", "dim": d, "axis": name}`` for each
    axis of each leaf's dims that the fitted spec no longer names."""
    out = []
    for path, leaf, spec in spec_leaves(tree, spec_tree):
        fitted = _entries(fit_spec(spec, tuple(leaf.shape), mesh),
                          leaf.shape)
        for d, entry in enumerate(spec):
            for a in _axes(entry):
                if a not in _axes(fitted[d]):
                    out.append({"leaf": "/".join(path), "dim": d, "axis": a})
    return out
