"""Per-op cost count of an eager step: FLOPs, bytes, kernel launches and
live memory, as a ``TorchDispatchMode``.

The counterpart of ``repro.launch.hlo_analysis``.  The reference walks the
post-SPMD HLO text of a compiled step, multiplying while-loop bodies by
their trip counts, because XLA's own cost analysis visits a scanned layer
once.  The port has no HLO: its steps run eagerly, layers as Python loops.
So :class:`CostCounter` sits under the dispatcher and counts every aten op
the step dispatches as it runs (every layer, the backward, a checkpoint's
recompute), usually on the ``meta`` device, which allocates nothing (see
``repro_torch.launch.dryrun``).  No HLO is walked.  The module imports
nothing of the port: the kernel modules import :func:`kernel_cost`.

Accounting, per op (one card; the reference's categories):

* ``dot``: ``mm``, ``bmm``, ``addmm``, ``baddbmm`` and the convolutions,
  2·M·N·K FLOPs by ``torch.utils.flop_counter``'s formulas; bytes are the
  operands and the result.
* ``elementwise``: numel(result) FLOPs; bytes are each operand read once
  (an expanded operand's distinct elements) and the result written once,
  the eager kernel's traffic.  A fill writes its result only.
* ``other``: reductions, scans and softmaxes, numel(input) FLOPs, operand
  and result bytes.
* ``data_movement``: copies, gathers, scatters, ``index``, ``cat`` and
  padding, twice the bytes moved (a scatter's values, a gather's result;
  ``HloCostAnalysis``'s approximation).
* ``dus``: slice updates (``index_copy`` and a ``copy_`` into part of a
  larger tensor), twice the slice.
* views, reshapes, ``expand``, ``detach`` and allocations count nothing.
* ``kernel``: the port's hand-written kernels, which report their own work
  (:func:`kernel_cost`; each kernel module states its convention).
* ``collective``: the functional collectives (``_c10d_functional``, and
  DTensor's ``shard_dim_alltoall``) that a partitioned step issues, the
  result's bytes, and by kind (``COLL_KINDS``) the ring wire bytes a
  device sends, :func:`collective_wire` (the reference's) over the
  group's size; by process group too (``Costs.coll_groups``).  Nothing
  on one card.

On a device mesh (DTensor arguments, usually on the meta device in a
``launch.mesh.fake_world``) the count is one rank's: DTensor's own
dispatch runs under the mode, so the mode lets each DTensor op pass
(``NotImplemented``) and counts the local ops and collectives it issues
on the rank's shards, and it skips the ops of DTensor's shape
propagation, which run on fake tensors.

Each op's time bound is the larger of its bytes over the H100's HBM rate
and its FLOPs over the peak of its type: bf16 (and fp16) products and
bf16 kernels on the tensor cores, float32 products (TF32 off) and every
other op on the CUDA cores.  The per-op bytes are what an eager kernel
reads and writes; operands that stay in the 50 MB L2 between ops move
less, so the byte time is a lower bound only for ops larger than it.

Memory: each new storage an op creates adds its bytes while it lives
(``weakref.finalize`` takes them off when it is freed); views and in-place
results add nothing, and the storages of the step's arguments are not
counted.  Autograd's saved tensors and a checkpoint's recompute show as
they would on the card; the peak of the live bytes is the step's
``temp_bytes``.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, Optional

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth, dense bf16 tensor-core peak
#: and the float32 peak without TF32 (the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12

COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
              "collective-permute")
#: the reference's byte categories and the port's hand-written kernels
BYTE_CATS = ("dot", "elementwise", "dus", "data_movement", "collective",
             "other", "kernel")


def ops_rate(dtype: Optional[torch.dtype]) -> float:
    """Peak operations a second of a product in ``dtype`` on the tensor
    cores (bf16, fp16), else on the CUDA cores (float32 and ``None``)."""
    if dtype in (torch.bfloat16, torch.float16):
        return BF16_OPS_PER_S
    return F32_OPS_PER_S


@dataclass
class Costs:
    """The reference's fields (``flops``, ``bytes``, ``coll``,
    ``bytes_by``), FLOPs by category, the hand-written kernels' tallies
    (name -> launches, flops, bytes), ops dispatched by category, and the
    H100 time terms: ``compute_s`` (FLOPs over each op's peak),
    ``memory_s`` (bytes over the HBM rate) and ``op_sum_s`` (each op's
    larger term, summed)."""
    flops: float = 0.0
    bytes: float = 0.0
    coll: Dict[str, float] = field(
        default_factory=lambda: {k: 0.0 for k in COLL_KINDS})
    bytes_by: Dict[str, float] = field(
        default_factory=lambda: {k: 0.0 for k in BYTE_CATS})
    flops_by: Dict[str, float] = field(
        default_factory=lambda: {k: 0.0 for k in BYTE_CATS})
    ops_by: Dict[str, int] = field(
        default_factory=lambda: {k: 0 for k in BYTE_CATS})
    kernels: Dict[str, Dict[str, float]] = field(default_factory=dict)
    #: (kind, process group name) -> [calls, wire bytes, result bytes]
    coll_groups: Dict[tuple, list] = field(default_factory=dict)
    compute_s: float = 0.0
    memory_s: float = 0.0
    op_sum_s: float = 0.0

    def add(self, cat: str, flops: float, nbytes: float,
            rate: float = F32_OPS_PER_S) -> None:
        """One op of category ``cat``."""
        self.flops += flops
        self.bytes += nbytes
        self.flops_by[cat] += flops
        self.bytes_by[cat] += nbytes
        self.ops_by[cat] += 1
        c, m = flops / rate, nbytes / HBM_BYTES_PER_S
        self.compute_s += c
        self.memory_s += m
        self.op_sum_s += max(c, m)

    def collective(self, kind: str, group: str, size: int,
                   result_bytes: float) -> None:
        """One collective of ``kind`` over a process group (its name and
        size) whose result has ``result_bytes``."""
        wire = collective_wire(kind, result_bytes, max(2, size))
        self.add("collective", 0, result_bytes)
        self.coll[kind] += wire
        tally = self.coll_groups.setdefault((kind, group), [0, 0.0, 0.0])
        tally[0] += 1
        tally[1] += wire
        tally[2] += result_bytes

    def bound(self) -> Dict:
        """The H100 bound: the three time terms and the dominant one."""
        return {"compute_s": self.compute_s, "memory_s": self.memory_s,
                "op_sum_s": self.op_sum_s,
                "dominant": ("compute" if self.compute_s > self.memory_s
                             else "memory")}


def collective_wire(kind: str, result_bytes: float, G: int) -> float:
    """Per-device wire bytes for a ring implementation (the reference's
    ``hlo_analysis.collective_wire``)."""
    if kind == "all-gather":
        return (G - 1) / G * result_bytes
    if kind == "all-reduce":
        return 2 * (G - 1) / G * result_bytes
    if kind == "reduce-scatter":
        return (G - 1) * result_bytes
    if kind == "all-to-all":
        return (G - 1) / G * result_bytes
    return float(result_bytes)


# ---------------------------------------------------------------------------
# per-op classification
# ---------------------------------------------------------------------------

_aten = torch.ops.aten


def _packets(*names: str):
    return {getattr(_aten, n) for n in names if hasattr(_aten, n)}


#: products: the formulas of ``torch.utils.flop_counter``
_DOT = _packets("mm", "addmm", "bmm", "baddbmm", "convolution",
                "_convolution", "convolution_backward")
#: no traffic: allocations, aliases, and ``arange`` (XLA's iota, which
#: the reference skips too)
_FREE = _packets("empty", "empty_like", "empty_strided", "new_empty",
                 "new_empty_strided", "detach", "alias", "lift_fresh",
                 "_unsafe_view", "arange", "_local_scalar_dense",
                 "sym_size", "sym_stride", "sym_numel", "is_same_size")
#: writes of a constant: the result's bytes only
_FILL = _packets("fill_", "fill", "zero_", "zeros", "ones", "full",
                 "zeros_like", "ones_like", "full_like", "new_zeros",
                 "new_ones", "new_full", "scalar_tensor")
_GATHER = _packets("index", "_unsafe_index", "index_select", "gather",
                   "embedding", "cat", "constant_pad_nd", "clone", "sort",
                   "flip", "roll", "repeat", "take_along_dim",
                   "masked_select", "expand_copy", "permute_copy")
#: scatters: the values written (argument 2 or 3)
_SCATTER = {p: 2 for p in _packets("index_put", "index_put_",
                                   "_index_put_impl_", "masked_scatter",
                                   "masked_scatter_")}
_SCATTER.update({p: 3 for p in _packets(
    "scatter", "scatter_", "scatter_add", "scatter_add_", "scatter_reduce",
    "scatter_reduce_", "index_add", "index_add_", "embedding_dense_backward")})
#: slice updates: the slice written
_DUS = {p: 3 for p in _packets("index_copy", "index_copy_")}
_DUS.update({p: 1 for p in _packets("slice_scatter", "select_scatter")})
_REDUCE = _packets("sum", "mean", "amax", "amin", "max", "min", "argmax",
                   "argmin", "prod", "var", "var_mean", "std", "norm",
                   "linalg_vector_norm", "logsumexp", "cumsum", "cumsum_",
                   "cumprod", "logcumsumexp", "_softmax", "_log_softmax",
                   "_softmax_backward_data", "_log_softmax_backward_data",
                   "searchsorted", "bincount", "any", "all", "count_nonzero")

#: the functional collectives by kind; ``wait_tensor`` and the autograd
#: wrapper move nothing
_COLLECTIVES = {"all_gather_into_tensor": "all-gather",
                "all_gather_into_tensor_out": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
                "all_to_all_single": "all-to-all",
                "broadcast": "collective-permute",
                "broadcast_": "collective-permute",
                "shard_dim_alltoall": "all-to-all"}
_COLL_NAMESPACES = ("_c10d_functional", "_dtensor")

_KIND: Dict = {}


def _kind(func) -> str:
    packet = func.overloadpacket
    kind = _KIND.get(packet)
    if kind is not None:
        return kind
    if packet in _DOT:
        kind = "dot"
    elif packet in _FREE or func.is_view:
        kind = "free"
    elif packet in _FILL:
        kind = "fill"
    elif packet in _SCATTER:
        kind = "scatter"
    elif packet in _DUS:
        kind = "dus"
    elif packet in _GATHER:
        kind = "gather"
    elif packet is _aten.copy_:
        kind = "copy"
    elif packet is _aten._to_copy:
        kind = "convert"
    elif packet in _REDUCE or (hasattr(torch.Tag, "reduction")
                               and torch.Tag.reduction in func.tags):
        kind = "reduce"
    else:
        kind = "elementwise"
    _KIND[packet] = kind
    return kind


def _tensors(tree) -> Iterator[torch.Tensor]:
    """The tensors among an op's arguments or results, one list deep."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            if isinstance(t, torch.Tensor):
                yield t
            elif isinstance(t, (list, tuple)):
                yield from (u for u in t if isinstance(u, torch.Tensor))


def nbytes(t: torch.Tensor) -> int:
    """The bytes of ``t``'s distinct elements: an expanded (stride-0)
    dimension is read once."""
    if t.numel() == 0:
        return 0
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


def _partial(t: torch.Tensor) -> bool:
    """Whether ``t`` is a view of part of a larger storage."""
    return t.numel() * t.element_size() < t.untyped_storage().nbytes()


def _group_of(func, args) -> tuple:
    """(name, size) of a functional collective's process group: its
    last argument names it."""
    import torch.distributed.distributed_c10d as c10d
    name = args[-1]
    return name, c10d._resolve_process_group(name).size()


def op_cost(func, args, kwargs, out, costs: Costs) -> None:
    """Add one dispatched op's FLOPs and bytes to ``costs``."""
    if func.namespace.startswith(_COLL_NAMESPACES):
        kind = _COLLECTIVES.get(func.overloadpacket.__name__)
        if kind is not None:
            group, size = _group_of(func, args)
            costs.collective(kind, group, size,
                             sum(nbytes(t) for t in _tensors(out)))
        return
    kind = _kind(func)
    if kind == "free":
        return
    results = list(_tensors(out))
    out_bytes = sum(nbytes(t) for t in results)
    if kind == "dot":
        from torch.utils.flop_counter import flop_registry
        flops = flop_registry[func.overloadpacket](
            *args, **(kwargs or {}), out_val=out)
        operands = sum(nbytes(t) for t in _tensors(args))
        costs.add("dot", flops, operands + out_bytes,
                  ops_rate(results[0].dtype))
    elif kind == "fill":
        costs.add("elementwise", 0, out_bytes)
    elif kind == "gather":
        costs.add("data_movement", 0, 2 * out_bytes)
    elif kind == "scatter":
        src = _SCATTER[func.overloadpacket]
        vals = args[src] if len(args) > src else None
        n = (nbytes(vals) if isinstance(vals, torch.Tensor)
             else nbytes(args[src - 1]))       # a scalar value: the index
        costs.add("data_movement", 0, 2 * n)
    elif kind == "dus":
        costs.add("dus", 0, 2 * nbytes(args[_DUS[func.overloadpacket]]))
    elif kind == "copy":
        dst = args[0]
        costs.add("dus" if _partial(dst) else "data_movement", 0,
                  2 * nbytes(dst))
    elif kind == "convert":
        src = args[0]
        if results and results[0].dtype != src.dtype:
            costs.add("elementwise", results[0].numel(),
                      nbytes(src) + out_bytes)
        else:
            costs.add("data_movement", 0, 2 * out_bytes)
    else:
        operands = list(_tensors(args)) + list(_tensors(
            list((kwargs or {}).values())))
        in_bytes = sum(nbytes(t) for t in operands)
        if kind == "reduce":
            n = max((t.numel() for t in operands), default=0)
            costs.add("other", n, in_bytes + out_bytes)
        else:
            costs.add("elementwise", sum(t.numel() for t in results),
                      in_bytes + out_bytes)


# ---------------------------------------------------------------------------
# the counting mode
# ---------------------------------------------------------------------------

def kernel_cost(name: str, flops: float, nbytes_: float,
                dtype: Optional[torch.dtype] = None) -> None:
    """A hand-written kernel's launch, reported by its wrapper's meta
    branch (which does no arithmetic) to the innermost open
    :class:`CostCounter`: its FLOPs and bytes from the kernel module's
    cost function, at the peak of ``dtype``'s products (``None``: the
    CUDA cores).  A no-op when no count is open."""
    counters = [m for m in _get_current_dispatch_mode_stack()
                if isinstance(m, CostCounter)]
    if not counters:
        return
    costs = counters[-1].costs
    costs.add("kernel", flops, nbytes_, ops_rate(dtype))
    tally = costs.kernels.setdefault(
        name, {"launches": 0, "flops": 0.0, "bytes": 0.0})
    tally["launches"] += 1
    tally["flops"] += flops
    tally["bytes"] += nbytes_


def _meta_bincount(x, weights=None, minlength=0):
    """``aten::bincount`` has no meta kernel: its result has max(minlength,
    max(x) + 1) entries, which this stand-in takes as ``minlength`` (the
    values below it, as the MoE's expert ids are below E)."""
    dtype = torch.int64 if weights is None else weights.dtype
    return torch.empty(minlength, dtype=dtype, device=x.device)


_FAKE = torch._C._TorchDispatchModeKey.FAKE


def _dtensor_types(types) -> bool:
    """Whether a DTensor is among an op's tensor types."""
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return any(issubclass(t, DTensor) for t in types)


class CostCounter(TorchDispatchMode):
    """Counts every aten op dispatched while it is open into ``costs``
    (:class:`Costs`), and the bytes of the storages those ops create
    while they live: ``live_bytes`` now, ``peak_bytes`` at most, and
    ``peak_by_op``, the live bytes at the peak by the op that created
    them.
    ``arguments``: the step's inputs, whose storages are not counted.  On
    the meta device ``aten::bincount``, which has no meta kernel, gets a
    result of ``minlength`` entries."""

    def __init__(self, arguments: Iterable[torch.Tensor] = ()):
        super().__init__()
        self.costs = Costs()
        self.live_bytes = 0
        self.peak_bytes = 0
        self.peak_by_op: Dict[str, int] = {}
        self._live_by_op: Dict[str, int] = {}
        self._storages: Dict[int, int] = {}
        for t in arguments:
            t = getattr(t, "_local_tensor", t)      # a DTensor's shard
            self._watch(t.untyped_storage(), 0, "")

    def _free(self, key: int) -> None:
        entry = self._storages.pop(key, None)
        if entry is None:
            return
        n, op = entry
        self.live_bytes -= n
        if n:
            self._live_by_op[op] -= n

    def _watch(self, storage, n: int, op: str) -> None:
        key = id(storage)
        self._storages[key] = (n, op)
        weakref.finalize(storage, self._free, key).atexit = False

    def _track(self, func, out, args=()) -> None:
        if func.name() == "_c10d_functional::_wrap_tensor_autograd":
            # on meta the collectives' autograd wrapper is a new empty
            # tensor where the real one wraps its input: the input's bytes
            # go on living in it
            s, src = out.untyped_storage(), args[0].untyped_storage()
            entry = self._storages.get(id(src))
            if id(s) not in self._storages and entry is not None:
                self._free(id(src))
                self._watch(s, *entry)
                self.live_bytes += entry[0]
                if entry[0]:
                    self._live_by_op[entry[1]] += entry[0]
                return
        for t in _tensors(out):
            s = t.untyped_storage()
            if id(s) in self._storages:
                continue
            n = s.nbytes()
            if not n:
                continue
            op = func.overloadpacket.__name__
            self._watch(s, n, op)
            self.live_bytes += n
            self._live_by_op[op] = self._live_by_op.get(op, 0) + n
            if self.live_bytes > self.peak_bytes:
                self.peak_bytes = self.live_bytes
                self.peak_by_op = dict(self._live_by_op)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _dtensor_types(types):
            return NotImplemented       # DTensor issues the local ops
        if torch._C._get_dispatch_mode(_FAKE) is not None:
            # DTensor's shape propagation: not the rank's work
            return func(*args, **(kwargs or {}))
        if func.overloadpacket is _aten.bincount and args[0].is_meta:
            out = _meta_bincount(*args, **(kwargs or {}))
        else:
            out = func(*args, **(kwargs or {}))
        op_cost(func, args, kwargs, out, self.costs)
        self._track(func, out, args)
        return out


__all__ = ["BF16_OPS_PER_S", "BYTE_CATS", "COLL_KINDS", "CostCounter",
           "Costs", "F32_OPS_PER_S", "HBM_BYTES_PER_S", "collective_wire",
           "kernel_cost", "nbytes", "op_cost", "ops_rate"]
