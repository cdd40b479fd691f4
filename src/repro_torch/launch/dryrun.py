"""Dry run: the work of every (architecture x input shape) step on one
H100, counted on the ``meta`` device; and each cell's state per device on
the reference's production layouts.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
        --shape train_4k                          # one cell, one H100
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        --out build/dryrun.json                   # every cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --out build/dryrun_mesh.json              # per device, 16x16 and
                                                  # 2x16x16

The counterpart of ``repro.launch.dryrun``.  The reference lowers and
compiles each cell for 512 placeholder host devices on its TPU pods and
reads XLA's memory analysis and the HLO text.  Here the step itself runs
on the ``meta`` device, which allocates nothing, under
:class:`~repro_torch.launch.cost_analysis.CostCounter`, from the shape
stand-ins of ``launch.steps`` (``params_shape``, AdamW state in the
config's ``moment_dtype``, ``input_specs``): the train step
(``make_train_step``), the prefill (``models.prefill``) or the serve step
(``make_serve_step``).  The hand-written kernels take the card's route
and report their own work (``kernels/*.py``, ``*_cost``).  One host, no
card, a few seconds a cell.

With ``--mesh one`` (the default) a cell counts the reference's whole
global batch on one device: 256 x 4,096 tokens for ``train_4k``.
``fits_80gb`` says whether the counted peak fits the card; most cells do
not.  What the count cannot see: the bytes are each eager op's operands
and result, so operands that stay in the 50 MB L2 move less than
counted; allocator rounding, the cuBLAS workspace and the SSD backward's
workspace are not in the peak; and the MoE dispatch's gather and scatter
are counted at their upper bound, every one of min(T * k, E * C) slots
filled (``models.layers.moe_block``).

With ``--mesh single``, ``multi`` or ``both`` a cell is the reference's
16x16 or 2x16x16 layout (``launch.mesh.production_mesh``), and its record
(:func:`mesh_cell`) is what one device holds there: the arguments and
outputs, laid out by the reference's specs
(``distributed.sharding``; ``--no-fsdp`` drops the weights' data-axis
split).  For the dense (the VL backbone's too) and MoE families' train
and prefill cells (:data:`MESH_COUNTED`; :func:`counted_mesh_cell`) the
partitioned step also runs, the MoE at its ``TUNED_PLANS`` groups, on
the meta
device, as rank 0 of a fake process group of 256 or 512 ranks
(``launch.mesh.fake_world``), its parameters, optimizer state and batch
DTensors laid out by those specs; rank 0's count gives the reference's
per-device keys: FLOPs, bytes by category, temporaries and peak, and
the collectives' wire bytes by kind (``collective_wire``; by mesh axes
in ``collectives``); the MoE dispatch's all-to-all, whose split sizes
depend on the data, at its upper bound (``moe_gather``).  Every other
cell keeps ``null`` there, and
``not_counted`` names its family or its shape kind.

Not ported: ``--attn`` (the port's plan builder refuses ``attn_impl``:
one attention, the flash kernel) and ``--attn-bf16`` / ``--attn-remat``
(no module of the port reads them).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

from ..configs import ARCH_NAMES, SHAPES, applicable, get_config
from ..configs.base import ModelConfig, ShapeConfig
from ..distributed.ctx import activation_sharding
from ..distributed.sharding import (Spec, batch_specs, cache_specs,
                                    data_axes, device_bytes, distribute,
                                    fit_spec, opt_specs,
                                    param_specs, unsharded)
from ..models.decode import TensorSpec, decode_cache_specs, prefill
from ..models.model import _dtype, padded_vocab
from ..optim.adamw import AdamWConfig, adamw_init
from .cost_analysis import COLL_KINDS, CostCounter
from .mesh import AbstractMesh, device_mesh, fake_world, production_mesh
from .steps import (input_specs, make_prefill_step, make_serve_step,
                    make_train_step, params_shape)

#: per-cell plans, the reference's: grouped MoE dispatch for olmoe's
#: 64-expert layers
TUNED_PLANS = {
    ("olmoe-1b-7b", "train_4k"): {"moe_groups": 16},
    ("olmoe-1b-7b", "prefill_32k"): {"moe_groups": 16},
}
MESH = "1xH100"
#: the H100's memory, for ``fits_80gb`` and ``arguments_fit_80gb``
CARD_BYTES = 80e9
#: ``--mesh``: the production layouts of each choice (False: 16x16, True:
#: 2x16x16); ``one`` is the one-card count
MESHES = {"single": (False,), "multi": (True,), "both": (False, True)}
#: the (family, shape kind) pairs whose partitioned step the port runs
#: (the dense family's includes the VL backbone)
MESH_COUNTED = {("dense", "train"), ("dense", "prefill"), ("moe", "train"),
                ("moe", "prefill")}
#: what a counted MoE record says of its dispatch
MOE_COUNTED = ("upper bound: every one of min(T*k, E*C) slots of a group "
               "filled; a group spanning R data ranks sends and receives "
               "min(T_rank*k, E*ceil(C/R)) rows a rank, evenly")
#: what every per-device record leaves out
NOT_IN_OUTPUT = (
    "the train step's metrics (a few scalars, the MoE's expert_load) are "
    "not in output_bytes, since the reference leaves their sharding to "
    "XLA")
_NULLS = ("flops_per_device, bytes_per_device, memory.temp_bytes, "
          "memory.peak_bytes and the collectives")


def mesh_not_counted(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    """Why a cell's partitioned step is not counted, or ``None`` when it
    is (:data:`MESH_COUNTED`)."""
    if shape.kind == "decode":
        return (f"{_NULLS}: the partitioned decode step (the serve step on "
                f"sharded caches) is a later slice of the port")
    if (cfg.family, shape.kind) not in MESH_COUNTED:
        return (f"{_NULLS}: the {cfg.family} family's partitioned step is "
                f"a later slice of the port")
    return None


def _meta(tree):
    """``TensorSpec`` records (nested in dicts) as empty tensors on the
    ``meta`` device."""
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, TensorSpec):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    return tree


def storage_bytes(tensors) -> int:
    """The bytes of the distinct storages of ``tensors``."""
    seen = {}
    for t in tensors:
        s = t.untyped_storage()
        seen[id(s)] = s.nbytes()
    return sum(seen.values())


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return []


def cell_step(cfg: ModelConfig, shape: ShapeConfig, microbatches: int = 1,
              max_len: Optional[int] = None,
              params: Optional[Dict] = None) -> Tuple:
    """The step of one cell and its arguments on the ``meta`` device:
    (step, args).  ``max_len``: the prefill's cache length (default the
    prompt's); ``params``: the parameter stand-ins, if already made."""
    params = params_shape(cfg) if params is None else params
    specs = _meta(input_specs(cfg, shape))
    if shape.kind == "train":
        opt_cfg = AdamWConfig(moment_dtype=cfg.moment_dtype)
        step = make_train_step(cfg, opt_cfg, microbatches=microbatches)
        return step, (params, adamw_init(params, opt_cfg), specs)
    if shape.kind == "prefill":
        def prefill_step(p, batch):
            return prefill(cfg, p, batch["tokens"],
                           embeds=batch.get("embeds"), max_len=max_len)
        return prefill_step, (params, specs)
    return make_serve_step(cfg), (params, specs["cache"], specs["token"])


def argument_bytes(cfg: ModelConfig, shape: ShapeConfig,
                   params: Optional[Dict] = None) -> int:
    """The bytes of one cell's arguments: the parameters, with the AdamW
    state for the train kind, and the inputs (the decode kind's cache and
    token)."""
    return storage_bytes(_leaves(cell_step(cfg, shape, params=params)[1]))


def run_cell(arch: str, shape_name: str, microbatches: int = 1,
             moe_groups: int = 1, cfg: Optional[ModelConfig] = None,
             shape: Optional[ShapeConfig] = None,
             max_len: Optional[int] = None) -> Dict:
    """The record of one cell, with the reference's keys: ``arch``,
    ``shape``, ``devices``, ``flops_per_device``, ``bytes_per_device``,
    ``memory`` (argument, output, temp and peak bytes, peak = argument +
    temp; and ``peak_by_op``, the temporaries live at the peak by the op
    that made them), ``bytes_by_category``,
    ``collective_wire_bytes_per_device`` and ``collective_total``
    (zero), ``n_params`` and ``active_params`` (the
    config's formulas); and the port's: ``count_s`` (the meta run's wall),
    ``kernels`` (launches, FLOPs and bytes of each hand-written kernel),
    ``flops_by_category``, ``launches`` (ops that launch work on the card,
    by category), ``bound_s`` (``compute_s`` and ``memory_s`` at the
    H100's peaks by dtype, ``op_sum_s``, each op's larger term summed, and
    the ``dominant`` term), ``fits_80gb``, ``tree_params`` (the parameter
    tree's count) and ``mesh``.  A cell that ``applicable`` rejects gets
    ``skipped``, with the reason.  ``cfg`` and ``shape`` override the
    named ones (a depth cut, another batch); ``max_len`` is a prefill's
    cache length."""
    if shape is None:
        for k, v in TUNED_PLANS.get((arch, shape_name), {}).items():
            if k == "moe_groups" and moe_groups == 1:
                moe_groups = v
    cfg = get_config(arch) if cfg is None else cfg
    shape = SHAPES[shape_name] if shape is None else shape
    res: Dict = {"arch": arch, "shape": shape_name, "mesh": MESH}
    ok, why = applicable(cfg, shape)
    if not ok:
        res["skipped"] = why
        return res
    step, args = cell_step(cfg, shape, microbatches, max_len)
    arg_tensors = _leaves(args)
    t0 = time.perf_counter()
    with activation_sharding(None, None, 1, 1, moe_groups=moe_groups), \
            CostCounter(arg_tensors) as counter:
        out = step(*args)
    count_s = time.perf_counter() - t0
    costs, argument = counter.costs, storage_bytes(arg_tensors)
    res.update({
        "devices": 1,
        "count_s": count_s,
        "microbatches": microbatches,
        "moe_groups": moe_groups,
        "flops_per_device": costs.flops,
        "bytes_per_device": costs.bytes,
        "memory": {
            "argument_bytes": argument,
            "output_bytes": storage_bytes(_leaves(out)),
            "temp_bytes": counter.peak_bytes,
            "peak_bytes": argument + counter.peak_bytes,
            "peak_by_op": dict(sorted(
                ((k, v) for k, v in counter.peak_by_op.items() if v),
                key=lambda kv: -kv[1])),
        },
        "bytes_by_category": dict(costs.bytes_by),
        "flops_by_category": dict(costs.flops_by),
        "launches": dict(costs.ops_by),
        "kernels": {k: dict(v) for k, v in costs.kernels.items()},
        "bound_s": costs.bound(),
        "fits_80gb": argument + counter.peak_bytes <= CARD_BYTES,
        "collective_wire_bytes_per_device": {k: 0.0 for k in COLL_KINDS},
        "collective_total": 0.0,
        "n_params": cfg.n_params(),
        "active_params": cfg.active_params(),
        "tree_params": sum(t.numel() for t in _leaves(args[0])),
    })
    if cfg.family == "moe":
        res["moe_gather"] = ("upper bound: every one of min(T*k, E*C) "
                             "slots filled")
    return res


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def mesh_layout(cfg: ModelConfig, shape: ShapeConfig, mesh,
                params: Dict, fsdp: bool = True) -> Tuple:
    """A cell's arguments and outputs on ``mesh``, each part as
    (stand-ins, specs), with the shardings the reference compiles with:
    the arguments ``params``, the train kind's ``optimizer`` state and
    the ``inputs`` (the batch, or the decode kind's cache and token); the
    outputs the train kind's parameters and optimizer state as their
    inputs, else the logits at ``fit_spec(Spec(dp, "model"))`` and the
    caches at ``cache_specs``.  Returns (arguments, outputs, unsharded):
    the last is where ``fit_spec`` dropped an axis
    (``distributed.sharding.unsharded``).  ``params``: the parameter
    stand-ins (``launch.steps.params_shape``)."""
    dp = data_axes(mesh)
    dp = dp if len(dp) > 1 else (dp[0] if dp else None)
    pspec = param_specs(cfg, mesh, params, fsdp=fsdp)
    inputs = input_specs(cfg, shape)
    B, V = shape.global_batch, cfg.vocab_size
    bspec = batch_specs(cfg, mesh)
    intended = {"params": param_specs(cfg, mesh, params, fsdp, fit=False)}
    shapes = {"params": params}
    args = {"params": (params, pspec)}
    if shape.kind == "train":
        opt = adamw_init(params, AdamWConfig(moment_dtype=cfg.moment_dtype))
        ospec = opt_specs(pspec)
        args["optimizer"] = (opt, ospec)
        args["inputs"] = (inputs, {k: bspec[k] for k in inputs})
        return args, {"params": (params, pspec),
                      "optimizer": (opt, ospec)}, unsharded(intended,
                                                            shapes, mesh)
    if shape.kind == "prefill":
        cache, lg_entry = decode_cache_specs(cfg, B, shape.seq_len), dp
        cspec = cache_specs(cfg, mesh, cache)
        args["inputs"] = (inputs, {k: bspec[k] for k in inputs})
    else:
        cache = inputs["cache"]
        cspec = cache_specs(cfg, mesh, cache)
        tok = fit_spec(Spec(dp), (B,), mesh)
        lg_entry = tok[0] if tok else None
        args["inputs"] = (inputs, {"cache": cspec, "token": tok})
        intended["token"], shapes["token"] = Spec(dp), inputs["token"]
    # the logits' spec is fitted to the vocabulary, as the reference's is,
    # and lays out the logits of the padded one
    lg = fit_spec(Spec(lg_entry, "model"), (B, V), mesh)
    logits = TensorSpec((B, padded_vocab(cfg)), _dtype(cfg))
    intended.update(cache=cache_specs(cfg, mesh, cache, fit=False),
                    logits=Spec(dp, "model"))
    shapes.update(cache=cache, logits=TensorSpec((B, V), logits.dtype))
    return (args, {"logits": (logits, lg), "cache": (cache, cspec)},
            unsharded(intended, shapes, mesh))


def _group_labels(dm) -> Dict[str, str]:
    """Process group name -> the mesh axes it spans ("pod,data", "all")."""
    names = tuple(dm.mesh_dim_names)
    out = {dm[n].get_group().group_name: n for n in names}
    data = tuple(a for a in ("pod", "data") if a in names)
    if len(data) > 1:
        out[dm[data]._flatten().get_group().group_name] = ",".join(data)
    if dm.ndim > 1:
        out[dm._flatten().get_group().group_name] = "all"
    return out


def _span_labels(dm) -> Dict[str, str]:
    """Process group name -> "moe span of R" for the groups of R data
    ranks that a MoE dispatch group spans (``ctx.span_groups``)."""
    from ..distributed.ctx import span_groups
    return {name: f"moe span of {ranks}"
            for name, ranks, _ in span_groups(dm)}


def mesh_count(cfg: ModelConfig, shape: ShapeConfig, mesh: AbstractMesh,
               fsdp: bool = True, moe_groups: int = 1) -> Dict:
    """Rank 0's share of a cell's partitioned step on ``mesh`` (the
    reference's 16x16 or 2x16x16 layout, ``production_mesh``), counted:
    the step runs in a :func:`fake_world` of ``mesh.size`` ranks on a
    mesh of the card's device type (its collectives are the ones NCCL
    would run, where a CPU mesh turns an all-to-all into an all-gather;
    meta tensors need no card), its parameters, AdamW state and batch
    DTensors of meta shards laid out by the reference's specs, under a
    :class:`CostCounter`, the MoE dispatched in ``moe_groups`` groups
    (the cell's ``TUNED_PLANS``, as :func:`counted_mesh_cell` passes
    them).  Returns the counter's ``costs``,
    ``temp_bytes`` (its peak of live bytes), ``peak_by_op``, ``count_s``
    (the run's wall) and ``collectives`` (wire bytes and calls by mesh
    axes and kind; a MoE dispatch's all-to-all under "moe span of R",
    its group of R data ranks)."""
    with fake_world(mesh.size):
        dm = device_mesh(mesh, "cuda")
        params = params_shape(cfg)
        pspec = param_specs(cfg, mesh, params, fsdp=fsdp)
        bspec = batch_specs(cfg, mesh)
        inputs = _meta(input_specs(cfg, shape))
        args = [distribute(params, pspec, dm)]
        if shape.kind == "train":
            opt_cfg = AdamWConfig(moment_dtype=cfg.moment_dtype)
            args.append(distribute(adamw_init(params, opt_cfg),
                                   opt_specs(pspec), dm))
            step = make_train_step(cfg, opt_cfg)
        else:
            step = make_prefill_step(cfg)
        args.append(distribute(inputs, {k: bspec[k] for k in inputs}, dm))
        labels = _group_labels(dm)
        t0 = time.perf_counter()
        with activation_sharding(dm, moe_groups=moe_groups), \
                CostCounter(_leaves(args)) as counter:
            step(*args)
        count_s = time.perf_counter() - t0
        labels.update(_span_labels(dm))
    colls: Dict = {}
    for (kind, group), (calls, wire, _) in sorted(
            counter.costs.coll_groups.items()):
        by = colls.setdefault(labels.get(group, group), {})
        by[kind] = {"calls": calls, "wire_bytes": wire}
    return {"costs": counter.costs, "temp_bytes": counter.peak_bytes,
            "peak_by_op": counter.peak_by_op, "count_s": count_s,
            "collectives": colls}


def mesh_cell(arch: str, shape_name: str, multi_pod: bool,
              fsdp: bool = True, params: Optional[Dict] = None) -> Dict:
    """The per-device record of one cell on the reference's 16x16 (or,
    ``multi_pod``, 2x16x16) layout (:func:`mesh_layout`), from the shape
    stand-ins of ``launch.steps`` and the specs of
    ``distributed.sharding``.  Keys: the reference's ``arch``, ``shape``,
    ``mesh``, ``devices``, ``n_params``, ``active_params`` and
    ``memory.argument_bytes`` / ``output_bytes`` (per device);
    ``argument_bytes_by`` and ``output_bytes_by`` (by part),
    ``arguments_fit_80gb``, ``fsdp``, ``moe_groups`` (``TUNED_PLANS``),
    ``tree_params``, ``unsharded`` (where ``fit_spec`` dropped an axis:
    the leaf, the dim, the axis).  ``flops_per_device``,
    ``bytes_per_device``, ``memory.temp_bytes`` and ``peak_bytes`` are
    ``null``: :func:`counted_mesh_cell` fills them where the partitioned
    step is counted.  ``not_counted`` says what is not counted and why.
    ``params``: the parameter stand-ins, if already made."""
    cfg, shape = get_config(arch), SHAPES[shape_name]
    res: Dict = {"arch": arch, "shape": shape_name,
                 "mesh": mesh_name(multi_pod)}
    ok, why = applicable(cfg, shape)
    if not ok:
        res["skipped"] = why
        return res
    mesh = production_mesh(multi_pod=multi_pod)
    params = params_shape(cfg) if params is None else params
    args, outs, drops = mesh_layout(cfg, shape, mesh, params, fsdp)
    arg_by = {k: device_bytes(t, s, mesh) for k, (t, s) in args.items()}
    out_by = {k: device_bytes(t, s, mesh) for k, (t, s) in outs.items()}
    argument = sum(arg_by.values())
    moe_groups = TUNED_PLANS.get((arch, shape_name), {}).get("moe_groups", 1)
    why = mesh_not_counted(cfg, shape)
    res.update({
        "devices": mesh.size,
        "fsdp": fsdp,
        "moe_groups": moe_groups,
        "flops_per_device": None,
        "bytes_per_device": None,
        "memory": {
            "argument_bytes": argument,
            "argument_bytes_by": arg_by,
            "output_bytes": sum(out_by.values()),
            "output_bytes_by": out_by,
            "temp_bytes": None,
            "peak_bytes": None,
        },
        "arguments_fit_80gb": argument <= CARD_BYTES,
        "unsharded": drops,
        "not_counted": (NOT_IN_OUTPUT if why is None
                        else f"{why}; {NOT_IN_OUTPUT}"),
        "n_params": cfg.n_params(),
        "active_params": cfg.active_params(),
        "tree_params": sum(t.numel() for t in _leaves(params)),
    })
    return res


def counted_mesh_cell(arch: str, shape_name: str, multi_pod: bool,
                      fsdp: bool = True,
                      params: Optional[Dict] = None) -> Dict:
    """:func:`mesh_cell`'s record, and where the partitioned step is
    counted (:func:`mesh_not_counted`), rank 0's count of it
    (:func:`mesh_count`): ``flops_per_device``, ``bytes_per_device``,
    ``memory.temp_bytes`` and ``peak_bytes`` (argument + temp, the
    reference's sum) and ``peak_by_op`` (the temporaries live at the
    peak by the op that made them), ``bytes_by_category``,
    ``flops_by_category``, ``collective_wire_bytes_per_device`` by kind,
    ``collective_total``,
    ``collectives`` (by mesh axes), ``kernels``, ``launches`` and
    ``count_s``."""
    res = mesh_cell(arch, shape_name, multi_pod, fsdp, params)
    cfg, shape = get_config(arch), SHAPES[shape_name]
    if "skipped" in res or mesh_not_counted(cfg, shape) is not None:
        return res
    c = mesh_count(cfg, shape, production_mesh(multi_pod=multi_pod), fsdp,
                   res["moe_groups"])
    costs = c["costs"]
    res["memory"].update(temp_bytes=c["temp_bytes"],
                         peak_bytes=res["memory"]["argument_bytes"]
                         + c["temp_bytes"],
                         peak_by_op=dict(sorted(
                             ((k, v) for k, v in c["peak_by_op"].items()
                              if v), key=lambda kv: -kv[1])))
    res.update({
        "count_s": c["count_s"],
        "flops_per_device": costs.flops,
        "bytes_per_device": costs.bytes,
        "bytes_by_category": dict(costs.bytes_by),
        "flops_by_category": dict(costs.flops_by),
        "launches": dict(costs.ops_by),
        "kernels": {k: dict(v) for k, v in costs.kernels.items()},
        "collective_wire_bytes_per_device": dict(costs.coll),
        "collective_total": sum(costs.coll.values()),
        "collectives": c["collectives"],
    })
    if cfg.family == "moe":
        res["moe_gather"] = MOE_COUNTED
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=["one", *MESHES], default="one")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--moe-groups", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in ARCH_NAMES for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    results, stand_ins = [], {}
    for arch, shape in cells:
        for mp in MESHES.get(args.mesh, (None,)):
            try:
                if mp is None:
                    r = run_cell(arch, shape, microbatches=args.microbatches,
                                 moe_groups=args.moe_groups)
                else:
                    if arch not in stand_ins:
                        stand_ins[arch] = params_shape(get_config(arch))
                    r = counted_mesh_cell(arch, shape, mp,
                                          fsdp=not args.no_fsdp,
                                          params=stand_ins[arch])
            except Exception as e:  # a failing cell is a bug: surface it
                r = {"arch": arch, "shape": shape,
                     "mesh": MESH if mp is None else mesh_name(mp),
                     "error": f"{type(e).__name__}: {e}"}
            results.append(r)
            print(json.dumps(r), flush=True)

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)

    if any("error" in r for r in results):
        sys.exit(1)


if __name__ == "__main__":
    main()
