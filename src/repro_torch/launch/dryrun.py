"""Dry run: the work of every (architecture x input shape) step on one
H100, counted on the ``meta`` device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
        --shape train_4k                          # one cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        --out build/dryrun.json                   # every cell

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

A cell counts the reference's whole global batch on one device: 256 x
4,096 tokens for ``train_4k``.  ``fits_80gb`` says whether the counted
peak fits the card; most cells do not.  What the count cannot see: the
bytes are each eager op's operands and result, so operands that stay in
the 50 MB L2 move less than counted; allocator rounding, the cuBLAS
workspace and the SSD backward's workspace are not in the peak; and the
MoE dispatch's gather and scatter are counted at their upper bound, every
one of min(T * k, E * C) slots filled (``models.layers.moe_block``).

Not ported: the reference's ``--mesh`` (``make_production_mesh``'s TPU
pods; one card here), ``--no-fsdp`` and ``--attn`` (the port's plan
builder refuses ``fsdp`` and ``attn_impl``: nothing to shard, one
attention, the flash kernel), and ``--attn-bf16`` / ``--attn-remat`` (no
module of the port reads them); nor ``collective_wire``, since no
collective runs on one card.
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
from ..models.decode import TensorSpec, prefill
from ..optim.adamw import AdamWConfig, adamw_init
from .cost_analysis import COLL_KINDS, CostCounter
from .steps import (input_specs, make_serve_step, make_train_step,
                    params_shape)

#: per-cell plans, the reference's: grouped MoE dispatch for olmoe's
#: 64-expert layers
TUNED_PLANS = {
    ("olmoe-1b-7b", "train_4k"): {"moe_groups": 16},
    ("olmoe-1b-7b", "prefill_32k"): {"moe_groups": 16},
}
MESH = "1xH100"
#: the H100's memory, for ``fits_80gb``
CARD_BYTES = 80e9


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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
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

    results = []
    for arch, shape in cells:
        try:
            r = run_cell(arch, shape, microbatches=args.microbatches,
                         moe_groups=args.moe_groups)
        except Exception as e:  # a failing cell is a bug: surface it
            r = {"arch": arch, "shape": shape, "mesh": MESH,
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
