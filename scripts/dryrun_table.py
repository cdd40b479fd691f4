"""The dry run's records as one markdown table, a row a cell.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \
        --out build/dryrun.json
    python scripts/dryrun_table.py build/dryrun.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \
        --out build/dryrun_mesh.json
    python scripts/dryrun_table.py build/dryrun.json build/dryrun_mesh.json

Columns: TFLOP a step, GB moved by category (products, elementwise,
slice updates, data movement, reductions and the rest, the hand-written
kernels), argument and peak GB, the H100 bound's compute, memory and
op-sum seconds, its dominant term, and whether the counted peak fits the
card's 80 GB.  A skipped cell gets its reason.  Everything in it is a
count on the host, divided by the H100's data-sheet peaks
(``repro_torch.launch.cost_analysis``): no number in it was measured on a
card.

Records of the production layouts (``--mesh single``, ``multi`` or
``both``) add columns: each layout's per-device argument and output GB
and whether the arguments fit a device's 80 GB on every layout, counts
from the sharding specs, given after the one-card records: their
columns join each counted cell's row.  The cells whose partitioned step
the dry run counts (the dense family's train and prefill) get a second
table, a row a cell and layout: one device's TFLOP, GB moved,
temporaries and peak GB, and the collectives' ring wire GB by kind.
The production records alone print that table only.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List, Tuple

CATS = ("dot", "elementwise", "dus", "data_movement", "other", "kernel")


def row(r) -> str:
    if "skipped" in r:
        return f"| {r['arch']} | {r['shape']} | skipped: {r['skipped']} |"
    gb = [f"{r['bytes_by_category'][c] / 1e9:.1f}" for c in CATS]
    b, m = r["bound_s"], r["memory"]
    cols = ([r["arch"], r["shape"], f"{r['flops_per_device'] / 1e12:.4g}"]
            + gb + [f"{m['argument_bytes'] / 1e9:.1f}",
                    f"{m['peak_bytes'] / 1e9:.1f}",
                    f"{b['compute_s']:.4g}", f"{b['memory_s']:.4g}",
                    f"{b['op_sum_s']:.4g}", b["dominant"],
                    "yes" if r["fits_80gb"] else "no"])
    return "| " + " | ".join(cols) + " |"


def mesh_columns(records) -> Tuple[List[str], Dict]:
    """The per-device columns of production-layout records: the header,
    and each counted cell's columns by (arch, shape)."""
    meshes = list(dict.fromkeys(r["mesh"] for r in records))
    by: Dict = {}
    for r in records:
        if "skipped" not in r:
            by.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r
    cols = {}
    for cell, recs in by.items():
        mem = [recs[m]["memory"] for m in meshes]
        cols[cell] = [f"{x['argument_bytes'] / 1e9:.4g} / "
                      f"{x['output_bytes'] / 1e9:.4g}" for x in mem] + [
            "yes" if all(recs[m]["arguments_fit_80gb"] for m in meshes)
            else "no"]
    header = [f"{m} argument / output GB" for m in meshes] + [
        "arguments fit 80 GB per device"]
    return header, cols


WIRE = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all")


def per_device_table(records) -> List[str]:
    """The counted production-layout records as markdown lines."""
    out = ["| arch | shape | mesh | TFLOP / device | GB / device "
           "| temp GB | peak GB | "
           + " | ".join(f"{k} wire GB" for k in WIRE)
           + " | wire GB total |", "|" + "---|" * (8 + len(WIRE))]
    for r in records:
        if r.get("flops_per_device") is None:
            continue
        m, w = r["memory"], r["collective_wire_bytes_per_device"]
        cols = ([r["arch"], r["shape"], r["mesh"],
                 f"{r['flops_per_device'] / 1e12:.4g}",
                 f"{r['bytes_per_device'] / 1e9:.4g}",
                 f"{m['temp_bytes'] / 1e9:.4g}",
                 f"{m['peak_bytes'] / 1e9:.4g}"]
                + [f"{w[k] / 1e9:.4g}" for k in WIRE]
                + [f"{r['collective_total'] / 1e9:.4g}"])
        out.append("| " + " | ".join(cols) + " |")
    return out


def main(argv=None) -> None:
    paths = argv or sys.argv[1:]
    files = []
    for path in paths:
        with open(path) as f:
            files.append(json.load(f))
    one = [rs for rs in files if rs and rs[0]["mesh"] == "1xH100"]
    mesh = [r for rs in files if rs and rs[0]["mesh"] != "1xH100"
            for r in rs]
    if not one:
        if not mesh:
            sys.exit("no records")
        print("\n".join(per_device_table(mesh)))
        return
    header, extra = mesh_columns(mesh) if mesh else ([], {})
    print("| arch | shape | TFLOP | dot GB | elementwise GB | dus GB "
          "| data movement GB | other GB | kernel GB | argument GB "
          "| peak GB | compute s | memory s | op-sum s | dominant "
          "| fits 80 GB |" + "".join(f" {h} |" for h in header))
    print("|" + "---|" * (17 + len(header)))
    for r in one[0]:
        cols = extra.get((r["arch"], r["shape"]), [])
        print(row(r) + "".join(f" {c} |" for c in cols))
    counted = per_device_table(mesh)
    if len(counted) > 2:
        print()
        print("\n".join(counted))


if __name__ == "__main__":
    main()
