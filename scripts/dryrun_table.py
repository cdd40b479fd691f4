"""The dry run's records as one markdown table, a row a cell.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \
        --out build/dryrun.json
    python scripts/dryrun_table.py build/dryrun.json

Columns: TFLOP a step, GB moved by category (products, elementwise,
slice updates, data movement, reductions and the rest, the hand-written
kernels), argument and peak GB, the H100 bound's compute, memory and
op-sum seconds, its dominant term, and whether the counted peak fits the
card's 80 GB.  A skipped cell gets its reason.  Everything in it is a
count on the host, divided by the H100's data-sheet peaks
(``repro_torch.launch.cost_analysis``): no number in it was measured on a
card.
"""

from __future__ import annotations

import json
import sys

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


def main(argv=None) -> None:
    path = (argv or sys.argv[1:])[0]
    with open(path) as f:
        records = json.load(f)
    print("| arch | shape | TFLOP | dot GB | elementwise GB | dus GB "
          "| data movement GB | other GB | kernel GB | argument GB "
          "| peak GB | compute s | memory s | op-sum s | dominant "
          "| fits 80 GB |")
    print("|" + "---|" * 17)
    for r in records:
        print(row(r))


if __name__ == "__main__":
    main()
