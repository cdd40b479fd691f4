"""The float32 SSD backward on an H100 against the exact gradient, over
many seeds: at each of chip_smoke.py's [20a] shapes (SHAPES) and with its
inputs (``ssd_bwd_args``: the [20a] seed and 7 more, with no and with a
gradient of the final state), ``ssd_scan_bwd`` (float32 x, the CUDA-core
kernels) and the float32 plain version ``ssd_scan_bwd_ref`` on the card,
each held against the plain version in float64 on the CPU.  Every
distance is max |got - exact| / max |exact| of each of dx, ddt, dA, dB,
dC; the tolerance of [20a] is 1e-4.  It uses no more of the tree than
``ssd_bwd_args``, ``nvidia_smi_line`` and the kernels, so a copy of it in
an older checkout reads that checkout's kernels.  Needs the card and nvcc;
run from the repo root:

    python scripts/ssd_bwd_f32_witness.py

It prints the card's name and power limit, one JSON line a (shape, seed,
dstate), and last a JSON summary: per shape the largest distance of each
gradient over the seeds, the kernel's and the plain version's.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: (b, S, nh, hp, st, chunk): chip_smoke.py's SSD_BWD_SHAPES, in order
SHAPES = ((1, 64, 2, 32, 16, 32), (2, 256, 4, 64, 64, 64),
          (1, 512, 3, 64, 96, 128), (2, 512, 8, 64, 128, 256),
          (1, 256, 4, 64, 128, 256), (1, 2048, 4, 64, 128, 1024),
          (1, 512, 7, 64, 128, 256))
#: seeds beyond [20a]'s own (200 + 10 i for the i-th shape)
EXTRA_SEEDS = 7


def main() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke as CS
    from repro_torch.kernels import ssd_scan as SSD
    if not torch.cuda.is_available():
        print("ssd_bwd_f32_witness: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(CS.nvidia_smi_line(), flush=True)
    device, cpu = torch.device("cuda", 0), torch.device("cpu")

    def dist(got, exact):
        return [float((g.to(cpu, torch.float64) - w).abs().max()
                      / w.abs().max()) for g, w in zip(got, exact)]

    summary = {}
    for i, (b, S, nh, hp, st, Q) in enumerate(SHAPES):
        worst = {"kernel": [0.0] * 5, "float32_plain": [0.0] * 5}
        seeds = [200 + 10 * i] + [1000 + 37 * k + i
                                  for k in range(EXTRA_SEEDS)]
        for seed in seeds:
            for with_dstate in (False, True):
                args, dy, ds = CS.ssd_bwd_args(b, S, nh, hp, st,
                                               torch.float32, device, seed,
                                               with_dstate)
                exact = SSD.ssd_scan_bwd_ref(
                    *(t.to(cpu, torch.float64) for t in args),
                    dy.to(cpu, torch.float64),
                    None if ds is None else ds.to(cpu, torch.float64),
                    chunk=Q)
                row = {"shape": [b, S, nh, hp, st, Q], "seed": seed,
                       "dstate": with_dstate,
                       "kernel": dist(SSD.ssd_scan_bwd(*args, dy, ds,
                                                       chunk=Q), exact),
                       "float32_plain": dist(SSD.ssd_scan_bwd_ref(
                           *args, dy, ds, chunk=Q), exact)}
                print(json.dumps(row), flush=True)
                for k in worst:
                    worst[k] = [max(a, c) for a, c in zip(worst[k], row[k])]
        summary[str([b, S, nh, hp, st, Q])] = worst
    print(json.dumps({"largest over seeds (dx, ddt, dA, dB, dC)": summary}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
