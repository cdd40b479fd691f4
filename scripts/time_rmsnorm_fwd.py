"""The rmsnorm forward of one checkout of the port, timed on an H100 at the
main paths' calls, so that two checkouts (a parent and a change) can be
compared on the same card, one after the other.

For each bf16 call (training 8,192 rows of 3,072; the prefill's gated norm,
16,384 of 7,168; decode, 8 of 3,584 and 8 of 7,168) it prints one JSON
line, chip_smoke.py's ``rmsnorm_record``: the kernel held against its
plain version, a rerun's bits, its CUDA-event time with the wrapper after
an L2 flush in turns with ``F.rms_norm``, the card time of its kernel and
of ``F.rms_norm``'s alone (``torch.profiler``), the plain version's time
and the byte bound.  Needs the card and nvcc; run from the repo root,
once for each checkout, in turns:

    python scripts/time_rmsnorm_fwd.py --src PARENT/src --label parent
    python scripts/time_rmsnorm_fwd.py --label change
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: (rows, D), bf16
SHAPES = ((8192, 3072), (16384, 7168), (8, 3584), (8, 7168))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--label", default="change")
    args = ap.parse_args()
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]
    import torch

    import chip_smoke as CS
    if not torch.cuda.is_available():
        print("time_rmsnorm_fwd: no CUDA device", file=sys.stderr)
        return 1
    print(CS.nvidia_smi_line(), flush=True)
    device = torch.device("cuda", 0)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=device)
    for i, (rows, D) in enumerate(SHAPES):
        x = CS.randn((rows, D), torch.bfloat16, device, 80 + 2 * i)
        w = CS.randn((D,), torch.bfloat16, device, 81 + 2 * i)
        rec = CS.rmsnorm_record(x, w, device, flush, plain_reps=5)
        print(json.dumps({"label": args.label, **rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
