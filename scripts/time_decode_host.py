"""The host cost of one checkout's no-mesh decode path on an H100, so that
two checkouts (a parent and a change) can be compared on the same card,
one after the other, in turns.

It prints one JSON line: the rmsnorm wrapper's host time a call at
llama3.2-3b's decode call (8 x 3,072 bf16; 5,000 calls under ``no_grad``
with no synchronize between them, three readings), its CUDA-event time
around one call after an L2 flush at decode's 8 x 3,584 and 8 x 7,168
(chip_smoke.py phase [11]'s "ms", mean of 200), and a decode step of
llama3.2-3b at full width cut to 4 layers on 8 slots (100 steps, three
readings).  Needs the card and nvcc; run from the repo root, once for
each checkout, in turns:

    python scripts/time_decode_host.py PARENT parent
    python scripts/time_decode_host.py . change
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import torch


def main() -> int:
    root, label = sys.argv[1], sys.argv[2]
    sys.path.insert(0, root + "/src")
    from repro_torch.configs import get_config
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.models import decode_step, init_decode_cache, init_params
    dev = torch.device("cuda", 0)
    out = {"tree": label}
    x = torch.randn(8, 3072, device=dev, dtype=torch.bfloat16)
    w = torch.randn(3072, device=dev, dtype=torch.bfloat16)
    with torch.no_grad():
        for _ in range(200):
            rmsnorm(x, w)
        torch.cuda.synchronize()
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(5000):
                rmsnorm(x, w)
            host = (time.perf_counter() - t0) / 5000
            torch.cuda.synchronize()
            out.setdefault("rmsnorm_host_us", []).append(host * 1e6)
        flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
        for D in (3584, 7168):
            xd = torch.randn(8, D, device=dev, dtype=torch.bfloat16)
            wd = torch.randn(D, device=dev, dtype=torch.bfloat16)
            rmsnorm(xd, wd)
            ts = []
            for _ in range(200):
                flush.zero_()
                a, b = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                a.record()
                rmsnorm(xd, wd)
                b.record()
                b.synchronize()
                ts.append(a.elapsed_time(b))
            out[f"rmsnorm_event_ms_D{D}"] = sum(ts) / len(ts)
        cfg = dataclasses.replace(get_config("llama3.2-3b"), n_layers=4)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
        cache = init_decode_cache(cfg, 8, 512, device=dev)
        tok = torch.zeros(8, dtype=torch.int32, device=dev)
        for _ in range(5):
            decode_step(cfg, params, cache, tok)
        torch.cuda.synchronize()
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(100):
                decode_step(cfg, params, cache, tok)
            torch.cuda.synchronize()
            out.setdefault("decode_step_ms", []).append(
                (time.perf_counter() - t0) / 100 * 1e3)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
