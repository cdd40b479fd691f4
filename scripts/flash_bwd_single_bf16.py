"""The bf16 flash-attention backward with p and ds as hi/lo bf16 pairs (the
kernel as it stands) against the same kernel with single bf16 p and ds
(the three lo products dropped), on an H100.

For each bf16 shape of chip_smoke's [17a] and its training shape, both
variants' relative L2 error against the plain version's autograd, and at
the training shape both variants' times in turns (hilo, single, single,
hilo) after an L2 flush.  The single variant is kept only if every shape
stays under 2**-8 / 1.5.  Needs the card and nvcc; run from the repo root:

    PYTHONPATH=src python scripts/flash_bwd_single_bf16.py
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as FA

#: [17a]'s bf16 small shapes (B, S, T, H, K, hd), causal, and the training
#: shape
SHAPES = [((2, 96, 160, 8, 2, 32), True), ((1, 257, 129, 6, 3, 64), False),
          ((2, 100, 72, 4, 2, 112), True), ((1, 300, 300, 6, 2, 128), True),
          ((4, 2048, 2048, 24, 8, 128), True)]
BOUND = 2.0 ** -8 / 1.5


def single_source(text: str) -> str:
    """The source with the products of the lo parts (three calls) taken
    out."""
    lines = text.splitlines()
    kept = [ln for ln in lines if not ("mma_rs<HD>(" in ln and "[1]" in ln)]
    if len(lines) - len(kept) != 3:
        raise RuntimeError("expected three lo products in the source")
    return "\n".join(kept) + "\n"


def load_variants(tmp: Path):
    src = (build.CSRC / "flash_attention_bwd.cu").read_text()
    fns = {}
    for name, text in (("hilo", src), ("single", single_source(src))):
        cu = tmp / f"flash_bwd_{name}.cu"
        cu.write_text(text)
        so = tmp / f"flash_bwd_{name}.so"
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS,
                        f"-I{build.CSRC}", "-o", str(so), str(cu)],
                       check=True)
        fn = ctypes.CDLL(str(so)).flash_attention_bwd_launch
        fn.argtypes = list(build.SIGNATURES["flash_attention_bwd.cu"][
            "flash_attention_bwd_launch"])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def run(fn, q, k, v, o, do, lse, causal):
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty(B * H * S, device=q.device)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), B, S, T, H, K, hd, 1,
            int(causal), 1.0 / math.sqrt(hd),
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"flash_attention_bwd_launch: CUDA error {rc}")
    return dq, dk, dv


def time_ms(fn, flush, reps=10) -> float:
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        total += start.elapsed_time(stop)
    return total / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"bound": BOUND, "shapes": []}
    with tempfile.TemporaryDirectory() as tmp:
        fns = load_variants(Path(tmp))
        for (B, S, T, H, K, hd), causal in SHAPES:
            q, do = (torch.randn((B, S, H, hd), generator=gen, device=dev
                                 ).bfloat16() for _ in range(2))
            k, v = (torch.randn((B, T, K, hd), generator=gen, device=dev
                                ).bfloat16() for _ in range(2))
            o, lse = FA.flash_attention_lse(q, k, v, causal=causal)
            want = FA.flash_attention_bwd_ref(q, k, v, o, do, causal=causal)
            rec = {"shape": [B, S, T, H, K, hd], "causal": causal}
            for name, fn in fns.items():
                got = run(fn, q, k, v, o, do, lse, causal)
                rec[f"{name}_rel_l2"] = [
                    float((g.float() - w.float()).norm() / w.float().norm())
                    for g, w in zip(got, want)]
            if S == 2048:
                ms = {"hilo": [], "single": []}
                for name in ("hilo", "single", "single", "hilo"):
                    ms[name].append(time_ms(lambda: run(
                        fns[name], q, k, v, o, do, lse, causal), flush))
                rec.update({f"{n}_ms": sum(t) / len(t) for n, t in ms.items()})
            out["shapes"].append(rec)
            print(json.dumps(rec), flush=True)
    out["single_within_bound"] = all(max(r["single_rel_l2"]) <= BOUND
                                     for r in out["shapes"])
    print(json.dumps({"single_within_bound": out["single_within_bound"],
                      "bound": BOUND}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
