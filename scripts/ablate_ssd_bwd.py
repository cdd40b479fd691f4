"""Where the bf16 SSD backward's time goes, by ablation, on an H100: the
port's ``csrc/ssd_scan_bwd.cu`` and copies of it with one part of a kernel
taken out (its results are then wrong and are not checked), each built
with nvcc, launched at mamba2-2.7b's and Zamba2's 4 x 2048 calls, and
timed kernel by kernel with ``torch.profiler`` (mean device ms of 5 calls
after one).  A part's cost is the kernel's time less the ablated copy's.
The kernels' own times are chip_smoke.py's ``parts_ms`` ([20b]); this
script is for the parts inside them.

The ablations are exact edits of the bf16 kernels' text as they stand in
the commit that added this script, each found once; after a change to
those lines the script stops with "the source has changed", and its
ABLATIONS must be written again for the new text.  Needs the card and
nvcc; run from the repo root:

    python scripts/ablate_ssd_bwd.py

It prints the card's name and power limit, then one JSON line a (call,
source): {"call", "source", "ms": {kernel: ms}}.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: (b, S, nh, hp, st, chunk): mamba2-2.7b's and Zamba2's backward calls
CALLS = {"mamba2": (4, 2048, 80, 64, 128, 256),
         "zamba2": (4, 2048, 112, 64, 64, 256)}
KERNELS = ("state", "pass", "rows", "cols", "finish")
#: each ablation: (text of the source, its replacement), each found once
ABLATIONS = {
    # the rows kernel without its carried-state terms (dy_i H, x_i G)
    "rows_no_state_terms": [(
        "  load_state(0);\n  tc::cp_async_commit();\n"
        "  for (int k = 0; k < nrh; ++k) {",
        "  for (int k = 0; k < 0; ++k) {")],
    # the rows kernel with L's exponentials taken as 1
    "rows_no_exp": [(
        "pm = __expf(ci[r] - cjk[col]) * djk[col] * dyx[n][e];",
        "pm = djk[col] * dyx[n][e];")],
    # the columns kernel with L's exponentials taken as 1
    "cols_no_exp": [("__expf(cik[il + e] - cj[q & 1]);", "1.f;")],
    # the columns kernel without its terms through G (loads, products,
    # dx, ddt and dcum's parts)
    "cols_no_g_terms": [
        ("  for (int w = 0; w < nch; ++w)\n    stage_plane<kS>(sRing + 2 * w",
         "  for (int w = 0; w < 0; ++w)\n    stage_plane<kS>(sRing + 2 * w"),
        ("  if (k < nch) {\n    const uint32_t sGh",
         "  if (false) {\n    const uint32_t sGh")],
}


def build_variants(build, out: Path):
    """The source and its ablated copies, built in parallel into ``out``
    with the port's flags (``build``: ``repro_torch.kernels.build``);
    returns {name: library path}."""
    src = (build.CSRC / "ssd_scan_bwd.cu").read_text()
    sources = {"ssd_scan_bwd.cu": src}
    for name, edits in ABLATIONS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the source has changed")
            text = text.replace(old, new)
        sources[name] = text

    def compile_one(item):
        name, text = item
        cu = out / f"{name.replace('.cu', '')}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        proc = subprocess.run(
            [build.nvcc_path(), *build.flags("ssd_scan_bwd.cu"), "-I",
             str(build.CSRC), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}")
        return name, so

    with ThreadPoolExecutor(len(sources)) as pool:
        return dict(pool.map(compile_one, sources.items()))


def main() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as CS
    from repro_torch.kernels import build
    from repro_torch.kernels import ssd_scan as SSD
    if not torch.cuda.is_available():
        print("ablate_ssd_bwd: no CUDA device", file=sys.stderr)
        return 1
    print(CS.nvidia_smi_line(), flush=True)
    device = torch.device("cuda", 0)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        libs = build_variants(build, Path(tmp))
        fns = {}
        for name, so in libs.items():
            fn = ctypes.CDLL(str(so)).ssd_scan_bwd_launch
            fn.argtypes = list(
                build.SIGNATURES["ssd_scan_bwd.cu"]["ssd_scan_bwd_launch"])
            fn.restype = ctypes.c_int
            fns[name] = fn
        for call, (b, S, nh, hp, st, Q) in CALLS.items():
            (x, dt, A, B, C), dy, _ = CS.ssd_bwd_args(
                b, S, nh, hp, st, torch.bfloat16, device, 300)
            n = SSD._bwd_workspace_floats(b, S, nh, hp, st, Q, x.dtype)
            ws = torch.empty(n, dtype=torch.float32, device=device)
            outs = [torch.empty_like(t) for t in (x, dt, A, B, C)]
            ptrs = ([t.data_ptr() for t in (x, dt, A, B, C, dy)] + [None]
                    + [t.data_ptr() for t in outs + [ws]])
            for name, fn in fns.items():
                def launch():
                    rc = fn(*ptrs, n, b, S, nh, hp, st, Q, 1,
                            torch.cuda.current_stream(device).cuda_stream)
                    if rc:
                        raise RuntimeError(f"{name}: CUDA error {rc}")
                launch()
                torch.cuda.synchronize(device)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(5):
                        launch()
                    torch.cuda.synchronize(device)
                ms = {k: sum(CS.device_us(e) for e in prof.key_averages()
                             if f"ssd_bwd_{k}_kernel" in e.key) / 5 / 1e3
                      for k in KERNELS}
                print(json.dumps({"call": call, "source": name, "ms": ms}),
                      flush=True)
            del x, dt, A, B, C, dy, ws, outs
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
