"""Time the checkpoint path of a model's training state on the card, split
into its parts: the copy from the device to the host (``.cpu()``), the
second host copy (``.copy()`` of the array), ``np.save`` of each leaf,
the directory's removal; then the same writes spread over threads.

    python scripts/time_checkpoint.py [--arch llama3.2-3b] \\
        [--dir build/ckpt_probe] [--threads 4,8]

The state is the trainer's (``{"params", "opt"}``: the arch's parameters
at full size in their dtype, AdamW's moments in the config's
``moment_dtype``) on the first CUDA device, flattened as
``checkpoint.manager`` flattens it, one ``.npy`` a leaf (bf16 as its
uint16 bits).  Each part is timed over all leaves with the host clock;
each leaf is dropped once written, so the host holds one leaf's copies
at a time.  Prints one JSON line.  It needs free disk under ``--dir``
of the state's size; the page cache is left as it is (the writes are
warm-cache writes, as the trainer's are).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.checkpoint.manager import _flatten  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402


def host_array(t):
    """A host tensor as the array written to disk."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def timed_serial(leaves, out):
    """Each part over the leaves, one leaf at a time: seconds by part."""
    parts = {"d2h_s": 0.0, "second_copy_s": 0.0, "np_save_s": 0.0}
    for key, leaf in leaves:
        t0 = time.perf_counter()
        t = leaf.detach().cpu()
        t1 = time.perf_counter()
        arr = host_array(t).copy()
        t2 = time.perf_counter()
        np.save(out / (key.replace("/", "__") + ".npy"), arr,
                allow_pickle=False)
        t3 = time.perf_counter()
        parts["d2h_s"] += t1 - t0
        parts["second_copy_s"] += t2 - t1
        parts["np_save_s"] += t3 - t2
        del t, arr
    return parts


def timed_threads(leaves, out, n):
    """The copies to the host and the writes of every leaf over ``n``
    threads, a leaf a task: the wall."""
    def one(item):
        key, leaf = item
        arr = host_array(leaf.detach().cpu())
        np.save(out / (key.replace("/", "__") + ".npy"), arr,
                allow_pickle=False)

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(n) as pool:
        list(pool.map(one, leaves))
    return time.perf_counter() - t0


def removal_s(path):
    t0 = time.perf_counter()
    shutil.rmtree(path)
    return time.perf_counter() - t0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--dir", default="build/ckpt_probe")
    ap.add_argument("--threads", default="4,8")
    args = ap.parse_args()
    device = torch.device("cuda", 0)
    cfg = get_config(args.arch)
    params = init_params(cfg, 0, device=device)
    opt = adamw_init(params, AdamWConfig(moment_dtype=cfg.moment_dtype))
    leaves = _flatten({"params": params, "opt": opt})
    nbytes = sum(t.numel() * t.element_size() for _, t in leaves
                 if torch.is_tensor(t))
    leaves = [(k, t if torch.is_tensor(t) else torch.as_tensor(t))
              for k, t in leaves]
    torch.cuda.synchronize(device)
    root = pathlib.Path(args.dir)
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    free = shutil.disk_usage(root).free
    fs = subprocess.run(["df", "-T", str(root)], capture_output=True,
                        text=True).stdout.strip().splitlines()[-1]
    row = {"arch": args.arch, "leaves": len(leaves), "gb": nbytes / 1e9,
           "free_gb": free / 1e9, "df": fs}
    serial = root / "serial"
    serial.mkdir()
    row.update(timed_serial(leaves, serial))
    row["removal_s"] = removal_s(serial)
    row["threads"] = {}
    for n in (int(v) for v in args.threads.split(",") if v):
        d = root / f"threads{n}"
        d.mkdir()
        wall = timed_threads(leaves, d, n)
        row["threads"][n] = {"wall_s": wall, "removal_s": removal_s(d)}
    shutil.rmtree(root, ignore_errors=True)
    row["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
