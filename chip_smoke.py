#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the event-loop kernels from ``src/repro_torch/kernels/csrc/`` with
nvcc, holds each kernel against its plain PyTorch version, drives the port's
main paths on the card, times the kernels, and prints one JSON line per
result.  Phases, in order:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the kernel build, timed;
3. kernel vs plain on synthetic inputs (P in {20, 56, 128}, K in {256, 4096,
   65536}; forced rows, equal-jitter ties, count == 0 lanes), bit-equal;
4. the campaign path: ``sweep_portfolio("mandelbrot", "epyc")`` at T = 500,
   reps = 3 and ``sweep_portfolio("tc", "epyc")`` through the kernels, then
   the same sweeps with the plain event core on the card, bit-equal, and
   both sweeps at T = 2 held against the plain CPU path (loop times
   bit-equal: the draws and the event core round alike on both);
5. the what-if path: ``what_if_wave`` (256 requests, 8 replicas) and
   ``what_if_routes`` (4 groups x 8 replicas, > 100 candidate rows), kernel
   vs plain on the card and vs the CPU;
6. each kernel timed with CUDA events at the main path's shapes, beside its
   plain version.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Any failure exits non-zero, and with no
card (or no checkout around this file) the script exits non-zero at once.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
CU_SOURCE = "src/repro_torch/kernels/csrc/event_loop.cu"
REPLACES = {
    "event_finish": "src/repro/kernels/event_loop.py:138",
    "event_finish_fused": "src/repro/kernels/event_loop.py:174",
}
#: NVIDIA H100 SXM data sheet: HBM bandwidth and non-tensor float32 peak
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain versions on synthetic inputs
# ---------------------------------------------------------------------------

def synthetic_lanes(rng, B: int, K: int, P: int):
    """Lane arrays with every case the recurrence has: ragged counts with
    count == 0 and count == K lanes, fully forced rows, partly forced rows,
    equal-jitter lanes and equal-cost lanes (exact ties every step)."""
    count = rng.integers(0, K + 1, B).astype(np.int32)
    count[::17] = 0
    count[1::13] = K
    forced = np.full((B, K), -1, np.int32)
    forced[2::7] = rng.integers(0, P, (len(range(2, B, 7)), K))
    part = rng.random((B, K)) < 0.1
    part[3::5] = False
    forced[part] = rng.integers(0, P, int(part.sum()))
    jitter = (rng.random((B, P)) * 45e-6).astype(np.float32)
    jitter[4::6] = 0.0
    speed = np.clip(1.0 + 0.01 * rng.standard_normal((B, P)), 0.8,
                    1.25).astype(np.float32)
    speed[5::6] = 1.0
    h_eff = np.full(B, 0.2e-6, np.float32)
    h_eff[::3] = 1.6e-6
    bcost = np.where(np.arange(B) % 4 == 0, 2e-6, 0.0).astype(np.float32)
    return count, forced, jitter, speed, h_eff, bcost


def phase_synthetic(device, grids_np: np.ndarray, N: int, seed: int = 0,
                    shapes=None):
    """Both kernels vs their plain versions; returns the mismatch counts."""
    from repro_torch.kernels import event_loop as ev

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    rng = np.random.default_rng(seed)
    grids = dev(grids_np)
    S, G1 = grids_np.shape
    G = G1 - 1
    shapes = shapes or [(P, K, 4096 if K <= 4096 else 512)
                        for P in (20, 56, 128) for K in (256, 4096, 65536)]
    results = []
    for P, K, B in shapes:
        count, forced, jitter, speed, h_eff, bcost = synthetic_lanes(
            rng, B, K, P)
        eff = (rng.random((B, K)) * 1e-4).astype(np.float32)
        eff[6::6] = 3e-5                    # equal costs: ties every step
        args = [dev(a) for a in (eff, speed, jitter, h_eff, bcost, forced,
                                 count)]
        got = ev.event_finish(*args)
        want = ev.event_finish_ref(*args)
        bad_plain = int((got != want).sum())

        sizes = rng.integers(1, max(2, 2 * N // K), (B, K)).astype(np.int32)
        starts = (rng.random((B, K)) * (N - sizes)).astype(np.int32)
        loc = (1.0 + 0.5 * rng.random((B, K))).astype(np.float32)
        noise = np.exp(0.025 * rng.standard_normal((B, K))).astype(np.float32)
        loc[6::6] = 1.0
        noise[6::6] = 1.0
        gid = rng.integers(0, S, B).astype(np.int32)
        gscale = np.full(B, np.float32(G) * np.float32(1.0 / N), np.float32)
        fargs = [grids] + [dev(a) for a in (gid, gscale, starts, sizes, loc,
                                            noise, speed, jitter, h_eff,
                                            bcost, forced, count)]
        got = ev.event_finish_fused(*fargs)
        want = ev.event_finish_fused_ref(*fargs)
        bad_fused = int((got != want).sum())
        log(f"  P={P:3d} K={K:6d} B={B:5d}: event_finish mismatches "
            f"{bad_plain}, event_finish_fused mismatches {bad_fused}")
        results.append((P, K, B, bad_plain, bad_fused))
    return results


# ---------------------------------------------------------------------------
# phase 4: the campaign path
# ---------------------------------------------------------------------------

def sweep(app: str, backend, T=None, reps: int = 3):
    from repro_torch import sweep_portfolio
    t0 = time.perf_counter()
    sw = sweep_portfolio(app, "epyc", T=T, reps=reps, backend=backend)
    if backend.device.type == "cuda":
        torch.cuda.synchronize(backend.device)
    return sw, time.perf_counter() - t0


def check_sweep(sw, T: int, n_loops: int) -> None:
    require(len(sw.runs) == 24, f"{sw.app}: {len(sw.runs)} runs, want 24")
    for key, run in sw.runs.items():
        require(run.times.shape == (T, n_loops), f"{sw.app} {key} shape")
        require(bool(np.all(np.isfinite(run.times))) and
                bool(np.all(run.times > 0)), f"{sw.app} {key} times")
        require(bool(np.all(np.isfinite(run.libs))), f"{sw.app} {key} libs")
    require(np.isfinite(sw.oracle_total()) and sw.oracle_total() > 0,
            f"{sw.app}: oracle_total")
    require(np.isfinite(sw.cov()) and sw.cov() > 0, f"{sw.app}: cov")


def small_sweeps(backend):
    """Both cells at full width, T = 2, one rep: small enough for the plain
    CPU path, so the card's results can be held against the CPU's."""
    from repro_torch import sweep_portfolio
    return [sweep_portfolio(app, "epyc", T=2, reps=1, backend=backend)
            for app in ("mandelbrot", "tc")]


def same_sweeps(a, b, lib_atol: float = 0.0) -> bool:
    """Loop times bit-equal; ``lib`` within ``lib_atol`` percentage points
    (0: equal; the CPU and the card sum its float32 row mean in different
    orders)."""
    return all(
        np.array_equal(x.runs[k].times, y.runs[k].times)
        and np.allclose(x.runs[k].libs, y.runs[k].libs, rtol=0,
                        atol=lib_atol)
        for x, y in zip(a, b) for k in x.runs)


# ---------------------------------------------------------------------------
# phase 5: the what-if path
# ---------------------------------------------------------------------------

def wave_inputs(seed: int, n_requests: int = 256, R: int = 8):
    rng = np.random.default_rng(seed)
    tokens = rng.lognormal(5.0, 1.0, n_requests)
    cost = 2e-5 + 1e-6 * tokens
    prefix = np.concatenate([[0.0], np.cumsum(cost)])
    avail = rng.random(R) * 1e-3
    return prefix, avail


def what_if_calls(backend, seed: int = 0):
    """A 256-request wave over 8 replicas for all 12 algorithms at the
    default chunk and at expChunk, and a 4-group x 8-replica fleet routing
    decision over 6 request shards (144 candidate rows)."""
    from repro_torch.core import N_ALGORITHMS, exp_chunk
    R = 8
    prefix, avail = wave_inputs(seed)
    N = len(prefix) - 1
    algs = list(range(N_ALGORITHMS))
    waves = [backend.what_if_wave(prefix, R, avail, 0.2e-6, 5e-6, algs,
                                  chunk_param=cp)
             for cp in (0, exp_chunk(N, R))]
    rng = np.random.default_rng(seed + 1)
    group_avail = [rng.random(R) * 2e-3 for _ in range(4)]
    prefixes, avails = [], []
    for s in range(6):
        p, _ = wave_inputs(seed + 10 + s, n_requests=int(rng.integers(
            64, 400)))
        prefixes.append(p)
        avails.append(group_avail[s % 4])
    cands = [(s, a, cp) for s in range(6) for a in algs
             for cp in (0, exp_chunk(len(prefixes[s]) - 1, R))]
    routes = backend.what_if_routes(prefixes, R, avails, 0.2e-6, 5e-6, cands)
    return waves + [routes]


# ---------------------------------------------------------------------------
# phase 6: timing
# ---------------------------------------------------------------------------

def time_call(fn, args, reps: int, device, flush) -> float:
    """Mean ms of ``fn(*args)`` over ``reps`` launches, each after an L2
    flush (the path's inputs are fresh copies, cold in L2)."""
    fn(*args)
    torch.cuda.synchronize(device)
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        stop.record()
        stop.synchronize()
        total += start.elapsed_time(stop)
    return total / reps


def _live(forced, count):
    cnt = count.long()
    K = forced.shape[1]
    live = torch.arange(K, device=forced.device)[None, :] < cnt[:, None]
    return int(cnt.sum()), int(((forced < 0) & live).sum())


def grid_reads(grids, gid, gscale, starts, sizes, count):
    """Distinct grid elements the live chunks read — ``row[i]`` and
    ``row[i + 1]`` at both ends of each chunk, indexed as ``prefix_costs``
    indexes them — and the distinct 32-byte sectors that hold them."""
    G = grids.shape[1] - 1
    live = (torch.arange(starts.shape[1], device=starts.device)[None, :]
            < count.long()[:, None])
    gs = gscale[:, None].expand_as(starts)[live]
    base = (gid.long() * (G + 1))[:, None].expand_as(starts)[live]
    idx = []
    for x in (starts[live], (starts + sizes)[live]):
        i = (x.to(torch.float32) * gs).to(torch.int32).clamp(0, G - 1).long()
        idx += [base + i, base + i + 1]
    elems = torch.cat(idx).unique()
    return int(elems.numel()), int((elems // 8).unique().numel())


def fused_bound(args):
    """Bytes and operations of one event_finish_fused call on these inputs:
    each input read once for the live chunks (start, size, loc, noise,
    forced: 20 B a chunk), the distinct grid elements those chunks read, the
    per-lane rows (speed, jitter and five scalars) and the output; an argmin
    over P (P - 1 compares) per chunk not forced, and 16 float32 operations
    a chunk for the interpolation, scaling and update."""
    grids, gid, gscale, starts, sizes = args[:5]
    speed, forced, count = args[7], args[11], args[12]
    B, P = speed.shape
    n_live, n_argmin = _live(forced, count)
    n_grid, _ = grid_reads(grids, gid, gscale, starts, sizes, count)
    nbytes = 20 * n_live + 4 * n_grid + 4 * B * (2 * P + 5) + 4 * B * P
    return nbytes, n_argmin * (P - 1) + 16 * n_live


def plain_bound(args):
    """As :func:`fused_bound` for event_finish: eff and forced (8 B a
    chunk), the per-lane rows (speed, jitter and three scalars), the output;
    4 operations a chunk for the update."""
    eff, speed, _, _, _, forced, count = args
    B, P = speed.shape
    n_live, n_argmin = _live(forced, count)
    nbytes = 8 * n_live + 4 * B * (2 * P + 3) + 4 * B * P
    return nbytes, n_argmin * (P - 1) + 4 * n_live


def bound_ms(nbytes: int, ops: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def longest_lane(args, shared: int):
    """The call's arguments cut to its longest lane alone; the first
    ``shared`` arguments are not per lane."""
    j = int(args[-1].argmax())
    return list(args[:shared]) + [a[j:j + 1].contiguous()
                                   for a in args[shared:]]


def kernel_record(name, launches, args, shared, fn, ref, bound_fn, device,
                  flush, reps, plain_reps):
    """Time one kernel and its plain version on one call's arguments, and
    the kernel on the call's longest lane alone: one warp walking that
    lane's chain of dependent steps, which no call can finish sooner."""
    err = float((fn(*args) - ref(*args)).abs().max())
    ms = time_call(fn, args, reps, device, flush)
    plain_ms = time_call(ref, args, plain_reps, device, flush)
    lane = longest_lane(args, shared)
    chain_ms = time_call(fn, lane, reps, device, flush)
    chain_steps = int(lane[-1].sum())
    nbytes, ops = bound_fn(args)
    b_ms, b_by = bound_ms(nbytes, ops)
    return {"name": name, "route": "cuda", "source": CU_SOURCE,
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": {"B": int(args[-1].shape[0]),
                      "K": int(args[-2].shape[1]),
                      "P": int(args[-6].shape[1]),
                      "live_chunks": int(args[-1].long().sum())},
            "bytes": nbytes, "ops": ops, "chain_steps": chain_steps,
            "chain_ms": chain_ms,
            "chain_step_us": chain_ms * 1e3 / max(chain_steps, 1)}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc" / "event_loop.cu"
            ).is_file():
        print(f"chip_smoke: the port's sources are not under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    try:
        return run()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1


def run() -> int:
    from repro_torch import TorchBatchedBackend
    from repro_torch.kernels import build
    from repro_torch.kernels import event_loop as ev
    from repro_torch.sim import get_application

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"[1] {smi}")
    log(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, {kind} x "
        f"{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    secs = {s: build.build(s) for s in build.SIGNATURES}
    log(f"[2] built {sorted(secs)} in {time.perf_counter() - t0:.1f} s")

    log("[3] kernels vs plain versions, synthetic inputs")
    grids_np = get_application("mandelbrot").profile_stack(500).grids()
    res = phase_synthetic(device, grids_np, N=262_144)
    bad = sum(r[3] + r[4] for r in res)
    log(f"[3] mismatches: {bad}")
    require(bad == 0, f"kernels disagree with their plain versions: {res}")

    log("[4] campaign path: sweep_portfolio on the kernels")
    bk = TorchBatchedBackend()
    bk.core_calls = []
    ev.reset_launch_counts()
    sw_m, wall_m = sweep("mandelbrot", bk, T=500, reps=3)
    times_m = dict(vars(bk.times))
    bk.times.reset()
    sw_t, wall_t = sweep("tc", bk, reps=3)
    campaign_launches = ev.launch_counts()
    fused_calls = [a for n, a in bk.core_calls if n == "event_finish_fused"]
    bk.core_calls = None
    log(f"[4] launches {json.dumps(campaign_launches)}")
    require(campaign_launches["event_finish_fused"] > 0,
            "the campaign path never launched event_finish_fused")
    check_sweep(sw_m, 500, 3)
    check_sweep(sw_t, 500, 1)
    log(json.dumps({"sweep": "mandelbrot/epyc", "T": 500, "reps": 3,
                    "wall_s": wall_m, "oracle_total": sw_m.oracle_total(),
                    "cov": sw_m.cov(), "path_times": times_m}))
    log(json.dumps({"sweep": "tc/epyc", "T": 500, "reps": 3,
                    "wall_s": wall_t, "oracle_total": sw_t.oracle_total(),
                    "cov": sw_t.cov(), "path_times": dict(vars(bk.times))}))

    pk = TorchBatchedBackend(event_core="plain")
    sw_mp, wall_mp = sweep("mandelbrot", pk, T=500, reps=3)
    sw_tp, wall_tp = sweep("tc", pk, reps=3)
    log(f"[4] plain event core on the card: mandelbrot {wall_mp:.1f} s, "
        f"tc {wall_tp:.1f} s")
    require(same_sweeps([sw_m, sw_t], [sw_mp, sw_tp]),
            "campaign results differ between the kernels and the plain "
            "versions on the card")
    require(sw_m.oracle_total() == sw_mp.oracle_total()
            and sw_t.oracle_total() == sw_tp.oracle_total(), "oracle totals")
    require(same_sweeps(small_sweeps(bk),
                        small_sweeps(TorchBatchedBackend(device="cpu")),
                        lib_atol=1e-4),
            "the T = 2 sweeps differ between the card and the CPU")
    log("[4] kernels == plain on the card; card == CPU on the T = 2 sweeps")

    log("[5] what-if path")
    ev.reset_launch_counts()
    bk.core_calls = []
    w_card = what_if_calls(bk)
    whatif_launches = ev.launch_counts()
    wave_calls = [a for n, a in bk.core_calls if n == "event_finish"]
    bk.core_calls = None
    log(f"[5] launches {json.dumps(whatif_launches)}, rows per call "
        f"{[int(a[0].shape[0]) for a in wave_calls]}")
    require(whatif_launches["event_finish"] > 0,
            "the what-if path never launched event_finish")
    w_plain = what_if_calls(TorchBatchedBackend(event_core="plain"))
    w_cpu = what_if_calls(TorchBatchedBackend(device="cpu"))
    for name, other in (("plain on the card", w_plain), ("the CPU", w_cpu)):
        require(all(np.array_equal(a, b) for a, b in zip(w_card, other)),
                f"what-if prices differ between the kernels and {name}")
        require(all(np.all(np.isfinite(a)) for a in w_card), "what-if nan")
    log("[5] kernels == plain on the card == CPU")

    log("[6] timing at the main path's shapes")
    flush = torch.empty(64 << 20, dtype=torch.int32, device=device)
    big_f = max(fused_calls, key=lambda a: int(a[-1].long().sum()))
    big_w = max(wave_calls, key=lambda a: int(a[-1].long().sum()))
    kernels = [
        kernel_record("event_finish", whatif_launches["event_finish"],
                      big_w, 0, ev.event_finish, ev.event_finish_ref,
                      plain_bound, device, flush, reps=50, plain_reps=5),
        kernel_record("event_finish_fused",
                      campaign_launches["event_finish_fused"], big_f, 1,
                      ev.event_finish_fused, ev.event_finish_fused_ref,
                      fused_bound, device, flush, reps=20, plain_reps=2),
    ]
    for k in kernels:
        require(k["max_abs_err"] == 0.0, f"{k['name']} disagrees at the "
                f"main path's shapes: {k['max_abs_err']}")
    log(f"[6] total {time.perf_counter() - t_start:.1f} s")
    log(nvidia_smi_line())
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
