"""The batched simulator's sequential event core: two CUDA kernels and
their plain PyTorch versions.

Per lane b: ``fin = jitter[b]``; for each chunk i < ``count[b]`` the PE is
``forced[b, i]`` when that is >= 0, else ``argmin(fin)`` with ties to the
lowest index, and ``fin[pe] += (h_eff + eff[i] * speed[pe]) + bcost``.

* ``event_finish`` — the core over precomputed effective chunk costs (the
  what-if path, whose costs come from an exact float64 host gather).
* ``event_finish_fused`` — the campaign path: each chunk's cost is
  interpolated from the lane's cumulative-cost grid row and scaled by its
  locality and noise factors inside the kernel, so the (B, K) cost array is
  never written to device memory.

Each wrapper takes the plain version for tensors on the CPU and launches its
kernel (``csrc/event_loop.cu``) for tensors on a CUDA device; it never falls
back from one to the other.  ``launches`` on each wrapper counts the kernel
launches, so a run can show that it went through the kernel.

Rounding: the reference contracts ``h_eff + eff*speed`` and the grid
interpolation ``lo + (pos - i)*(hi - lo)`` into fused multiply-adds; the
plain versions write both as ``torch.addcmul`` and the kernels as
``__fmaf_rn``, so all three agree bit for bit.
"""

from __future__ import annotations

from typing import Dict

import torch

#: largest PE count the kernels hold in registers (4 per thread of a warp)
MAX_P = 128

_SOURCE = "event_loop.cu"


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def event_finish_ref(eff, speed, jitter, h_eff, bcost, forced, count):
    """Plain core: one step per chunk index, vectorized over lanes.

    eff (B, K) f32, speed/jitter (B, P) f32, h_eff/bcost (B,) f32,
    forced (B, K) i32 (-1 = argmin assignment), count (B,) i32.
    Returns finish (B, P) f32."""
    B = eff.shape[0]
    fin = jitter.clone()
    if B == 0:
        return fin
    rows = torch.arange(B, device=eff.device)
    for i in range(int(count.max())):
        f = forced[:, i].long()
        pe = torch.where(f >= 0, f, fin.argmin(dim=1))
        inc = torch.addcmul(h_eff, eff[:, i], speed[rows, pe]) + bcost
        cur = fin[rows, pe]
        fin[rows, pe] = torch.where(i < count, cur + inc, cur)
    return fin


def prefix_costs(grids, grid_id, gscale, starts, sizes, loc, noise):
    """Effective chunk costs (B, K) f32 from the lanes' grid rows:
    ``((pref(start + size) - pref(start)) * loc) * noise`` with
    ``pref`` the linear interpolation over row ``grid_id[b]``."""
    G = grids.shape[1] - 1
    flat = grids.reshape(-1)
    base = (grid_id.long() * (G + 1))[:, None]
    gs = gscale[:, None]

    def pref(x):
        pos = x.to(torch.float32) * gs
        i = pos.to(torch.int32).clamp(0, G - 1)
        idx = base + i.long()
        lo = flat[idx]
        return torch.addcmul(lo, pos - i.to(torch.float32), flat[idx + 1] - lo)

    return (pref(starts + sizes) - pref(starts)) * loc * noise


def event_finish_fused_ref(grids, grid_id, gscale, starts, sizes, loc, noise,
                           speed, jitter, h_eff, bcost, forced, count):
    """Plain fused core: :func:`prefix_costs`, then :func:`event_finish_ref`.

    grids (S, G+1) f32 cumulative-cost stack, grid_id (B,) i32, gscale (B,)
    f32 (= G / N per lane), starts/sizes (B, K) i32, loc/noise (B, K) f32;
    the rest as in :func:`event_finish_ref`."""
    eff = prefix_costs(grids, grid_id, gscale, starts, sizes, loc, noise)
    return event_finish_ref(eff, speed, jitter, h_eff, bcost, forced, count)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(fn_name: str, args, device) -> None:
    from .build import load
    lib = load(_SOURCE)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = getattr(lib, fn_name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} failed with CUDA error {rc}")


def _lane_args(B, P, K, device, speed, jitter, h_eff, bcost, forced, count):
    f32, i32 = torch.float32, torch.int32
    if P > MAX_P:
        raise ValueError(f"P={P} exceeds the kernels' {MAX_P} PEs")
    _check("speed", speed, f32, (B, P), device)
    _check("jitter", jitter, f32, (B, P), device)
    _check("h_eff", h_eff, f32, (B,), device)
    _check("bcost", bcost, f32, (B,), device)
    _check("forced", forced, i32, (B, K), device)
    _check("count", count, i32, (B,), device)


def event_finish(eff, speed, jitter, h_eff, bcost, forced, count):
    """Sequential assignment core over precomputed effective chunk costs;
    arguments as in :func:`event_finish_ref`.  Returns finish (B, P) f32."""
    device = eff.device
    if device.type == "cpu":
        return event_finish_ref(eff, speed, jitter, h_eff, bcost, forced,
                                count)
    if device.type != "cuda":
        raise ValueError(f"event_finish runs on cuda or cpu, not {device}")
    B, K = eff.shape
    P = speed.shape[1]
    _check("eff", eff, torch.float32, (B, K), device)
    _lane_args(B, P, K, device, speed, jitter, h_eff, bcost, forced, count)
    out = torch.empty((B, P), dtype=torch.float32, device=device)
    _launch("event_finish_launch",
            [t.data_ptr() for t in (eff, speed, jitter, h_eff, bcost, forced,
                                    count, out)] + [B, K, P], device)
    event_finish.launches += 1
    return out


def event_finish_fused(grids, grid_id, gscale, starts, sizes, loc, noise,
                       speed, jitter, h_eff, bcost, forced, count):
    """Fully fused campaign core: grid-row cost interpolation + locality /
    noise scaling + assignment recurrence in one pass; arguments as in
    :func:`event_finish_fused_ref`.  Returns finish (B, P) f32."""
    device = starts.device
    if device.type == "cpu":
        return event_finish_fused_ref(grids, grid_id, gscale, starts, sizes,
                                      loc, noise, speed, jitter, h_eff,
                                      bcost, forced, count)
    if device.type != "cuda":
        raise ValueError(
            f"event_finish_fused runs on cuda or cpu, not {device}")
    B, K = starts.shape
    P = speed.shape[1]
    S, G1 = grids.shape
    _check("grids", grids, torch.float32, (S, G1), device)
    _check("grid_id", grid_id, torch.int32, (B,), device)
    _check("gscale", gscale, torch.float32, (B,), device)
    for name, t, dt in (("starts", starts, torch.int32),
                        ("sizes", sizes, torch.int32),
                        ("loc", loc, torch.float32),
                        ("noise", noise, torch.float32)):
        _check(name, t, dt, (B, K), device)
    _lane_args(B, P, K, device, speed, jitter, h_eff, bcost, forced, count)
    out = torch.empty((B, P), dtype=torch.float32, device=device)
    _launch("event_finish_fused_launch",
            [t.data_ptr() for t in (grids, grid_id, gscale, starts, sizes,
                                    loc, noise, speed, jitter, h_eff, bcost,
                                    forced, count, out)]
            + [B, K, P, G1 - 1], device)
    event_finish_fused.launches += 1
    return out


event_finish.launches = 0
event_finish_fused.launches = 0

WRAPPERS = (event_finish, event_finish_fused)


def launch_counts() -> Dict[str, int]:
    return {fn.__name__: fn.launches for fn in WRAPPERS}


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
