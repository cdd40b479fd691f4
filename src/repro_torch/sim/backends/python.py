"""The reference Python engine: a discrete-event simulator of OpenMP
self-scheduled loop execution — the port's copy of
``repro.sim.backends.python``.

Reproduces the execution model of LB4OMP (paper §2): P threads arrive at a
parallel loop with small jitter, self-assign chunks from a central queue
(dynamic algorithms) or execute pre-assigned ranges (STATIC / StaticSteal),
pay a dispatch overhead ``h`` per work request, and — on memory-bound loops —
a locality penalty for dynamic assignment and per-chunk stream restarts.

Three execution paths:

* ``STATIC`` and the constant-chunk closed form (SS / StaticSteal past
  ``EVENT_CAP``) — the closed forms of :mod:`.closed_form`, shared with the
  batched engine;
* event loop — everything else (GSS/TSS/AutoLLVM/mFAC2/AWF-*/mAF and small-N
  SS/StaticSteal): a heap of thread-available times; chunk sizes come from
  the live algorithm objects, adaptive ones receive per-chunk telemetry.

This engine is host numpy by nature: it never touches the card.  It is
chosen by name (``get_backend("python")``), never as a fallback, and gives
the adaptive algorithms their exact per-chunk telemetry where the batched
engine runs telemetry-free surrogates of them.
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Sequence

import numpy as np

from ...core.portfolio import make_algorithm
from .base import (EVENT_CAP, BatchResult, InstancePerturb, InstanceSpec,
                   SimBackend, needs_closed_form, sigma_scale_of)
from .closed_form import (H_ATOMIC_ADAPTIVE, MUTEX_ADAPTIVE, InstanceResult,
                          _h_eff, _run_constant_closed, _run_static,
                          _thread_speeds)

__all__ = ["H_ATOMIC_ADAPTIVE", "MUTEX_ADAPTIVE", "InstanceResult",
           "PythonBackend", "run_instance"]


def run_instance(profile, system, alg_idx: int,
                 chunk_param: int, rng, record_chunks: bool = False,
                 perturb: Optional[InstancePerturb] = None
                 ) -> InstanceResult:
    N = profile.N

    if alg_idx == 0:
        return _run_static(profile, system, chunk_param, rng, record_chunks,
                           perturb)

    if needs_closed_form(alg_idx, N, chunk_param):
        return _run_constant_closed(profile, system, alg_idx,
                                    max(1, chunk_param), rng, perturb)

    return _run_events(profile, system, alg_idx, chunk_param, rng,
                       record_chunks, perturb)


# ---------------------------------------------------------------------------
# event loop
# ---------------------------------------------------------------------------

def _run_events(profile, system, alg_idx, chunk_param, rng, record_chunks,
                perturb=None):
    P, N, mb = system.P, profile.N, profile.memory_bound
    h = _h_eff(system, alg_idx)
    alg = make_algorithm(alg_idx)
    alg.reset(N, P, chunk_param)

    jitter = rng.uniform(0.0, system.jitter, P)
    speed = _thread_speeds(system, rng, perturb)
    finish = jitter.copy()

    heap = [(jitter[i], i) for i in range(P)]
    heapq.heapify(heap)

    steal_bounds = None
    steal_ranges = None
    if alg_idx == 5:   # StaticSteal needs iteration *identity* per PE
        bounds = np.linspace(0, N, P + 1).round().astype(np.int64)
        steal_bounds = bounds
        steal_ranges = [[int(bounds[i]), int(bounds[i + 1])] for i in range(P)]

    # fast scalar prefix lookup (avoids np.interp per-call overhead)
    if profile.uniform:
        unit = profile.unit

        def pref(x):
            return x * unit
    else:
        grid = profile.prefix_grid
        gscale = len(grid[:-1]) / N    # GRID / N

        def pref(x):
            pos = x * gscale
            i = int(pos)
            if i >= len(grid) - 1:
                return float(grid[-1])
            lo = grid[i]
            return float(lo + (pos - i) * (grid[i + 1] - lo))

    # pre-drawn lognormal noise (scalar Generator calls are ~3us each)
    sigma = system.noise_sigma * sigma_scale_of(perturb)
    noise_buf = np.exp(rng.normal(0.0, sigma, 4096))
    noise_i = 0

    cursor = 0
    events = 0
    ls = profile.locality_sens
    base_infl = 1.0 + ls * system.dyn_locality
    amp = ls * system.loc_amp
    c_loc = profile.c_loc
    bcost = mb * system.boundary_cost
    sizes: Optional[List[int]] = [] if record_chunks else None
    pop, push = heapq.heappop, heapq.heappush

    while alg.remaining > 0:
        t, pe = pop(heap)
        if alg_idx == 5:
            c, a, b = _steal_next(alg, steal_ranges, pe)
            if c == 0:
                continue
            own_range = steal_bounds[pe] <= a < steal_bounds[pe + 1]
            loc = 1.0 if own_range else (base_infl + amp * c_loc / (c + c_loc))
        else:
            c = alg.next_chunk(pe)
            if c == 0:
                break
            a, b = cursor, cursor + c
            cursor += c
            loc = base_infl + amp * c_loc / (c + c_loc)
        raw = pref(b) - pref(a)
        if noise_i >= 4096:
            noise_buf = np.exp(rng.normal(0.0, sigma, 4096))
            noise_i = 0
        exec_t = raw * loc * speed[pe] * noise_buf[noise_i] + bcost
        noise_i += 1
        alg.report(pe, c, exec_t, exec_t + h)
        t_new = t + h + exec_t
        finish[pe] = t_new
        push(heap, (t_new, pe))
        if sizes is not None:
            sizes.append(c)
        events += 1
        if events > EVENT_CAP * 4:
            raise RuntimeError(
                f"event cap exceeded: alg={alg_idx} N={N} P={P} "
                f"chunk_param={chunk_param}")

    return InstanceResult(loop_time=float(finish.max()), finish=finish,
                          n_chunks=events, chunk_sizes=sizes)


def _steal_next(alg, ranges, pe):
    """Range-aware StaticSteal: serve own range in quanta; steal the richer
    half of the richest victim when empty.  Keeps ``alg`` bookkeeping in sync
    so ``alg.remaining`` stays authoritative."""
    q = max(1, alg.chunk_param)
    lo, hi = ranges[pe]
    if lo >= hi:
        victim = max(range(alg.P), key=lambda i: ranges[i][1] - ranges[i][0])
        vl, vh = ranges[victim]
        if vh - vl <= 0:
            return 0, 0, 0
        half = (vh - vl + 1) // 2
        ranges[victim][1] = vh - half      # victim keeps the front
        ranges[pe] = [vh - half, vh]       # thief takes the back half
        lo, hi = ranges[pe]
    c = min(q, hi - lo)
    ranges[pe][0] = lo + c
    alg.remaining -= c
    alg.scheduled += c
    return c, lo, lo + c


# ---------------------------------------------------------------------------
# backend wrapper
# ---------------------------------------------------------------------------

class PythonBackend(SimBackend):
    """The reference engine behind the ``SimBackend`` protocol."""

    name = "python"

    def run_instance(self, profile, system, alg: int, chunk_param: int,
                     rng, record_chunks: bool = False,
                     perturb: Optional[InstancePerturb] = None
                     ) -> InstanceResult:
        return run_instance(profile, system, alg, chunk_param, rng,
                            record_chunks, perturb)

    def run_batch(self, profiles: Sequence, system,
                  specs: Sequence[InstanceSpec]) -> BatchResult:
        B = len(specs)
        lt = np.zeros(B)
        lib = np.zeros(B)
        nc = np.zeros(B, np.int64)
        for i, s in enumerate(specs):
            rng = np.random.default_rng(s.seed)
            r = run_instance(profiles[s.profile_id], system, s.alg,
                             s.chunk_param, rng, perturb=s.perturb)
            lt[i], lib[i], nc[i] = r.loop_time, r.lib, r.n_chunks
        return BatchResult(loop_time=lt, lib=lib, n_chunks=nc)

    def what_if_wave(self, prefix: np.ndarray, n_replicas: int,
                     init_avail: np.ndarray, h: float, fixed: float,
                     algs: Sequence[int], chunk_param: int = 0
                     ) -> np.ndarray:
        """Greedy host replay of the serving dispatch loop per candidate —
        mirrors ``DispatchSimulator.run_wave`` (adaptive algorithms run their
        real telemetry-driven host classes here)."""
        N = len(prefix) - 1
        R = n_replicas
        out = np.zeros(len(algs))
        for k, alg_idx in enumerate(algs):
            free = np.asarray(init_avail, dtype=np.float64).copy()
            if alg_idx == 0 and chunk_param <= 0:
                bounds = np.linspace(0, N, R + 1).round().astype(int)
                for r in range(R):
                    if bounds[r + 1] > bounds[r]:
                        free[r] += fixed + prefix[bounds[r + 1]] \
                            - prefix[bounds[r]]
            else:
                alg = make_algorithm(alg_idx)
                alg.reset(N, R, chunk_param)
                cursor = 0
                while alg.remaining > 0:
                    r = int(np.argmin(free))
                    c = alg.next_chunk(r)
                    if c <= 0:
                        break
                    dt = fixed + float(prefix[cursor + c] - prefix[cursor])
                    cursor += c
                    alg.report(r, c, dt, dt + h)
                    free[r] += h + dt
            out[k] = free.max()
        return out
