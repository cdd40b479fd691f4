"""Factorial experiment campaign (paper §4.1, Table 2) — the portfolio
layer, the port's counterpart of the first part of ``repro.sim.campaign``.

The fixed-algorithm portfolio sweep fans (alg x chunk-mode x rep x time-step
x loop) into one ``run_batch`` call of the active ``SimBackend``; from it
come the Oracle (per-loop, per-time-step best over all algorithm x chunk
combinations) and the c.o.v. of Fig. 4.  The selector replays (``ReplayBatch``
and ``run_campaign``) need the selection-policy layer and are not ported yet.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.metrics import coefficient_of_variation
from ..core.portfolio import N_ALGORITHMS, exp_chunk
from .backends import InstanceSpec, get_backend
from .systems import SystemModel, get_system
from .workloads import Application, get_application

CHUNK_MODES = ("default", "expChunk")


def _digest(label: str) -> int:
    """Stable 16-bit label digest for rng seed tuples — ``hash()`` is salted
    per process for strings, which made campaign noise irreproducible."""
    return zlib.crc32(label.encode("utf-8")) & 0xFFFF


def chunk_param_for(mode: str, N: int, P: int) -> int:
    if mode == "default":
        return 0
    if mode == "expChunk":
        return exp_chunk(N, P)
    raise ValueError(mode)


# ---------------------------------------------------------------------------
# fixed-algorithm runs (portfolio sweep → Oracle, c.o.v.)
# ---------------------------------------------------------------------------

@dataclass
class FixedRun:
    """Median per-time-step loop times for one (alg, chunk_mode)."""
    times: np.ndarray          # (T, n_loops) medians over reps
    libs: np.ndarray           # (T, n_loops)

    @property
    def total(self) -> float:
        return float(self.times.sum())


def _run_portfolio(app: Application, system: SystemModel,
                   pairs: List[Tuple[int, str]], T: int, reps: int,
                   seed: int, backend=None) -> Dict[Tuple[int, str],
                                                    "FixedRun"]:
    """Evaluate every (alg, chunk_mode) pair over the app's time-stepped
    loops through ONE backend batch (the campaign fan-out: alg x mode x
    time-step x loop x rep).  Seed tuples are the historical per-instance
    rng labels: closed-form instances draw from them as the reference does,
    and event-loop lanes fold them into their stateless threefry streams."""
    bk = get_backend(backend)
    # time-invariant apps: simulate a window and tile (median statistics are
    # identical across steps; saves orders of magnitude of DES time)
    T_sim = min(T, 24) if app.time_invariant else T
    stack = app.profile_stack(T_sim)
    n_loops = stack.n_loops
    specs: List[InstanceSpec] = []
    for alg, mode in pairs:
        for t in range(T_sim):
            for li in range(n_loops):
                pid = stack.pid(t, li)
                cp = chunk_param_for(mode, stack.profiles[pid].N, system.P)
                for r in range(reps):
                    specs.append(InstanceSpec(
                        profile_id=pid, alg=alg, chunk_param=cp,
                        seed=(seed, _digest(app.name), system.P, alg,
                              _digest(mode), t, r)))
    res = bk.run_batch(stack.profiles, system, specs)
    lt = res.loop_time.reshape(len(pairs), T_sim, n_loops, reps)
    lb = res.lib.reshape(len(pairs), T_sim, n_loops, reps)
    out = {}
    for i, pair in enumerate(pairs):
        times = np.median(lt[i], axis=-1)
        libs = np.median(lb[i], axis=-1)
        if T_sim < T:
            reps_needed = -(-T // T_sim)
            times = np.tile(times, (reps_needed, 1))[:T]
            libs = np.tile(libs, (reps_needed, 1))[:T]
        out[pair] = FixedRun(times=times, libs=libs)
    return out


def run_fixed(app: Application, system: SystemModel, alg: int,
              chunk_mode: str, T: Optional[int] = None, reps: int = 3,
              seed: int = 0, backend=None) -> FixedRun:
    T = T or app.T
    return _run_portfolio(app, system, [(alg, chunk_mode)], T, reps, seed,
                          backend=backend)[(alg, chunk_mode)]


@dataclass
class PortfolioSweep:
    """All 12 algorithms x 2 chunk modes for one app-system pair."""
    app: str
    system: str
    runs: Dict[Tuple[int, str], FixedRun]

    def oracle_times(self) -> np.ndarray:
        """(T, n_loops) per-loop per-step best over the whole sweep (§3.3)."""
        stack = np.stack([r.times for r in self.runs.values()])
        return stack.min(axis=0)

    def oracle_total(self) -> float:
        return float(self.oracle_times().sum())

    def oracle_best_fn(self, loop_index: int = 0):
        """Per-step best algorithm index (default chunk-mode-agnostic)."""
        keys = list(self.runs.keys())
        stack = np.stack([self.runs[k].times[:, loop_index] for k in keys])
        arg = stack.argmin(axis=0)
        return lambda t: keys[arg[min(t, len(arg) - 1)]][0]

    def oracle_argmin(self) -> np.ndarray:
        """(T, n_loops) index into ``sorted run keys`` of the per-instance
        winner — the Oracle's selection trace (backend-equivalence tests
        compare these across engines)."""
        keys = sorted(self.runs.keys(), key=str)
        stack = np.stack([self.runs[k].times for k in keys])
        return stack.argmin(axis=0)

    def cov(self) -> float:
        """Fig. 4: c.o.v. of loop execution time over every algorithm and
        chunk parameter."""
        totals = np.array([r.total for r in self.runs.values()])
        return coefficient_of_variation(totals)


def sweep_portfolio(app_name: str, system_name: str, T: Optional[int] = None,
                    reps: int = 3, seed: int = 0,
                    backend=None) -> PortfolioSweep:
    """All 12 algorithms x 2 chunk modes, fanned into a single backend
    batch (on the torch backend the whole sweep is a handful of device
    calls instead of tens of thousands of Python event loops)."""
    app = get_application(app_name)
    system = get_system(system_name)
    T_eff = T or app.T
    pairs = [(alg, mode) for alg in range(N_ALGORITHMS)
             for mode in CHUNK_MODES]
    runs = _run_portfolio(app, system, pairs, T_eff, reps, seed,
                          backend=backend)
    return PortfolioSweep(app=app_name, system=system_name, runs=runs)
