"""Workload models for the paper's six applications (Table 2, §4.1).

Each application exposes ``loops(t)`` — the per-time-step list of
``LoopProfile``s for its modified OpenMP loops.  Iteration costs are carried
as a *prefix-sum grid* (G buckets, linear interpolation) so that chunk costs
over arbitrary ranges are O(1) regardless of N (STREAM has N = 2e9).

The cost *patterns* implement the imbalance characters stated in Table 2:

    Mandelbrot  L0 constant / L1 increasing / L2 decreasing imbalance
    STREAM      uniform, fully memory-bound
    TC          power-law head (sorted Kronecker degrees) — severe imbalance
    HACCKernels uniform, compute-bound
    LULESH      4 loops, mild imbalance, mixed memory/compute
    SPHYNX      evolving imbalance across time-steps (gravity loop)
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

GRID = 16384  # prefix-grid resolution


def profile_digest(p) -> tuple:
    """Content key of one profile, memoized on the profile — shared by every
    per-profile cache (the batched backend's device-grid uploads).

    Profiles are treated as immutable (the repo's ``Application`` classes
    rebuild ``LoopProfile`` objects rather than mutating them) — the
    expensive blake2b over a 64 KB grid runs once per object.  The cheap
    fields (``N``, ``total``, the grid tail) ride along in the key as a
    partial guard, but mutating ``prefix_grid`` in place after first use
    is unsupported: rebuild the profile instead.
    """
    if p.prefix_grid is None:
        return (p.N, p.total)
    memo = getattr(p, "_grid_blake", None)
    if memo is None or memo[0] is not p.prefix_grid:     # rebound array
        memo = (p.prefix_grid, hashlib.blake2b(
            np.ascontiguousarray(p.prefix_grid).tobytes(),
            digest_size=16).digest())
        try:
            p._grid_blake = memo
        except Exception:   # pragma: no cover - exotic read-only profiles
            pass
    # N/total/tail read live so they guard the cheap mutations too
    return (p.N, p.total, float(p.prefix_grid[-1]), memo[1])


def stack_prefix_grids(profiles) -> np.ndarray:
    """(S, GRID+1) float32 stacked cumulative-cost grids — the device-ready
    form the batched backend gathers from.  Uniform profiles synthesize a
    linear ramp at the shared resolution so one interpolation serves all."""
    rows = np.zeros((len(profiles), GRID + 1), np.float32)
    for i, p in enumerate(profiles):
        if p.prefix_grid is None:
            rows[i] = np.linspace(0.0, p.total, GRID + 1, dtype=np.float32)
        else:
            assert len(p.prefix_grid) == GRID + 1, "mixed grid resolutions"
            rows[i] = p.prefix_grid
    return rows


@dataclass
class LoopProfile:
    """Cost model of one parallel loop at one time-step."""

    name: str
    N: int
    memory_bound: float                 # 0 = compute-bound .. 1 = STREAM
    locality_sens: float = 0.0          # spatial-reuse sensitivity (small-chunk
                                        # locality loss; 0 = random access)
    c_loc: int = 64                     # reuse window in iterations
    unit: float = 0.0                   # mean per-iteration cost (s)
    prefix_grid: Optional[np.ndarray] = None   # (GRID+1,) cumulative cost, or None = uniform
    total: float = 0.0

    def __post_init__(self):
        if self.prefix_grid is None:
            self.total = self.N * self.unit
        else:
            self.total = float(self.prefix_grid[-1])

    def prefix(self, x):
        """Cumulative cost of iterations [0, x). Vectorized; x in [0, N]."""
        if self.prefix_grid is None:
            return np.asarray(x, dtype=np.float64) * self.unit
        pos = np.asarray(x, dtype=np.float64) * (GRID / self.N)
        return np.interp(pos, np.arange(GRID + 1), self.prefix_grid)

    def range_cost(self, a, b):
        return self.prefix(b) - self.prefix(a)

    @property
    def uniform(self) -> bool:
        return self.prefix_grid is None


def _grid_from_pattern(pattern: np.ndarray, N: int, unit: float) -> np.ndarray:
    """pattern: (GRID,) relative per-bucket cost density, mean-normalized."""
    density = pattern / pattern.mean()
    bucket_cost = density * (N / GRID) * unit
    return np.concatenate([[0.0], np.cumsum(bucket_cost)])


@dataclass
class ProfileStack:
    """Device-ready view of an application's loops over a window of
    time-steps: the flattened profile list plus the stacked prefix grids
    the batched backend gathers from (one row per (t, loop), uniform
    profiles synthesized as linear ramps at the shared resolution).

    ``pid(t, li)`` maps a (time-step, loop-index) pair to its row.
    """

    profiles: List[LoopProfile]
    n_loops: int

    def pid(self, t: int, li: int) -> int:
        return t * self.n_loops + li

    def grids(self) -> np.ndarray:
        """(S, GRID+1) float32 stacked cumulative-cost grids."""
        return stack_prefix_grids(self.profiles)


class Application:
    name: str = "app"
    T: int = 500
    loop_names: List[str] = []
    time_invariant: bool = False  # loops(t) identical for all t

    def loops(self, t: int) -> List[LoopProfile]:  # pragma: no cover
        raise NotImplementedError

    def profile_stack(self, T: Optional[int] = None) -> ProfileStack:
        """Flatten ``loops(t)`` for t in [0, T) into a ``ProfileStack``."""
        T = T or self.T
        profiles: List[LoopProfile] = []
        for t in range(T):
            profiles.extend(self.loops(t))
        return ProfileStack(profiles=profiles, n_loops=len(self.loop_names))


class Mandelbrot(Application):
    """Compute-bound, N = 262'144, 3 loops: constant / increasing / decreasing
    workload imbalance (the loops 'zoom' into different set regions)."""

    name = "mandelbrot"
    N = 262_144
    T = 500
    loop_names = ["L0", "L1", "L2"]
    UNIT = 2.0e-6

    def __init__(self):
        x = np.linspace(0.0, 1.0, GRID)
        # escape-iteration-like bumps at different set regions
        self._bump0 = np.exp(-((x - 0.35) / 0.08) ** 2)
        self._bump1 = np.exp(-((x - 0.62) / 0.05) ** 2)
        self._bump2 = np.exp(-((x - 0.18) / 0.06) ** 2)

    def loops(self, t: int) -> List[LoopProfile]:
        frac = t / max(1, self.T - 1)
        amps = (6.0,                  # L0: constant imbalance
                0.5 + 11.0 * frac,    # L1: increasing
                11.5 - 11.0 * frac)   # L2: decreasing
        bumps = (self._bump0, self._bump1, self._bump2)
        out = []
        for nm, a, b in zip(self.loop_names, amps, bumps):
            pattern = 1.0 + a * b
            out.append(LoopProfile(
                name=nm, N=self.N, memory_bound=0.0, locality_sens=0.0,
                unit=self.UNIT,
                prefix_grid=_grid_from_pattern(pattern, self.N, self.UNIT)))
        return out


class StreamTriad(Application):
    """Memory-bound, N = 2e9, perfectly regular."""

    name = "stream"
    N = 2_000_000_000
    T = 500
    loop_names = ["L0"]
    UNIT = 2.0e-9   # ~24 B/iter over per-thread effective bandwidth
    time_invariant = True

    def loops(self, t: int) -> List[LoopProfile]:
        return [LoopProfile(name="L0", N=self.N, memory_bound=1.0,
                            locality_sens=0.3, c_loc=512, unit=self.UNIT)]


class TriangleCounting(Application):
    """Graph kernel, N = 2^20, severe power-law imbalance (degree-sorted
    Kronecker graph: the heavy vertices form a contiguous head)."""

    name = "tc"
    N = 1_048_576
    T = 500
    loop_names = ["L0"]
    UNIT = 5.0e-6
    time_invariant = True

    def __init__(self):
        i = np.arange(GRID, dtype=np.float64)
        # cost ~ d_u^2 for degree-sorted Kronecker: heavy head spread over the
        # first few percent of vertices (interleaving CAN balance it)
        pattern = 1.0 + 120.0 * (i + 1.0) ** -0.7
        self._grid = _grid_from_pattern(pattern, self.N, self.UNIT)

    def loops(self, t: int) -> List[LoopProfile]:
        # graph traversal: access pattern is random regardless of chunking
        return [LoopProfile(name="L0", N=self.N, memory_bound=0.2,
                            locality_sens=0.0, unit=self.UNIT,
                            prefix_grid=self._grid)]


class HACCKernels(Application):
    """Compute-bound short-range force kernel, N = 600'000, no imbalance."""

    name = "hacc"
    N = 600_000
    T = 500
    loop_names = ["L0"]
    UNIT = 2.0e-5   # short-range force kernel: ~20us per particle-pair set
    time_invariant = True

    def loops(self, t: int) -> List[LoopProfile]:
        return [LoopProfile(name="L0", N=self.N, memory_bound=0.0,
                            locality_sens=0.05, c_loc=64, unit=self.UNIT)]


class Lulesh(Application):
    """Hydrodynamics mini-app: 4 loops over 5'488'000 elements each (Table 2's
    21'952'000 total across the modified loops), mild imbalance, mixed
    memory/compute behavior."""

    name = "lulesh"
    N = 5_488_000
    T = 500
    loop_names = ["CalcFBHourglass", "CalcHourglassCtl", "CalcKinematics",
                  "IntegrateStress"]
    UNIT = 4.0e-8

    def __init__(self):
        rng = np.random.default_rng(1234)
        self._patterns = [1.0 + 0.12 * rng.random(GRID) for _ in range(4)]
        self._mb = [0.7, 0.6, 0.5, 0.65]

    def loops(self, t: int) -> List[LoopProfile]:
        return [LoopProfile(name=nm, N=self.N, memory_bound=mb,
                            locality_sens=0.7, c_loc=64, unit=self.UNIT,
                            prefix_grid=_grid_from_pattern(p, self.N, self.UNIT))
                for nm, p, mb in zip(self.loop_names, self._patterns, self._mb)]


class Sphynx(Application):
    """SPH Evrard collapse: gravity loop over 1e6 particles, variable and
    *evolving* load imbalance across time-steps (particle clustering)."""

    name = "sphynx"
    N = 1_000_000
    T = 500
    loop_names = ["gravity"]
    UNIT = 2.0e-5

    def __init__(self):
        x = np.linspace(0.0, 1.0, GRID)
        self._x = x

    def loops(self, t: int) -> List[LoopProfile]:
        frac = t / max(1, self.T - 1)
        # clusters drift and sharpen as the collapse evolves
        c1 = 0.3 + 0.25 * frac
        c2 = 0.75 - 0.15 * math.sin(2.0 * math.pi * frac)
        w = 0.18 - 0.10 * frac
        amp = 3.0 + 5.0 * frac + 1.5 * math.sin(6.0 * math.pi * frac)
        pattern = (0.4 + amp * np.exp(-((self._x - c1) / max(w, 0.03)) ** 2)
                   + 0.7 * amp * np.exp(-((self._x - c2) / 0.12) ** 2))
        # neighbor-list reuse window is short (~2 dozen particles)
        return [LoopProfile(name="gravity", N=self.N, memory_bound=0.15,
                            locality_sens=0.8, c_loc=24, unit=self.UNIT,
                            prefix_grid=_grid_from_pattern(pattern, self.N,
                                                           self.UNIT))]


APPLICATIONS: Dict[str, type] = {
    "mandelbrot": Mandelbrot,
    "stream": StreamTriad,
    "tc": TriangleCounting,
    "hacc": HACCKernels,
    "lulesh": Lulesh,
    "sphynx": Sphynx,
}


def get_application(name: str) -> Application:
    return APPLICATIONS[name]()
