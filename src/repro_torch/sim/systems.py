"""Machine models for the paper's three systems (Table 2).

Constants are calibrated so the simulator reproduces the paper's *qualitative*
behavior (claims C1-C8 in DESIGN.md), not exact seconds:

* ``h`` — central work-queue dispatch overhead per chunk (mutex/atomic path).
* ``h_adaptive_mult`` — extra bookkeeping for the mutex-protected adaptive
  variants (AWF-B/D per LB4OMP's implementation notes; mFAC2 and AWF-C/E use
  the atomic path).
* ``boundary_cost`` — per-chunk stream/prefetch restart cost charged to
  *memory-bound* loops (the data-locality loss the paper attributes to small
  chunks; §4.2).
* ``dyn_locality`` — relative inflation of memory-bound work under *dynamic*
  assignment (iterations land on threads that did not first-touch the data).
* ``noise_sigma`` — lognormal multiplicative execution noise per chunk.
* ``jitter`` — thread arrival spread at loop start (the GSS motivation).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class SystemModel:
    name: str
    P: int
    h: float                  # s per dispatch (atomic/mutex fast path)
    h_adaptive_mult: float    # multiplier on h for mutex-protected adaptive algs
    h_serial_frac: float      # fraction of h inside the serializing critical
                              # section (central-queue saturation model)
    boundary_cost: float      # s per chunk on fully memory-bound loops
    dyn_locality: float       # base inflation of dynamically-assigned work on
                              # locality-sensitive loops (first-touch loss)
    loc_amp: float            # hardware miss-penalty amplitude for tiny chunks
    c_loc: int                # (unused default reuse window; per-loop c_loc wins)
    noise_sigma: float
    jitter: float             # s, max arrival offset
    speed_spread: float       # persistent per-thread speed variation (fraction)
    pe_speeds: Optional[Tuple[float, ...]] = None
                              # per-PE execution-time multipliers for
                              # *persistently* heterogeneous machines
                              # (big.LITTLE-style); None = homogeneous.
                              # 1.0 nominal, > 1 slower.  Composed with any
                              # instance perturbation by the backends.

    def __post_init__(self):
        if self.pe_speeds is not None:
            speeds = tuple(float(x) for x in self.pe_speeds)
            if len(speeds) != self.P:
                raise ValueError(
                    f"pe_speeds has {len(speeds)} entries for P={self.P}")
            if any(x <= 0.0 for x in speeds):
                raise ValueError("pe_speeds must be positive multipliers")
            object.__setattr__(self, "pe_speeds", speeds)

    def chunk_inflation(self, locality_sens: float, c: float,
                        c_loc: float) -> float:
        """Execution-time inflation for dynamically assigned chunks of size c
        on a loop whose spatial-reuse window is ``c_loc`` iterations."""
        return 1.0 + locality_sens * (
            self.dyn_locality + self.loc_amp * c_loc / (c + c_loc))


BROADWELL = SystemModel(
    name="broadwell", P=20, h=0.10e-6, h_adaptive_mult=4.0,
    h_serial_frac=0.5, boundary_cost=3.0e-6, dyn_locality=0.08,
    loc_amp=4.0, c_loc=256, noise_sigma=0.015,
    jitter=25e-6, speed_spread=0.005)

CASCADE_LAKE = SystemModel(
    name="cascadelake", P=56, h=0.12e-6, h_adaptive_mult=6.0,
    h_serial_frac=0.5, boundary_cost=3.0e-6, dyn_locality=0.10,
    loc_amp=6.0, c_loc=256, noise_sigma=0.02,
    jitter=35e-6, speed_spread=0.008)

EPYC = SystemModel(
    name="epyc", P=128, h=0.20e-6, h_adaptive_mult=8.0,
    h_serial_frac=0.5, boundary_cost=2.0e-6, dyn_locality=0.12,
    loc_amp=8.0, c_loc=256, noise_sigma=0.025,
    jitter=45e-6, speed_spread=0.010)

SYSTEMS = {s.name: s for s in (BROADWELL, CASCADE_LAKE, EPYC)}


def hetero_system(base: SystemModel, name: str,
                  pe_speeds: Tuple[float, ...]) -> SystemModel:
    """A synthetic heterogeneous machine derived from one of the paper's
    systems: same overhead/noise constants, but per-PE execution-time
    multipliers (1.0 nominal, > 1 slower)."""
    return dataclasses.replace(base, name=name,
                               pe_speeds=tuple(pe_speeds))


def _big_little(base: SystemModel, name: str, frac_little: float,
                little_factor: float) -> SystemModel:
    k = max(1, int(round(base.P * frac_little)))
    speeds = (1.0,) * (base.P - k) + (float(little_factor),) * k
    return hetero_system(base, name, speeds)


#: Synthetic heterogeneous machines beyond the paper's three (kept out of
#: ``SYSTEMS`` so figure pipelines iterating the paper's machine set are
#: untouched).  "big.LITTLE" quarters: last 25% of PEs run slower.
HETERO_SYSTEMS = {
    s.name: s for s in (
        _big_little(BROADWELL, "broadwell_het", 0.25, 2.0),
        _big_little(CASCADE_LAKE, "cascadelake_het", 0.25, 3.0),
        _big_little(EPYC, "epyc_het", 0.25, 4.0),
    )
}


def get_system(name: str) -> SystemModel:
    try:
        return SYSTEMS[name]
    except KeyError:
        pass
    try:
        return HETERO_SYSTEMS[name]
    except KeyError:
        raise KeyError(
            f"unknown system {name!r}; known: "
            f"{sorted(SYSTEMS) + sorted(HETERO_SYSTEMS)}") from None
