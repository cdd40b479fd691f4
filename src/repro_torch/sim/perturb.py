"""Perturbation & drift injection — the port's copy of
``repro.sim.perturb``.

The selection problem only matters because workloads and systems are
non-stationary: SimAS is selection *under perturbations*, and LB4OMP
motivates dynamic scheduling with PE-speed variability.  This module is the
declarative layer that makes the campaign's cells non-stationary:

* :class:`PESlowdown` / :class:`PEFailure` — a subset of PEs runs slower
  (or effectively dies) inside a time-step window;
* :class:`NoiseBurst` — the machine's lognormal per-chunk noise sigma is
  inflated inside a window (bursty co-tenancy);
* :class:`WorkloadDrift` — the application itself drifts between time
  steps: iteration-count scaling (``kind="N"``), load-imbalance sharpening
  (``kind="cov"``: the per-iteration cost density is raised to a power and
  renormalized, preserving total work), or an app-phase shift
  (``kind="phase"``: the app's own ``loops(t)`` evolution is fast-forwarded);
* :class:`PerturbationSpec` — a frozen, hashable bundle of the above,
  attached to a campaign :class:`~repro_torch.sim.campaign.CellSpec` (or
  passed to ``run_selector*``) and resolved per time step into the
  backends' :class:`~repro_torch.sim.backends.base.InstancePerturb`;
* :class:`FleetPerturb` / :class:`GroupSlowdown` / :class:`ReplicaFailure` /
  :class:`ReplicaStraggler` — the serving-layer analogue: whole replica
  groups slow down, individual replicas drop out of or degrade within their
  group, all inside wall-clock windows (``FleetSimulator`` scales the
  group's cost model, masks dead replicas out of dispatch, and exposes the
  effective per-group capacity to routers and admission control; whole-group
  failures interrupt in-flight work, which the fleet's
  :class:`~repro_torch.serving.fleet.recovery.RecoveryPolicy`
  retries/migrates).

Execution-side injection happens inside the backends' shared precompute
(per-PE speed multipliers and a sigma scale applied *before* the sequential
event core), so the CUDA kernels and their plain versions see the same
inputs, and a perturbation-off run is bit-equal to the clean one by
construction: neutral multipliers are exactly 1.0 and no rng draw is added
or reordered.

Windows are half-open in time steps: active for ``t0 <= t < t1``
(``t1=None`` means "until the end").
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .backends.base import InstancePerturb

__all__ = [
    "FAILED_PE_FACTOR", "PESlowdown", "PEFailure", "NoiseBurst",
    "WorkloadDrift", "PerturbationSpec", "GroupSlowdown", "ReplicaFailure",
    "ReplicaStraggler", "FleetPerturb", "InstancePerturb",
    "pe_slowdown_spec", "noise_burst_spec", "drift_spec",
]

#: execution-time multiplier modelling a *failed* PE: large enough that the
#: argmin event cores never assign it work after its first chunk, small
#: enough to stay far from float32 overflow inside the cores
FAILED_PE_FACTOR = 1.0e4


def _active(t0: int, t1: Optional[int], t: int) -> bool:
    return t >= t0 and (t1 is None or t < t1)


@dataclass(frozen=True)
class PESlowdown:
    """``pes`` run ``factor``x slower for time steps ``t0 <= t < t1``."""

    pes: Tuple[int, ...]
    factor: float
    t0: int = 0
    t1: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "pes", tuple(int(p) for p in self.pes))


@dataclass(frozen=True)
class PEFailure:
    """``pes`` are effectively dead for ``t0 <= t < t1`` (their execution
    time inflates by :data:`FAILED_PE_FACTOR`; dynamic algorithms route
    around them, STATIC does not — that asymmetry is the whole point)."""

    pes: Tuple[int, ...]
    t0: int = 0
    t1: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "pes", tuple(int(p) for p in self.pes))


@dataclass(frozen=True)
class NoiseBurst:
    """The machine's lognormal noise sigma is multiplied by ``factor``
    for ``t0 <= t < t1``."""

    factor: float
    t0: int = 0
    t1: Optional[int] = None


@dataclass(frozen=True)
class WorkloadDrift:
    """The application drifts at step ``t0`` (and stays drifted).

    ``kind="N"``     — every loop's iteration count scales by ``factor``;
    ``kind="cov"``   — per-iteration cost density is raised to ``factor``
                       and renormalized (total work preserved; > 1 sharpens
                       imbalance, < 1 flattens it);
    ``kind="phase"`` — the app's own time evolution jumps forward by
                       ``phase_shift`` steps (``loops(t + phase_shift)``).
    """

    kind: str
    t0: int = 0
    factor: float = 1.0
    phase_shift: int = 0

    def __post_init__(self):
        if self.kind not in ("N", "cov", "phase"):
            raise ValueError(f"unknown drift kind {self.kind!r}; "
                             f"expected 'N', 'cov' or 'phase'")


def _drift_profile(p, d: WorkloadDrift):
    if d.kind == "N":
        N2 = max(1, int(round(p.N * d.factor)))
        if p.prefix_grid is None:
            return dataclasses.replace(p, N=N2)
        # scaling the cumulative-cost grid by the same factor keeps the
        # density shape while total work tracks the new N
        return dataclasses.replace(p, N=N2,
                                   prefix_grid=p.prefix_grid * d.factor)
    if d.kind == "cov":
        if p.prefix_grid is None:
            return p            # uniform density: nothing to sharpen
        dens = np.maximum(np.diff(p.prefix_grid), 0.0)
        dens = dens ** d.factor
        total = float(p.prefix_grid[-1] - p.prefix_grid[0])
        s = float(dens.sum())
        if s <= 0.0:
            return p
        dens *= total / s       # preserve total work exactly (up to fp)
        grid = np.concatenate([[0.0], np.cumsum(dens)])
        return dataclasses.replace(p, prefix_grid=grid.astype(np.float64))
    return p                    # "phase" is handled at the app level


@dataclass(frozen=True)
class PerturbationSpec:
    """Declarative, hashable perturbation bundle for one campaign cell."""

    slowdowns: Tuple[PESlowdown, ...] = ()
    failures: Tuple[PEFailure, ...] = ()
    noise_bursts: Tuple[NoiseBurst, ...] = ()
    drifts: Tuple[WorkloadDrift, ...] = ()

    def __post_init__(self):
        for name in ("slowdowns", "failures", "noise_bursts", "drifts"):
            object.__setattr__(self, name, tuple(getattr(self, name)))

    @property
    def has_drift(self) -> bool:
        return bool(self.drifts)

    def instance_perturb(self, t: int, P: int) -> Optional[InstancePerturb]:
        """Resolve the execution-side perturbation active at step ``t`` for
        a P-PE machine; ``None`` when nothing is active (the common case —
        callers then take the untouched clean path)."""
        scale: Optional[np.ndarray] = None
        for ev in self.slowdowns:
            if _active(ev.t0, ev.t1, t):
                if scale is None:
                    scale = np.ones(P)
                for p in ev.pes:
                    scale[p % P] *= ev.factor
        for ev in self.failures:
            if _active(ev.t0, ev.t1, t):
                if scale is None:
                    scale = np.ones(P)
                for p in ev.pes:
                    scale[p % P] *= FAILED_PE_FACTOR
        ss = 1.0
        for ev in self.noise_bursts:
            if _active(ev.t0, ev.t1, t):
                ss *= ev.factor
        if scale is None and ss == 1.0:
            return None
        return InstancePerturb(
            pe_scale=None if scale is None else tuple(scale),
            sigma_scale=ss)

    def loops(self, app, t: int) -> List:
        """The app's loop profiles at step ``t`` under any active drift."""
        shift = sum(d.phase_shift for d in self.drifts
                    if d.kind == "phase" and t >= d.t0)
        loops = app.loops(t + shift)
        transforms = [d for d in self.drifts
                      if d.kind in ("N", "cov") and t >= d.t0]
        for d in transforms:
            loops = [_drift_profile(p, d) for p in loops]
        return loops


# ---------------------------------------------------------------------------
# convenience builders (the bench / CI scenarios)
# ---------------------------------------------------------------------------

def pe_slowdown_spec(P: int, frac: float = 0.2, factor: float = 8.0,
                     t0: int = 0, t1: Optional[int] = None
                     ) -> PerturbationSpec:
    """The canonical scenario: the last ``frac`` of the machine's PEs run
    ``factor``x slower from step ``t0`` on."""
    k = max(1, int(round(P * frac)))
    return PerturbationSpec(slowdowns=(
        PESlowdown(pes=tuple(range(P - k, P)), factor=factor, t0=t0, t1=t1),))


def noise_burst_spec(factor: float = 6.0, t0: int = 0,
                     t1: Optional[int] = None) -> PerturbationSpec:
    return PerturbationSpec(noise_bursts=(NoiseBurst(factor=factor, t0=t0,
                                                     t1=t1),))


def drift_spec(kind: str, t0: int = 0, factor: float = 1.0,
               phase_shift: int = 0) -> PerturbationSpec:
    return PerturbationSpec(drifts=(WorkloadDrift(kind=kind, t0=t0,
                                                  factor=factor,
                                                  phase_shift=phase_shift),))


# ---------------------------------------------------------------------------
# fleet-level perturbations (serving layer)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GroupSlowdown:
    """Replica group ``group`` serves ``factor``x slower for wall-clock
    ``t0 <= now < t1`` (seconds, half-open; ``t1=None`` = until the end)."""

    group: int
    factor: float
    t0: float = 0.0
    t1: Optional[float] = None


@dataclass(frozen=True)
class ReplicaFailure:
    """Replicas of ``group`` drop out for wall-clock ``t0 <= now < t1``
    (seconds, half-open; ``t1=None`` = never rejoin).  ``replicas=None``
    means the WHOLE group fails — the only failure shape that interrupts
    in-flight work (sub-shard attribution does not exist at wave
    granularity); a partial replica set is masked out of future dispatch
    and pricing from ``t0`` on."""

    group: int
    t0: float = 0.0
    t1: Optional[float] = None
    replicas: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.replicas is not None:
            object.__setattr__(self, "replicas",
                               tuple(int(r) for r in self.replicas))


@dataclass(frozen=True)
class ReplicaStraggler:
    """Replicas of ``group`` serve ``factor``x slower for wall-clock
    ``t0 <= now < t1`` (``replicas=None`` = every replica — then equivalent
    to :class:`GroupSlowdown`, but applied per replica inside the dispatch
    loop instead of through the group cost model)."""

    group: int
    factor: float
    t0: float = 0.0
    t1: Optional[float] = None
    replicas: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.replicas is not None:
            object.__setattr__(self, "replicas",
                               tuple(int(r) for r in self.replicas))


def _wall_active(ev, now: float) -> bool:
    return ev.t0 <= now and (ev.t1 is None or now < ev.t1)


@dataclass(frozen=True)
class FleetPerturb:
    """Time-windowed fleet perturbations for ``FleetSimulator``:
    group-level slowdowns (``events``), replica-level failures and
    stragglers."""

    events: Tuple[GroupSlowdown, ...] = ()
    failures: Tuple[ReplicaFailure, ...] = ()
    stragglers: Tuple[ReplicaStraggler, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))
        object.__setattr__(self, "failures", tuple(self.failures))
        object.__setattr__(self, "stragglers", tuple(self.stragglers))

    def slowdowns(self, now: float, G: int) -> np.ndarray:
        """(G,) multiplicative service-time slowdowns active at ``now``."""
        f = np.ones(G)
        for ev in self.events:
            if _wall_active(ev, now):
                f[ev.group % G] *= ev.factor
        return f

    @property
    def has_replica_events(self) -> bool:
        return bool(self.failures or self.stragglers)

    def replica_state(self, now: float, G: int, R: int
                      ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """``(alive, scale)`` — (G, R) dispatch-availability mask and
        service-time multipliers active at ``now``; ``None`` while no
        replica-level event is active (the clean path)."""
        alive: Optional[np.ndarray] = None
        scale: Optional[np.ndarray] = None
        for ev in self.failures:
            if _wall_active(ev, now):
                if alive is None:
                    alive = np.ones((G, R), dtype=bool)
                reps = range(R) if ev.replicas is None else ev.replicas
                for r in reps:
                    alive[ev.group % G, r % R] = False
        for ev in self.stragglers:
            if _wall_active(ev, now):
                if scale is None:
                    scale = np.ones((G, R))
                reps = range(R) if ev.replicas is None else ev.replicas
                for r in reps:
                    scale[ev.group % G, r % R] *= ev.factor
        if alive is None and scale is None:
            return None
        return (np.ones((G, R), dtype=bool) if alive is None else alive,
                np.ones((G, R)) if scale is None else scale)

    def failure_start(self, g: int, G: int, R: int, lo: float, hi: float
                      ) -> Optional[Tuple[float, float]]:
        """Earliest WHOLE-group failure on group ``g`` starting strictly
        inside ``(lo, hi)`` — the event that interrupts a shard dispatched
        at ``lo`` predicted to drain at ``hi``.  Returns ``(t0, t1)`` with
        ``t1 = inf`` for a permanent failure, or ``None``."""
        best: Optional[Tuple[float, float]] = None
        for ev in self.failures:
            if ev.group % G != g:
                continue
            if ev.replicas is not None and \
                    len({r % R for r in ev.replicas}) < R:
                continue
            if lo < ev.t0 < hi:
                t1 = np.inf if ev.t1 is None else float(ev.t1)
                if best is None or ev.t0 < best[0]:
                    best = (float(ev.t0), t1)
        return best

    def next_change(self, now: float) -> Optional[float]:
        """Earliest event boundary strictly after ``now`` — the instant the
        fleet's availability/capacity next changes.  The run loop advances
        here when every group is unroutable, so a fully-failed fleet waits
        out the window instead of livelocking."""
        bounds = []
        for ev in (*self.events, *self.failures, *self.stragglers):
            bounds.append(ev.t0)
            if ev.t1 is not None:
                bounds.append(ev.t1)
        future = [b for b in bounds if b > now]
        return min(future) if future else None
