"""Simulation-backend protocol: the contract every DES engine of the port
implements — the port's own copy of ``repro.sim.backends.base``.

A backend evaluates loop instances — one at a time (``run_instance``, the
selector path) or as a whole batch (``run_batch``, the campaign path) — and
what-if dispatch waves for the serving layer (``what_if_wave``).  The
campaign and the benchmarks only ever talk to this surface, so engines are
interchangeable.  The batched torch engine keeps its *sequential event core*
behind a ``(eff_costs, forced, count) -> finish`` contract: a plain torch
loop and a hand-written CUDA kernel that must match it bit for bit.

``EVENT_CAP`` is the *shared* event budget: SS / StaticSteal switch to the
analytic closed form when one instance would exceed it, so the cutover point
is identical everywhere (the paper's STREAM blowup is always computed
analytically, never stepped).
"""

from __future__ import annotations

import abc
import zlib
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

#: Max dispatch events one instance may generate before SS/StaticSteal go
#: analytic (the reference's value).
EVENT_CAP = 120_000


def needs_closed_form(alg: int, N: int, chunk_param: int,
                      cap: int = EVENT_CAP) -> bool:
    """True when a constant-chunk algorithm (SS/StaticSteal) would blow the
    event budget and must be evaluated with the analytic closed form."""
    if alg not in (1, 5):
        return False
    c_floor = max(1, chunk_param)
    return N / c_floor > cap


@dataclass(frozen=True)
class InstancePerturb:
    """Per-instance view of an injected perturbation (``repro_torch.sim.
    perturb`` resolves a time-windowed :class:`PerturbationSpec` into one of
    these per time step).

    ``pe_scale`` multiplies each PE's execution time (1.0 nominal, > 1
    slower, ~1e4 models a failed PE the dynamic algorithms must route
    around); ``sigma_scale`` multiplies the machine's lognormal noise sigma
    (bursty noise).  ``None`` / 1.0 are exact no-ops: both backends apply
    the multipliers as IEEE ``x * 1.0`` identities without consuming any
    extra rng draws, so a neutral perturbation is bit-equal to no
    perturbation at all (test-enforced).
    """

    pe_scale: Optional[Tuple[float, ...]] = None
    sigma_scale: float = 1.0

    def __post_init__(self):
        if self.pe_scale is not None:
            object.__setattr__(self, "pe_scale",
                               tuple(float(x) for x in self.pe_scale))
        object.__setattr__(self, "sigma_scale", float(self.sigma_scale))

    @property
    def neutral(self) -> bool:
        return self.sigma_scale == 1.0 and (
            self.pe_scale is None
            or all(x == 1.0 for x in self.pe_scale))

    def key(self) -> Tuple:
        """Hashable cache-key component (pricing caches must not alias a
        perturbed run with a clean one)."""
        return (self.pe_scale, self.sigma_scale)


def combined_pe_scale(system, perturb: Optional[InstancePerturb]
                      ) -> Optional[np.ndarray]:
    """Per-PE execution-time multipliers: the machine model's persistent
    heterogeneity (``SystemModel.pe_speeds``) composed with any instance
    perturbation.  ``None`` means exactly uniform — callers skip the
    multiply entirely, keeping clean runs bit-identical."""
    speeds = getattr(system, "pe_speeds", None)
    out = None if speeds is None else np.asarray(speeds, np.float64)
    if perturb is not None and perturb.pe_scale is not None:
        ps = np.asarray(perturb.pe_scale, np.float64)
        out = ps if out is None else out * ps
    return out


def sigma_scale_of(perturb: Optional[InstancePerturb]) -> float:
    return 1.0 if perturb is None else perturb.sigma_scale


@dataclass(frozen=True)
class InstanceSpec:
    """One loop instance inside a batch: which profile, which algorithm,
    which chunk parameter, and the full rng seed tuple (the campaign's
    crc32-label convention).  ``fold_seed`` collapses the tuple into one
    stateless uint32 for the counter-based threefry streams.

    ``perturb`` is deliberately excluded from ``fold_seed``: a perturbed
    instance keeps the exact noise stream of its clean twin, so enabling a
    perturbation never shifts any other lane's (or its own) draws.
    """

    profile_id: int
    alg: int
    chunk_param: int
    seed: Tuple[int, ...]
    perturb: Optional[InstancePerturb] = None

    def fold_seed(self) -> int:
        return zlib.crc32(np.asarray(self.seed, dtype=np.int64).tobytes())


@dataclass
class BatchResult:
    """Per-instance outputs in spec order."""

    loop_time: np.ndarray      # (B,)
    lib: np.ndarray            # (B,)
    n_chunks: np.ndarray       # (B,) int


@dataclass
class LockstepRequest:
    """One lane's loop instance inside a lockstep replay step.

    Unlike :class:`InstanceSpec` (stateless seed tuples), a lockstep request
    carries the lane's *live* numpy Generator: selector replays are
    sequential across time steps, and every instance must consume the lane's
    noise stream exactly where the historical per-cell loop would have — the
    Python backend stays bit-identical to ``run_selector``'s sequential
    replay, and the batched backend draws its stateless fold seed from the
    same stream position its ``run_instance`` path would.
    """

    profile_id: int
    alg: int
    chunk_param: int
    rng: np.random.Generator
    perturb: Optional[InstancePerturb] = None


class SimBackend(abc.ABC):
    """Protocol for pluggable simulation engines."""

    name: str = "base"
    event_cap: int = EVENT_CAP

    @abc.abstractmethod
    def run_instance(self, profile, system, alg: int, chunk_param: int,
                     rng, record_chunks: bool = False,
                     perturb: Optional[InstancePerturb] = None):
        """Simulate one loop instance; returns an ``InstanceResult``."""

    @abc.abstractmethod
    def run_batch(self, profiles: Sequence, system,
                  specs: Sequence[InstanceSpec]) -> BatchResult:
        """Evaluate a batch of instances over a shared profile set."""

    def run_lockstep(self, profiles: Sequence, system,
                     requests: Sequence["LockstepRequest"]) -> BatchResult:
        """Execute one lockstep replay step: every lane's loop instance for
        the current time step, each drawing from its own lane rng.

        Lane rng streams MUST be consumed in request order (lanes are
        independent generators, so only the *within-lane* order is
        observable).  This base implementation steps ``run_instance``
        sequentially — bit-identical to the historical per-cell replay loop;
        batched engines override it to fan the event-loop instances into one
        device call while preserving each lane's stream position.
        """
        B = len(requests)
        lt = np.zeros(B)
        lib = np.zeros(B)
        nc = np.zeros(B, np.int64)
        for i, q in enumerate(requests):
            r = self.run_instance(profiles[q.profile_id], system, q.alg,
                                  q.chunk_param, q.rng, perturb=q.perturb)
            lt[i], lib[i], nc[i] = r.loop_time, r.lib, r.n_chunks
        return BatchResult(loop_time=lt, lib=lib, n_chunks=nc)

    @abc.abstractmethod
    def what_if_wave(self, prefix: np.ndarray, n_replicas: int,
                     init_avail: np.ndarray, h: float, fixed: float,
                     algs: Sequence[int], chunk_param: int = 0
                     ) -> np.ndarray:
        """Predicted wave makespan for each candidate algorithm.

        ``prefix``: (N+1,) cumulative request cost (token cost model);
        ``init_avail``: (R,) current replica busy-offsets; ``h`` the
        dispatch overhead per self-assigned chunk; ``fixed`` the cost
        model's per-batch constant (paid by every chunk, including
        STATIC's pre-assigned ranges, which skip ``h``).  Returns one
        makespan per entry of ``algs`` — the serving policy's batched
        what-if query (SimAS-style online consultation).
        """

    def what_if_routes(self, prefixes: Sequence[np.ndarray],
                       n_replicas: int,
                       init_avails: Sequence[np.ndarray], h: float,
                       fixed: float,
                       cands: Sequence[Tuple[int, int, int]]) -> np.ndarray:
        """Fleet-batched what-if: candidates span (routing slot, algorithm,
        chunk parameter).

        A *slot* is one replica group handed one candidate request shard:
        ``prefixes[s]`` is that shard's (N_s+1,) cumulative cost prefix and
        ``init_avails[s]`` the group's (R,) busy offsets at dispatch time.
        ``cands`` rows are ``(slot, alg, chunk_param)``; the return value is
        one predicted makespan per row — what the fleet router consumes to
        price candidate (replica-group, algorithm, chunk) assignments in a
        single consultation per admission wave.

        This base implementation fans out over :meth:`what_if_wave` (one
        call per distinct (slot, chunk) pair); batched engines override it
        to evaluate every candidate row in one device call.
        """
        out = np.zeros(len(cands))
        groups: dict = {}
        for i, (slot, alg, cp) in enumerate(cands):
            groups.setdefault((int(slot), int(cp)), []).append((i, int(alg)))
        for (slot, cp), rows in groups.items():
            mk = self.what_if_wave(prefixes[slot], n_replicas,
                                   init_avails[slot], h, fixed,
                                   [a for _, a in rows], chunk_param=cp)
            for (i, _), m in zip(rows, mk):
                out[i] = m
        return out
