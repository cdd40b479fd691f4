"""Batched PyTorch simulation backend — campaign-scale sweeps as a handful of
device calls; the counterpart of ``repro.sim.backends.jax_batched``.

Where the reference engine steps one Python event loop per instance, this
backend evaluates *whole batches* of instances — (algorithm x chunk-mode x
rep x time-step) — at once:

1.  Chunk schedules come from ``repro_torch.core.sched`` (non-adaptive
    algorithms exactly; AWF-*/mAF via their telemetry-free surrogate
    recurrences; StaticSteal via the quantum-serving replay that yields
    explicit (start, size, pe) triples), cached by (alg, N, P, chunk_param)
    — one schedule serves every rep and time-step (LRU-bounded).
2.  The lanes are packed host-side into power-of-two K buckets (rows padded
    to a power of two, at most ``_MAX_ELEMS`` elements per (B, K) array)
    and copied to the device.  There the shared precompute draws each lane's
    jitter, PE speeds and per-chunk noise from its threefry stream
    (``repro_torch.sim.rng``, keyed by the lane's fold seed only).
3.  The sequential event core is the fused CUDA kernel
    (``repro_torch.kernels.event_loop.event_finish_fused``): grid-row cost
    interpolation, locality/noise scaling and the argmin assignment
    recurrence in one pass.  On the CPU the same wrapper runs its plain
    version.  ``event_core="plain"`` runs the plain versions on any device;
    it exists so that a run on the card can hold the whole path against
    them, and is never chosen on its own.

Heterogeneous machines (``SystemModel.pe_speeds``) and injected
perturbations (``InstancePerturb``) enter as two more lanes of the shared
precompute: per-PE execution-time multipliers ``pe_mult`` (B, P) applied to
the drawn speeds after their clamp, and a per-lane noise-sigma scale.  Both
are exactly 1.0 on clean lanes, so those stay bit-identical.  Under a
non-uniform PE scale the adaptive algorithms (AWF-B/C/D/E, mAF) take their
weighted schedules (``weighted_adaptive_schedule``), whose every chunk is
forced to the PE that requests it (``REPRO_ADAPTIVE_REWEIGHT=0`` keeps the
unweighted recurrences).

STATIC and over-``EVENT_CAP`` SS/StaticSteal instances are delegated to the
reference closed forms with the *same* numpy rng streams, so those results
are bit-identical to the reference.  Serving what-ifs gather their per-chunk
request costs from the float64 host prefix (exact integer indexing) before
the float32 device recurrence (``event_finish``).

Dispatch is double-buffered (``async_dispatch=`` / ``REPRO_ASYNC_DISPATCH``,
default on): ``_run_events`` keeps exactly one dispatch in flight, packing
dispatch t+1 on the host while the card runs t and draining t once t+1 is
enqueued.  On a card each dispatch packs fresh host arrays, stages them in
pinned memory, copies them in and its results out with ``non_blocking``
copies, and records one CUDA event a device; the drain waits on those
events, and only then reads the dispatch's CUDA-event timers.  A what-if
call (``_finish_rows``) is one dispatch, so it stays synchronous.

Lanes split over the campaign mesh (``data_parallel=`` /
``REPRO_DATA_PARALLEL``, default every card; ``devices=`` names the list,
such as ``[torch.device("cpu")] * 8`` for a test): the lane axis of every
dispatch — ``run_batch`` / ``run_lockstep`` instances and what-if candidate
rows — is padded with ``count == 0`` rows to a multiple of the device count
(``distributed.sharding.pad_lanes``), each device runs one contiguous shard
on its current stream, and the shards are gathered in lane order with the
padding sliced off.  Lanes never interact, so the results are bit-identical
at every device count.  One device is one shard: the same path.  The split
above one card is held only with CPU device lists here; the H100 machine
this port is measured on has one card.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import OrderedDict
from dataclasses import dataclass, fields
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ...core.metrics import xla_row_mean
from ...core.portfolio import ADAPTIVE_SET
from ...core.sched import (chunk_schedule, staticsteal_schedule,
                           weighted_adaptive_schedule)
from ...device import resolve_device
from ...distributed.sharding import pad_lanes, shard_bounds
from ...launch.mesh import campaign_mesh, local_devices
from ...kernels.event_loop import (event_finish, event_finish_fused,
                                   event_finish_fused_ref, event_finish_ref)
from .. import rng
from ..workloads import profile_digest as _profile_digest
from ..workloads import stack_prefix_grids
from .base import (BatchResult, InstancePerturb, InstanceSpec,
                   LockstepRequest, SimBackend, combined_pe_scale,
                   needs_closed_form, sigma_scale_of)
from .closed_form import InstanceResult, _h_eff, run_closed_form

#: schedule-length buckets (powers of four bound the number of distinct
#: shapes); the last bucket must exceed EVENT_CAP plus StaticSteal's
#: steal-split slack
_K_BUCKETS = (256, 1024, 4096, 16384, 65536, 262144)
#: max elements per (B, K) device array in one call (~16 MB float32)
_MAX_ELEMS = 1 << 22

EVENT_CORES = ("kernel", "plain")
#: env var naming the event core when ``event_core=None``; the reference's
#: names map onto the port's: ``auto``/``kernel``/``pallas`` -> ``"kernel"``,
#: ``plain``/``while_loop`` -> ``"plain"``
EVENT_CORE_ENV = "REPRO_EVENT_CORE"
_EVENT_CORE_NAMES = {"auto": "kernel", "kernel": "kernel", "pallas": "kernel",
                     "plain": "plain", "while_loop": "plain"}
#: env var toggling the weighted adaptive schedules under perturbed /
#: heterogeneous PE speeds ("0" keeps the weights-at-1 recurrences)
ADAPTIVE_REWEIGHT_ENV = "REPRO_ADAPTIVE_REWEIGHT"
#: env var clamping the campaign mesh's data axis (lanes split over it);
#: unset means every device of the mesh, 1 runs every lane on one device
DATA_PARALLEL_ENV = "REPRO_DATA_PARALLEL"
#: env var toggling double-buffered async dispatch ("0" restores the
#: synchronous pack -> dispatch -> drain loop)
ASYNC_DISPATCH_ENV = "REPRO_ASYNC_DISPATCH"


def resolve_event_core(event_core: Optional[str] = None) -> str:
    """The event core: ``event_core`` when given (``"kernel"`` or
    ``"plain"``), else ``REPRO_EVENT_CORE`` mapped by name, else
    ``"kernel"``; any other name raises ``ValueError``."""
    if event_core is not None:
        if event_core not in EVENT_CORES:
            raise ValueError(f"unknown event core {event_core!r}; "
                             f"available: {list(EVENT_CORES)}")
        return event_core
    env = os.environ.get(EVENT_CORE_ENV)
    if env is None:
        return "kernel"
    name = _EVENT_CORE_NAMES.get(env.lower())
    if name is None:
        raise ValueError(f"unknown event core {env!r} in {EVENT_CORE_ENV}; "
                         f"available: {sorted(_EVENT_CORE_NAMES)}")
    return name


def resolve_adaptive_reweight(adaptive_reweight: Optional[bool] = None
                              ) -> bool:
    if adaptive_reweight is None:
        return os.environ.get(ADAPTIVE_REWEIGHT_ENV, "1") != "0"
    return bool(adaptive_reweight)


def resolve_data_parallel(data_parallel: Optional[int] = None,
                          devices: Optional[Sequence] = None) -> int:
    """The campaign mesh's data extent: ``data_parallel`` when given, else
    ``REPRO_DATA_PARALLEL``, else every device of ``devices`` (default:
    every card; raises without one).  Always clamped to that count."""
    n = len(local_devices(devices))
    if data_parallel is None:
        env = os.environ.get(DATA_PARALLEL_ENV)
        data_parallel = int(env) if env else n
    if data_parallel < 1:
        raise ValueError(f"data_parallel must be >= 1, got {data_parallel}")
    return min(data_parallel, n)


def resolve_async_dispatch(async_dispatch: Optional[bool] = None) -> bool:
    if async_dispatch is None:
        return os.environ.get(ASYNC_DISPATCH_ENV, "1") != "0"
    return bool(async_dispatch)


def _next_bucket(n: int) -> int:
    for b in _K_BUCKETS:
        if n <= b:
            return b
    raise ValueError(f"schedule length {n} exceeds largest bucket")


def _pow2_rows(n: int) -> int:
    b = 8
    while b < n:
        b *= 2
    return b


class _LRU:
    """Tiny LRU mapping bounding the backend's caches (schedules, steal
    replays, device-resident grid stacks)."""

    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self._d: OrderedDict = OrderedDict()

    def get(self, key, default=None):
        try:
            self._d.move_to_end(key)
            return self._d[key]
        except KeyError:
            return default

    def put(self, key, value) -> None:
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.maxsize:
            self._d.popitem(last=False)

    def __len__(self) -> int:
        return len(self._d)


@dataclass
class PathTimes:
    """Where a backend's time went, summed over its calls: host seconds on
    the host clock; device milliseconds from CUDA events (0 on the CPU).

    In ``_run_events`` (sweeps, replays, pricing) ``launch_s`` is the host
    enqueuing a dispatch's copies, draws, core and copies back, and
    ``device_s`` the host's wait in its drain — under async dispatch the
    wait left after the packing of the next dispatch overlapped the card;
    their sum is the whole device call of a synchronous dispatch.  A
    what-if call is synchronous and its ``device_s`` is the whole call."""

    closed_s: float = 0.0     # STATIC / over-cap closed forms (host numpy)
    rows_s: float = 0.0       # schedules + per-lane rows (host)
    pack_s: float = 0.0       # ragged-to-padded packing (host)
    launch_s: float = 0.0     # enqueuing a dispatch's copies and launches
    device_s: float = 0.0     # waiting for the card (see above)
    h2d_ms: float = 0.0       # the packed lanes' copies to the card
    draws_ms: float = 0.0     # threefry jitter / speed / noise draws
    core_ms: float = 0.0      # the event-core calls
    dispatches: int = 0
    lockstep_s: float = 0.0   # host clock around whole run_lockstep calls
    lockstep_calls: int = 0

    def reset(self) -> None:
        for f in fields(self):
            setattr(self, f.name, type(getattr(self, f.name))())


class TorchBatchedBackend(SimBackend):
    """Campaign-scale batched engine (see module docstring).

    ``device`` defaults to ``cuda`` and raises when there is no card; pass
    ``device="cpu"`` for the plain CPU path.  ``event_core`` is ``"kernel"``
    (the wrappers: CUDA kernels on a card, plain versions on the CPU) or
    ``"plain"`` (the plain versions on any device); ``None`` resolves
    ``REPRO_EVENT_CORE``.  ``adaptive_reweight`` (``None`` resolves
    ``REPRO_ADAPTIVE_REWEIGHT``, default on) gives the adaptive algorithms
    their weighted schedules under non-uniform PE speeds.

    ``devices`` lists the devices lanes may split over (default: every card
    when ``device`` is the card, else ``[device]``; ``device`` defaults to
    its first); ``data_parallel`` (``None`` resolves
    ``REPRO_DATA_PARALLEL``) takes the first that many of them as the
    campaign mesh.  ``async_dispatch`` (``None`` resolves
    ``REPRO_ASYNC_DISPATCH``, default on) double-buffers the dispatch loop.
    """

    name = "torch"

    def __init__(self, device: Union[str, torch.device, None] = None,
                 event_core: Optional[str] = None,
                 adaptive_reweight: Optional[bool] = None,
                 data_parallel: Optional[int] = None,
                 async_dispatch: Optional[bool] = None,
                 devices: Optional[Sequence] = None):
        event_core = resolve_event_core(event_core)
        if devices is not None:
            devices = local_devices(devices)
            self.device = (devices[0] if device is None
                           else resolve_device(device))
        else:
            self.device = resolve_device(device)
            devices = (local_devices() if self.device.type == "cuda"
                       else [self.device])
        if len({d.type for d in devices}) > 1:
            raise ValueError(f"devices of one type only, got {devices}")
        self.event_core = event_core
        if event_core != "kernel":
            self.name = f"torch-{event_core}"
        self.data_parallel = resolve_data_parallel(data_parallel, devices)
        #: the devices lanes split over, one contiguous shard each
        self.mesh = campaign_mesh(self.data_parallel, devices)
        self.async_dispatch = resolve_async_dispatch(async_dispatch)
        self.adaptive_reweight = resolve_adaptive_reweight(adaptive_reweight)
        # (alg, N, P, cp) -> sizes ndarray, for central-queue algorithms
        self._sched_cache = _LRU(512)
        # StaticSteal replays keyed additionally by the cost/locality params
        self._steal_cache = _LRU(128)
        # (alg, N, P, cp, locality, machine[, loop costs][, weights]) ->
        # event rows; weighted schedules live only here, under their weights
        self._rows_cache = _LRU(512)
        # (profile-stack digest, device) -> padded (Sp, G+1) grids there
        self._grids_cache = _LRU(4 * len(self.mesh))
        self.times = PathTimes()
        #: CUDA-event timers recorded since the last dispatch was enqueued
        self._timers: List[tuple] = []
        self._timed = self.mesh[0].type == "cuda"
        #: when a list, every event-core call appends (core name, arguments)
        #: — a run on the card uses it to time the kernels at the path's
        #: own shapes; None records nothing
        self.core_calls: Optional[list] = None

    # ---- schedule precompute ---------------------------------------------

    def _central_schedule(self, alg: int, N: int, P: int, cp: int,
                          cache: bool = True) -> np.ndarray:
        key = (alg, N, P, cp)
        hit = self._sched_cache.get(key)
        if hit is not None:
            return hit
        sizes, count = chunk_schedule(alg, N, P, cp,
                                      max_chunks=_K_BUCKETS[-1])
        sizes = sizes[:count].astype(np.int64)
        if sizes.sum() != N:
            raise RuntimeError(
                f"schedule truncated: alg={alg} N={N} P={P} cp={cp}")
        if cache:
            self._sched_cache.put(key, sizes)
        return sizes

    def _steal_schedule(self, N: int, P: int, cp: int, profile, system,
                        cache: bool = True):
        unit = profile.total / N
        key = (N, P, cp, round(unit, 18), round(profile.locality_sens, 6),
               profile.c_loc, round(profile.memory_bound, 6), system.name)
        hit = self._steal_cache.get(key)
        if hit is not None:
            return hit
        ls = profile.locality_sens
        starts, sizes, pes, own, count = staticsteal_schedule(
            N, P, cp, max_chunks=_K_BUCKETS[-1], unit=unit, h=system.h,
            bcost=profile.memory_bound * system.boundary_cost,
            base_infl=1.0 + ls * system.dyn_locality,
            amp=ls * system.loc_amp, c_loc=float(profile.c_loc))
        if sizes[:count].sum(dtype=np.int64) != N:
            raise RuntimeError(f"steal schedule truncated: N={N} P={P}")
        out = (starts[:count], sizes[:count], pes[:count], own[:count])
        if cache:
            self._steal_cache.put(key, out)
        return out

    def _weights(self, alg: int, system, scale) -> Optional[np.ndarray]:
        """The mean-1 inverse-speed weights of an adaptive algorithm's
        weighted schedule under the lane's PE ``scale``, or None when the
        lane takes the unweighted one (not adaptive, reweighting off, or
        uniform PE speeds)."""
        if not (self.adaptive_reweight and alg in ADAPTIVE_SET):
            return None
        if scale is None or np.all(scale == 1.0):
            return None
        w = 1.0 / scale
        w *= system.P / w.sum()
        return w

    def _event_rows(self, spec: InstanceSpec, profile, system, scale):
        """(starts, sizes, loc, forced) numpy rows for one event instance
        whose PEs run at ``scale`` (``combined_pe_scale``; None = uniform),
        cached: every rep and time step of a loop shares them.  A weighted
        lane's key holds its weights, so it never poisons its clean twin."""
        N, P = profile.N, system.P
        ls, c_loc = profile.locality_sens, profile.c_loc
        key = (spec.alg, N, P, spec.chunk_param, ls, c_loc,
               system.dyn_locality, system.loc_amp)
        if spec.alg == 5:   # the replay also depends on the loop's costs
            key += (round(profile.total / N, 18),
                    round(profile.memory_bound, 6), system.name, system.h,
                    system.boundary_cost)
        w = self._weights(spec.alg, system, scale)
        if w is not None:   # the weighted schedule depends on the speeds
            key += (tuple(np.round(w, 9)),)
        hit = self._rows_cache.get(key)
        if hit is not None:
            return hit
        base_infl = 1.0 + ls * system.dyn_locality
        amp = ls * system.loc_amp
        if w is not None:
            sizes, pes = weighted_adaptive_schedule(spec.alg, N, P,
                                                    spec.chunk_param, w)
            starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(
                np.int32)
            loc = (base_infl + amp * c_loc / (sizes + c_loc)).astype(
                np.float32)
            rows = (starts, sizes.astype(np.int32), loc, pes)
        elif spec.alg == 5:
            starts, sizes, pes, own = self._steal_schedule(
                N, P, spec.chunk_param, profile, system)
            loc = np.where(own, 1.0,
                           base_infl + amp * c_loc / (sizes + c_loc))
            rows = (starts, sizes, loc.astype(np.float32), pes)
        else:
            sizes = self._central_schedule(spec.alg, N, P, spec.chunk_param)
            starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(
                np.int32)
            loc = (base_infl + amp * c_loc / (sizes + c_loc)).astype(
                np.float32)
            rows = (starts, sizes.astype(np.int32), loc, None)
        self._rows_cache.put(key, rows)
        return rows

    def _grids_dev(self, profiles, device: Optional[torch.device] = None
                   ) -> torch.Tensor:
        """The padded grid stack on ``device`` (default the backend's own),
        cached by profile content.

        The profile axis is padded to a power-of-two row bucket (padding
        rows are never gathered — grid_id only points at real profiles).
        Caching keys on per-profile content digests, so lockstep replays
        that rebuild equal ``LoopProfile`` objects every time step still hit
        the same upload."""
        device = self.device if device is None else device
        key = (tuple(_profile_digest(p) for p in profiles), str(device))
        hit = self._grids_cache.get(key)
        if hit is not None:
            return hit
        grids = stack_prefix_grids(profiles)
        Sp = _pow2_rows(len(profiles))
        if Sp > len(profiles):
            grids = np.vstack([grids, np.zeros((Sp - len(profiles),
                                                grids.shape[1]), np.float32)])
        dev = torch.from_numpy(grids).to(device)
        self._grids_cache.put(key, dev)
        return dev

    # ---- device calls -----------------------------------------------------

    @staticmethod
    def _on(device: torch.device):
        """Make ``device`` current for the enclosed calls (on a card: its
        current stream takes the copies, launches and events)."""
        if device.type == "cuda":
            return torch.cuda.device(device)
        return contextlib.nullcontext()

    @staticmethod
    def _stage(a: np.ndarray, device: torch.device, job: "_Dispatch"
               ) -> torch.Tensor:
        """A freshly packed host array on ``device``.  On a card it is
        copied into pinned memory and from there with a non-blocking copy
        (a pageable ``.to`` would block the host); ``job`` holds the pinned
        buffer until its drain, so nothing reuses it in flight."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type != "cuda":
            return t.to(device)
        t = t.pin_memory()
        job.keep.append(t)
        return t.to(device, non_blocking=True)

    @staticmethod
    def _fetch(t: torch.Tensor) -> torch.Tensor:
        """``t`` on the host: from a card a non-blocking copy into pinned
        memory, to be read only after the dispatch's event."""
        if t.device.type != "cuda":
            return t
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return out.copy_(t, non_blocking=True)

    @contextlib.contextmanager
    def _device_timer(self, field: str):
        """Bracket the enclosed calls with CUDA events for ``times.<field>``
        on the current device's stream; nothing waits here — the events go
        with their dispatch and are read at its drain."""
        if not self._timed:
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        stop.record()
        self._timers.append((field, start, stop))

    def _enqueued(self, job: "_Dispatch") -> None:
        """Close ``job`` once enqueued on every device: one event a device
        after its copies back, and the timers recorded since the last
        dispatch."""
        if self._timed:
            for dev in self.mesh:
                with self._on(dev):
                    ev = torch.cuda.Event()
                    ev.record()
                    job.events.append(ev)
        job.timers, self._timers = self._timers, []

    def _drain(self, job: "_Dispatch", n: int) -> List[np.ndarray]:
        """Wait for a dispatch: its outputs gathered in lane order with the
        padding sliced off; then, the card having passed them, its timers
        added to :attr:`times`."""
        t0 = time.perf_counter()
        for ev in job.events:
            ev.synchronize()
        for field, start, stop in job.timers:
            setattr(self.times, field,
                    getattr(self.times, field) + start.elapsed_time(stop))
        outs = [np.concatenate([o[i].numpy() for o in job.outs])[:n]
                for i in range(len(job.outs[0]))]
        self.times.device_s += time.perf_counter() - t0
        return outs

    def _core(self, fn, *args) -> torch.Tensor:
        if self.core_calls is not None:
            self.core_calls.append((fn.__name__, args))
        with self._device_timer("core_ms"):
            return fn(*args)

    def _batched_events(self, P: int, grids, gid, inv_n, starts, sizes, loc,
                        count, forced, seeds, h_eff, bcost, pe_mult,
                        noise_scale, jitter_max: float, speed_spread: float):
        """Shared precompute + one event-core call for one packed batch.

        ``pe_mult`` (B, P) f32 multiplies the drawn PE speeds after their
        clamp; ``noise_scale`` (B,) f32 is each lane's folded noise factor
        ``(sigma * sigma_scale) * sqrt(2)``.
        jitter_max/speed_spread are float32-representable scalars.
        Returns (makespan (B,), lib (B,), finish (B, P)) device tensors."""
        G = grids.shape[1] - 1
        K = starts.shape[1]
        with self._device_timer("draws_ms"):
            kj, ks, kn = rng.split(rng.prng_key(seeds), 3)
            # as the reference's compiled draws: each scale is folded into
            # sqrt(2) before it meets erf_inv(u); 1 + spread*normal is fused
            jitter = rng.uniform(kj, P) * jitter_max
            e_s = rng.erf_inv_uniform(ks, P)
            speed = torch.clamp(
                torch.addcmul(torch.ones_like(e_s), e_s, torch.full_like(
                    e_s, rng.folded_scale(speed_spread))), 0.8, 1.25)
            # heterogeneity / perturbation: all-1.0 rows are exact no-ops
            speed = speed * pe_mult
            noise = rng.exp(rng.erf_inv_uniform(kn, K)
                            * noise_scale[:, None])
        gscale = inv_n * float(G)
        core = (event_finish_fused_ref if self.event_core == "plain"
                else event_finish_fused)
        fin = self._core(core, grids, gid, gscale, starts, sizes, loc, noise,
                         speed, jitter, h_eff, bcost, forced, count)
        mk = fin.max(dim=1).values
        # the row mean in the reference's summation order: lib is bit-equal
        lib = torch.where(mk > 0.0, (1.0 - xla_row_mean(fin) / mk) * 100.0,
                          torch.zeros_like(mk))
        return mk, lib, fin

    def _finish_rows(self, R: int, eff: np.ndarray, count: np.ndarray,
                     forced: np.ndarray, avail: np.ndarray,
                     h: float) -> np.ndarray:
        """What-if core: unit speeds, busy offsets as jitter, ``h`` per
        chunk, no boundary cost; returns each row's makespan.  One
        dispatch, waited for at once (the call needs its answer); the rows
        split over the mesh, padded with ``count == 0`` rows."""
        t0 = time.perf_counter()
        A = eff.shape[0]
        Ap = pad_lanes(A, self.mesh)
        eff, count, forced, avail = (
            np.concatenate([a, np.full((Ap - A,) + a.shape[1:], fill,
                                       a.dtype)])
            for a, fill in ((eff, 0.0), (count, 0), (forced, -1),
                            (avail, 0.0)))
        core = (event_finish_ref if self.event_core == "plain"
                else event_finish)
        job = _Dispatch()
        for dev, (lo, hi) in zip(self.mesh, shard_bounds(Ap, self.mesh)):
            with self._on(dev):
                a = hi - lo
                fin = self._core(
                    core, self._stage(eff[lo:hi], dev, job),
                    torch.ones((a, R), dtype=torch.float32, device=dev),
                    self._stage(avail[lo:hi], dev, job),
                    torch.full((a,), h, dtype=torch.float32, device=dev),
                    torch.zeros(a, dtype=torch.float32, device=dev),
                    self._stage(forced[lo:hi], dev, job),
                    self._stage(count[lo:hi], dev, job))
                job.outs.append([self._fetch(fin.max(dim=1).values)])
        self._enqueued(job)
        self.times.device_s += time.perf_counter() - t0
        out, = self._drain(job, A)
        self.times.dispatches += 1
        return out

    # ---- batch execution --------------------------------------------------

    def run_batch(self, profiles: Sequence, system,
                  specs: Sequence[InstanceSpec]) -> BatchResult:
        B = len(specs)
        lt = np.zeros(B)
        lib = np.zeros(B)
        nc = np.zeros(B, np.int64)
        event_ids: List[int] = []
        for i, s in enumerate(specs):
            profile = profiles[s.profile_id]
            if s.alg == 0 or needs_closed_form(s.alg, profile.N,
                                               s.chunk_param):
                t0 = time.perf_counter()
                r = run_closed_form(profile, system, s.alg, s.chunk_param,
                                    np.random.default_rng(s.seed),
                                    perturb=s.perturb)
                lt[i], lib[i], nc[i] = r.loop_time, r.lib, r.n_chunks
                self.times.closed_s += time.perf_counter() - t0
            else:
                event_ids.append(i)
        if event_ids:
            mks, libs, _, counts = self._run_events(
                profiles, system, [specs[i] for i in event_ids])
            lt[event_ids], lib[event_ids], nc[event_ids] = mks, libs, counts
        return BatchResult(loop_time=lt, lib=lib, n_chunks=nc)

    def _run_events(self, profiles, system, specs):
        """Evaluate event-loop instances; returns (mk, lib, finish, count)
        arrays in spec order."""
        P = system.P
        t0 = time.perf_counter()
        grids = [self._grids_dev(profiles, dev) for dev in self.mesh]
        scales = [combined_pe_scale(system, s.perturb) for s in specs]
        rows = [self._event_rows(s, profiles[s.profile_id], system, sc)
                for s, sc in zip(specs, scales)]
        counts = np.array([len(r[1]) for r in rows], np.int32)
        B = len(specs)
        mk = np.zeros(B)
        lb = np.zeros(B)
        fin = np.zeros((B, P))

        # per-spec scalar lanes (gathered per bucket below)
        gid_all = np.fromiter((s.profile_id for s in specs), np.int32, B)
        inv_all = np.fromiter((1.0 / profiles[s.profile_id].N
                               for s in specs), np.float32, B)
        seed_all = np.fromiter((s.fold_seed() for s in specs), np.int64, B)
        h_all = np.fromiter((_h_eff(system, s.alg) for s in specs),
                            np.float32, B)
        bc_all = np.fromiter(
            (profiles[s.profile_id].memory_bound * system.boundary_cost
             for s in specs), np.float32, B)
        # perturbation lanes: per-PE multipliers and noise scales (exactly
        # 1.0 and the machine's own folded sigma on clean lanes)
        pm_all = np.ones((B, P), np.float32)
        ss_all = np.ones(B, np.float32)
        for i, (s, sc) in enumerate(zip(specs, scales)):
            if sc is not None:
                pm_all[i] = sc
            ss_all[i] = sigma_scale_of(s.perturb)
        # each lane's factor of erf_inv(u) in its noise exponent, in the
        # reference's compiled order: (sigma * sigma_scale) * sqrt(2), each
        # product rounded to float32 (folded_scale(sigma) on clean lanes)
        ns_all = rng.folded_scales(np.float32(system.noise_sigma) * ss_all)
        by_bucket: Dict[int, List[int]] = {}
        for i, c in enumerate(counts):
            by_bucket.setdefault(_next_bucket(int(c)), []).append(i)
        self.times.rows_s += time.perf_counter() - t0

        scalars = tuple(float(np.float32(x)) for x in (
            system.jitter, system.speed_spread))

        def packed():
            """Host-side ragged-to-padded assembly, one yielded batch per
            dispatch: fresh arrays each time, so the async loop below packs
            batch t+1 while the card runs batch t."""
            for K, ids in sorted(by_bucket.items()):
                # a device's row budget: the mesh holds shards x _MAX_ELEMS
                max_rows = max(8, (_MAX_ELEMS // K) * len(self.mesh))
                for off in range(0, len(ids), max_rows):
                    t0 = time.perf_counter()
                    sub = np.asarray(ids[off:off + max_rows])
                    n = len(sub)
                    Bp = pad_lanes(_pow2_rows(n), self.mesh)
                    # ragged-to-padded: one boolean scatter per field
                    lens = counts[sub]
                    mask = (np.arange(K, dtype=np.int32)[None, :]
                            < lens[:, None])
                    starts = np.zeros((Bp, K), np.int32)
                    sizes = np.zeros((Bp, K), np.int32)
                    loc = np.zeros((Bp, K), np.float32)
                    forced = np.full((Bp, K), -1, np.int32)
                    starts[:n][mask] = np.concatenate(
                        [rows[i][0] for i in sub])
                    sizes[:n][mask] = np.concatenate(
                        [rows[i][1] for i in sub])
                    loc[:n][mask] = np.concatenate([rows[i][2] for i in sub])
                    forced[:n][mask] = np.concatenate(
                        [rows[i][3] if rows[i][3] is not None
                         else np.full(lens[j], -1, np.int32)
                         for j, i in enumerate(sub)])
                    cols = []
                    for arr, fill, dt in ((gid_all, 0, np.int32),
                                          (inv_all, 1.0, np.float32),
                                          (counts, 0, np.int32),
                                          (seed_all, 0, np.int64),
                                          (h_all, 0.0, np.float32),
                                          (bc_all, 0.0, np.float32),
                                          (pm_all, 1.0, np.float32),
                                          (ns_all, 0.0, np.float32)):
                        col = np.full((Bp,) + arr.shape[1:], fill, dt)
                        col[:n] = arr[sub]
                        cols.append(col)
                    gid, inv_n, cnt, seeds, h_eff, bcost, pe_mult, nscale = \
                        cols
                    self.times.pack_s += time.perf_counter() - t0
                    yield sub, (gid, inv_n, starts, sizes, loc, cnt, forced,
                                seeds, h_eff, bcost, pe_mult, nscale)

        def drain(sub, job):
            mk[sub], lb[sub], fin[sub] = self._drain(job, len(sub))

        # double-buffered dispatch: exactly one dispatch in flight, so the
        # packing of batch t+1 (host numpy) overlaps the card running batch
        # t; t is drained once t+1 is enqueued
        pending = None
        for sub, lanes in packed():
            job = (sub, self._dispatch(P, grids, lanes, scalars))
            if not self.async_dispatch:
                drain(*job)
                continue
            if pending is not None:
                drain(*pending)
            pending = job
        if pending is not None:
            drain(*pending)
        return mk, lb, fin, counts

    def _dispatch(self, P: int, grids, lanes, scalars) -> "_Dispatch":
        """Enqueue one packed batch: each device's contiguous shard is staged,
        drawn, run and copied back on its current stream; nothing waits."""
        t0 = time.perf_counter()
        job = _Dispatch()
        bounds = shard_bounds(len(lanes[0]), self.mesh)
        for dev, g, (lo, hi) in zip(self.mesh, grids, bounds):
            with self._on(dev):
                with self._device_timer("h2d_ms"):
                    dev_lanes = [self._stage(a[lo:hi], dev, job)
                                 for a in lanes]
                res = self._batched_events(P, g, *dev_lanes, *scalars)
                job.outs.append([self._fetch(x) for x in res])
        self._enqueued(job)
        self.times.launch_s += time.perf_counter() - t0
        self.times.dispatches += 1
        return job

    def run_lockstep(self, profiles: Sequence, system,
                     requests: Sequence[LockstepRequest]) -> BatchResult:
        """One lockstep replay step as a single batched device call.

        Per request the lane rng is consumed exactly like the sequential
        ``run_instance`` path would at the same stream position: STATIC and
        over-cap SS/StaticSteal instances run the reference closed forms on
        the lane rng directly, every event-loop instance draws one integer
        as its stateless fold seed.  All event instances across all lanes
        then execute as one ``_run_events`` batch — results equal
        sequential replays because each lane's noise depends only on its
        fold seed, never on batch order or size.
        """
        t_call = time.perf_counter()
        B = len(requests)
        lt = np.zeros(B)
        lib = np.zeros(B)
        nc = np.zeros(B, np.int64)
        event_ids: List[int] = []
        specs: List[InstanceSpec] = []
        for i, q in enumerate(requests):
            profile = profiles[q.profile_id]
            if q.alg == 0 or needs_closed_form(q.alg, profile.N,
                                               q.chunk_param):
                t0 = time.perf_counter()
                r = run_closed_form(profile, system, q.alg, q.chunk_param,
                                    q.rng, perturb=q.perturb)
                lt[i], lib[i], nc[i] = r.loop_time, r.lib, r.n_chunks
                self.times.closed_s += time.perf_counter() - t0
            else:
                seed = (int(q.rng.integers(0, 2**31 - 1)),)
                specs.append(InstanceSpec(profile_id=q.profile_id, alg=q.alg,
                                          chunk_param=q.chunk_param,
                                          seed=seed, perturb=q.perturb))
                event_ids.append(i)
        if specs:
            mks, libs, _, counts = self._run_events(profiles, system, specs)
            lt[event_ids], lib[event_ids], nc[event_ids] = mks, libs, counts
        self.times.lockstep_s += time.perf_counter() - t_call
        self.times.lockstep_calls += 1
        return BatchResult(loop_time=lt, lib=lib, n_chunks=nc)

    # ---- single instance (selector path) ----------------------------------

    def run_instance(self, profile, system, alg: int, chunk_param: int,
                     rng, record_chunks: bool = False,
                     perturb: Optional[InstancePerturb] = None
                     ) -> InstanceResult:
        if alg == 0 or needs_closed_form(alg, profile.N, chunk_param):
            return run_closed_form(profile, system, alg, chunk_param, rng,
                                   record_chunks, perturb)
        # stateless fold seed drawn from the caller's stream so repeated
        # calls stay reproducible AND distinct
        seed = (int(rng.integers(0, 2**31 - 1)),)
        spec = InstanceSpec(profile_id=0, alg=alg, chunk_param=chunk_param,
                            seed=seed, perturb=perturb)
        mk, lib, fin, counts = self._run_events([profile], system, [spec])
        sizes = None
        if record_chunks:
            _, sz, _, _ = self._event_rows(
                spec, profile, system, combined_pe_scale(system, perturb))
            sizes = [int(c) for c in sz]
        res = InstanceResult(loop_time=float(mk[0]), finish=fin[0],
                             n_chunks=int(counts[0]), chunk_sizes=sizes)
        # the batch's float32 lib, as run_batch and run_lockstep report it
        # (InstanceResult would recompute it in float64 from ``finish``), so
        # a sequential selector replay equals the lockstep one bit for bit
        res.lib = float(lib[0])
        return res

    # ---- serving what-if ---------------------------------------------------

    def _what_if_schedule(self, N: int, R: int, alg: int, cp: int,
                          prefix: np.ndarray, cache: bool):
        """(starts int64, sizes int32, forced or None) of one what-if
        candidate over N requests on R replicas."""
        t0 = time.perf_counter()
        if alg == 5:
            # steal cache keys include the per-wave unit cost, so it would
            # never hit — skip it
            unit = float(prefix[-1] - prefix[0]) / max(N, 1)
            st, sz, pes, _ = self._steal_schedule(
                N, R, cp, _UniformStub(N, unit), _NoLocStub(), cache=False)
            out = st.astype(np.int64), sz, pes
        else:
            sz = self._central_schedule(alg, N, R, cp, cache=cache)
            st = np.concatenate([[0], np.cumsum(sz)[:-1]])
            out = st, sz.astype(np.int32), None
        self.times.rows_s += time.perf_counter() - t0
        return out

    def _static_closed(self, prefix, avail, R: int, fixed: float) -> float:
        t0 = time.perf_counter()
        N = len(prefix) - 1
        bounds = np.linspace(0, N, R + 1).round().astype(int)
        free = np.asarray(avail, dtype=np.float64).copy()
        nonempty = np.diff(bounds) > 0
        free[:R] += np.diff(prefix[bounds]) + fixed * nonempty
        self.times.closed_s += time.perf_counter() - t0
        return float(free.max())

    def _price_rows(self, R: int, rows, h: float) -> np.ndarray:
        """One device call over (prefix, avail, starts, sizes, forced)
        candidate rows; per-chunk costs gathered from the float64 prefix
        host-side (exact integer indexing), so the float32 rounding happens
        on the small per-chunk values, not on the large cumulative totals.
        Schedule slots are padded to a power-of-two bucket."""
        t0 = time.perf_counter()
        K = _pow2_rows(max(len(r[3]) for r in rows))
        A = len(rows)
        eff = np.zeros((A, K), np.float32)
        forced = np.full((A, K), -1, np.int32)
        cnt = np.zeros(A, np.int32)
        av = np.zeros((A, R), np.float32)
        for j, (prefix, avail, st, sz, pes) in enumerate(rows):
            n = len(sz)
            eff[j, :n] = prefix[st + sz] - prefix[st]
            cnt[j] = n
            av[j] = avail
            if pes is not None:
                forced[j, :n] = pes
        self.times.pack_s += time.perf_counter() - t0
        return self._finish_rows(R, eff, cnt, forced, av,
                                 float(np.float32(h)))

    def what_if_wave(self, prefix: np.ndarray, n_replicas: int,
                     init_avail: np.ndarray, h: float, fixed: float,
                     algs: Sequence[int], chunk_param: int = 0
                     ) -> np.ndarray:
        N = len(prefix) - 1
        R = n_replicas
        out = np.zeros(len(algs))
        prefix = np.asarray(prefix, dtype=np.float64)
        ks: List[int] = []
        rows = []
        for k, alg in enumerate(algs):
            if alg == 0 and chunk_param <= 0:
                out[k] = self._static_closed(prefix, init_avail, R, fixed)
                continue
            # cache=False: wave sizes and mean costs drift per dispatch, so
            # online what-ifs would fill the caches with never-reused entries
            st, sz, pes = self._what_if_schedule(N, R, alg, chunk_param,
                                                 prefix, cache=False)
            ks.append(k)
            rows.append((prefix, init_avail, st, sz, pes))
        if rows:
            out[ks] = self._price_rows(R, rows, h + fixed)
        return out

    def what_if_routes(self, prefixes: Sequence[np.ndarray],
                       n_replicas: int,
                       init_avails: Sequence[np.ndarray], h: float,
                       fixed: float,
                       cands: Sequence[Tuple[int, int, int]]) -> np.ndarray:
        """Every (slot, alg, chunk) candidate row of a fleet routing
        decision in ONE device call — the rows differ in busy-state as well
        as schedule, so each carries its own (R,) offset vector.  STATIC
        default-chunk rows take the float64 closed form host-side, exactly
        like :meth:`what_if_wave`."""
        R = n_replicas
        prefixes = [np.asarray(p, dtype=np.float64) for p in prefixes]
        avails = [np.asarray(a, dtype=np.float64) for a in init_avails]
        out = np.zeros(len(cands))
        ids: List[int] = []
        rows = []
        for i, (slot, alg, cp) in enumerate(cands):
            prefix = prefixes[slot]
            N = len(prefix) - 1
            if N <= 0:
                out[i] = avails[slot].max() if len(avails[slot]) else 0.0
                continue
            if alg == 0 and cp <= 0:
                out[i] = self._static_closed(prefix, avails[slot], R, fixed)
                continue
            # cache=True (unlike what_if_wave): a saturated fleet dispatches
            # quota-sized shards wave after wave, so the (alg, N, P, cp)
            # keys DO repeat; the LRU bound caps the drifting-size tail
            st, sz, pes = self._what_if_schedule(N, R, alg, cp, prefix,
                                                 cache=True)
            ids.append(i)
            rows.append((prefix, avails[slot], st, sz, pes))
        if rows:
            out[ids] = self._price_rows(R, rows, h + fixed)
        return out


class _Dispatch:
    """One enqueued dispatch: each device's outputs (host tensors, pinned on
    a card), one CUDA event a device, the pinned inputs held until the
    drain, and the dispatch's CUDA-event timers."""

    def __init__(self):
        self.outs: List[list] = []
        self.events: List[torch.cuda.Event] = []
        self.keep: List[torch.Tensor] = []
        self.timers: List[tuple] = []


class _UniformStub:
    """Minimal profile stand-in for serving what-if StaticSteal replays."""

    def __init__(self, N, unit):
        self.N, self.unit = N, unit
        self.total = N * unit
        self.locality_sens = 0.0
        self.c_loc = 64
        self.memory_bound = 0.0


class _NoLocStub:
    name = "wave"
    h = 0.0
    boundary_cost = 0.0
    dyn_locality = 0.0
    loc_amp = 0.0
