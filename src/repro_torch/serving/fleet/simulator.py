"""Fleet-scale serving simulator: replica groups behind a router — the
port's copy of ``repro.serving.fleet.simulator``.

``FleetSimulator`` composes the port's four layers into one region:

- **data** — an :class:`~repro_torch.serving.fleet.traces.ArrivalTrace`
  drives asynchronous admissions (Poisson / bursty / diurnal);
- **serving** — each replica group is a
  :class:`~repro_torch.serving.engine.DispatchSimulator`
  (chunk-self-scheduled continuous-batching waves over R replicas);
- **sim backends** — routing decisions are priced through the backends'
  batched ``what_if_routes`` (one call per admission wave);
- **core policies** — every group owns a per-region
  :class:`~repro_torch.core.service.SelectionService` region
  (``region{g}``), so SimPolicy/SimHybrid/QLearn state is group-local and
  warm-start snapshots (``store_dir``) round-trip per group.

Time model: the fleet clock advances wave-by-wave.  Each iteration admits
up to the controller's budget from the pending queue, routes the admitted
batch, and dispatches every shard on its group with the group's *absolute*
per-replica finish times converted to the dispatcher's relative busy
offsets (idle time between waves really elapses).  While a backlog remains
the next wave opens when the earliest replica anywhere frees — the
continuous-batching refill trigger.  A request's latency is its group's
wave-drain time minus its arrival (wave granularity, matching the per-wave
LIB/makespan the selection layer observes).

Fault tolerance (see :mod:`repro_torch.serving.fleet.recovery`):
wall-clock :class:`~repro_torch.sim.perturb.ReplicaFailure` /
``ReplicaStraggler`` events in ``perturb`` mask replicas out of dispatch
and degrade per-group capacity; a whole-group failure interrupts in-flight
shards, whose requests the
:class:`~repro_torch.serving.fleet.recovery.RecoveryPolicy` retries with
capped backoff, optionally hedges, and re-routes (migrates) through the
ordinary router pricing path.  With ``recovery=None`` the baseline physics
still hold — interrupted work replays on its own group when it rejoins —
but routing stays blind to failures.  Every admitted request is completed
exactly once or explicitly dead-lettered (ledger-checked).

Crash safety: pass ``journal=RunJournal(dir)`` and ``run`` snapshots its
full state atomically at wave granularity; ``run(..., resume=True)`` on a
fresh simulator restores the newest snapshot and finishes bit-identically
to an uninterrupted run (see :mod:`repro_torch.serving.fleet.journal`).

``run`` is single-shot: it mutates group busy-state and region policies,
so a second call on the same simulator raises — build a fresh one (resume
does exactly that around a journal).
"""

from __future__ import annotations

import heapq
import json
import os
import zlib
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ...core import percent_load_imbalance
from ...data.pipeline import Request
from ...sim.backends import get_backend
from ...sim.perturb import FleetPerturb
from ..engine import DispatchSimulator, ReplicaCostModel, WaveStats
from .journal import RunJournal
from .recovery import BASELINE_RECOVERY, RecoveryLedger, RecoveryPolicy
from .router import RouterPolicy, make_router, request_cost
from .traces import ArrivalTrace


@dataclass
class FleetView:
    """Dispatch-time snapshot handed to routers and admission control."""

    now: float
    busy: List[np.ndarray]          # per-group (R,) offsets relative to now
    n_replicas: int
    cost: ReplicaCostModel
    h: float                        # per-chunk dispatch overhead
    backend: object = None          # SimBackend for what-if pricing
    #: (G,) relative service-rate capacity per group (1.0 nominal, < 1 for
    #: a slowed group); None = homogeneous — routers and admission control
    #: then take their exact historical paths
    capacity: Optional[np.ndarray] = None
    #: (G,) routability mask under a failure-aware view (None = every
    #: group accepts work — the exact historical path)
    routable: Optional[np.ndarray] = None

    def cost_prefix(self, requests: Sequence[Request]) -> np.ndarray:
        """(N+1,) cumulative service-cost prefix of a request shard (the
        same token cost model ``DispatchSimulator`` dispatches under)."""
        tokens = np.array([r.prompt_len + r.gen_len for r in requests],
                          dtype=np.float64)
        return (self.cost.per_token
                * np.concatenate([[0.0], np.cumsum(tokens)])
                + self.cost.per_request * np.arange(len(tokens) + 1))

    def price_routes(self, prefixes, avails, cands) -> np.ndarray:
        """One batched (slot, algorithm, chunk) pricing call — the fleet's
        SimAS-style consultation."""
        return self.backend.what_if_routes(prefixes, self.n_replicas,
                                           avails, self.h, self.cost.fixed,
                                           cands)


@dataclass
class AdmissionControl:
    """Deadlock-free backpressure: shapes (never fully stalls) each wave.

    - ``wave_quota`` — per-group admission cap per wave (decision
      granularity);
    - ``batch_window`` — wave-formation window in seconds: an underloaded
      fleet waits up to this long past the oldest pending arrival for the
      wave to fill before dispatching (in the saturated regime the window
      has already elapsed, so waves go out full and immediately);
    - ``queue_depth`` — per-replica outstanding-work bound in seconds: a
      wave may not push any further work once the fleet-wide outstanding
      budget ``queue_depth * replicas`` is full (queue-depth backpressure);
    - ``p95_slo`` — predicted-p95 backpressure: while the oldest pending
      wait plus the predicted service horizon of the admitted batch exceeds
      the SLO, the wave is halved (down to ``min_admit``, so the queue
      always drains).
    """

    wave_quota: int = 256
    batch_window: float = 0.05
    queue_depth: float = float("inf")
    p95_slo: Optional[float] = None
    min_admit: int = 8

    def admit(self, pending: Sequence[Request], now: float,
              view: FleetView) -> int:
        if not pending:
            return 0
        G = len(view.busy)
        R = view.n_replicas
        k = min(len(pending), self.wave_quota * G)
        head_costs = np.array([request_cost(r, view.cost)
                               for r in list(pending)[:k]])
        mean_cost = float(head_costs.mean()) if len(head_costs) else 0.0
        outstanding = float(sum(b.sum() for b in view.busy))
        if np.isfinite(self.queue_depth):
            budget = max(0.0, self.queue_depth * G * R - outstanding)
            k = min(k, int(budget / max(mean_cost, 1e-12)))
        if self.p95_slo is not None and k > self.min_admit:
            oldest = now - pending[0].arrival
            busy_p95 = float(np.percentile(np.concatenate(view.busy), 95))
            # aggregate service rate in replica-equivalents: on a skewed
            # fleet a slowed group drains fewer requests per second, so the
            # horizon must weight by per-group capacity (uniform capacity
            # reduces to the historical G * R exactly)
            cap = view.capacity if view.capacity is not None else np.ones(G)
            rate = max(float(cap.sum()) * R, 1e-9)
            while k > self.min_admit:
                pred = oldest + busy_p95 \
                    + float(head_costs[:k].sum()) / rate
                if pred <= self.p95_slo:
                    break
                k //= 2
        if outstanding <= 0.0:
            # idle-fleet floor only: with work still outstanding, a k the
            # backpressure terms drove to 0 must STAY 0 — re-admitting
            # min_admit here defeated queue-depth backpressure entirely
            k = max(k, min(self.min_admit, len(pending)))
        return max(k, 0)


@dataclass
class FleetReport:
    """Fleet-level outcome of one trace run."""

    n_requests: int
    makespan: float                 # last drain time minus first arrival
    throughput: float               # completed requests / makespan
    p50: float
    p95: float
    p99: float
    mean_latency: float
    fleet_lib: float                # Eq. 8 LIB over all fleet replicas
    mean_wave_lib: float            # mean per-wave LIB across group waves
    waves: int
    mean_wave_size: float
    deferred: int                   # pending-request-waves held back
    per_group: List[Dict] = field(default_factory=list)
    latencies: Optional[np.ndarray] = None
    #: fault-recovery accounting (completed / dead-lettered / retries /
    #: hedges / migrations); None on a fault-free run
    recovery: Optional[Dict] = None

    def summary(self) -> Dict:
        out = {k: (round(v, 6) if isinstance(v, float) else v)
               for k, v in self.__dict__.items()
               if k not in ("per_group", "latencies")}
        if out.get("recovery") is None:
            out.pop("recovery", None)   # fault-free summaries stay as-is
        return out


def _trace_signature(trace, reqs: List[Request]) -> str:
    """Stable digest of the request stream — the journal's guard against
    resuming one trace's snapshot under a different trace."""
    if isinstance(trace, ArrivalTrace):
        return trace.signature
    head = reqs[:64]
    ident = json.dumps([len(reqs),
                        [(r.rid, r.prompt_len, r.gen_len, round(r.arrival, 9))
                         for r in head]])
    return f"list-{zlib.crc32(ident.encode('utf-8')):08x}"


class _RunState:
    """Every mutable datum of one fleet run — exactly what the journal
    snapshots and what resume restores."""

    def __init__(self, G: int, R: int, n: int, reqs: List[Request],
                 fault_mode: bool):
        self.now = 0.0
        self.i = 0                      # trace cursor (admitted watermark)
        self.waves = 0
        self.admitted = 0
        self.deferred = 0
        self.t0 = reqs[0].arrival if reqs else 0.0
        self.finish = np.zeros((G, R))  # absolute replica finishes
        self.busy_tot = np.zeros((G, R))  # accumulated work seconds
        self.lats: List[np.ndarray] = []
        self.pending: deque = deque()
        # fault state (inert on the clean path)
        self.retryq: List[Tuple[float, int, int, int, int]] = []  # heap
        self.seq = 0                    # retry FIFO tiebreaker
        self.completed = np.zeros(n, dtype=bool) if fault_mode else None
        self.ledger = RecoveryLedger()
        self.retry_from: Dict[int, int] = {}   # rid -> group it failed on
        self.retry_pin: Dict[int, int] = {}    # rid -> pinned group
        self.resets: List[Tuple[float, int]] = []  # (t_star, group) pending

    def push_retry(self, ready: float, rid: int, attempt: int,
                   pin: Optional[int]) -> None:
        heapq.heappush(self.retryq,
                       (float(ready), self.seq, int(rid), int(attempt),
                        -1 if pin is None else int(pin)))
        self.seq += 1


class FleetSimulator:
    """N ``DispatchSimulator`` replica groups behind a pluggable router.

    ``backend`` (a name or a ``SimBackend``) prices the router's and the
    groups' what-if calls; ``None`` resolves ``get_backend(None)``, the
    batched engine on the card, and raises when there is none."""

    def __init__(self, n_groups: int = 4, replicas_per_group: int = 8,
                 router: Union[str, RouterPolicy, None] = "whatif",
                 selector: Optional[str] = None, reward: str = "LT",
                 chunk_param: int = 0, seed: int = 0,
                 cost_model: Optional[ReplicaCostModel] = None,
                 dispatch_overhead: float = 0.2e-3,
                 backend: Optional[str] = None,
                 admission: Optional[AdmissionControl] = None,
                 store_dir: Optional[str] = None,
                 selector_kw: Optional[dict] = None,
                 group_slowdown: Optional[Sequence[float]] = None,
                 perturb: Optional[FleetPerturb] = None,
                 recovery: Optional[RecoveryPolicy] = None):
        self.G = n_groups
        self.R = replicas_per_group
        self.cost = cost_model or ReplicaCostModel()
        self.h = dispatch_overhead
        self.router = make_router(router)
        self.admission = admission or AdmissionControl()
        self.backend = get_backend(backend)
        self.store_dir = store_dir
        self.seed = seed
        # persistent per-group service-time slowdowns (heterogeneous fleet)
        # composed with time-windowed FleetPerturb events per wave
        self.group_slowdown = None if group_slowdown is None else \
            np.asarray(group_slowdown, np.float64)
        if self.group_slowdown is not None and \
                len(self.group_slowdown) != self.G:
            raise ValueError(
                f"group_slowdown has {len(self.group_slowdown)} entries "
                f"for {self.G} groups")
        self.perturb = perturb
        self.recovery = recovery
        self._cost_scale = np.ones(self.G)
        self._ran = False
        kw = dict(selector_kw or {})
        if store_dir is not None:
            os.makedirs(store_dir, exist_ok=True)
            kw.setdefault("store_dir", store_dir)
        # one region per group: distinct warm-start keys AND decorrelated
        # policy rng streams from the same base seed
        self.groups = [
            DispatchSimulator(replicas_per_group, selector=selector,
                              reward=reward, chunk_param=chunk_param,
                              seed=seed, cost_model=self.cost,
                              dispatch_overhead=dispatch_overhead,
                              selector_kw=dict(kw), backend=backend,
                              region=f"region{g}")
            for g in range(n_groups)]

    # -- warm-start round-trip ----------------------------------------------
    def save_state(self) -> List[str]:
        """Persist every group's region policy (requires ``store_dir``);
        a fresh fleet on the same store_dir warm-starts each region."""
        paths: List[str] = []
        for sim in self.groups:
            if sim.service.store_dir is not None and sim.service.regions:
                paths.extend(sim.service.save())
        return paths

    def warm_started(self) -> List[bool]:
        return [sim.service.warm_started(sim.region) for sim in self.groups]

    # -- simulation ----------------------------------------------------------
    def _slowdowns(self, now: float) -> Optional[np.ndarray]:
        """(G,) service-time slowdowns active at ``now``; None when the
        fleet is exactly homogeneous (the bit-identical clean path)."""
        f = self.group_slowdown
        if self.perturb is not None:
            p = self.perturb.slowdowns(now, self.G)
            f = p if f is None else f * p
        if f is None or bool(np.all(f == 1.0)):
            return None
        return f

    def _apply_slowdowns(self, f: Optional[np.ndarray]) -> None:
        """Rescale each group's dispatch cost model to the slowdowns active
        this wave (no-op — object-identical cost models — while uniform)."""
        want = np.ones(self.G) if f is None else f
        for g, sim in enumerate(self.groups):
            if want[g] == self._cost_scale[g]:
                continue
            s = float(want[g])
            sim.cost = self.cost if s == 1.0 else ReplicaCostModel(
                fixed=self.cost.fixed * s,
                per_token=self.cost.per_token * s,
                per_request=self.cost.per_request * s)
            self._cost_scale[g] = s

    def _view(self, now: float, finish: np.ndarray,
              f: Optional[np.ndarray] = None) -> FleetView:
        busy = [np.maximum(finish[g] - now, 0.0) for g in range(self.G)]
        return FleetView(now=now, busy=busy, n_replicas=self.R,
                         cost=self.cost, h=self.h, backend=self.backend,
                         capacity=None if f is None else 1.0 / f)

    def _fault_view(self, now: float, finish: np.ndarray,
                    f: Optional[np.ndarray],
                    rep: Optional[Tuple[np.ndarray, np.ndarray]],
                    visible: bool) -> FleetView:
        """The wave's view under the fault model: a failure-aware (visible)
        view folds dead/straggling replicas into per-group capacity and a
        routable mask; a blind view is exactly the historical one."""
        if rep is None or not visible:
            return self._view(now, finish, f)
        alive, scale = rep
        eff = (alive / scale).mean(axis=1)      # (G,) service-rate fraction
        base = np.ones(self.G) if f is None else 1.0 / f
        view = self._view(now, finish, f)
        view.capacity = base * eff
        view.routable = alive.any(axis=1)
        return view

    # -- fault helpers -------------------------------------------------------
    def _interrupt_group(self, st: _RunState, g: int, t_star: float) -> None:
        """Register the lazy whole-group reset at ``t_star`` (replicas stop
        there; in-flight beyond it is void)."""
        if (t_star, g) not in st.resets:
            st.resets.append((t_star, g))

    def _apply_resets(self, st: _RunState) -> None:
        """Apply pending group resets the clock has reached: replicas of an
        interrupted group stop at the failure instant — the voided tail of
        their schedule is refunded from finish and busy accounting."""
        due = [(t, g) for (t, g) in st.resets if t <= st.now]
        for (t, g) in sorted(due):
            over = np.maximum(st.finish[g] - t, 0.0)
            st.finish[g] -= over
            st.busy_tot[g] = np.maximum(st.busy_tot[g] - over, 0.0)
        st.resets = [x for x in st.resets if x not in due]

    def _schedule_retry(self, st: _RunState, rec: RecoveryPolicy, rid: int,
                        group: int, t_fail: float, kind: str) -> None:
        """Void request ``rid``'s service on ``group`` at ``t_fail`` and
        either queue its retry (backoff; pinned when migration is off) or
        dead-letter it once the budget is spent."""
        a = st.ledger.attempt_of(rid) + 1
        if rec.exhausted(a):
            st.ledger.attempts[rid] = a
            st.ledger.dead_letter(rid, "max_retries")
            st.retry_from.pop(rid, None)
            return
        st.ledger.record_retry(rid)
        if kind == "interrupt":
            st.ledger.interrupted += 1
        elif kind == "timeout":
            st.ledger.timeouts += 1
        st.retry_from[rid] = group
        pin = group if not rec.migrate else None
        st.push_retry(t_fail + rec.backoff(rid, a, self.seed), rid, a, pin)

    def _merge_ready_retries(self, st: _RunState, reqs: List[Request],
                             rid_index: Dict[int, int]) -> None:
        """Move every retry whose backoff elapsed to the FRONT of the
        pending queue (they are the oldest work), FIFO by (ready, seq)."""
        ready: List[Tuple[float, int, int, int, int]] = []
        while st.retryq and st.retryq[0][0] <= st.now:
            ready.append(heapq.heappop(st.retryq))
        for (_rdy, _seq, rid, _a, pin) in reversed(ready):
            if pin >= 0:
                st.retry_pin[rid] = pin
            st.pending.appendleft(reqs[rid_index[rid]])

    def _next_fault_event(self, st: _RunState) -> Optional[float]:
        """Earliest instant after ``now`` at which anything can change:
        a replica frees, a retry becomes ready, a pending group reset
        lands, or a perturbation window opens/closes."""
        cands: List[float] = []
        future = st.finish[st.finish > st.now]
        if future.size:
            cands.append(float(future.min()))
        if st.retryq:
            cands.append(max(st.retryq[0][0], np.nextafter(st.now, np.inf)))
        cands.extend(t for (t, _g) in st.resets if t > st.now)
        if self.perturb is not None:
            nc = self.perturb.next_change(st.now)
            if nc is not None:
                cands.append(nc)
        return min(cands) if cands else None

    def _shed(self, st: _RunState, rec: RecoveryPolicy) -> None:
        """Graceful degradation: dead-letter pending requests that already
        waited past ``shed_wait`` (deterministic head-of-queue scan)."""
        if rec.shed_wait is None:
            return
        while st.pending and \
                st.now - st.pending[0].arrival > rec.shed_wait:
            r = st.pending.popleft()
            st.ledger.dead_letter(r.rid, "shed")
            st.ledger.shed += 1
            st.retry_from.pop(r.rid, None)
            st.retry_pin.pop(r.rid, None)

    def _hedge_plan(self, st: _RunState, rec: RecoveryPolicy, r: Request,
                    g: int, f: Optional[np.ndarray],
                    rep: Optional[Tuple[np.ndarray, np.ndarray]]
                    ) -> Optional[Tuple[int, int, float, float]]:
        """Price a single-request hedge duplicate on the best group other
        than ``g``: returns ``(group, replica, service, done)`` or None.
        The hedge itself is voided if its group fails before it drains."""
        best = None
        slow = np.ones(self.G) if f is None else f
        for h in range(self.G):
            if h == g:
                continue
            alive = None if rep is None else rep[0][h]
            if alive is not None and not alive.any():
                continue
            fin = st.finish[h] if alive is None else st.finish[h][alive]
            ranks = np.arange(self.R) if alive is None \
                else np.flatnonzero(alive)
            k = int(np.argmin(fin))
            rr = int(ranks[k])
            scale = 1.0 if rep is None else float(rep[1][h, rr])
            service = (self.cost.fixed + request_cost(r, self.cost)) \
                * float(slow[h]) * scale
            start = max(float(st.finish[h, rr]), st.now)
            done = start + service
            if self.perturb is not None and \
                    self.perturb.failure_start(h, self.G, self.R,
                                               st.now, done) is not None:
                continue                # hedge would be interrupted too
            if best is None or done < best[3]:
                best = (h, rr, service, done)
        return best

    # -- journaling ----------------------------------------------------------
    def _snapshot(self, journal: RunJournal, st: _RunState, sig: str,
                  fault_mode: bool) -> None:
        meta = {
            "sig": sig, "G": self.G, "R": self.R, "seed": self.seed,
            "router": self.router.name,
            "router_state": self.router.state_dict(),
            "fault_mode": bool(fault_mode),
            "now": st.now, "i": st.i, "waves": st.waves,
            "admitted": st.admitted, "deferred": st.deferred, "t0": st.t0,
            "seq": st.seq,
            "resets": [[float(t), int(g)] for (t, g) in st.resets],
            "retry_from": {str(k): int(v)
                           for k, v in st.retry_from.items()},
            "retry_pin": {str(k): int(v) for k, v in st.retry_pin.items()},
            "attempts": {str(k): int(v)
                         for k, v in st.ledger.attempts.items()},
            "dead": {str(k): v for k, v in st.ledger.dead.items()},
            "counters": {k: getattr(st.ledger, k) for k in
                         ("retries", "interrupted", "timeouts", "migrated",
                          "hedges", "hedge_wins", "shed")},
            "policies": self._policy_states(),
        }
        retry = np.array(sorted(st.retryq), dtype=np.float64).reshape(-1, 5)
        arrays = {
            "finish": st.finish, "busy_tot": st.busy_tot,
            "lat_data": (np.concatenate(st.lats) if st.lats
                         else np.empty(0)),
            "lat_lens": np.array([len(a) for a in st.lats], dtype=np.int64),
            "pending": np.array([r.rid for r in st.pending],
                                dtype=np.int64),
            "retry": retry,
            "completed": (np.packbits(st.completed)
                          if st.completed is not None
                          else np.empty(0, dtype=np.uint8)),
            "stats_i": np.array(
                [[s.wave, s.algorithm, s.n_requests, s.chunks]
                 for sim in self.groups for s in sim.stats],
                dtype=np.int64).reshape(-1, 4),
            "stats_f": np.array(
                [[s.makespan, s.lib]
                 for sim in self.groups for s in sim.stats],
                dtype=np.float64).reshape(-1, 2),
            "stats_lens": np.array([len(sim.stats) for sim in self.groups],
                                   dtype=np.int64),
        }
        journal.save(st.waves, meta, arrays)

    def _policy_states(self) -> List[Dict]:
        out = []
        for sim in self.groups:
            rec = sim.service._regions.get(sim.region)
            if rec is None:
                out.append({})
                continue
            state = rec.policy.state_dict()
            out.append({"method": rec.policy.name, "state": state,
                        "instances": rec.instances})
        return out

    def _restore(self, snap: Dict, st: _RunState, sig: str, n: int,
                 fault_mode: bool) -> None:
        meta = snap["meta"]
        if meta["sig"] != sig:
            raise ValueError(
                f"journal snapshot was taken for trace {meta['sig']}, "
                f"cannot resume trace {sig}")
        if meta["G"] != self.G or meta["R"] != self.R:
            raise ValueError(
                f"journal fleet shape ({meta['G']}x{meta['R']}) does not "
                f"match this fleet ({self.G}x{self.R})")
        if meta["router"] != self.router.name:
            raise ValueError(
                f"journal was written under router {meta['router']!r}, "
                f"this fleet runs {self.router.name!r}")
        self.router.load_state_dict(meta.get("router_state", {}))
        st.now = float(meta["now"])
        st.i = int(meta["i"])
        st.waves = int(meta["waves"])
        st.admitted = int(meta["admitted"])
        st.deferred = int(meta["deferred"])
        st.t0 = float(meta["t0"])
        st.seq = int(meta["seq"])
        st.finish = np.array(snap["finish"], dtype=np.float64)
        st.busy_tot = np.array(snap["busy_tot"], dtype=np.float64)
        lat_data = np.asarray(snap["lat_data"], dtype=np.float64)
        st.lats = list(np.split(lat_data,
                                np.cumsum(snap["lat_lens"])[:-1])) \
            if len(snap["lat_lens"]) else []
        st.resets = [(float(t), int(g)) for t, g in meta.get("resets", [])]
        st.retry_from = {int(k): int(v)
                         for k, v in meta.get("retry_from", {}).items()}
        st.retry_pin = {int(k): int(v)
                        for k, v in meta.get("retry_pin", {}).items()}
        st.retryq = [(float(r[0]), int(r[1]), int(r[2]), int(r[3]),
                      int(r[4])) for r in snap["retry"]]
        heapq.heapify(st.retryq)
        if fault_mode:
            packed = np.asarray(snap["completed"], dtype=np.uint8)
            st.completed = np.unpackbits(packed, count=n).astype(bool) \
                if packed.size else np.zeros(n, dtype=bool)
        st.ledger.attempts = {int(k): int(v)
                              for k, v in meta.get("attempts", {}).items()}
        st.ledger.dead = {int(k): str(v)
                          for k, v in meta.get("dead", {}).items()}
        for k, v in meta.get("counters", {}).items():
            setattr(st.ledger, k, int(v))
        # per-group wave stats + region policy state
        lens = np.asarray(snap["stats_lens"], dtype=np.int64)
        si, sf = snap["stats_i"], snap["stats_f"]
        off = 0
        for g, sim in enumerate(self.groups):
            w = int(lens[g])
            sim.stats = [
                WaveStats(wave=int(si[off + j, 0]),
                          algorithm=int(si[off + j, 1]),
                          n_requests=int(si[off + j, 2]),
                          makespan=float(sf[off + j, 0]),
                          lib=float(sf[off + j, 1]),
                          chunks=int(si[off + j, 3]))
                for j in range(w)]
            off += w
        for sim, pol in zip(self.groups, meta.get("policies", [])):
            if not pol:
                continue
            rec = sim.service._record(sim.region)
            if pol.get("state") is not None and \
                    pol.get("method") == rec.policy.name:
                try:
                    rec.policy.load_state_dict(pol["state"])
                except (KeyError, ValueError, TypeError):
                    pass                # stateless-compatible policies
            rec.instances = int(pol.get("instances", 0))

    # -- the run loop --------------------------------------------------------
    def run(self, trace: Union[ArrivalTrace, Sequence[Request]],
            keep_latencies: bool = False,
            journal: Optional[RunJournal] = None,
            resume: bool = False) -> FleetReport:
        if self._ran:
            raise RuntimeError(
                "FleetSimulator.run is single-shot: a run mutates group "
                "busy-state and region policies — build a fresh "
                "FleetSimulator per run (resume=True restores a journal "
                "into a fresh instance)")
        self._ran = True
        reqs = trace.requests if isinstance(trace, ArrivalTrace) \
            else list(trace)
        n = len(reqs)
        sig = _trace_signature(trace, reqs)
        rec_pol = self.recovery
        fault_mode = rec_pol is not None or (
            self.perturb is not None and self.perturb.has_replica_events)
        if rec_pol is None:
            rec_pol = BASELINE_RECOVERY
        rid_index = {r.rid: j for j, r in enumerate(reqs)} if fault_mode \
            else None

        st = _RunState(self.G, self.R, n, reqs, fault_mode)
        if resume:
            if journal is None:
                raise ValueError("resume=True needs a journal")
            snap = journal.latest()
            if snap is None:
                raise ValueError(f"no journal snapshot under {journal.dir}")
            self._restore(snap, st, sig, n, fault_mode)

        quota = self.admission.wave_quota * self.G
        window = self.admission.batch_window
        visible = rec_pol.visible

        while st.i < n or st.pending or st.retryq:
            if fault_mode:
                self._merge_ready_retries(st, reqs, rid_index)
                if not st.pending:
                    nxt = []
                    if st.i < n:
                        nxt.append(reqs[st.i].arrival)
                    if st.retryq:
                        nxt.append(st.retryq[0][0])
                    t_next = min(nxt)
                    if t_next > st.now:
                        st.now = t_next
                        self._merge_ready_retries(st, reqs, rid_index)
            elif not st.pending and reqs[st.i].arrival > st.now:
                st.now = reqs[st.i].arrival
            while st.i < n and reqs[st.i].arrival <= st.now:
                st.pending.append(reqs[st.i])
                st.i += 1
            if st.i < n and len(st.pending) < quota and window > 0.0:
                # wave formation: wait for the quota to fill or the batch
                # window (measured from the oldest pending arrival) to
                # close, whichever is first — a no-op once saturated
                t_close = st.pending[0].arrival + window
                t_full = reqs[min(st.i + quota - len(st.pending), n)
                              - 1].arrival
                t_open = min(t_close, t_full)
                if t_open > st.now:
                    st.now = t_open
                    while st.i < n and reqs[st.i].arrival <= st.now:
                        st.pending.append(reqs[st.i])
                        st.i += 1
            if fault_mode:
                self._apply_resets(st)
                self._merge_ready_retries(st, reqs, rid_index)
                self._shed(st, rec_pol)
                if not st.pending:
                    continue            # everything shed / waiting retries
            f = self._slowdowns(st.now)
            self._apply_slowdowns(f)
            rep = self.perturb.replica_state(st.now, self.G, self.R) \
                if (fault_mode and self.perturb is not None) else None
            view = self._fault_view(st.now, st.finish, f, rep, visible) \
                if fault_mode else self._view(st.now, st.finish, f)
            if view.routable is not None and not view.routable.any():
                # every group is down: wait out the failure window (or the
                # next state change) instead of livelocking
                st.deferred += len(st.pending)
                t_next = self._next_fault_event(st)
                if t_next is None:
                    raise RuntimeError(
                        "fleet is permanently failed with work pending "
                        "and no future event — cannot complete the run")
                st.now = t_next
                continue
            k = self.admission.admit(st.pending, st.now, view)
            if k <= 0 and st.pending:
                # backpressure holds the whole wave: let the fleet drain to
                # the next replica-free instant and re-evaluate (never
                # busy-spin — admit() floors to min_admit once idle)
                st.deferred += len(st.pending)
                if fault_mode:
                    t_next = self._next_fault_event(st)
                    if t_next is not None:
                        st.now = t_next
                        continue
                else:
                    future = st.finish[st.finish > st.now]
                    if future.size:
                        st.now = float(future.min())
                        continue
                k = min(len(st.pending), max(1, self.admission.min_admit))
            batch = [st.pending.popleft() for _ in range(k)]
            st.deferred += len(st.pending)
            shards = self.router.route(batch, view)
            if fault_mode and st.retry_pin:
                # migration off: retries go back to the group they failed
                # on, bypassing the router's placement
                for g in range(self.G):
                    kept = []
                    for r in shards[g]:
                        pin = st.retry_pin.get(r.rid)
                        if pin is not None and pin != g:
                            shards[pin].append(r)
                        else:
                            kept.append(r)
                    shards[g] = kept
                for r in batch:
                    st.retry_pin.pop(r.rid, None)
            if fault_mode:
                self._dispatch_faulty(st, rec_pol, reqs, rid_index, shards,
                                      batch, view, f, rep)
            else:
                self._dispatch_clean(st, shards, batch, view)
            st.admitted += len(batch)
            st.waves += 1
            if journal is not None and st.waves % journal.every == 0:
                self._snapshot(journal, st, sig, fault_mode)
            if st.pending:
                # saturated: reopen when the earliest replica frees
                st.now = max(st.now,
                             float(st.finish.min(axis=1).min()))
        if journal is not None:
            self._snapshot(journal, st, sig, fault_mode)
        return self._report(st, n, keep_latencies, fault_mode)

    # -- dispatch paths ------------------------------------------------------
    def _dispatch_clean(self, st: _RunState, shards, batch, view) -> None:
        """The historical fault-free wave dispatch (bit-exact legacy path)."""
        wave_lat = np.empty(len(batch))
        w = 0
        for g, shard in enumerate(shards):
            if not shard:
                continue
            busy = view.busy[g]
            base = float(busy.min())
            sim = self.groups[g]
            # re-base to the dispatcher's relative origin (= the time
            # its earliest replica frees)
            sim.busy = busy - base
            stat = sim.run_wave(shard, st.waves)
            new_busy = sim.busy
            st.busy_tot[g] += new_busy - (busy - base)
            st.finish[g] = (st.now + base) + new_busy
            done = st.now + base + stat.makespan
            for r in shard:
                wave_lat[w] = done - r.arrival
                w += 1
        st.lats.append(wave_lat)

    def _dispatch_faulty(self, st: _RunState, rec: RecoveryPolicy,
                         reqs, rid_index, shards, batch, view, f, rep
                         ) -> None:
        """Wave dispatch under the fault model: masked/straggling replicas,
        whole-group interruption, timeouts, hedges, and the retry ledger."""
        records: List[Tuple[int, List[Request], float]] = []
        for g, shard in enumerate(shards):
            if not shard:
                continue
            alive_g = None if rep is None else rep[0][g]
            if alive_g is not None and not alive_g.any():
                # dispatched into a dead group (blind baseline, or a retry
                # pinned to it): the work queues until the fleet next
                # changes state, then replays.  With no future event a
                # bounded budget burns down to a dead letter; the unbounded
                # baseline could never complete, so it fails loudly.
                rejoin = self.perturb.next_change(st.now) \
                    if self.perturb is not None else None
                if rejoin is None and rec.max_retries < 0:
                    raise RuntimeError(
                        f"group {g} failed permanently with recovery "
                        f"disabled — queued work can never complete")
                t_fail = st.now if rejoin is None else rejoin
                for r in shard:
                    self._schedule_retry(st, rec, r.rid, g, t_fail,
                                         "interrupt")
                continue
            busy = view.busy[g]
            base = float(busy.min())
            sim = self.groups[g]
            sim.busy = busy - base
            stat = sim.run_wave(
                shard, st.waves, active=alive_g,
                replica_scale=None if rep is None else rep[1][g])
            new_busy = sim.busy
            st.busy_tot[g] += new_busy - (busy - base)
            st.finish[g] = (st.now + base) + new_busy
            records.append((g, shard, st.now + base + stat.makespan))

        # hedged duplicates for retried requests: a single-request
        # mini-dispatch on the best OTHER group; first finish wins, and a
        # losing hedge is never charged (its cost is refunded by
        # construction at wave granularity)
        hedge_done: Dict[int, float] = {}
        if rec.hedge:
            for g, shard, done_g in records:
                for r in shard:
                    if st.ledger.attempt_of(r.rid) == 0:
                        continue
                    plan = self._hedge_plan(st, rec, r, g, f, rep)
                    if plan is None:
                        continue
                    st.ledger.hedges += 1
                    h, rr, service, done_h = plan
                    fail = None if self.perturb is None else \
                        self.perturb.failure_start(g, self.G, self.R,
                                                   st.now, done_g)
                    p_done = done_g if fail is None else np.inf
                    if done_h < p_done:
                        st.ledger.hedge_wins += 1
                        st.finish[h, rr] = max(float(st.finish[h, rr]),
                                               st.now) + service
                        st.busy_tot[h, rr] += service
                        hedge_done[r.rid] = done_h

        # resolution: complete, retry, or dead-letter every routed request
        wave_lat: List[float] = []
        for g, shard, done_g in records:
            fail = None if self.perturb is None else \
                self.perturb.failure_start(g, self.G, self.R, st.now,
                                           done_g)
            if fail is not None:
                self._interrupt_group(st, g, fail[0])
            for r in shard:
                was_retry = r.rid in st.retry_from
                if was_retry and st.retry_from.get(r.rid) != g:
                    st.ledger.migrated += 1
                h_done = hedge_done.get(r.rid)
                if fail is None or h_done is not None:
                    eff = done_g if fail is None else np.inf
                    if h_done is not None:
                        eff = min(eff, h_done)
                    if rec.timeout is not None and \
                            eff - st.now > rec.timeout:
                        self._schedule_retry(st, rec, r.rid, g,
                                             st.now + rec.timeout,
                                             "timeout")
                        continue
                    j = rid_index[r.rid]
                    if st.completed[j]:
                        raise AssertionError(
                            f"request {r.rid} completed twice")
                    st.completed[j] = True
                    st.retry_from.pop(r.rid, None)
                    wave_lat.append(eff - r.arrival)
                else:
                    # in-flight on the failed group, no hedge to fall
                    # back on: void at the failure instant and retry
                    self._schedule_retry(st, rec, r.rid, g, fail[0],
                                         "interrupt")
        st.lats.append(np.array(wave_lat, dtype=np.float64))

    # -- reporting -----------------------------------------------------------
    def _report(self, st: _RunState, n: int, keep_latencies: bool,
                fault_mode: bool) -> FleetReport:
        lat = np.concatenate(st.lats) if st.lats else np.empty(0)
        makespan = float(st.finish.max() - st.t0) if n else 0.0
        wave_libs = np.array([s.lib for sim in self.groups
                              for s in sim.stats])
        recovery = None
        served = n
        if fault_mode:
            served = int(st.completed.sum())
            st.ledger.check(n, served)
            if lat.size != served:
                raise AssertionError(
                    f"{lat.size} latencies recorded for {served} "
                    f"completed requests")
            recovery = {"completed": served, **st.ledger.summary()}
        report = FleetReport(
            n_requests=n,
            makespan=makespan,
            throughput=served / max(makespan, 1e-12),
            p50=float(np.percentile(lat, 50)) if lat.size else 0.0,
            p95=float(np.percentile(lat, 95)) if lat.size else 0.0,
            p99=float(np.percentile(lat, 99)) if lat.size else 0.0,
            mean_latency=float(lat.mean()) if lat.size else 0.0,
            fleet_lib=percent_load_imbalance(st.busy_tot.ravel()),
            mean_wave_lib=float(wave_libs.mean()) if len(wave_libs) else 0.0,
            waves=st.waves,
            mean_wave_size=st.admitted / max(st.waves, 1),
            deferred=st.deferred,
            per_group=[{"region": sim.region,
                        "waves": len(sim.stats),
                        "requests": int(sum(s.n_requests
                                            for s in sim.stats)),
                        "busy_s": float(st.busy_tot[g].sum()),
                        "lib": percent_load_imbalance(st.busy_tot[g])}
                       for g, sim in enumerate(self.groups)],
            latencies=lat if keep_latencies else None,
            recovery=recovery)
        return report
