"""Factorial experiment campaign (paper §4.1, Table 2) — the port's
counterpart of ``repro.sim.campaign``.

Drives the DES over {applications} x {systems} x {scheduling algorithms |
selection methods} x {chunk parameter: default | expChunk} x {RL reward: LT |
LIB}, computes the Oracle (per-loop, per-time-step best over all algorithm x
chunk combinations) and the performance-degradation table of Fig. 5, the
c.o.v. of Fig. 4, and the selection traces of Figs. 7-8.

Two batched layers put the whole campaign on the active ``SimBackend``:

* the fixed-algorithm portfolio sweep fans (alg x chunk-mode x rep x
  time-step x loop) into ``run_batch``;
* the selector replays — sequential across time steps by nature — run in
  *lockstep across cells* through :class:`ReplayBatch`: a per-step
  decide / execute / learn cycle where every lane's loop execution for step
  ``t`` is one ``run_lockstep`` call per machine model.

Decisions are host numpy (the policies of ``repro_torch.core``); only the
backend touches the card.  With no backend given, everything runs on the
torch engine on the card.  A lane's ``CellSpec.perturb``
(:class:`~repro_torch.sim.perturb.PerturbationSpec`) makes it
non-stationary: PE slowdowns, failures and noise bursts reach the backend
per step as an ``InstancePerturb``, workload drift transforms the lane's
loop profiles.
"""

from __future__ import annotations

import time
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core import (ALGORITHM_NAMES, N_ALGORITHMS, SelectionService,
                    coefficient_of_variation, exp_chunk, is_learned_policy,
                    is_sim_policy)
from ..core.api import Observation
from ..core.learned import LoopFeaturizer
from ..core.simpolicy import _SIM_ALIASES
from .backends import (InstancePerturb, InstanceSpec, LockstepRequest,
                       get_backend)
from .perturb import PerturbationSpec
from .systems import SystemModel, get_system
from .whatif import LoopWhatIf
from .workloads import Application, get_application

CHUNK_MODES = ("default", "expChunk")


def _digest(label: str) -> int:
    """Stable 16-bit label digest for rng seed tuples — ``hash()`` is salted
    per process for strings, which made campaign noise irreproducible."""
    return zlib.crc32(label.encode("utf-8")) & 0xFFFF


def _lane_digest(selector: str, reward: Optional[str]) -> int:
    """Selector digest for a replay lane's rng seed tuple.

    The reward objective is part of the lane identity: ``_digest(selector)``
    alone made QLearn+LT and QLearn+LIB share one noise stream, which
    batching surfaced as perfectly correlated lanes inside a lockstep step.
    Reward-less selectors keep the bare-selector digest, so their historical
    seed tuples (and Figs. 7-8 traces) are unchanged."""
    return _digest(selector if reward is None else f"{selector}+{reward}")


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


# ---------------------------------------------------------------------------
# selector runs
# ---------------------------------------------------------------------------

@dataclass
class SelectorRun:
    selector: str
    chunk_mode: str
    reward: Optional[str]
    total: float
    #: per loop name: list of (chosen alg, loop_time, lib) per time-step
    history: Dict[str, List[Tuple[int, float, float]]]
    #: the live service that produced the run (per-loop policies, Q-tables);
    #: introspection only — equality and repr ignore it
    service: Optional[SelectionService] = field(default=None, repr=False,
                                                compare=False)

    def selection_shares(self, loop: Optional[str] = None) -> Dict[str, float]:
        """Fig. 7/8 pie charts: fraction of instances per selected algorithm."""
        hists = ([self.history[loop]] if loop else list(self.history.values()))
        counts = np.zeros(N_ALGORITHMS)
        for h in hists:
            for a, _, _ in h:
                counts[a] += 1
        tot = counts.sum() or 1.0
        return {ALGORITHM_NAMES[i]: counts[i] / tot
                for i in range(N_ALGORITHMS) if counts[i] > 0}


def _lane_service(app: Application, selector: str, reward: Optional[str],
                  seed: int, sweep: Optional[PortfolioSweep],
                  system: Optional[SystemModel] = None,
                  sim_backend=None, horizon: Optional[int] = None
                  ) -> Tuple[SelectionService, Optional[object]]:
    """Per-lane service: one independent policy per modified loop (LB4OMP
    loop ids).  Oracle lanes carry per-loop overrides with the per-step
    best from the portfolio sweep.  Simulation-assisted lanes (SimPolicy /
    SimHybrid) additionally get a :class:`LoopWhatIf` candidate pricer on
    ``sim_backend``, learned lanes a :class:`LoopFeaturizer` — both share
    the ``set_context`` surface and are returned so the replay can bind
    the current loop context before each decision."""
    if selector.lower() == "oracle":
        assert sweep is not None, "Oracle needs a portfolio sweep"
        return SelectionService("Oracle", overrides={
            nm: {"best_fn": sweep.oracle_best_fn(li)}
            for li, nm in enumerate(app.loop_names)}), None
    if is_sim_policy(selector):
        assert system is not None, "sim-assisted lanes need a machine model"
        # AwareSim lanes price through the two-pass adaptive surrogate
        # (clean pass → weight re-estimation → perturbed pass)
        two_pass = _SIM_ALIASES.get(selector.lower()) == "AwareSim"
        whatif = LoopWhatIf(system, backend=sim_backend, two_pass=two_pass)
        return SelectionService(selector, reward=reward, seed=seed,
                                simulator=whatif), whatif
    if is_learned_policy(selector):
        # learned lanes bind decision context through a LoopFeaturizer —
        # the same set_context surface as a what-if pricer, so the replay
        # drives both through the lane's ``whatif`` slot
        assert system is not None, "learned lanes need a machine model"
        fz = LoopFeaturizer(system)
        # the policy's phase feature must mean the same thing it meant in
        # the training logs (t / lane T), so the lane horizon rides along
        hkw = {} if horizon is None else {"horizon": horizon}
        return SelectionService(selector, reward=reward, seed=seed,
                                featurizer=fz, **hkw), fz
    return SelectionService(selector, reward=reward, seed=seed), None


def _lane_rng(app_name: str, system: SystemModel, selector: str,
              chunk_mode: str, reward: Optional[str],
              seed: int) -> np.random.Generator:
    """The lane's noise stream, folded from the historical crc32 label
    tuple (see ``_lane_digest`` for the reward term)."""
    return np.random.default_rng((seed, _digest(app_name), system.P,
                                  _lane_digest(selector, reward),
                                  _digest(chunk_mode)))


def run_selector_sequential(app_name: str, system_name: str, selector: str,
                            chunk_mode: str = "default",
                            reward: Optional[str] = None,
                            T: Optional[int] = None, seed: int = 0,
                            sweep: Optional[PortfolioSweep] = None,
                            backend=None, sim_backend=None,
                            perturb: Optional[PerturbationSpec] = None
                            ) -> SelectorRun:
    """Reference replay: one cell, one instance at a time.

    The bit-exactness oracle for the lockstep engine: ``run_selector``
    routes through :class:`ReplayBatch` and must reproduce this loop
    exactly."""
    bk = get_backend(backend)
    app = get_application(app_name)
    system = get_system(system_name)
    T = T or app.T

    if sim_backend is None:
        sim_backend = backend
    service, whatif = _lane_service(app, selector, reward, seed, sweep,
                                    system=system, sim_backend=sim_backend,
                                    horizon=T)
    rng = _lane_rng(app_name, system, selector, chunk_mode, reward, seed)
    total = 0.0
    for t in range(T):
        ip = None if perturb is None else perturb.instance_perturb(t,
                                                                   system.P)
        loops = app.loops(t) if perturb is None else perturb.loops(app, t)
        for li, profile in enumerate(loops):
            nm = app.loop_names[li]
            cp = chunk_param_for(chunk_mode, profile.N, system.P)
            if whatif is not None:      # bind the loop the decision is about
                whatif.set_context(profile, cp, perturb=ip)
            with service.instance(nm) as inst:
                # a policy may steer the chunk parameter; the campaign's
                # chunk mode fills the default
                d = inst.decision.with_instance_defaults(cp)
                res = bk.run_instance(profile, system, d.action,
                                      d.chunk_param, rng, perturb=ip)
                inst.report(loop_time=res.loop_time, lib=res.lib)
            total += res.loop_time
    # the service's per-region records ARE the selection traces
    history = {nm: list(service.history(nm)) for nm in app.loop_names}
    return SelectorRun(selector=selector, chunk_mode=chunk_mode,
                       reward=reward, total=total, history=history,
                       service=service)


# ---------------------------------------------------------------------------
# lockstep multi-cell replay (the batched Fig. 5 engine)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CellSpec:
    """One replay lane of the factorial campaign: which application on which
    system, driven by which selection method.  ``perturb`` makes the lane
    non-stationary (``repro_torch.sim.perturb``); it is deliberately NOT part
    of the lane's rng identity, so a perturbed lane consumes the exact noise
    stream of its clean twin (paired comparisons by construction)."""

    app: str
    system: str
    selector: str
    chunk_mode: str = "default"
    reward: Optional[str] = None
    perturb: Optional[PerturbationSpec] = None

    @property
    def key(self) -> Tuple[str, str, Optional[str]]:
        """The (selector, chunk_mode, reward) key Fig. 5 tables use."""
        return (self.selector, self.chunk_mode, self.reward)


class _Lane:
    """Live state of one replay lane: its service (per-loop policies), its
    private noise stream, and the running total."""

    __slots__ = ("spec", "app", "system", "T", "service", "whatif", "rng",
                 "total", "_ip_cache")

    def __init__(self, spec: CellSpec, app: Application, system: SystemModel,
                 T: int, seed: int, sweep: Optional[PortfolioSweep],
                 sim_backend=None):
        self.spec = spec
        self.app = app
        self.system = system
        self.T = T
        self.service, self.whatif = _lane_service(
            app, spec.selector, spec.reward, seed, sweep, system=system,
            sim_backend=sim_backend, horizon=T)
        self.rng = _lane_rng(spec.app, system, spec.selector,
                             spec.chunk_mode, spec.reward, seed)
        self.total = 0.0
        self._ip_cache: Dict[int, Optional[InstancePerturb]] = {}

    def perturb_at(self, t: int) -> Optional[InstancePerturb]:
        """The lane's resolved execution-side perturbation at step ``t``
        (memoized — every loop of the step shares one resolution)."""
        if self.spec.perturb is None:
            return None
        ip = self._ip_cache.get(t, False)
        if ip is False:
            ip = self.spec.perturb.instance_perturb(t, self.system.P)
            self._ip_cache.clear()      # only the current step is ever hot
            self._ip_cache[t] = ip
        return ip

    def result(self) -> SelectorRun:
        history = {nm: list(self.service.history(nm))
                   for nm in self.app.loop_names}
        return SelectorRun(selector=self.spec.selector,
                           chunk_mode=self.spec.chunk_mode,
                           reward=self.spec.reward, total=self.total,
                           history=history, service=self.service)


class _StepGroup:
    """Per-system accumulator for one lockstep step: the shared profile
    list (lanes on the same application share rows) plus the request and
    pending-instance queues, in lane order."""

    def __init__(self, system: SystemModel):
        self.system = system
        self.profiles: List = []
        self._pids: Dict[Tuple, List[int]] = {}
        self.requests: List[LockstepRequest] = []
        self.pending: List = []          # (lane, RegionInstance) per request
        self.trans: List = []            # translog row index per request

    def register(self, key: Tuple, loops) -> List[int]:
        """Share profile rows between lanes with identical loop content —
        keyed on (app name, active drift), so a drifted lane never aliases
        its clean sibling's profiles."""
        pids = self._pids.get(key)
        if pids is None:
            pids = list(range(len(self.profiles),
                              len(self.profiles) + len(loops)))
            self.profiles.extend(loops)
            self._pids[key] = pids
        return pids


class ReplayBatch:
    """Lockstep multi-cell selector replay.

    Selector state is sequential across time steps, but loop execution is
    parallel across cells — so the replay is organized as a per-step
    decide / execute / learn cycle over many (app, system, selector,
    chunk-mode, reward) lanes:

    * **decide** — every lane's per-loop policy is consulted host-side
      (``SelectionService.instance``; RL agents, fuzzy ladders, Oracle
      overrides, learned nets and simulation-assisted pricing all run
      here);
    * **execute** — all lanes' loop instances for step *t* fan into ONE
      ``SimBackend.run_lockstep`` call per machine model (profiles of lanes
      sharing an application are deduplicated);
    * **learn** — the batched results scatter back through
      ``Observation.batch`` into each lane's policy feedback.

    Lanes are fully independent: each owns its service and its private rng
    stream (the historical crc32 label tuples), so a lockstep replay is
    identical to running ``run_selector_sequential`` per cell.  With no
    ``backend`` the replay runs on the torch engine on the card.
    """

    def __init__(self, lanes: Sequence[CellSpec], T: Optional[int] = None,
                 seed: int = 0,
                 sweeps: Optional[Dict[Tuple[str, str],
                                       PortfolioSweep]] = None,
                 backend=None, sim_backend=None, translog=None):
        self.bk = get_backend(backend)
        #: optional :class:`~repro_torch.sim.translog.TransitionLogger` —
        #: records every lane decision's context + full counterfactual
        #: prices for offline policy training; pricing draws from the
        #: what-if's fixed stateless seed, so a logged replay stays
        #: bit-identical
        self.translog = translog
        if sim_backend is None:
            # sim-assisted lanes price candidates on the replay backend by
            # default, so their argmin matches that engine's Oracle
            sim_backend = backend
        sweeps = sweeps or {}
        apps: Dict[str, Application] = {}
        self._apps = apps
        self.lanes: List[_Lane] = []
        for spec in lanes:
            app = apps.get(spec.app)
            if app is None:
                app = apps[spec.app] = get_application(spec.app)
            self.lanes.append(_Lane(
                spec, app, get_system(spec.system), T or app.T, seed,
                sweeps.get((spec.app, spec.system)),
                sim_backend=sim_backend))
        self.T_max = max((lane.T for lane in self.lanes), default=0)

    def _loops(self, cache: Dict[Tuple, List], app_name: str, t: int,
               drift: Optional[PerturbationSpec] = None) -> List:
        key = (app_name, drift)
        loops = cache.get(key)
        if loops is None:
            app = self._apps[app_name]
            loops = cache[key] = (app.loops(t) if drift is None
                                  else drift.loops(app, t))
        return loops

    def step(self, t: int) -> None:
        """One decide / execute / learn cycle over all active lanes."""
        loops_cache: Dict[Tuple, List] = {}
        groups: Dict[str, _StepGroup] = {}
        for lane in self.lanes:                               # decide
            if t >= lane.T:
                continue
            g = groups.get(lane.spec.system)
            if g is None:
                g = groups[lane.spec.system] = _StepGroup(lane.system)
            pz = lane.spec.perturb
            drift = pz if (pz is not None and pz.has_drift) else None
            ip = lane.perturb_at(t)
            loops = self._loops(loops_cache, lane.spec.app, t, drift)
            pids = g.register((lane.spec.app, drift), loops)
            for li, profile in enumerate(loops):
                cp = chunk_param_for(lane.spec.chunk_mode, profile.N,
                                     lane.system.P)
                if lane.whatif is not None:
                    lane.whatif.set_context(profile, cp, perturb=ip)
                inst = lane.service.instance(lane.app.loop_names[li])
                d = inst.decision.with_instance_defaults(cp)
                g.requests.append(LockstepRequest(
                    profile_id=pids[li], alg=d.action,
                    chunk_param=d.chunk_param, rng=lane.rng, perturb=ip))
                g.pending.append((lane, inst))
                if self.translog is not None:
                    g.trans.append(self.translog.log_decision(
                        lane, t, profile, cp, ip, d))
        for g in groups.values():                             # execute
            res = self.bk.run_lockstep(g.profiles, g.system, g.requests)
            obs = Observation.batch(res.loop_time, res.lib)
            for i, ((lane, inst), o) in enumerate(zip(g.pending,
                                                      obs)):  # learn
                inst.report(observation=o)
                inst.close()
                lane.total += o.loop_time
                if g.trans and g.trans[i] is not None:
                    self.translog.log_result(g.trans[i], o.loop_time)

    def run(self) -> List[SelectorRun]:
        """Replay every lane to completion; results in lane order."""
        for t in range(self.T_max):
            self.step(t)
        return [lane.result() for lane in self.lanes]


def run_selector(app_name: str, system_name: str, selector: str,
                 chunk_mode: str = "default", reward: Optional[str] = None,
                 T: Optional[int] = None, seed: int = 0,
                 sweep: Optional[PortfolioSweep] = None,
                 backend=None, sim_backend=None,
                 perturb: Optional[PerturbationSpec] = None,
                 translog=None) -> SelectorRun:
    """Execute one selection method over the full time-stepped application.

    Every modified loop gets an independent policy via ``SelectionService``
    (LB4OMP loop ids); ``selector`` is any ``make_policy`` name, including
    "Hybrid" (expert-seeded RL) and "Oracle" (per-loop overrides carrying
    the per-step best; ``sweep`` is required for it).  Runs as a one-lane
    :class:`ReplayBatch` — identical to the sequential reference loop
    (``run_selector_sequential``); batch many cells through ``ReplayBatch``
    or ``run_campaign`` to amortize the backend calls across lanes."""
    spec = CellSpec(app=app_name, system=system_name, selector=selector,
                    chunk_mode=chunk_mode, reward=reward, perturb=perturb)
    sweeps = {(app_name, system_name): sweep} if sweep is not None else None
    return ReplayBatch([spec], T=T, seed=seed, sweeps=sweeps,
                       backend=backend, sim_backend=sim_backend,
                       translog=translog).run()[0]


# ---------------------------------------------------------------------------
# the full factorial campaign (Fig. 5)
# ---------------------------------------------------------------------------

SELECTOR_GRID: List[Tuple[str, Optional[str]]] = [
    ("RandomSel", None), ("ExhaustiveSel", None), ("ExpertSel", None),
    ("QLearn", "LT"), ("QLearn", "LIB"), ("SARSA", "LT"), ("SARSA", "LIB"),
]

#: the paper grid plus the §6 expert-seeded RL combination
EXTENDED_SELECTOR_GRID: List[Tuple[str, Optional[str]]] = \
    SELECTOR_GRID + [("Hybrid", "LT"), ("Hybrid", "LT+LIB")]

#: the extended grid plus the simulation-assisted methods (SimAS-style):
#: candidate pricing in simulation, zero live exploration for SimPolicy and
#: a sim-pruned RL window for SimHybrid
SIM_SELECTOR_GRID: List[Tuple[str, Optional[str]]] = \
    EXTENDED_SELECTOR_GRID + [("SimPolicy", "LT"), ("SimHybrid", "LT")]


@dataclass
class CampaignResult:
    app: str
    system: str
    sweep: PortfolioSweep
    oracle_total: float
    selector_runs: Dict[Tuple[str, str, Optional[str]], SelectorRun]
    #: host-clock walls of the campaign call this cell came from: the
    #: portfolio sweeps (``sweep_s``, all cells) and the lockstep replay
    #: (``replay_s``, all lanes); both end in a copy back to the host
    walls: Dict[str, float] = field(default_factory=dict, repr=False,
                                    compare=False)

    def degradation(self) -> Dict[Tuple[str, str, Optional[str]], float]:
        """Fig. 5 cells: (T_method - T_oracle) / T_oracle * 100."""
        return {k: (r.total - self.oracle_total) / self.oracle_total * 100.0
                for k, r in self.selector_runs.items()}


def run_campaign(cells: Sequence[Tuple[str, str]],
                 T: Optional[int] = None, reps: int = 3, seed: int = 0,
                 selectors=SELECTOR_GRID,
                 chunk_modes=CHUNK_MODES,
                 backend=None,
                 selector_backend=None,
                 sim_backend=None,
                 translog=None
                 ) -> Dict[Tuple[str, str], CampaignResult]:
    """The full factorial campaign over many Fig. 5 cells at once.

    ``cells`` is a sequence of (application, system) name pairs.  Per cell
    the fixed-algorithm portfolio sweeps to the Oracle through one
    ``run_batch``; then EVERY cell's (selector x chunk-mode x reward) lanes
    replay in lockstep through one :class:`ReplayBatch` — per time step the
    campaign issues one batched backend call per machine model instead of
    ``len(cells) * len(selectors) * len(chunk_modes)`` sequential DES runs.

    ``backend`` drives the portfolio sweeps; ``selector_backend`` (default:
    same as ``backend``) drives the lockstep replays; ``sim_backend``
    (default: same as ``selector_backend``) prices the candidate sets of
    simulation-assisted lanes (``SIM_SELECTOR_GRID``).  ``None`` throughout
    is the torch engine on the card.  ``translog`` (a
    :class:`~repro_torch.sim.translog.TransitionLogger`) records every lane
    decision with full counterfactual prices for offline policy training
    without touching lane rng streams."""
    if selector_backend is None:
        selector_backend = backend
    t0 = time.perf_counter()
    sweeps = {
        (app, sysname): sweep_portfolio(app, sysname, T=T, reps=reps,
                                        seed=seed, backend=backend)
        for app, sysname in cells}
    t1 = time.perf_counter()
    lanes = [CellSpec(app=app, system=sysname, selector=sel,
                      chunk_mode=mode, reward=reward)
             for app, sysname in cells
             for mode in chunk_modes
             for sel, reward in selectors]
    runs = ReplayBatch(lanes, T=T, seed=seed, sweeps=sweeps,
                       backend=selector_backend,
                       sim_backend=sim_backend, translog=translog).run()
    walls = {"sweep_s": t1 - t0, "replay_s": time.perf_counter() - t1}
    by_cell: Dict[Tuple[str, str], Dict] = {tuple(c): {} for c in cells}
    for spec, run in zip(lanes, runs):
        by_cell[(spec.app, spec.system)][spec.key] = run
    out = {}
    for app, sysname in cells:
        sweep = sweeps[(app, sysname)]
        T_eff = T or get_application(app).T
        out[(app, sysname)] = CampaignResult(
            app=app, system=sysname, sweep=sweep,
            oracle_total=float(sweep.oracle_times()[:T_eff].sum()),
            selector_runs=by_cell[(app, sysname)], walls=walls)
    return out


def run_campaign_cell(app_name: str, system_name: str,
                      T: Optional[int] = None, reps: int = 3,
                      seed: int = 0,
                      selectors=SELECTOR_GRID,
                      chunk_modes=CHUNK_MODES,
                      backend=None,
                      selector_backend=None,
                      sim_backend=None) -> CampaignResult:
    """One Fig. 5 cell (a ``run_campaign`` of a single (app, system) pair).

    ``backend`` picks the simulation engine for the heavy portfolio sweep
    (the torch engine on the card when None); the selector replays and
    their pricing follow it unless ``selector_backend`` names another —
    ``"python"`` for the exact-telemetry host engine."""
    return run_campaign([(app_name, system_name)], T=T, reps=reps, seed=seed,
                        selectors=selectors, chunk_modes=chunk_modes,
                        backend=backend,
                        selector_backend=selector_backend,
                        sim_backend=sim_backend)[(app_name, system_name)]
