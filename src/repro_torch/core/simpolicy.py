"""Simulation-assisted selection (SimAS-style, Mohammed & Ciorba 2021).

The paper's RL and hybrid methods pay for exploration on live traffic: every
instance spent probing a bad scheduling algorithm is a real slowdown.  SimAS
removes that cost by pricing the candidate portfolio *in a simulator* and
executing only the predicted winner.  This module is that idea behind the
:class:`~repro_torch.core.api.SelectionPolicy` protocol:

``SimPolicy``
    On every ``decide()``, price the full candidate set (all 12 portfolio
    algorithms, plus chunk-parameter variants) through one batched what-if
    call on the configured simulator, apply the registered reward to each
    predicted :class:`Observation`, and commit to the argmin.  When the
    simulator's predicted spread is below ``confidence_threshold`` — the
    candidates are indistinguishable, so the prediction carries no signal —
    fall back to the expert fuzzy ladder, which tracks the *live* (LT, LIB)
    trajectory through ``feedback``.

``SimAssistedHybrid``
    :class:`~repro_torch.core.selectors.HybridPolicy` whose RL exploration window
    is pre-pruned by simulated cost: instead of the expert ladder's
    neighbourhood, the agent explores only the simulator's predicted top-k
    algorithms (the Oracle pick of a noise-free simulator is always inside
    the pruned set).  Exploration drops from the full 144-instance grid to
    ``expert_steps + top_k**2`` instances.

A *candidate simulator* is anything with::

    candidates() -> Sequence[Candidate]          # what can be priced now
    price(cands) -> Sequence[Observation] | array of predicted loop times

Concrete simulators live next to their execution layers; the port has
``repro_torch.sim.whatif.LoopWhatIf`` (DES loop instances) and
``repro_torch.serving.engine.WaveWhatIf`` (dispatch waves via
``DispatchSimulator.what_if``); the reference's step-plan pricer is still
to come.
A simulator that cannot price yet (no context bound) raises
:class:`SimUnavailable`; the policies degrade to their live fallbacks.

``REPRO_SIM_POLICY`` names the sim-assisted method consumers should default
to (e.g. ``SimPolicy`` / ``SimHybrid``): ``SelectionService`` and
``DispatchSimulator`` resolve it when no explicit method is given, so a
whole campaign can be flipped to simulation-assisted selection from the
environment.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from .api import Decision, Observation, SelectionPolicy, get_reward
from .drift import PageHinkley
from .portfolio import N_ALGORITHMS
from .rewards import REWARD_POSITIVE
from .selectors import ExpertPolicy, HybridPolicy

__all__ = [
    "Candidate", "SimUnavailable", "SimPolicy", "SimAssistedHybrid",
    "SIM_POLICY_ENV", "resolve_sim_policy", "is_sim_policy",
    "SIM_POLICY_NAMES",
]

#: env var naming the default simulation-assisted method ("SimPolicy",
#: "SimHybrid"); consumers resolve it through :func:`resolve_sim_policy`.
SIM_POLICY_ENV = "REPRO_SIM_POLICY"

#: canonical registry spellings (``make_policy`` accepts these, lowercased).
#: The ``Reactive*`` variants re-price / re-prune when a drift detector fires
#: on the live stream; ``AwareSim`` is a plain SimPolicy whose campaign lane
#: prices through a two-pass adaptive-surrogate what-if (the lane wiring in
#: ``repro_torch.sim.campaign`` switches on this name).
SIM_POLICY_NAMES = ["SimPolicy", "SimHybrid", "ReactiveSim",
                    "ReactiveHybrid", "AwareSim"]

_SIM_ALIASES = {
    "simpolicy": "SimPolicy", "sim": "SimPolicy", "simsel": "SimPolicy",
    "simas": "SimPolicy",
    "simhybrid": "SimHybrid", "sim-hybrid": "SimHybrid",
    "simassistedhybrid": "SimHybrid",
    "reactivesim": "ReactiveSim", "simreact": "ReactiveSim",
    "reactivesimpolicy": "ReactiveSim",
    "reactivehybrid": "ReactiveHybrid", "simhybridreact": "ReactiveHybrid",
    "reactivesimhybrid": "ReactiveHybrid",
    "awaresim": "AwareSim", "simaware": "AwareSim",
    "adaptivesim": "AwareSim",
}


def is_sim_policy(name: Optional[str]) -> bool:
    """True when ``name`` spells one of the simulation-assisted methods."""
    return isinstance(name, str) and name.lower() in _SIM_ALIASES


def resolve_sim_policy(default: Optional[str] = None) -> Optional[str]:
    """The method consumers should build when none was requested: the
    ``REPRO_SIM_POLICY`` env override if set (canonicalized), else
    ``default``.  A value that spells no sim policy is rejected HERE — the
    env var is read far from the shell that set it, so the eventual
    unknown-policy error would never mention it."""
    import os
    name = os.environ.get(SIM_POLICY_ENV)
    if not name:
        return default
    canon = _SIM_ALIASES.get(name.lower())
    if canon is None:
        raise ValueError(
            f"{SIM_POLICY_ENV}={name!r} names no simulation-assisted "
            f"policy; valid spellings: {sorted(_SIM_ALIASES)}")
    return canon


@dataclass(frozen=True)
class Candidate:
    """One entry of a what-if pricing request: a portfolio algorithm and an
    optional chunk-parameter variant (``None`` = the caller's default, the
    same convention as :class:`~repro_torch.core.api.Decision.chunk_param`)."""

    alg: int
    chunk_param: Optional[int] = None


class SimUnavailable(RuntimeError):
    """Raised by a candidate simulator that cannot price right now (e.g. no
    loop/wave context bound yet).  Policies catch it and fall back to their
    live decision path."""


def _as_observations(priced) -> List[Observation]:
    """Normalize a simulator's output: either ready-made Observations or a
    bare array of predicted loop times."""
    if len(priced) and isinstance(priced[0], Observation):
        return list(priced)
    return [Observation(loop_time=float(t)) for t in np.asarray(priced)]


# ---------------------------------------------------------------------------
# SimPolicy — execute only the simulator's predicted winner
# ---------------------------------------------------------------------------

class SimPolicy(SelectionPolicy):
    """Price every candidate in simulation, run the argmin, learn nothing on
    live traffic.

    ``decide`` issues one batched pricing call over the simulator's candidate
    set and commits to the argmin under the registered reward.  The policy is
    stateless across instances apart from the embedded expert ladder, which
    digests every live observation so that the *fallback* (taken when the
    predicted spread is under ``confidence_threshold``, or when the simulator
    has no context) stays anchored to reality rather than to a cold start.
    """

    name = "SimPolicy"

    def __init__(self, simulator, reward="LT",
                 candidates: Optional[Sequence[Candidate]] = None,
                 confidence_threshold: float = 0.02,
                 n_actions: int = N_ALGORITHMS,
                 reactive: bool = False, fidelity_alpha: float = 0.35,
                 detector: Optional[PageHinkley] = None):
        self.simulator = simulator
        self.reward_name = reward if isinstance(reward, str) else getattr(
            reward, "__name__", "custom")
        self._reward_fn = get_reward(reward)
        self._candidates = list(candidates) if candidates is not None else None
        self.confidence_threshold = float(confidence_threshold)
        self.n_actions = n_actions
        self._fallback = ExpertPolicy(n_actions=n_actions)
        #: (predicted cost of the committed candidate, measured reward) per
        #: sim-driven instance — fidelity introspection for studies
        self.pred_log: List[tuple] = []
        self._last_pred: Optional[float] = None
        # --- reactive re-pricing (perturbation-aware variant) -------------
        self.reactive = bool(reactive)
        if self.reactive:
            self.name = "ReactiveSim"
        self.fidelity_alpha = float(fidelity_alpha)
        self.detector = detector if detector is not None else (
            PageHinkley() if self.reactive else None)
        #: per-(alg, chunk_param) EMA of measured/predicted cost — the live
        #: fidelity correction multiplying each candidate's simulated price
        self._corrections: dict = {}
        self._last_key: Optional[tuple] = None
        #: number of drift detections that flushed the correction table
        self.drift_events = 0

    def _candidate_set(self) -> List[Candidate]:
        if self._candidates is not None:
            return self._candidates
        cands = self.simulator.candidates() if hasattr(
            self.simulator, "candidates") else None
        if not cands:
            return [Candidate(a) for a in range(self.n_actions)]
        return list(cands)

    def decide(self) -> Decision:
        try:
            cands = self._candidate_set()
            priced = _as_observations(self.simulator.price(cands))
        except SimUnavailable:
            self._last_pred = None
            d = self._fallback.decide()
            return Decision(action=d.action, phase="expert", confidence=0.0)
        raw = np.array([self._reward_fn(o) for o in priced],
                       dtype=np.float64)
        costs = raw
        if self.reactive and self._corrections:
            # live surrogate-fidelity corrections: multiply each candidate's
            # simulated price by its measured/predicted EMA ratio
            costs = raw * np.array(
                [self._corrections.get((c.alg, c.chunk_param), 1.0)
                 for c in cands], dtype=np.float64)
        best = int(np.argmin(costs))
        lo, hi = float(costs[best]), float(costs.max())
        spread = (hi - lo) / max(abs(hi), 1e-12)
        if spread < self.confidence_threshold:
            # indistinguishable candidates: the prediction carries no signal
            d = self._fallback.decide()
            self._last_pred = None
            self._last_key = None
            return Decision(action=d.action, phase="expert",
                            confidence=d.confidence)
        # committed: confidence is the relative margin to the runner-up
        second = float(np.partition(costs, 1)[1]) if len(costs) > 1 else hi
        conf = float(np.clip((second - lo) / max(abs(second), 1e-12), 0, 1))
        # fidelity bookkeeping uses the RAW simulated price of the committed
        # candidate (corrections must calibrate against the simulator, not
        # against themselves)
        self._last_pred = float(raw[best])
        self._last_key = (cands[best].alg, cands[best].chunk_param)
        return Decision(action=cands[best].alg,
                        chunk_param=cands[best].chunk_param,
                        phase="exploit", confidence=conf)

    def feedback(self, decision: Decision, obs: Observation) -> None:
        # keep the fallback ladder tracking the live trajectory
        self._fallback.feedback(decision, obs)
        if self._last_pred is None:
            return
        pred, key = self._last_pred, self._last_key
        self._last_pred = None
        self._last_key = None
        measured = self._reward_fn(obs)
        self.pred_log.append((pred, measured))
        if not self.reactive or key is None:
            return
        if pred <= 0.0 or measured <= 0.0:
            return              # ratio undefined (e.g. signed rewards)
        ratio = measured / pred
        prev = self._corrections.get(key, 1.0)
        a = self.fidelity_alpha
        self._corrections[key] = (1.0 - a) * prev + a * ratio
        if self.detector is not None and self.detector.update(
                float(np.log(ratio))):
            # the world shifted: corrections learned before the drift are
            # stale for every candidate except the one just measured
            self._corrections = {key: self._corrections[key]}
            self.drift_events += 1


# ---------------------------------------------------------------------------
# SimAssistedHybrid — RL explores only the simulator's top-k
# ---------------------------------------------------------------------------

class SimAssistedHybrid(HybridPolicy):
    """Hybrid expert+RL whose exploration window is pruned by simulated cost.

    The expert phase runs unchanged (it also keeps the live baseline the
    differential fuzzy system needs); at agent-build time the full algorithm
    grid is priced in simulation and the RL agent's action set becomes the
    predicted top-``top_k`` — always a subset of the portfolio containing
    the simulator's argmin — with the Q-table seeded toward the predicted
    winner.  If the simulator cannot price (no context), the expert-window
    construction of :class:`HybridPolicy` applies unchanged."""

    name = "SimHybrid"

    def __init__(self, simulator, top_k: int = 4, expert_steps: int = 2,
                 reactive: bool = False,
                 detector: Optional[PageHinkley] = None, **kw):
        kw.setdefault("window", top_k)
        super().__init__(expert_steps=expert_steps, **kw)
        self.simulator = simulator
        self.top_k = max(1, min(int(top_k), self.n_actions))
        # --- reactive re-pruning (perturbation-aware variant) -------------
        self.reactive = bool(reactive)
        if self.reactive:
            self.name = "ReactiveHybrid"
        self.detector = detector if detector is not None else (
            PageHinkley() if self.reactive else None)
        self.drift_events = 0

    def _build_agent(self) -> None:
        try:
            cands = [Candidate(a) for a in range(self.n_actions)]
            priced = _as_observations(self.simulator.price(cands))
        except SimUnavailable:
            super()._build_agent()
            return
        costs = np.array([self._reward_fn(o) for o in priced],
                         dtype=np.float64)
        order = np.argsort(costs, kind="stable")
        best = int(order[0])
        self.actions = sorted(int(a) for a in order[: self.top_k])
        self.window = len(self.actions)
        self.agent = self._agent_cls(n_actions=self.window,
                                     initial_state=self.actions.index(best),
                                     **self._agent_kw)
        # seed: the predicted winner starts strictly above the 0-initialized
        # alternatives, so post-exploration greedy ties break toward it
        self.agent.q[:, self.actions.index(best)] = REWARD_POSITIVE

    def feedback(self, decision: Decision, obs: Observation) -> None:
        super().feedback(decision, obs)
        if not self.reactive or self.detector is None:
            return
        if self.agent is None or self.agent.learning:
            return              # still exploring: cost swings are expected
        if self.detector.update(self._reward_fn(obs)):
            # the exploitation-phase cost stream shifted: re-price the full
            # grid against the simulator's *current* context and re-prune the
            # exploration window (fresh agent, fresh Eulerian sweep)
            self._build_agent()
            self.drift_events += 1
