"""Unified selection API — the structured surface every consumer speaks.

The paper's selection methods (§3.2-3.5) were originally driven through a
scalar ``select() / observe(action, loop_time, lib)`` protocol.  That
protocol cannot express the paper's two most valuable extensions:

* §6's *combination* of expert knowledge with RL-based learning (the fuzzy
  ladder seeding/bounding the Q-agent's exploration), and
* §5's Q-table persistence ("eliminating the learning phase of RL-based
  methods") flowing automatically through the per-region service.

This module is the redesign: three small, composable pieces.

``Observation``
    Everything a region instance can report back — loop time, percent load
    imbalance (Eq. 8), serving-centric signals (throughput, tail latency),
    raw per-PE finish times, and the instance index.

``Decision``
    What a policy hands the caller — the portfolio (or plan) index, an
    optional chunk parameter, a confidence score, and the policy phase
    (``expert`` / ``explore`` / ``exploit`` / ``monitor``).

``SelectionPolicy``
    The protocol: ``decide() -> Decision`` before the instance runs,
    ``feedback(decision, observation)`` after.  Policies optionally expose
    ``state_dict() / load_state_dict()`` so ``SelectionService`` can persist
    and warm-start them (paper §5).

Reward functions are pluggable through a registry: a *reward signal* is any
callable ``Observation -> float`` (lower is better) registered with
``@register_reward``.  The Eq. 11 three-level mapping (``RewardTracker``)
is applied on top of the extracted signal, so LT / LIB generalize to
composite and serving-centric rewards (p95 tail latency, LT+LIB blends,
negated throughput) without touching the agents.

Concrete policies live in :mod:`repro_torch.core.selectors`; build them by name
with ``make_policy`` (re-exported here for convenience).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .metrics import percent_load_imbalance

__all__ = [
    "Observation", "Decision", "SelectionPolicy",
    "register_reward", "get_reward", "reward_names", "RewardFn",
    "make_policy",
]


# ---------------------------------------------------------------------------
# structured observations and decisions
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Observation:
    """One region instance's measured outcome.

    Only ``loop_time`` is mandatory; every other field is an optional,
    richer signal a consumer may report (the serving dispatcher reports
    throughput/tail latency and raw per-replica times; the simulator
    reports loop time and LIB).
    """

    loop_time: float                      # seconds (LT, paper §3.5)
    lib: float = 0.0                      # percent load imbalance (Eq. 8)
    throughput: Optional[float] = None    # work units per second
    tail_latency: Optional[float] = None  # p95-style latency signal
    pe_times: Optional[Sequence[float]] = None  # per-PE finish times
    instance: int = -1                    # region instance index (-1 unknown)

    @classmethod
    def from_pe_times(cls, pe_times: Sequence[float], **kw) -> "Observation":
        """Build an observation from raw per-PE finish times: loop time is
        the makespan, LIB follows Eq. 8."""
        times = np.asarray(pe_times, dtype=np.float64)
        kw.setdefault("loop_time", float(times.max()))
        kw.setdefault("lib", percent_load_imbalance(times))
        kw.setdefault("tail_latency", float(np.percentile(times, 95)))
        return cls(pe_times=tuple(float(t) for t in times), **kw)

    @classmethod
    def batch(cls, loop_times, libs=None) -> List["Observation"]:
        """Vectorized construction from a batched backend result: one
        observation per lane instance, in array order (the lockstep replay's
        learn phase scatters these back to each lane's policy).  ``instance``
        is left unset (-1); the region service stamps its own counter when
        the observation is reported."""
        lt = np.asarray(loop_times, dtype=np.float64)
        lb = np.zeros_like(lt) if libs is None \
            else np.asarray(libs, dtype=np.float64)
        return [cls(loop_time=float(t), lib=float(b))
                for t, b in zip(lt, lb)]


@dataclass(frozen=True)
class Decision:
    """A policy's choice for the next region instance."""

    action: int                       # portfolio / plan index
    chunk_param: Optional[int] = None  # chunk parameter, None = caller's
    confidence: float = 1.0           # 0 (guessing) .. 1 (committed)
    phase: str = "exploit"            # expert | explore | exploit | monitor

    def with_instance_defaults(self, chunk_param: int) -> "Decision":
        if self.chunk_param is None:
            return replace(self, chunk_param=chunk_param)
        return self


# ---------------------------------------------------------------------------
# the policy protocol
# ---------------------------------------------------------------------------

class SelectionPolicy:
    """Protocol every selection method implements.

    ``decide`` is called before each region instance and must return a
    ``Decision``; ``feedback`` is called after, with the decision that was
    acted on and the measured ``Observation``.  ``decide`` must tolerate
    being called repeatedly without intervening feedback (callers may peek).
    """

    name: str = "base"

    #: instances the method spends learning before committing to a selection
    @property
    def learning_steps(self) -> int:
        return 0

    @property
    def learning(self) -> bool:
        return False

    def decide(self) -> Decision:  # pragma: no cover - abstract
        raise NotImplementedError

    def feedback(self, decision: Decision, obs: Observation) -> None:
        pass

    # -- persistence hooks (paper §5 warm start) ---------------------------
    def state_dict(self) -> Optional[dict]:
        """JSON-serializable state, or None if there is nothing worth
        persisting (stateless / purely reactive policies)."""
        return None

    def load_state_dict(self, state: dict, *,
                        skip_learning: bool = True) -> bool:
        """Restore from ``state_dict`` output; returns True if the policy
        warm-started (e.g. skipped its learning phase)."""
        return False


# ---------------------------------------------------------------------------
# reward-function registry
# ---------------------------------------------------------------------------

#: a reward signal maps a structured observation to a scalar, LOWER IS
#: BETTER (the Eq. 11 tracker rewards new minima).
RewardFn = Callable[[Observation], float]

_REWARDS: Dict[str, RewardFn] = {}


def register_reward(name: str) -> Callable[[RewardFn], RewardFn]:
    """Register ``fn(obs) -> float`` under ``name`` (case-insensitive).

        @register_reward("p99")
        def p99(obs):
            return obs.tail_latency if obs.tail_latency is not None \\
                else obs.loop_time
    """
    def deco(fn: RewardFn) -> RewardFn:
        _REWARDS[name.lower()] = fn
        return fn
    return deco


def get_reward(reward: "str | RewardFn") -> RewardFn:
    """Resolve a reward by registry name (or pass a callable through)."""
    if callable(reward):
        return reward
    try:
        return _REWARDS[reward.lower()]
    except KeyError:
        raise ValueError(
            f"unknown reward {reward!r}; registered: {reward_names()}"
        ) from None


def reward_names() -> List[str]:
    return sorted(_REWARDS)


@register_reward("LT")
def _reward_lt(obs: Observation) -> float:
    """Loop (step / wave / round) execution time — the paper's LT."""
    return obs.loop_time


@register_reward("LIB")
def _reward_lib(obs: Observation) -> float:
    """Percent load imbalance, Eq. 8 — the paper's LIB."""
    return obs.lib


@register_reward("p95")
def _reward_p95(obs: Observation) -> float:
    """Serving-centric: p95 tail latency, falling back to per-PE times and
    then to the loop time when the consumer reports nothing richer."""
    if obs.tail_latency is not None:
        return obs.tail_latency
    if obs.pe_times is not None and len(obs.pe_times):
        return float(np.percentile(np.asarray(obs.pe_times), 95))
    return obs.loop_time


@register_reward("throughput")
def _reward_throughput(obs: Observation) -> float:
    """Negated throughput (lower is better); falls back to loop time."""
    if obs.throughput is not None:
        return -obs.throughput
    return obs.loop_time


@register_reward("LT+LIB")
def _reward_lt_lib(obs: Observation) -> float:
    """Composite: loop time inflated by the imbalance fraction.  A 20 % LIB
    instance scores like a 1.2x slower balanced one, so the agent optimizes
    time while penalizing imbalance it could remove."""
    return obs.loop_time * (1.0 + obs.lib / 100.0)


# ---------------------------------------------------------------------------
# factory (implemented next to the concrete policies)
# ---------------------------------------------------------------------------

def make_policy(name: str, **kw) -> SelectionPolicy:
    """Build a policy by name: Fixed, RandomSel, ExhaustiveSel, ExpertSel,
    QLearn, SARSA, Hybrid, Oracle, plus the simulation-assisted SimPolicy /
    SimHybrid (which require a ``simulator=`` candidate pricer; see
    ``repro_torch.core.simpolicy``).  See ``selectors.make_policy``."""
    from .selectors import make_policy as _impl
    return _impl(name, **kw)
