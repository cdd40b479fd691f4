"""Scheduling-algorithm selection policies (paper §3.2-3.5, §6).

Every method implements the structured :class:`repro_torch.core.api.SelectionPolicy`
protocol so the simulator, serving dispatcher and step-plan autotuner can
drive any of them through one surface:

    policy = make_policy("QLearn", reward="LT", seed=0)
    for t in range(T):
        d = policy.decide()                  # Decision: action, phase, ...
        obs = execute(d.action)              # -> Observation
        policy.feedback(d, obs)

Expert-based:  RandomSel, ExhaustiveSel, ExpertSel     [25]
RL-based:      QLearn, SARSA                           (this paper)
Combined:      Hybrid — ExpertSel's fuzzy ladder seeds and bounds the RL
               agent's exploration (paper §6's expert+RL combination)
References:    Fixed (single algorithm), Oracle (offline per-instance best)

The pre-redesign scalar surface (``Selector.select()`` /
``observe(action, loop_time, lib)`` and ``make_selector``) survives at the
bottom of this module as thin adapter shims over the policies.  It is
deprecated; new code should use ``make_policy`` / ``SelectionService``.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, List, Optional

import numpy as np

from .agents import QLearnAgent, SarsaAgent
from .api import Decision, Observation, SelectionPolicy, get_reward
from .fuzzy import make_diff_system, make_initial_system
from .portfolio import N_ALGORITHMS
from .rewards import REWARD_POSITIVE

SELECTOR_NAMES = ["Fixed", "RandomSel", "ExhaustiveSel", "ExpertSel",
                  "QLearn", "SARSA", "Hybrid", "Oracle"]
#: the structured-API spelling of the same registry (plus the
#: simulation-assisted methods, which need a ``simulator=``, and the
#: offline-trained learned methods, which want a ``featurizer=`` +
#: trained ``state=``)
POLICY_NAMES = SELECTOR_NAMES + ["SimPolicy", "SimHybrid", "ReactiveSim",
                                 "ReactiveHybrid", "AwareSim",
                                 "Learned", "LearnedHybrid"]


# ---------------------------------------------------------------------------
# reference policies
# ---------------------------------------------------------------------------

class FixedPolicy(SelectionPolicy):
    """Always the same algorithm — used for per-algorithm campaign runs."""

    name = "Fixed"

    def __init__(self, algorithm: int):
        self.algorithm = int(algorithm)

    def decide(self) -> Decision:
        return Decision(action=self.algorithm, phase="exploit")


class OraclePolicy(SelectionPolicy):
    """Paper §3.3: manually derived per-instance best (offline exhaustive).
    ``best_fn(t)`` maps instance index → portfolio index."""

    name = "Oracle"

    def __init__(self, best_fn: Callable[[int], int]):
        self._best = best_fn
        self._t = 0

    def decide(self) -> Decision:
        return Decision(action=int(self._best(self._t)), phase="exploit")

    def feedback(self, decision: Decision, obs: Observation) -> None:
        self._t += 1


# ---------------------------------------------------------------------------
# expert-based policies [25]
# ---------------------------------------------------------------------------

class RandomPolicy(SelectionPolicy):
    """[25]: jump probability P_j = LIB / 10; if P_j > RND(0,1) pick a random
    algorithm, else keep the current one.  LIB > 10 % → always switch.

    The jump is rolled once per instance (in ``feedback``, and once at
    construction for the first instance), so ``decide`` is a pure peek —
    repeated calls neither advance the RNG nor change the selection."""

    name = "RandomSel"

    def __init__(self, seed: int = 0, initial: int = 0,
                 n_actions: int = N_ALGORITHMS):
        self.rng = np.random.default_rng(seed)
        self.current = int(initial)
        self.n_actions = n_actions
        self._lib = 100.0  # force an exploratory jump on the first instance
        self._jumped = self._jump()

    def _jump(self) -> bool:
        """Mutating roll: maybe re-pick the current algorithm."""
        if self._lib / 10.0 > self.rng.random():
            self.current = int(self.rng.integers(0, self.n_actions))
            return True
        return False

    def decide(self) -> Decision:
        if self._jumped:
            return Decision(action=self.current, phase="explore",
                            confidence=0.0)
        p_jump = self._lib / 10.0
        return Decision(action=self.current, phase="exploit",
                        confidence=float(np.clip(1.0 - p_jump, 0.0, 1.0)))

    def feedback(self, decision: Decision, obs: Observation) -> None:
        self._lib = float(obs.lib)
        self._jumped = self._jump()     # roll for the next instance


class ExhaustivePolicy(SelectionPolicy):
    """[25]: one instance per portfolio algorithm (in order), then argmin of
    the recorded times.  LIB is monitored after selection; a >10 % deviation
    from the recorded average re-triggers the search."""

    name = "ExhaustiveSel"

    def __init__(self, lib_retrigger: float = 0.10, min_samples: int = 3,
                 n_actions: int = N_ALGORITHMS):
        self.n_actions = n_actions
        self._times = np.full(n_actions, np.inf)
        self._phase = 0                 # next algorithm to try
        self._selected: Optional[int] = None
        self._lib_sum = 0.0
        self._lib_cnt = 0
        self._retrigger = lib_retrigger
        self._min_samples = min_samples

    @property
    def learning_steps(self) -> int:
        return self.n_actions

    @property
    def learning(self) -> bool:
        return self._selected is None

    def decide(self) -> Decision:
        if self._selected is None:
            return Decision(action=self._phase, phase="explore",
                            confidence=0.0)
        return Decision(action=self._selected, phase="monitor")

    def feedback(self, decision: Decision, obs: Observation) -> None:
        action, loop_time, lib = decision.action, obs.loop_time, obs.lib
        if self._selected is None:
            self._times[action] = loop_time
            self._phase += 1
            if self._phase >= self.n_actions:
                self._selected = int(np.argmin(self._times))
                self._lib_sum = self._lib_cnt = 0
            return
        # monitoring phase
        self._lib_cnt += 1
        self._lib_sum += lib
        avg = self._lib_sum / self._lib_cnt
        if (self._lib_cnt >= self._min_samples and avg > 1.0
                and abs(lib - avg) > self._retrigger * avg):
            # high-imbalance drift: reassess the portfolio
            self._times[:] = np.inf
            self._phase = 0
            self._selected = None


class ExpertPolicy(SelectionPolicy):
    """[25]: fuzzy-logic selection.  First instance runs STATIC to baseline
    T_par and LIB; the second instance uses the *absolute* fuzzy system; later
    instances use the *differential* system on (dT_par, dLIB) to move along
    the portfolio's adaptivity ladder."""

    name = "ExpertSel"

    def __init__(self, n_actions: int = N_ALGORITHMS):
        self._initial = make_initial_system()
        self._diff = make_diff_system()
        self.n_actions = n_actions
        self.current = 0            # DLS_0 = STATIC
        self._t = 0
        self._first_time: Optional[float] = None
        self._prev_time: Optional[float] = None
        self._prev_lib: Optional[float] = None

    @property
    def learning_steps(self) -> int:
        return 1

    @property
    def learning(self) -> bool:
        return self._t < 1

    def decide(self) -> Decision:
        phase = "expert" if self._t > 0 else "explore"
        return Decision(action=self.current, phase=phase,
                        confidence=0.0 if self._t == 0 else 0.5)

    def feedback(self, decision: Decision, obs: Observation) -> None:
        loop_time, lib = obs.loop_time, obs.lib
        if self._t == 0:
            self._first_time = loop_time
            ladder = self._initial.infer(lib, 1.0)
            self.current = int(np.clip(round(ladder), 0, self.n_actions - 1))
        else:
            dT = loop_time / max(self._prev_time, 1e-12) - 1.0
            dLIB = lib - self._prev_lib
            step = self._diff.infer(dT, dLIB)
            self.current = int(np.clip(round(self.current + step),
                                       0, self.n_actions - 1))
        self._prev_time = loop_time
        self._prev_lib = lib
        self._t += 1


# ---------------------------------------------------------------------------
# RL-based policies (this paper)
# ---------------------------------------------------------------------------

class RLPolicy(SelectionPolicy):
    """Tabular RL over the portfolio with a pluggable reward signal.

    The registered reward function extracts a scalar (lower is better) from
    each ``Observation``; the Eq. 11 three-level tracker inside the agent
    maps it to r+/r0/r-.  ``reward`` may be any registry name ("LT", "LIB",
    "p95", "LT+LIB", ...) or a callable."""

    agent_cls = None  # type: ignore[assignment]

    def __init__(self, reward="LT", alpha: float = 0.5,
                 gamma: float = 0.5, alpha_decay: float = 0.05,
                 decay_mode: str = "subtractive", initial: int = 0,
                 n_actions: int = N_ALGORITHMS):
        self.reward_name = reward if isinstance(reward, str) else getattr(
            reward, "__name__", "custom")
        self._reward_fn = get_reward(reward)
        self.agent = self.agent_cls(n_actions=n_actions, alpha=alpha,
                                    gamma=gamma, alpha_decay=alpha_decay,
                                    decay_mode=decay_mode,
                                    initial_state=initial)

    @property
    def learning_steps(self) -> int:
        return self.agent.learning_steps

    @property
    def learning(self) -> bool:
        return self.agent.learning

    def decide(self) -> Decision:
        a = self.agent.select()
        if self.agent.learning:
            return Decision(action=a, phase="explore", confidence=0.0)
        row = self.agent.q[self.agent.state]
        margin = float(row.max() - np.partition(row, -2)[-2]) \
            if len(row) > 1 else 1.0
        conf = float(np.clip(margin / (abs(float(row.max())) + 1e-9), 0, 1))
        return Decision(action=a, phase="exploit", confidence=conf)

    def feedback(self, decision: Decision, obs: Observation) -> None:
        self.agent.observe(decision.action, self._reward_fn(obs))

    def state_dict(self) -> dict:
        return {"kind": self.name, "reward": self.reward_name,
                "agent": self.agent.state_dict()}

    def load_state_dict(self, state: dict, *,
                        skip_learning: bool = True) -> bool:
        self.agent.load_state_dict(state["agent"],
                                   skip_learning=skip_learning)
        return not self.agent.learning


class QLearnPolicy(RLPolicy):
    name = "QLearn"
    agent_cls = QLearnAgent


class SarsaPolicy(RLPolicy):
    name = "SARSA"
    agent_cls = SarsaAgent


# ---------------------------------------------------------------------------
# hybrid expert + RL (paper §6's combination, previously unbuildable)
# ---------------------------------------------------------------------------

class HybridPolicy(SelectionPolicy):
    """ExpertSel's fuzzy ladder seeds and bounds the RL agent's exploration.

    Phase 1 (``expert_steps`` instances): run the fuzzy ladder exactly like
    ExpertSel, letting published expert knowledge walk toward the right
    portfolio neighbourhood for the observed (T_par, LIB) regime.

    Phase 2: open a window of ``window`` algorithms around the ladder's
    final position and hand it to a tabular RL agent.  The explore-first
    Eulerian circuit then covers only ``window**2`` state-action pairs
    instead of the full ``n_actions**2`` (144), and the Q-table is seeded so
    greedy ties break toward the expert's pick.

    Defaults (6 expert + 5x5 RL = 31 instances) cut the paper's 28.8 %
    exploration cost (144 of 500) to ~6 % while keeping the asymptotic
    selection quality of pure Q-Learn whenever the optimum lies in the
    expert's neighbourhood — the paper's §6 argument for combining the two
    families."""

    name = "Hybrid"

    def __init__(self, reward="LT", agent: str = "qlearn",
                 expert_steps: int = 6, window: int = 5,
                 n_actions: int = N_ALGORITHMS, alpha: float = 0.5,
                 gamma: float = 0.5, alpha_decay: float = 0.05,
                 decay_mode: str = "subtractive"):
        if expert_steps < 1:
            raise ValueError("expert_steps must be >= 1")
        self.reward_name = reward if isinstance(reward, str) else getattr(
            reward, "__name__", "custom")
        self._reward_fn = get_reward(reward)
        self.n_actions = n_actions
        self.window = max(1, min(window, n_actions))
        self.expert_steps = expert_steps
        self._agent_kw = dict(alpha=alpha, gamma=gamma,
                              alpha_decay=alpha_decay, decay_mode=decay_mode)
        self._agent_cls = QLearnAgent if agent.lower() == "qlearn" \
            else SarsaAgent
        self._expert = ExpertPolicy(n_actions=n_actions)
        self.agent = None
        self.actions: List[int] = []    # RL-local index → portfolio index
        self._t = 0

    @property
    def learning_steps(self) -> int:
        return self.expert_steps + self.window * self.window

    @property
    def learning(self) -> bool:
        return self._t < self.learning_steps

    def _build_agent(self) -> None:
        """Bound the action set to a window around the expert's final ladder
        position and seed the Q-table toward its pick."""
        center = self._expert.current
        lo = int(np.clip(center - self.window // 2, 0,
                         self.n_actions - self.window))
        self.actions = list(range(lo, lo + self.window))
        self.agent = self._agent_cls(n_actions=self.window,
                                     initial_state=self.actions.index(
                                         min(self.actions,
                                             key=lambda a: abs(a - center))),
                                     **self._agent_kw)
        # seed: the expert's pick starts strictly above the 0-initialized
        # alternatives, so post-exploration greedy ties break toward it
        self.agent.q[:, self.actions.index(center) if center in self.actions
                     else 0] = REWARD_POSITIVE

    def decide(self) -> Decision:
        if self._t < self.expert_steps:
            d = self._expert.decide()
            return Decision(action=d.action, phase="expert",
                            confidence=d.confidence)
        if self.agent is None:
            self._build_agent()
        a_local = self.agent.select()
        phase = "explore" if self.agent.learning else "exploit"
        return Decision(action=self.actions[a_local], phase=phase,
                        confidence=0.0 if self.agent.learning else 1.0)

    def feedback(self, decision: Decision, obs: Observation) -> None:
        if self._t < self.expert_steps:
            self._expert.feedback(decision, obs)
            self._t += 1
            return
        if self.agent is None:
            self._build_agent()
        if decision.action in self.actions:
            a_local = self.actions.index(decision.action)
            self.agent.observe(a_local, self._reward_fn(obs))
        self._t += 1

    def state_dict(self) -> Optional[dict]:
        if self.agent is None:
            return None     # still in the expert phase: nothing worth keeping
        return {"kind": self.name, "reward": self.reward_name,
                "n_actions": self.n_actions, "t": self._t,
                "actions": list(self.actions),
                "agent": self.agent.state_dict()}

    def load_state_dict(self, state: dict, *,
                        skip_learning: bool = True) -> bool:
        # validate and restore into locals first: a corrupt snapshot must
        # leave the policy untouched (a half-assigned self.agent would
        # silently disable the expert-driven window rebuild)
        if int(state.get("n_actions", -1)) != self.n_actions:
            raise ValueError(
                f"snapshot was taken on a portfolio of "
                f"{state.get('n_actions')} actions, not {self.n_actions}; "
                f"its expert-bounded window would exclude the new actions")
        actions = [int(a) for a in state["actions"]]
        if not actions or any(a < 0 or a >= self.n_actions for a in actions):
            raise ValueError(f"stored action window {actions} is outside "
                             f"this portfolio (n_actions={self.n_actions})")
        agent = self._agent_cls(n_actions=len(actions), **self._agent_kw)
        agent.load_state_dict(state["agent"], skip_learning=skip_learning)
        self.actions = actions
        self.window = len(actions)
        self.agent = agent
        # the snapshot was taken post-expert-phase; keep the instance
        # counter consistent with the restored agent's position
        self._t = self.expert_steps + agent._t
        return not self.learning


# ---------------------------------------------------------------------------
# factory
# ---------------------------------------------------------------------------

def _pick(kw: Dict, *names: str) -> Dict:
    return {k: v for k, v in kw.items() if k in names}


def _reward_kw(kw: Dict) -> Dict:
    """Honour both the new ``reward=`` spelling and legacy ``reward_type=``."""
    out = {}
    reward = kw.get("reward", kw.get("reward_type"))
    if reward is not None:
        out["reward"] = reward
    return out


def make_policy(name: str, **kw) -> SelectionPolicy:
    """Build any selection policy by name (case-insensitive).

    Unknown keyword arguments are ignored per-policy, so one call site can
    pass a uniform kwargs dict for every method string it accepts."""
    name = name.lower()
    if name in ("fixed",):
        return FixedPolicy(kw["algorithm"])
    if name in ("randomsel", "random"):
        return RandomPolicy(seed=kw.get("seed", 0),
                            initial=kw.get("initial", 0),
                            n_actions=kw.get("n_actions", N_ALGORITHMS))
    if name in ("exhaustivesel", "exhaustive"):
        return ExhaustivePolicy(**_pick(kw, "lib_retrigger", "min_samples",
                                        "n_actions"))
    if name in ("expertsel", "expert"):
        return ExpertPolicy(**_pick(kw, "n_actions"))
    if name in ("qlearn", "q-learn", "q_learn"):
        return QLearnPolicy(**_pick(kw, "alpha", "gamma", "alpha_decay",
                                    "decay_mode", "initial", "n_actions"),
                            **_reward_kw(kw))
    if name in ("sarsa",):
        return SarsaPolicy(**_pick(kw, "alpha", "gamma", "alpha_decay",
                                   "decay_mode", "initial", "n_actions"),
                           **_reward_kw(kw))
    if name in ("hybrid", "hybridsel", "expert+rl", "expertrl"):
        return HybridPolicy(**_pick(kw, "agent", "expert_steps", "window",
                                    "alpha", "gamma", "alpha_decay",
                                    "decay_mode", "n_actions"),
                            **_reward_kw(kw))
    if name in ("oracle",):
        return OraclePolicy(kw["best_fn"])
    # simulation-assisted methods (SimAS-style; repro_torch.core.simpolicy) —
    # imported lazily, simpolicy imports the policies defined above; the
    # alias table lives there so is_sim_policy() and this factory agree
    from .simpolicy import _SIM_ALIASES, SimAssistedHybrid, SimPolicy
    canon = _SIM_ALIASES.get(name)
    if canon is not None:
        if "simulator" not in kw:
            raise ValueError(
                f"policy {name!r} needs a simulator= candidate pricer "
                f"(e.g. LoopWhatIf)")
        if canon in ("SimPolicy", "ReactiveSim", "AwareSim"):
            # AwareSim is a plain SimPolicy; its two-pass adaptive-surrogate
            # pricing lives in the lane's LoopWhatIf (campaign wiring keys on
            # the selector name)
            return SimPolicy(kw["simulator"],
                             reactive=(canon == "ReactiveSim"),
                             **_pick(kw, "candidates",
                                     "confidence_threshold", "n_actions",
                                     "fidelity_alpha", "detector"),
                             **_reward_kw(kw))
        return SimAssistedHybrid(kw["simulator"],
                                 reactive=(canon == "ReactiveHybrid"),
                                 **_pick(kw, "top_k", "agent", "expert_steps",
                                         "window", "alpha", "gamma",
                                         "alpha_decay", "decay_mode",
                                         "n_actions", "detector"),
                                 **_reward_kw(kw))
    # offline-trained learned methods (repro_torch.core.learned) — lazily
    # imported for the same reason; weights default to the process-wide
    # state (set_default_state / REPRO_LEARNED_STATE), cold policies fall
    # back to the expert ladder
    from .learned import _LEARNED_ALIASES, LearnedHybrid, LearnedPolicy
    canon = _LEARNED_ALIASES.get(name)
    if canon is not None:
        if canon == "Learned":
            return LearnedPolicy(**_pick(kw, "featurizer", "state",
                                         "n_actions", "horizon"),
                                 **_reward_kw(kw))
        return LearnedHybrid(**_pick(kw, "featurizer", "state", "top_k",
                                     "horizon", "agent", "expert_steps",
                                     "window", "alpha", "gamma",
                                     "alpha_decay", "decay_mode",
                                     "n_actions"),
                             **_reward_kw(kw))
    raise ValueError(f"unknown selection policy {name!r}; "
                     f"choose from {POLICY_NAMES}")


# ---------------------------------------------------------------------------
# DEPRECATED scalar shims — the pre-redesign ``select()/observe()`` surface.
# Kept so external callers and the original paper scripts keep working; new
# code should use ``make_policy`` / ``SelectionService.instance``.
# ---------------------------------------------------------------------------

class Selector:
    """Deprecated adapter: wraps a :class:`SelectionPolicy` behind the old
    ``select() -> int`` / ``observe(action, loop_time, lib)`` protocol."""

    name = "base"
    #: number of instances the method needs before it commits to a selection
    learning_steps = 0

    def __init__(self, policy: Optional[SelectionPolicy] = None):
        self.policy = policy
        if policy is not None:
            self.name = policy.name
            self.learning_steps = policy.learning_steps

    def select(self) -> int:
        if self.policy is None:  # pragma: no cover - abstract base
            raise NotImplementedError
        return self.policy.decide().action

    def observe(self, action: int, loop_time: float, lib: float) -> None:
        if self.policy is not None:
            self.policy.feedback(
                Decision(action=int(action)),
                Observation(loop_time=float(loop_time), lib=float(lib)))


class FixedSel(Selector):
    name = "Fixed"

    def __init__(self, algorithm: int):
        super().__init__(FixedPolicy(algorithm))
        self.algorithm = int(algorithm)


class OracleSel(Selector):
    name = "Oracle"

    def __init__(self, best_fn: Callable[[int], int]):
        super().__init__(OraclePolicy(best_fn))


class RandomSel(Selector):
    """Keeps the pre-redesign semantics exactly: the jump is rolled on every
    ``select()`` call and ``observe`` only updates the LIB signal.  The
    policy constructor already rolled once (for the first instance), so the
    first ``select()`` skips its roll — the RNG stream, and therefore every
    seeded trajectory, is identical to the original implementation."""

    name = "RandomSel"

    def __init__(self, seed: int = 0, initial: int = 0,
                 n_actions: int = N_ALGORITHMS):
        super().__init__(RandomPolicy(seed=seed, initial=initial,
                                      n_actions=n_actions))
        self._rolled = True     # the constructor's roll covers select() #1

    def select(self) -> int:
        if self._rolled:
            self._rolled = False
        else:
            self.policy._jump()
        return self.policy.current

    def observe(self, action: int, loop_time: float, lib: float) -> None:
        self.policy._lib = float(lib)


class ExhaustiveSel(Selector):
    name = "ExhaustiveSel"

    def __init__(self, lib_retrigger: float = 0.10, min_samples: int = 3,
                 n_actions: int = N_ALGORITHMS):
        super().__init__(ExhaustivePolicy(lib_retrigger=lib_retrigger,
                                          min_samples=min_samples,
                                          n_actions=n_actions))


class ExpertSel(Selector):
    name = "ExpertSel"

    def __init__(self):
        super().__init__(ExpertPolicy())


class QLearnSel(Selector):
    name = "QLearn"

    def __init__(self, reward_type: str = "LT", **kw):
        super().__init__(make_policy("qlearn", reward=reward_type, **kw))
        self.reward_type = reward_type
        self.agent = self.policy.agent


class SarsaSel(Selector):
    name = "SARSA"

    def __init__(self, reward_type: str = "LT", **kw):
        super().__init__(make_policy("sarsa", reward=reward_type, **kw))
        self.reward_type = reward_type
        self.agent = self.policy.agent


def make_selector(name: str, **kw) -> Selector:
    """Deprecated: build a scalar-protocol ``Selector``.  Use
    ``make_policy`` (or ``SelectionService``) instead."""
    warnings.warn("make_selector() is deprecated; use make_policy() or "
                  "SelectionService.instance()", DeprecationWarning,
                  stacklevel=2)
    name_l = name.lower()
    if name_l in ("fixed",):
        return FixedSel(kw["algorithm"])
    if name_l in ("oracle",):
        return OracleSel(kw["best_fn"])
    if name_l in ("randomsel", "random"):
        return RandomSel(seed=kw.get("seed", 0),
                         n_actions=kw.get("n_actions", N_ALGORITHMS))
    if name_l in ("qlearn", "q-learn", "q_learn"):
        return QLearnSel(reward_type=kw.get("reward_type",
                                            kw.get("reward", "LT")),
                         **_pick(kw, "alpha", "gamma", "alpha_decay",
                                 "decay_mode", "n_actions"))
    if name_l in ("sarsa",):
        return SarsaSel(reward_type=kw.get("reward_type",
                                           kw.get("reward", "LT")),
                        **_pick(kw, "alpha", "gamma", "alpha_decay",
                                "decay_mode", "n_actions"))
    return Selector(make_policy(name, **kw))
