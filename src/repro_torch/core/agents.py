"""Tabular model-free RL agents (paper §3.4-3.5): Q-Learn and SARSA.

State  = currently selected scheduling algorithm (12 states)
Action = next scheduling algorithm            (12 actions)
→ 144 state-action pairs, Q-table initialized to 0.

Explore-first policy: before exploiting, visit *every* (state, action)
transition once — an Eulerian circuit over the complete digraph with
self-loops on 12 nodes (144 edges → 144 learning loop-instances, i.e. 28.8 %
of a 500-step run, exactly the paper's figure).

Updates (Eqs. 9-10):

    SARSA:   Q(s,a) += alpha * (r + gamma * Q(s',a')        - Q(s,a))
    Q-Learn: Q(s,a) += alpha * (r + gamma * max_a' Q(s',a') - Q(s,a))

alpha = gamma = 0.5 by default; alpha decays by ``alpha_decay`` after the
learning phase (KMP_RL_ALPHA_DECAY = 0.05).  The paper does not specify the
decay operator; we default to the subtractive reading with a floor, and make
it configurable (see DESIGN.md §8).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

from .portfolio import N_ALGORITHMS
from .rewards import RewardTracker


def explore_first_sequence(n: int = N_ALGORITHMS, start: int = 0) -> List[int]:
    """Eulerian circuit on the complete digraph with self-loops on ``n`` nodes.

    Returns the sequence of *actions* (length n*n) such that, starting from
    ``start``, every ordered pair (state, action) — including self-pairs — is
    visited exactly once.  Hierholzer's algorithm; deterministic.
    """
    # remaining out-edges per node, popped in descending order so that the
    # walk tends to return to the start node last.
    out = {u: list(range(n)) for u in range(n)}
    stack = [start]
    circuit: List[int] = []
    while stack:
        u = stack[-1]
        if out[u]:
            v = out[u].pop()
            stack.append(v)
        else:
            circuit.append(stack.pop())
    circuit.reverse()          # node sequence of length n*n + 1, starts at `start`
    assert circuit[0] == start and len(circuit) == n * n + 1
    return circuit[1:]         # the actions taken from each successive state


@dataclass
class TabularAgent:
    """Shared machinery for Q-Learn / SARSA over the portfolio."""

    n_actions: int = N_ALGORITHMS
    alpha: float = 0.5
    gamma: float = 0.5
    alpha_decay: float = 0.05
    alpha_min: float = 0.0
    decay_mode: str = "subtractive"  # or "multiplicative"
    reward: RewardTracker = field(default_factory=RewardTracker)
    initial_state: int = 0

    def __post_init__(self) -> None:
        self.q = np.zeros((self.n_actions, self.n_actions), dtype=np.float64)
        self.state = self.initial_state
        self._explore = explore_first_sequence(self.n_actions,
                                               start=self.initial_state)
        self._t = 0  # loop-instance counter

    # -- policy -------------------------------------------------------------
    @property
    def learning(self) -> bool:
        return self._t < len(self._explore)

    @property
    def learning_steps(self) -> int:
        return len(self._explore)

    def select(self) -> int:
        """Action for the next loop instance."""
        if self.learning:
            return self._explore[self._t]
        return self._greedy(self.state)

    def _greedy(self, s: int) -> int:
        row = self.q[s]
        return int(np.argmax(row))  # first max wins ties (portfolio order)

    # -- learning -------------------------------------------------------------
    def observe(self, action: int, x: float) -> None:
        """Reward observation ``x`` (LT seconds or LIB %) for the instance just
        executed with ``action``; performs the TD update and advances state."""
        r = self.reward.reward(x)
        s, a = self.state, action
        s_next = action  # the executed algorithm becomes the new state
        target = r + self.gamma * self._bootstrap(s_next)
        self.q[s, a] += self.alpha * (target - self.q[s, a])
        self.state = s_next
        was_learning = self.learning
        self._t += 1
        if not was_learning and self.alpha_decay > 0.0:
            if self.decay_mode == "subtractive":
                self.alpha = max(self.alpha_min, self.alpha - self.alpha_decay)
            else:
                self.alpha = max(self.alpha_min,
                                 self.alpha * (1.0 - self.alpha_decay))

    def _bootstrap(self, s_next: int) -> float:  # pragma: no cover
        raise NotImplementedError

    # -- persistence (paper §5 warm start) ------------------------------------
    def state_dict(self) -> dict:
        """JSON-serializable snapshot: Q-table, reward extrema, position."""
        lo, hi = self.reward.extrema
        return {
            "kind": type(self).__name__,
            "n_actions": self.n_actions,
            "alpha": self.alpha, "gamma": self.gamma,
            "alpha_decay": self.alpha_decay,
            "initial_state": int(self.initial_state),
            "state": int(self.state),
            "instances": self._t,
            "q": np.asarray(self.q).tolist(),
            "reward_min": None if not np.isfinite(lo) else lo,
            "reward_max": None if not np.isfinite(hi) else hi,
            "reward_count": self.reward.count,
        }

    def load_state_dict(self, rec: dict, *, skip_learning: bool = True
                        ) -> None:
        """Restore a ``state_dict`` snapshot.

        With ``skip_learning`` (the paper-§5 warm start) the agent resumes
        at the snapshot's instance count: a fully-trained snapshot skips the
        whole explore-first phase (28.8 % cost → 0), while a snapshot saved
        *mid-learning* resumes exploration where it stopped rather than
        freezing a near-empty Q-table into greedy exploitation forever.
        With ``skip_learning=False`` the explore-first phase is replayed
        from scratch over the restored table."""
        # validate everything into locals first: a truncated/hand-edited
        # record must leave the agent untouched, not half-restored
        q = np.asarray(rec["q"], dtype=np.float64)
        if q.shape != self.q.shape:
            raise ValueError(f"stored Q-table shape {q.shape} does not match "
                             f"agent shape {self.q.shape}")
        state = int(rec["state"])
        alpha = float(rec["alpha"])
        t = int(rec.get("instances", len(self._explore))) if skip_learning \
            else 0
        # the explore-first Eulerian circuit depends on the start node; a
        # mid-learning snapshot must resume on the circuit it was saved on
        initial_state = int(rec.get("initial_state", self.initial_state))
        reward_min = rec.get("reward_min")
        reward_max = rec.get("reward_max") if reward_min is not None else None
        reward_count = int(rec.get("reward_count", 1))

        self.q = q
        self.state = state
        self.alpha = alpha
        if initial_state != self.initial_state:
            self.initial_state = initial_state
            self._explore = explore_first_sequence(self.n_actions,
                                                   start=initial_state)
        if reward_min is not None:
            self.reward._min = reward_min
            self.reward._max = reward_max
            self.reward.count = reward_count
        self._t = t


class QLearnAgent(TabularAgent):
    """Eq. 10 — off-policy: bootstrap with max_a' Q(s', a')."""

    def _bootstrap(self, s_next: int) -> float:
        return float(self.q[s_next].max())


class SarsaAgent(TabularAgent):
    """Eq. 9 — on-policy: bootstrap with Q(s', a') for the action the current
    policy would take in s' (greedy / next explore-first action)."""

    def _bootstrap(self, s_next: int) -> float:
        t_next = self._t + 1
        if t_next < len(self._explore):
            a_next = self._explore[t_next]
        else:
            a_next = self._greedy(s_next)
        return float(self.q[s_next, a_next])
