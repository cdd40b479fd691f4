"""Reward function (paper §3.5, Eq. 11).

Two reward *types* feed the same three-level reward:

    LT  — loop (step / round) execution time
    LIB — percent load imbalance, Eq. 8

        R_t(x) = r+   if x <= min_t(x)      (new best)
                 r0   if min < x < max      (neutral)
                 r-   if x >= max_t(x)      (new worst)

min/max are running extrema over all *previously observed* instances of the
loop.  Paper values: r+ = 0.01 (not 0, to stay distinguishable from the
Q-table's 0 init), r0 = -2.0, r- = -4.0.

The LT/LIB *signal extraction* that used to be hard-coded here is now the
pluggable reward registry in :mod:`repro_torch.core.api` (``@register_reward``):
any ``Observation -> float`` (lower is better) can feed this tracker, so
LT/LIB generalize to p95 tail latency, LT+LIB blends, throughput, etc.
``REWARD_TYPES`` is kept for the legacy two-string surface.
"""

from __future__ import annotations

from dataclasses import dataclass, field

REWARD_POSITIVE = 0.01
REWARD_NEUTRAL = -2.0
REWARD_NEGATIVE = -4.0

REWARD_TYPES = ("LT", "LIB")


@dataclass
class RewardTracker:
    """Running min/max extrema + Eq. 11 mapping for one loop id."""

    r_pos: float = REWARD_POSITIVE
    r_neu: float = REWARD_NEUTRAL
    r_neg: float = REWARD_NEGATIVE
    _min: float = field(default=float("inf"))
    _max: float = field(default=float("-inf"))
    count: int = 0

    def reward(self, x: float) -> float:
        """Return Eq. 11 reward for observation ``x`` and fold it into the
        running extrema.  The first observation is a new best → r+."""
        if self.count == 0:
            r = self.r_pos
        elif x <= self._min:
            r = self.r_pos
        elif x >= self._max:
            r = self.r_neg
        else:
            r = self.r_neu
        self._min = min(self._min, x)
        self._max = max(self._max, x)
        self.count += 1
        return r

    @property
    def extrema(self):
        return self._min, self._max
