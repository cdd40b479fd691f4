"""Minimal Mamdani fuzzy-inference engine for ExpertSel (paper §3.2, [25]).

[25] uses two fuzzy systems: one mapping *absolute* (T_par, LIB) to an initial
scheduling-algorithm class, and one mapping *changes* (dT_par, dLIB) to a move
along the portfolio's adaptivity ladder.  The exact rule tables live in [25]
(not reprinted in this paper); the rules below encode the same published
expert knowledge: low imbalance → static/low-overhead, moderate → dynamic
non-adaptive, high → adaptive; worsening time after a switch → step back.

Triangular memberships, max-min inference, centroid defuzzification.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple


def tri(x: float, a: float, b: float, c: float) -> float:
    """Triangular membership with peak at b; shoulders clamp at the ends."""
    if x <= a:
        return 1.0 if a == b else 0.0
    if x >= c:
        return 1.0 if b == c else 0.0
    if x < b:
        return (x - a) / (b - a) if b > a else 1.0
    return (c - x) / (c - b) if c > b else 1.0


@dataclass
class FuzzyVar:
    name: str
    terms: Dict[str, Tuple[float, float, float]]

    def fuzzify(self, x: float) -> Dict[str, float]:
        return {t: tri(x, *abc) for t, abc in self.terms.items()}


class FuzzySystem:
    """rules: list of ((term_for_input0, term_for_input1, ...), output_center).
    Inference: firing = min of input memberships; output = centroid of
    firing-weighted output centers."""

    def __init__(self, inputs: Sequence[FuzzyVar],
                 rules: Sequence[Tuple[Tuple[str, ...], float]]):
        self.inputs = list(inputs)
        self.rules = list(rules)

    def infer(self, *xs: float) -> float:
        assert len(xs) == len(self.inputs)
        memberships = [v.fuzzify(x) for v, x in zip(self.inputs, xs)]
        num = den = 0.0
        for terms, center in self.rules:
            w = min(memberships[i][t] for i, t in enumerate(terms))
            num += w * center
            den += w
        return num / den if den > 0 else 0.0


# ---------------------------------------------------------------------------
# The two ExpertSel systems.  Output domain = portfolio index ladder
# [0 STATIC .. 11 mAF] (DLS_0..DLS_n axis of [25]).
# ---------------------------------------------------------------------------

LIB_VAR = FuzzyVar("LIB", {
    "low": (0.0, 0.0, 10.0),
    "moderate": (5.0, 20.0, 40.0),
    "high": (25.0, 100.0, 100.0),
})

TPAR_VAR = FuzzyVar("Tpar_rel", {     # T_par normalized by the first instance
    "low": (0.0, 0.0, 0.9),
    "moderate": (0.8, 1.0, 1.3),
    "high": (1.2, 3.0, 3.0),
})

# initial selection: LIB x Tpar -> algorithm-class center on the ladder
INITIAL_RULES = [
    (("low", "low"), 0.0),        # balanced & fast -> STATIC
    (("low", "moderate"), 0.0),
    (("low", "high"), 3.0),       # balanced but slow -> low-overhead dynamic
    (("moderate", "low"), 2.0),   # GSS
    (("moderate", "moderate"), 5.0),   # TSS/StaticSteal region
    (("moderate", "high"), 6.0),  # mFAC2
    (("high", "low"), 8.0),       # adaptive AWF
    (("high", "moderate"), 9.5),
    (("high", "high"), 11.0),     # severe imbalance -> mAF
]

DT_VAR = FuzzyVar("dT", {            # relative change of T_par (x_t/x_{t-1} - 1)
    "better": (-1.0, -1.0, -0.02),
    "same": (-0.05, 0.0, 0.05),
    "worse": (0.02, 1.0, 1.0),
})

DLIB_VAR = FuzzyVar("dLIB", {        # change of LIB in percentage points
    "down": (-100.0, -100.0, -1.0),
    "same": (-3.0, 0.0, 3.0),
    "up": (1.0, 100.0, 100.0),
})

# differential system: (dT, dLIB) -> ladder step in [-2, +2]
DIFF_RULES = [
    (("better", "down"), 0.0),    # improving: keep
    (("better", "same"), 0.0),
    (("better", "up"), 1.0),      # faster but imbalance creeping: adapt a bit
    (("same", "down"), 0.0),
    (("same", "same"), 0.0),
    (("same", "up"), 1.0),
    (("worse", "down"), -1.0),    # slower though balanced: overhead — step back
    (("worse", "same"), -1.0),
    (("worse", "up"), 2.0),       # slower and more imbalanced: jump to adaptive
]


def make_initial_system() -> FuzzySystem:
    return FuzzySystem([LIB_VAR, TPAR_VAR], INITIAL_RULES)


def make_diff_system() -> FuzzySystem:
    return FuzzySystem([DT_VAR, DLIB_VAR], DIFF_RULES)
