"""Load-imbalance and variability metrics (paper Eq. 8 and Table 2).

These operate on per-PE *finishing times* (simulator / serving rounds) or any
per-worker load vector (e.g. per-expert token counts in MoE — the L2/L3
adaptations).  Pure functions over numpy arrays; the port's own copy of
``repro.core.metrics``.
"""

from __future__ import annotations

import numpy as np


def percent_load_imbalance(finish_times) -> float:
    """LIB, Eq. 8: (1 - mean/max) * 100.  Used by RandomSel (P_j = LIB/10)
    and as the RL `LIB` reward input."""
    ft = np.asarray(finish_times, dtype=np.float64)
    mx = float(ft.max())
    if mx <= 0.0:
        return 0.0
    return (1.0 - float(ft.mean()) / mx) * 100.0


def execution_imbalance(finish_times) -> float:
    """Table 2 metric (deRose et al. [16]): (max-mean)/max * P/(P-1) * 100."""
    ft = np.asarray(finish_times, dtype=np.float64)
    P = ft.shape[-1]
    mx = float(ft.max())
    if mx <= 0.0 or P <= 1:
        return 0.0
    return (mx - float(ft.mean())) / mx * (P / (P - 1.0)) * 100.0


def coefficient_of_variation(times) -> float:
    """Fig. 4: std of loop execution times across portfolio / mean."""
    t = np.asarray(times, dtype=np.float64)
    m = float(t.mean())
    if m <= 0.0:
        return 0.0
    return float(t.std()) / m
