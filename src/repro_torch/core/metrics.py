"""Load-imbalance and variability metrics (paper Eq. 8 and Table 2).

These operate on per-PE *finishing times* (simulator / serving rounds) or any
per-worker load vector (e.g. per-expert token counts in MoE — the L2/L3
adaptations).  Pure functions over numpy arrays; the port's own copy of
``repro.core.metrics``.  :func:`xla_row_mean` is the row mean of the
batched simulator's ``lib``, summed in the order of the reference's
compiled float32 code.
"""

from __future__ import annotations

import numpy as np
import torch


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


#: window of XLA's tree-reduction rewrite of a long reduce on the CPU
XLA_REDUCE_WINDOW = 32


def xla_row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the order of XLA's CPU code, so that a
    float32 sum rounds as the reference's ``jnp.sum`` does.

    XLA sums a row of n <= 32 values one after another from 0.  A longer
    row is rewritten as a reduce-window: the row is zero-padded to a
    multiple of 32 (half the padding in front, the odd one behind), each
    window of 32 is summed in order, and the window sums are reduced the
    same way."""
    n = x.shape[-1]
    w = XLA_REDUCE_WINDOW
    if n > w:
        n_win = -(-n // w)
        pad = n_win * w - n
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        return xla_row_sum(xla_row_sum(
            x.reshape(x.shape[:-1] + (n_win, w))))
    out = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for j in range(n):
        out = out + x[..., j]
    return out


def xla_row_mean(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mean`` over the last axis as XLA computes it on the CPU: the
    sum of :func:`xla_row_sum` times the float32 reciprocal of n (XLA
    rewrites the division by a constant into that product)."""
    n = x.shape[-1]
    return xla_row_sum(x) * (torch.ones((), dtype=x.dtype, device=x.device)
                             / n)
