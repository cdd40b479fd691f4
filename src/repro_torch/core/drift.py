"""Online drift detection for the reactive sim-assisted policies.

A Page-Hinkley test over a scalar observation stream: the classic two-sided
CUSUM-style detector used by streaming-ML selection literature.  The reactive
policies (``repro_torch.core.simpolicy``) feed it the log surrogate-fidelity ratio
(measured / predicted cost) or the live reward stream; a detection means the
world the simulator was calibrated against has shifted — re-price the
candidate set, re-prune the exploration window, drop stale corrections.

The detector is deliberately tiny and dependency-free: it keeps a running
mean and two cumulative deviation sums, flags when either drifts more than
``threshold`` past its historical extremum, and resets itself on detection
so repeated drifts are each reported once.
"""

from __future__ import annotations

__all__ = ["PageHinkley"]


class PageHinkley:
    """Two-sided Page-Hinkley change detector.

    ``update(x)`` returns True when the stream's mean has shifted (either
    direction) by more than ``delta`` per step accumulated past
    ``threshold``, after at least ``min_obs`` observations.  On detection
    the internal state resets, so the detector re-arms for the next shift.
    """

    def __init__(self, delta: float = 0.05, threshold: float = 0.6,
                 min_obs: int = 8):
        self.delta = float(delta)
        self.threshold = float(threshold)
        self.min_obs = int(min_obs)
        self.n_detections = 0
        self.reset()

    def reset(self) -> None:
        self._n = 0
        self._mean = 0.0
        self._sum_up = 0.0      # cumulative positive deviation (mean rose)
        self._min_up = 0.0
        self._sum_dn = 0.0      # cumulative negative deviation (mean fell)
        self._max_dn = 0.0

    def update(self, x: float) -> bool:
        x = float(x)
        self._n += 1
        self._mean += (x - self._mean) / self._n
        dev = x - self._mean
        self._sum_up += dev - self.delta
        self._min_up = min(self._min_up, self._sum_up)
        self._sum_dn += dev + self.delta
        self._max_dn = max(self._max_dn, self._sum_dn)
        if self._n < self.min_obs:
            return False
        if (self._sum_up - self._min_up > self.threshold
                or self._max_dn - self._sum_dn > self.threshold):
            self.n_detections += 1
            self.reset()
            return True
        return False
