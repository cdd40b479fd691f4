"""Replayable arrival traces — the fleet's stand-in for millions of users;
the port's copy of ``repro.serving.fleet.traces``, the same traces field
for field and the same ``signature``.

An :class:`ArrivalTrace` is a fully materialized, deterministic request
stream: heterogeneous Pareto-tailed prompt/gen lengths (the serving
adaptation's imbalance source, shared with ``data.pipeline``) under a
pluggable arrival *process*.  Every generator is a pure function of
``(kind, n, seed, params)`` — replaying a trace is just calling
:func:`make_trace` with the same arguments, and every random field draws
from its own named substream (:func:`~repro_torch.data.pipeline.field_rng`), so
arrival times are bit-identical across length re-parameterizations.

Three processes cover the regimes the router study needs:

``poisson``
    Constant-rate exponential gaps — the stationary baseline (exactly
    ``data.pipeline.synthetic_requests``).
``bursty``
    2-state MMPP: a background rate with exponential-gap arrivals, and a
    burst state at ``burst_factor`` times that rate; state dwell times are
    geometric in *arrivals* (per-arrival Markov switching).  This is the
    non-stationary regime where what-if-priced routing pays: bursts leave
    replica groups unevenly loaded, so busy-state-blind policies misroute.
``diurnal``
    Sinusoidal rate ``base_rate * (1 + amplitude * sin(2*pi*t/period))``
    realized by thinning a max-rate Poisson stream — the slow day/night
    swing over which per-region selection policies must re-adapt.
"""

from __future__ import annotations

import json
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List

import numpy as np

from ...data.pipeline import Request, field_rng, synthetic_requests


@dataclass
class ArrivalTrace:
    """A materialized request stream: ``requests`` are arrival-sorted and
    ``rid``-indexed 0..n-1.  ``kind``/``seed``/``params`` are the complete
    replay recipe (``make_trace(kind, n, seed, **params)`` rebuilds the
    trace bit-identically)."""

    kind: str
    seed: int
    requests: List[Request]
    params: Dict = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.requests)

    @property
    def signature(self) -> str:
        """Stable digest of the replay recipe — the run journal records it
        so a snapshot can never be resumed under a different trace."""
        ident = json.dumps([self.kind, self.seed, len(self.requests),
                            sorted((k, repr(v))
                                   for k, v in self.params.items())])
        return f"{self.kind}-{zlib.crc32(ident.encode('utf-8')):08x}"

    @property
    def duration(self) -> float:
        """Span of the arrival process (time of the last arrival)."""
        return self.requests[-1].arrival if self.requests else 0.0

    @property
    def mean_rate(self) -> float:
        return len(self.requests) / max(self.duration, 1e-12)

    def offered_tokens(self) -> int:
        return sum(r.prompt_len + r.gen_len for r in self.requests)


def poisson_trace(n: int, seed: int = 0, rate: float = 256.0,
                  mean_prompt: int = 512, mean_gen: int = 128,
                  heavy_tail: float = 1.3) -> ArrivalTrace:
    """Stationary Poisson arrivals at ``rate`` requests/second."""
    reqs = synthetic_requests(n, seed=seed, mean_prompt=mean_prompt,
                              mean_gen=mean_gen, heavy_tail=heavy_tail,
                              arrival_rate=rate)
    return ArrivalTrace("poisson", seed, reqs,
                        {"rate": rate, "mean_prompt": mean_prompt,
                         "mean_gen": mean_gen, "heavy_tail": heavy_tail})


def _mmpp_states(n: int, rng: np.random.Generator, p_enter: float,
                 p_exit: float) -> np.ndarray:
    """Per-arrival 2-state Markov chain (0 = background, 1 = burst),
    vectorized as alternating geometric dwell counts."""
    states = np.empty(n, dtype=np.int8)
    filled = 0
    state = 0
    while filled < n:
        # geometric dwell (in arrivals) before switching out of `state`
        p = p_enter if state == 0 else p_exit
        dwell = int(rng.geometric(min(max(p, 1e-9), 1.0)))
        take = min(dwell, n - filled)
        states[filled:filled + take] = state
        filled += take
        state = 1 - state
    return states


def bursty_trace(n: int, seed: int = 0, base_rate: float = 256.0,
                 burst_factor: float = 8.0, p_enter: float = 0.02,
                 p_exit: float = 0.1, mean_prompt: int = 512,
                 mean_gen: int = 128, heavy_tail: float = 1.3
                 ) -> ArrivalTrace:
    """2-state MMPP arrivals: background ``base_rate`` with bursts at
    ``burst_factor *  base_rate``; expected dwell is ``1/p_enter`` arrivals
    of background per ``1/p_exit`` arrivals of burst."""
    rng = field_rng(seed, "arrival")
    states = _mmpp_states(n, rng, p_enter, p_exit)
    rates = np.where(states == 1, base_rate * burst_factor, base_rate)
    arrivals = np.cumsum(rng.exponential(1.0, n) / rates)
    reqs = synthetic_requests(n, seed=seed, mean_prompt=mean_prompt,
                              mean_gen=mean_gen, heavy_tail=heavy_tail,
                              arrivals=arrivals)
    return ArrivalTrace("bursty", seed, reqs,
                        {"base_rate": base_rate, "burst_factor": burst_factor,
                         "p_enter": p_enter, "p_exit": p_exit,
                         "mean_prompt": mean_prompt, "mean_gen": mean_gen,
                         "heavy_tail": heavy_tail})


def diurnal_trace(n: int, seed: int = 0, base_rate: float = 256.0,
                  amplitude: float = 0.8, period: float = 120.0,
                  mean_prompt: int = 512, mean_gen: int = 128,
                  heavy_tail: float = 1.3) -> ArrivalTrace:
    """Sinusoidal-rate arrivals via thinning: candidates at the peak rate
    ``base_rate * (1 + amplitude)``, each kept with probability
    ``rate(t) / peak`` — an exact non-homogeneous Poisson realization."""
    if not 0.0 <= amplitude < 1.0:
        raise ValueError("diurnal amplitude must be in [0, 1)")
    rng = field_rng(seed, "arrival")
    peak = base_rate * (1.0 + amplitude)
    arrivals = np.empty(0)
    t = 0.0
    while len(arrivals) < n:
        m = max(1024, int((n - len(arrivals)) * (1.0 + amplitude) * 1.2))
        cand = t + np.cumsum(rng.exponential(1.0 / peak, m))
        rate = base_rate * (1.0 + amplitude
                            * np.sin(2.0 * np.pi * cand / period))
        keep = rng.random(m) < rate / peak
        arrivals = np.concatenate([arrivals, cand[keep]])
        t = float(cand[-1])
    arrivals = arrivals[:n]
    reqs = synthetic_requests(n, seed=seed, mean_prompt=mean_prompt,
                              mean_gen=mean_gen, heavy_tail=heavy_tail,
                              arrivals=arrivals)
    return ArrivalTrace("diurnal", seed, reqs,
                        {"base_rate": base_rate, "amplitude": amplitude,
                         "period": period, "mean_prompt": mean_prompt,
                         "mean_gen": mean_gen, "heavy_tail": heavy_tail})


#: registry of trace generators (the fleet benchmark and CLI key off these)
TRACE_KINDS: Dict[str, Callable[..., ArrivalTrace]] = {
    "poisson": poisson_trace,
    "bursty": bursty_trace,
    "diurnal": diurnal_trace,
}


def make_trace(kind: str, n: int, seed: int = 0, **params) -> ArrivalTrace:
    """Build (or replay) a trace by kind name."""
    try:
        gen = TRACE_KINDS[kind.lower()]
    except KeyError:
        raise ValueError(f"unknown trace kind {kind!r}; "
                         f"available: {sorted(TRACE_KINDS)}") from None
    return gen(n, seed=seed, **params)
