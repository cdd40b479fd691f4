"""Closed forms of the reference engine — the part of
``repro.sim.backends.python`` the batched engine hands off to.

Two execution paths need no event loop:

* ``STATIC`` — closed form over pre-assigned (contiguous or round-robin)
  ranges; no dispatch events.
* constant-chunk closed form — SS / StaticSteal whose chunk floor would
  generate more than ``EVENT_CAP`` dispatch events (e.g. SS on STREAM's 2e9
  iterations: the paper's orders-of-magnitude blowup, computed analytically).

They stay numpy on the host, driven by the same numpy rng streams as the
reference, so these results are bit-identical to it.  Both engines share
them: the batched one (``torch_batched``) and the Python event loop
(``python``), which runs everything else on the host.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ...core.metrics import percent_load_imbalance
from .base import (InstancePerturb, combined_pe_scale, needs_closed_form,
                   sigma_scale_of)

H_ATOMIC_ADAPTIVE = 2.0      # h multiplier for atomic-path adaptive algs (C/E/mAF)
MUTEX_ADAPTIVE = {7, 9}      # AWF-B, AWF-D: mutex-protected weight updates


@dataclass
class InstanceResult:
    loop_time: float
    finish: np.ndarray
    n_chunks: int
    lib: float = field(init=False)
    chunk_sizes: Optional[List[int]] = None

    def __post_init__(self):
        self.lib = percent_load_imbalance(self.finish)


def _thread_speeds(system, rng, perturb=None) -> np.ndarray:
    """Per-PE execution-time multipliers: the stochastic spread draw (always
    consumed, so perturbed runs never shift the noise stream), times any
    heterogeneity / injected perturbation.  The clip applies only to the
    stochastic part — persistent slow PEs and failures must not be clipped
    back to 1.25x."""
    s = 1.0 + rng.normal(0.0, system.speed_spread, system.P)
    s = np.clip(s, 0.8, 1.25)
    scale = combined_pe_scale(system, perturb)
    if scale is not None:
        s = s * scale
    return s


def _h_eff(system, alg_idx: int) -> float:
    if alg_idx in MUTEX_ADAPTIVE:
        return system.h * system.h_adaptive_mult
    if alg_idx in (8, 10, 11):          # AWF-C/E, mAF (atomic path)
        return system.h * H_ATOMIC_ADAPTIVE
    return system.h


def run_closed_form(profile, system, alg_idx: int, chunk_param: int, rng,
                    record_chunks: bool = False,
                    perturb: Optional[InstancePerturb] = None
                    ) -> InstanceResult:
    """STATIC, or SS / StaticSteal past ``EVENT_CAP``: the reference's
    closed forms on the caller's numpy rng."""
    if alg_idx == 0:
        return _run_static(profile, system, chunk_param, rng, record_chunks,
                           perturb)
    if not needs_closed_form(alg_idx, profile.N, chunk_param):
        raise ValueError(f"algorithm {alg_idx} with chunk {chunk_param} on "
                         f"N={profile.N} needs the event loop")
    return _run_constant_closed(profile, system, alg_idx,
                                max(1, chunk_param), rng, perturb)


# ---------------------------------------------------------------------------
# STATIC: pre-assigned ranges, no dispatch events
# ---------------------------------------------------------------------------

def _run_static(profile, system, chunk_param, rng, record_chunks,
                perturb=None):
    P, N, mb = system.P, profile.N, profile.memory_bound
    jitter = rng.uniform(0.0, system.jitter, P)
    speed = _thread_speeds(system, rng, perturb)

    if chunk_param <= 0:
        # P contiguous ranges of ceil/floor(N/P)
        bounds = np.linspace(0, N, P + 1).round().astype(np.int64)
        cost = np.diff(profile.prefix(bounds))
        n_chunks = P
        per_pe_chunks = np.ones(P)
        sizes = np.diff(bounds).tolist() if record_chunks else None
    else:
        c = min(chunk_param, N)
        n_chunks = -(-N // c)
        if profile.uniform and n_chunks > 2_000_000:
            # analytic round-robin on a uniform profile
            base = np.full(P, profile.total / P)
            cost = base
            per_pe_chunks = np.full(P, n_chunks / P)
            sizes = None
        else:
            bounds = np.arange(0, N + c, c, dtype=np.int64)
            bounds[-1] = N
            chunk_cost = np.diff(profile.prefix(bounds))
            pe = np.arange(n_chunks) % P
            cost = np.bincount(pe, weights=chunk_cost, minlength=P)
            per_pe_chunks = np.bincount(pe, minlength=P).astype(np.float64)
            sizes = np.diff(bounds).tolist() if record_chunks else None
    # interleaved static chunks restart memory streams at every boundary and
    # lose within-window reuse when chunks are smaller than c_loc (no dynamic
    # first-touch loss though: the assignment repeats every time-step)
    if chunk_param > 0:
        infl = 1.0 + profile.locality_sens * system.loc_amp * (
            profile.c_loc / (chunk_param + profile.c_loc))
    else:
        infl = 1.0
    boundary = mb * system.boundary_cost * per_pe_chunks
    agg_noise = np.exp(rng.normal(
        0.0, system.noise_sigma * 0.5 * sigma_scale_of(perturb), P))
    finish = jitter + (cost * infl * speed * agg_noise) + boundary
    return InstanceResult(loop_time=float(finish.max()), finish=finish,
                          n_chunks=int(n_chunks), chunk_sizes=sizes)


# ---------------------------------------------------------------------------
# constant-chunk closed form (SS / StaticSteal with tiny chunks on huge N)
# ---------------------------------------------------------------------------

def _run_constant_closed(profile, system, alg_idx, c, rng, perturb=None):
    P, N, mb = system.P, profile.N, profile.memory_bound
    ls = profile.locality_sens
    n_chunks = -(-N // c)
    h = _h_eff(system, alg_idx)
    work = profile.total * system.chunk_inflation(ls, c, profile.c_loc)
    overhead_par = n_chunks * (h + mb * system.boundary_cost) / P
    if alg_idx == 1:
        # SS hits ONE central queue: beyond saturation the critical section
        # serializes and the dispatch cost stops dividing by P (the paper's
        # orders-of-magnitude blowup on STREAM).
        overhead = max(overhead_par, n_chunks * h * system.h_serial_frac)
    else:
        # StaticSteal: per-thread deques, no central serialization
        overhead = n_chunks * (h * 0.6 + mb * system.boundary_cost) / P
    # tiny-chunk self-scheduling rebalances perfectly, so heterogeneity /
    # perturbation enters as aggregate capacity (sum of PE rates), not as a
    # per-PE finish multiplier; uniform scales reduce to the exact work / P
    scale = combined_pe_scale(system, perturb)
    if scale is None:
        base = work / P + overhead
    else:
        base = work / float((1.0 / scale).sum()) + overhead
    jitter = rng.uniform(0.0, system.jitter, P)
    speed = _thread_speeds(system, rng)
    agg_noise = np.exp(rng.normal(
        0.0, system.noise_sigma * 0.3 * sigma_scale_of(perturb), P))
    # self-scheduling balances up to one chunk of spread
    tail = rng.uniform(0.0, 1.0, P) * (work / n_chunks + h)
    finish = jitter.mean() + base * speed * agg_noise + tail
    return InstanceResult(loop_time=float(finish.max()), finish=finish,
                          n_chunks=int(n_chunks))
