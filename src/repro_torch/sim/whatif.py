"""Loop-instance candidate pricing for simulation-assisted selection.

:class:`LoopWhatIf` is the DES-side *candidate simulator* behind
``repro_torch.core.simpolicy``: a replay lane binds the current loop profile with
``set_context`` before consulting its policy, and ``price`` evaluates every
candidate (algorithm x chunk-parameter variant) through ONE
``SimBackend.run_batch`` call on a noise-free copy of the machine model —
deterministic predictions whose argmin coincides with the Oracle's choice on
noise-free cells (test-enforced, on the CPU and on the card).

Pricing never touches the lane's live rng stream: candidate runs draw from a
fixed stateless seed, so wiring a ``SimPolicy`` lane into a lockstep replay
leaves every other lane — and the lane's own noise trajectory — bit-exact.

Perturbation awareness: ``set_context`` also accepts the step's resolved
:class:`~repro_torch.sim.backends.base.InstancePerturb`.  The default pricer stays
deliberately BLIND to it — a surrogate is calibrated against the nominal
machine, and unannounced perturbations are exactly the drift the reactive
policies must detect from live feedback.  With ``two_pass=True`` the pricer
runs the two-pass adaptive-surrogate scheme instead: a clean pass first
(kept in :attr:`last_clean` — the AWF/mAF weight re-estimation baseline),
then a perturbed re-simulation whose prices are returned (the ``AwareSim``
lane wiring).
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import List, Optional, Sequence

from ..core import exp_chunk
from ..core.api import Observation
from ..core.simpolicy import Candidate, SimUnavailable
from .backends import InstancePerturb, InstanceSpec, get_backend
from .workloads import profile_digest

#: constant stateless seed for candidate pricing runs (the noise-free system
#: leaves almost nothing for it to draw; determinism is what matters)
_PRICE_SEED = (0x51A5,)

#: priced candidate sets kept per (profile, chunk-context) — sphynx-style
#: time-varying apps produce one entry per time step, so bound it
_CACHE_SIZE = 512


def noise_free(system):
    """The deterministic twin of a machine model: same dispatch overheads and
    locality costs, zero stochastic terms (persistent ``pe_speeds``
    heterogeneity is *kept* — it is structure, not noise)."""
    return dataclasses.replace(system, noise_sigma=0.0, jitter=0.0,
                               speed_spread=0.0)


class LoopWhatIf:
    """Prices ``SimPolicy`` candidates for DES loop instances.

    One instance serves a whole replay lane: the lane re-binds the current
    loop with ``set_context(profile, chunk_param, perturb)`` before each
    decision and every candidate is evaluated against that context.
    ``backend`` is any ``get_backend`` name/instance (the lane's
    ``sim_backend``); on the batched torch engine the full candidate set
    is one device call (``None``: the torch engine on the card).
    """

    def __init__(self, system, backend=None, deterministic: bool = True,
                 two_pass: bool = False):
        self.bk = get_backend(backend)
        self.system = noise_free(system) if deterministic else system
        self.two_pass = bool(two_pass)
        self._profile = None
        self._chunk_param = 0
        self._perturb: Optional[InstancePerturb] = None
        #: clean-pass prices from the last two-pass ``price`` call (the
        #: adaptive-surrogate baseline); None outside two-pass operation
        self.last_clean: Optional[List[Observation]] = None
        self._cache: "OrderedDict[tuple, List[Observation]]" = OrderedDict()
        #: ``price`` calls, the cache misses among them (one ``run_batch``
        #: each; two-pass calls may miss twice), and their wall time on the
        #: host clock (synchronized: ``run_batch`` returns host arrays)
        self.calls = 0
        self.misses = 0
        self.wall_s = 0.0

    # -- context ------------------------------------------------------------
    def set_context(self, profile, chunk_param: int = 0,
                    perturb: Optional[InstancePerturb] = None) -> None:
        """Bind the loop instance the next ``price`` calls are about."""
        self._profile = profile
        self._chunk_param = int(chunk_param)
        self._perturb = None if (perturb is not None
                                 and perturb.neutral) else perturb

    # -- the candidate-simulator protocol -----------------------------------
    def candidates(self) -> List[Candidate]:
        """All 12 algorithms under the context's default chunk parameter,
        plus their expChunk variants when that differs — LB4OMP's full
        selection portfolio."""
        if self._profile is None:
            raise SimUnavailable("LoopWhatIf has no loop context bound")
        from ..core import N_ALGORITHMS
        out = [Candidate(a) for a in range(N_ALGORITHMS)]
        ec = exp_chunk(self._profile.N, self.system.P)
        if ec != self._chunk_param:
            out += [Candidate(a, ec) for a in range(N_ALGORITHMS)]
        return out

    def _priced(self, p, resolved, perturb: Optional[InstancePerturb]
                ) -> List[Observation]:
        # profile_digest covers the prefix-grid *content* — mean-normalized
        # patterns share N*unit totals across time steps, so cheap fields
        # alone would alias genuinely different load distributions.  The
        # perturbation key keeps perturbed prices from aliasing clean ones.
        key = (p.name, profile_digest(p), p.unit, p.memory_bound,
               p.locality_sens, p.c_loc, resolved,
               None if perturb is None else perturb.key())
        hit = self._cache.get(key)
        if hit is not None:
            self._cache.move_to_end(key)
            return hit
        self.misses += 1
        specs = [InstanceSpec(profile_id=0, alg=a, chunk_param=cp,
                              seed=_PRICE_SEED + (a, cp), perturb=perturb)
                 for a, cp in resolved]
        res = self.bk.run_batch([p], self.system, specs)
        out = [Observation(loop_time=float(t), lib=float(b))
               for t, b in zip(res.loop_time, res.lib)]
        self._cache[key] = out
        if len(self._cache) > _CACHE_SIZE:
            self._cache.popitem(last=False)
        return out

    def price(self, cands: Sequence[Candidate]) -> List[Observation]:
        """Predicted (loop_time, lib) per candidate via one batched
        noise-free ``run_batch`` on the configured backend (two when
        ``two_pass`` is on under an active perturbation)."""
        if self._profile is None:
            raise SimUnavailable("LoopWhatIf has no loop context bound")
        t0 = time.perf_counter()
        try:
            return self._price(cands)
        finally:
            self.calls += 1
            self.wall_s += time.perf_counter() - t0

    def _price(self, cands: Sequence[Candidate]) -> List[Observation]:
        p = self._profile
        resolved = tuple(
            (c.alg, self._chunk_param if c.chunk_param is None
             else int(c.chunk_param)) for c in cands)
        if self.two_pass and self._perturb is not None:
            # two-pass adaptive surrogate: simulate clean, let the backend
            # re-estimate the adaptive algorithms' per-PE weights from the
            # perturbed speeds, re-simulate perturbed; the clean pass is the
            # re-estimation baseline callers can diff against
            self.last_clean = self._priced(p, resolved, None)
            return self._priced(p, resolved, self._perturb)
        # default pricer: BLIND to execution-side perturbations (a surrogate
        # is calibrated against the nominal machine; unannounced slowdowns
        # are exactly what the reactive policies must detect live)
        self.last_clean = None
        return self._priced(p, resolved, None)
