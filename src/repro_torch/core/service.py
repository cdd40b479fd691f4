"""Per-region selection service (LB4OMP's loop-id mechanism, paper §3.1/§3.5).

LB4OMP assigns a unique id to every ``schedule(runtime)`` loop so that each
loop learns independently.  ``SelectionService`` mirrors that — callers
register a region id (an OpenMP loop in the simulator, a jitted step in the
autotuner, a dispatch queue in serving) and get an isolated
:class:`~repro_torch.core.api.SelectionPolicy` — and adds the two paper
extensions the old begin/end registry could not reach:

* **structured instances** — the context-manager API hands out a
  :class:`Decision` and accepts a full :class:`Observation`::

      service = SelectionService("Hybrid", reward="LT")
      with service.instance("gravity") as inst:
          a = inst.action                  # or inst.decision for phase etc.
          res = execute(a)
          inst.report(loop_time=res.loop_time, lib=res.lib)

* **per-region policy overrides** — heterogeneous regions can run
  different methods under one service (``overrides={"io_loop": {"method":
  "ExhaustiveSel"}}`` or ``service.set_policy(region, "SARSA", ...)``);

* **automatic Q-table warm start (paper §5)** — with ``store_dir`` set,
  region policies are restored from disk keyed by (region, system
  fingerprint) when first touched, and persisted by ``save()`` (or on exit
  when the service is used as a context manager).  A restored Q-Learn /
  SARSA / Hybrid region skips its explore-first phase entirely — the
  paper's 28.8 % exploration cost drops to zero on re-runs.

The pre-redesign ``begin(region) -> int`` / ``end(region, action, lt, lib)``
calls survive as deprecated shims over the same machinery.
"""

from __future__ import annotations

import zlib
from collections import deque
from dataclasses import dataclass, field, replace
from typing import Dict, Hashable, List, Optional, Tuple

from .api import Decision, Observation, SelectionPolicy, make_policy
from .persistence import (load_policy_state, save_policy_state,
                          system_fingerprint)
from .simpolicy import resolve_sim_policy


def _stable_region_seed(seed: int, region: Hashable) -> int:
    """De-correlate per-region RNG streams *reproducibly*: ``hash()`` of a
    string varies per process under salted hashing, so use a stable CRC-32
    digest of the region id instead."""
    digest = zlib.crc32(repr(region).encode("utf-8"))
    return (int(seed) * 0x9E3779B1 + digest) % (2 ** 31)


#: full Observations kept per region for introspection are bounded to this
#: window (they can carry per-PE time vectors); ``history`` keeps only the
#: compact (action, loop_time, lib) tuple per instance and is deliberately
#: unbounded — campaign-length consumers read it in full.
OBSERVATION_WINDOW = 1024


@dataclass
class RegionRecord:
    policy: SelectionPolicy
    history: List[Tuple[int, float, float]] = field(default_factory=list)
    # (chosen algorithm, loop_time, lib) per instance
    observations: "deque[Observation]" = field(
        default_factory=lambda: deque(maxlen=OBSERVATION_WINDOW))
    instances: int = 0
    warm_started: bool = False


class RegionInstance:
    """One region instance: a decision to act on, and a place to report the
    outcome.  Created by ``SelectionService.instance``; committing the
    feedback happens on ``__exit__`` (or an explicit ``close()``)."""

    def __init__(self, service: "SelectionService", region: Hashable,
                 record: RegionRecord):
        self._service = service
        self._region = region
        self._record = record
        self.decision: Decision = record.policy.decide()
        self._obs: Optional[Observation] = None
        self._done = False

    @property
    def region(self) -> Hashable:
        return self._region

    @property
    def action(self) -> int:
        return self.decision.action

    def report(self, loop_time: Optional[float] = None,
               lib: Optional[float] = None, *,
               throughput: Optional[float] = None,
               tail_latency: Optional[float] = None,
               pe_times=None, observation: Optional[Observation] = None
               ) -> Observation:
        """Attach the measured outcome.  Either pass a ready-made
        ``observation`` or the individual signals; ``pe_times`` alone is
        enough (makespan / Eq. 8 LIB / p95 are derived, but any signal the
        caller supplies explicitly wins over the derived value)."""
        if observation is not None:
            if observation.instance < 0:
                observation = replace(observation,
                                      instance=self._record.instances)
            self._obs = observation
        elif pe_times is not None:
            extra = {"throughput": throughput,
                     "instance": self._record.instances}
            if loop_time is not None:
                extra["loop_time"] = float(loop_time)
            if lib is not None:
                extra["lib"] = float(lib)
            if tail_latency is not None:
                extra["tail_latency"] = tail_latency
            self._obs = Observation.from_pe_times(pe_times, **extra)
        else:
            if loop_time is None:
                raise ValueError("report() needs loop_time, pe_times, or a "
                                 "full observation")
            self._obs = Observation(
                loop_time=float(loop_time),
                lib=0.0 if lib is None else float(lib),
                throughput=throughput, tail_latency=tail_latency,
                pe_times=None if pe_times is None else tuple(pe_times),
                instance=self._record.instances)
        return self._obs

    def close(self) -> None:
        """Commit the feedback (no-op if nothing was reported — the decision
        is then treated as a peek, like the old lone ``begin()``)."""
        if self._done or self._obs is None:
            self._done = True
            return
        self._done = True
        self._service._complete(self._region, self.decision, self._obs)

    def __enter__(self) -> "RegionInstance":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()


class SelectionService:
    """Multiplexes independent selection policies over region ids."""

    def __init__(self, method: Optional[str] = None,
                 reward: Optional[str] = None,
                 store_dir: Optional[str] = None,
                 system: Optional[str] = None,
                 overrides: Optional[Dict[Hashable, Dict]] = None,
                 **policy_kw):
        # no explicit method: honour the REPRO_SIM_POLICY env override (a
        # simulation-assisted default needs a ``simulator=`` in policy_kw)
        self._method = method if method is not None \
            else resolve_sim_policy("QLearn")
        self._kw = dict(policy_kw)
        if reward is not None:
            self._kw["reward"] = reward
        self._regions: Dict[Hashable, RegionRecord] = {}
        self._overrides: Dict[Hashable, Dict] = dict(overrides or {})
        self.store_dir = store_dir
        self.system = system or system_fingerprint()

    # -- region setup -------------------------------------------------------
    def set_policy(self, region: Hashable, method: str, **kw) -> None:
        """Override the policy for one region (before its first instance)."""
        if region in self._regions:
            raise ValueError(f"region {region!r} already has a live policy")
        self._overrides[region] = {"method": method, **kw}

    def _record(self, region: Hashable) -> RegionRecord:
        if region not in self._regions:
            spec = dict(self._overrides.get(region, {}))
            method = spec.pop("method", self._method)
            kw = {**self._kw, **spec}
            if "seed" in kw:
                kw["seed"] = _stable_region_seed(kw["seed"], region)
            rec = RegionRecord(policy=make_policy(method, **kw))
            if self.store_dir is not None:
                try:
                    stored = load_policy_state(self.store_dir, str(region),
                                               self.system)
                except (ValueError, OSError, TypeError):
                    stored = None       # corrupt/unreadable snapshot
                rec.warm_started = self._try_warm_start(rec.policy, stored)
            self._regions[region] = rec
        return self._regions[region]

    @staticmethod
    def _try_warm_start(policy: SelectionPolicy,
                        stored: Optional[Dict]) -> bool:
        """Restore ``policy`` from a stored record only when it is actually
        compatible: same method, same reward objective, same table shape.
        Any mismatch (e.g. the plan portfolio grew since the snapshot) is a
        cache miss — start cold rather than exploit a stale table."""
        if stored is None or stored.get("method") != policy.name:
            return False
        state = stored.get("state") or {}
        want = getattr(policy, "reward_name", None)
        got = state.get("reward")
        if want is not None and got is not None and \
                str(got).lower() != str(want).lower():
            return False
        try:
            return policy.load_state_dict(state)
        except (KeyError, ValueError, TypeError):
            return False

    # -- the instance API ---------------------------------------------------
    def instance(self, region: Hashable) -> RegionInstance:
        """Open one region instance; use as a context manager (feedback is
        committed on exit once ``report`` was called)."""
        return RegionInstance(self, region, self._record(region))

    def _complete(self, region: Hashable, decision: Decision,
                  obs: Observation) -> None:
        rec = self._regions[region]
        rec.policy.feedback(decision, obs)
        rec.history.append((decision.action, obs.loop_time, obs.lib))
        rec.observations.append(obs)
        rec.instances += 1

    # -- introspection ------------------------------------------------------
    def policy(self, region: Hashable) -> SelectionPolicy:
        """The region's policy — instantiated (and warm-started, with a
        store_dir) on first touch, so peeking ``policy(r).decide()`` works
        before any instance runs."""
        return self._record(region).policy

    def warm_started(self, region: Hashable) -> bool:
        return self._record(region).warm_started

    def history(self, region: Hashable):
        """Read-only: empty for regions that never ran an instance (does not
        instantiate the region's policy as a side effect)."""
        rec = self._regions.get(region)
        return rec.history if rec is not None else []

    @property
    def regions(self):
        return list(self._regions)

    # -- persistence (paper §5) ---------------------------------------------
    def save(self) -> List[str]:
        """Persist every stateful region policy, keyed by (region, system
        fingerprint).  Returns the written paths."""
        if self.store_dir is None:
            raise ValueError("SelectionService was created without store_dir")
        paths = []
        for region, rec in self._regions.items():
            state = rec.policy.state_dict()
            if state is None:
                continue
            paths.append(save_policy_state(
                {"method": rec.policy.name, "state": state,
                 "instances": rec.instances},
                self.store_dir, str(region), self.system))
        return paths

    def __enter__(self) -> "SelectionService":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None and self.store_dir is not None:
            self.save()

    # -- DEPRECATED scalar shims --------------------------------------------
    def begin(self, region: Hashable) -> int:
        """Deprecated: use ``instance``.  Returns the portfolio (or plan)
        index to use for the next region instance."""
        return self._record(region).policy.decide().action

    def end(self, region: Hashable, action: int, loop_time: float,
            lib: float) -> None:
        """Deprecated: use ``instance``/``report``."""
        rec = self._record(region)
        self._complete(region, Decision(action=int(action)),
                       Observation(loop_time=float(loop_time),
                                   lib=float(lib),
                                   instance=rec.instances))
