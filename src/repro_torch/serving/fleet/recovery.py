"""Fault recovery for fleet serving: retry, hedge, migrate, dead-letter —
the port's copy of ``repro.serving.fleet.recovery``.

The fleet's fault model (see :mod:`repro_torch.sim.perturb`) injects wall-clock
:class:`~repro_torch.sim.perturb.ReplicaFailure` / ``ReplicaStraggler`` events.
This module is the *policy* layer deciding what happens to the work those
events touch:

* **retry with capped exponential backoff** — a request whose shard was
  interrupted by a whole-group failure (or cancelled by its per-dispatch
  ``timeout`` deadline) re-enters the pending queue at
  ``t_fail + backoff(attempt)`` and is re-routed through the ordinary
  :class:`~repro_torch.serving.fleet.router.RouterPolicy` pricing path —
  with a ``WhatIfRouter`` that means recovery decisions are what-if-priced
  too;
* **hedged duplicates** — a retried request can additionally be dispatched
  as a single-request mini-dispatch on the best *other* routable group;
  first finish wins and the loser's service time is refunded to its
  replica (``hedge=True``);
* **migration** — ``migrate=True`` (default) lets the router re-place
  retried work on any routable group; ``migrate=False`` pins each retry to
  the group that failed (work returns only when the group rejoins) — this
  is the recovery-*off* baseline that recovery is compared against;
* **load shedding** — with ``shed_wait`` set, requests that have already
  waited longer than the bound are dead-lettered deterministically at wave
  formation instead of being admitted into a fleet that cannot meet its
  SLO (graceful degradation, never a livelock);
* **dead-lettering** — a request that exhausts ``max_retries`` is recorded
  in the dead-letter ledger with its reason.  The fleet's accounting
  invariant is: every admitted request is completed exactly once OR
  dead-lettered, never lost and never double-counted —
  :meth:`RecoveryLedger.check` enforces it at the end of every run.

Backoff jitter is *stateless*: a CRC-32 fold of ``(seed, rid, attempt)``,
so resuming a journaled run replays identical retry times with no RNG
cursor to checkpoint.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

__all__ = ["RecoveryPolicy", "RecoveryLedger", "RetryEntry",
           "BASELINE_RECOVERY"]


@dataclass(frozen=True)
class RecoveryPolicy:
    """Knobs for the fleet's fault-recovery behavior.

    ``timeout``
        Per-dispatch service deadline in seconds: a request whose shard is
        predicted to drain later than ``dispatch + timeout`` is cancelled
        at the deadline and retried (the group's chunk work is sunk — only
        the completion is voided).  ``None`` disables deadlines.
    ``max_retries``
        Retry budget per request; exceeding it dead-letters the request.
        A negative budget means unbounded (the recovery-off baseline, where
        interrupted work must eventually complete on its own group).
    ``backoff_base`` / ``backoff_factor`` / ``backoff_cap`` / ``jitter``
        Capped exponential backoff: attempt ``a`` waits
        ``min(cap, base * factor**a) * (1 + jitter * u(rid, a))`` with a
        stateless uniform ``u`` in [0, 1).
    ``hedge``
        Dispatch retried requests twice (primary shard + a single-request
        hedge on the best other routable group); first finish wins, the
        losing hedge's cost is refunded.
    ``migrate``
        Allow retried work to be re-routed to other groups.  ``False``
        pins retries to the failed group (rejoin-and-replay baseline).
    ``visible``
        Whether routers/admission see the failure state (routable mask and
        degraded per-group capacity).  The recovery-off baseline runs
        blind: it keeps routing into the failed group's void.
    ``shed_wait``
        Dead-letter pending requests that have waited longer than this
        (seconds) at wave formation.  ``None`` never sheds.
    """

    timeout: Optional[float] = None
    max_retries: int = 3
    backoff_base: float = 0.02
    backoff_factor: float = 2.0
    backoff_cap: float = 0.5
    jitter: float = 0.0
    hedge: bool = False
    migrate: bool = True
    visible: bool = True
    shed_wait: Optional[float] = None

    def __post_init__(self):
        if self.timeout is not None and self.timeout <= 0.0:
            raise ValueError("timeout must be positive (or None)")
        if self.backoff_base < 0.0 or self.backoff_cap < 0.0:
            raise ValueError("backoff terms must be non-negative")

    def backoff(self, rid: int, attempt: int, seed: int = 0) -> float:
        """Deterministic capped exponential backoff for retry ``attempt``
        (1-based) of request ``rid``."""
        base = min(self.backoff_cap,
                   self.backoff_base * self.backoff_factor ** (attempt - 1))
        if self.jitter <= 0.0 or base <= 0.0:
            return base
        digest = zlib.crc32(f"{seed}|{rid}|{attempt}".encode("utf-8"))
        u = digest / 2 ** 32
        return base * (1.0 + self.jitter * u)

    def exhausted(self, attempt: int) -> bool:
        """True once ``attempt`` retries have failed and the budget is
        spent (never, for the unbounded baseline)."""
        return self.max_retries >= 0 and attempt > self.max_retries


#: recovery-off physics: interrupted work is NOT abandoned (the accounting
#: invariant still holds) — it replays on its own group when the group
#: rejoins, with no deadline, no re-routing, no failure-aware view.  This
#: is what ``FleetSimulator(recovery=None)`` runs under fault injection,
#: and the baseline that recovery is measured against.
BASELINE_RECOVERY = RecoveryPolicy(timeout=None, max_retries=-1,
                                   backoff_base=0.0, backoff_cap=0.0,
                                   hedge=False, migrate=False, visible=False,
                                   shed_wait=None)


@dataclass(frozen=True)
class RetryEntry:
    """One queued retry: request ``rid`` becomes dispatchable at ``ready``;
    ``seq`` breaks ties deterministically (FIFO per ready instant);
    ``pin_group`` forces the retry back onto one group (``migrate=False``)."""

    ready: float
    seq: int
    rid: int
    attempt: int
    pin_group: Optional[int] = None

    def sort_key(self) -> Tuple[float, int]:
        return (self.ready, self.seq)


@dataclass
class RecoveryLedger:
    """Accounting of every recovery action in one fleet run."""

    attempts: Dict[int, int] = field(default_factory=dict)
    dead: Dict[int, str] = field(default_factory=dict)     # rid -> reason
    retries: int = 0
    interrupted: int = 0
    timeouts: int = 0
    migrated: int = 0
    hedges: int = 0
    hedge_wins: int = 0
    shed: int = 0

    def attempt_of(self, rid: int) -> int:
        return self.attempts.get(rid, 0)

    def record_retry(self, rid: int) -> int:
        """Bump and return the request's attempt counter."""
        a = self.attempts.get(rid, 0) + 1
        self.attempts[rid] = a
        self.retries += 1
        return a

    def dead_letter(self, rid: int, reason: str) -> None:
        self.dead[rid] = reason

    def summary(self) -> Dict:
        reasons: Dict[str, int] = {}
        for r in self.dead.values():
            reasons[r] = reasons.get(r, 0) + 1
        return {"retries": self.retries, "interrupted": self.interrupted,
                "timeouts": self.timeouts, "migrated": self.migrated,
                "hedges": self.hedges, "hedge_wins": self.hedge_wins,
                "shed": self.shed, "dead_lettered": len(self.dead),
                "dead_by_reason": reasons}

    def check(self, n: int, completed: int) -> None:
        """The trust anchor: completed + dead-lettered == admitted."""
        if completed + len(self.dead) != n:
            raise AssertionError(
                f"fleet accounting broken: {completed} completed + "
                f"{len(self.dead)} dead-lettered != {n} admitted")
