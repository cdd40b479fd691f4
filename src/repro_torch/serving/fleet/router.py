"""Routing policies over continuous-batching replica groups — the port's
copy of ``repro.serving.fleet.router``.

A router turns one fleet admission wave into per-group request shards:
``route(requests, view) -> List[List[Request]]`` (one, possibly empty, shard
per replica group).  ``view`` is the fleet's dispatch-time snapshot (a
:class:`~repro_torch.serving.fleet.simulator.FleetView`): per-group busy
offsets, the shared replica cost model, and the batched what-if pricing
hook.

``RoundRobinRouter`` and ``LeastOutstandingRouter`` are the classic
load-balancing baselines.  ``WhatIfRouter`` is the simulation-assisted one:
it builds a small set of candidate *partitions* of the wave, prices every
(replica-group, algorithm, chunk) assignment of every partition through ONE
batched ``what_if_routes`` call (SimAS-style consultation; on the batched
backend one ``event_finish`` launch on the card), and commits to the
partition with the lowest predicted fleet completion.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Type, Union

import numpy as np

from ...core import exp_chunk
from ...data.pipeline import Request


def request_cost(r: Request, cost) -> float:
    """Marginal predicted service seconds of one request under the replica
    cost model (the per-dispatch fixed term is amortized over a whole chunk
    and excluded here)."""
    return cost.per_token * (r.prompt_len + r.gen_len) + cost.per_request


def _routable_index(view) -> Optional[np.ndarray]:
    """Indices of the groups this wave may dispatch to, or ``None`` when
    every group is routable (the clean, bit-identical path).  A fleet view
    without failure awareness (``routable is None``) routes everywhere."""
    mask = getattr(view, "routable", None)
    if mask is None or bool(np.all(mask)):
        return None
    idx = np.flatnonzero(np.asarray(mask, dtype=bool))
    if idx.size == 0:
        raise ValueError("route() called with no routable group")
    return idx


def _subview(view, idx: np.ndarray):
    """The fleet view restricted to the routable groups ``idx``."""
    return dataclasses.replace(
        view, busy=[view.busy[int(g)] for g in idx],
        capacity=None if view.capacity is None else view.capacity[idx],
        routable=None)


def _scatter(shards: List[List[Request]], idx: np.ndarray, G: int
             ) -> List[List[Request]]:
    """Re-place sub-fleet shards onto the full group axis (dead groups get
    empty shards)."""
    out: List[List[Request]] = [[] for _ in range(G)]
    for k, g in enumerate(idx):
        out[int(g)] = shards[k]
    return out


class RouterPolicy:
    """Protocol: stateful per-fleet routing policy."""

    name = "router"

    def route(self, requests: List[Request], view) -> List[List[Request]]:
        raise NotImplementedError

    # journalable state (crash-safe resume): stateless routers return {}
    def state_dict(self) -> Dict:
        return {}

    def load_state_dict(self, state: Dict) -> None:
        pass


class RoundRobinRouter(RouterPolicy):
    """Stripe requests over the groups in arrival order, carrying the
    cursor across waves — size- and busy-state-blind.  With a failure-aware
    view, dead groups are simply skipped in the stripe."""

    name = "round_robin"

    def __init__(self):
        self._cursor = 0

    def route(self, requests: List[Request], view) -> List[List[Request]]:
        G = len(view.busy)
        idx = _routable_index(view)
        lanes = np.arange(G) if idx is None else idx
        L = len(lanes)
        shards: List[List[Request]] = [[] for _ in range(G)]
        for j, r in enumerate(requests):
            shards[int(lanes[(self._cursor + j) % L])].append(r)
        self._cursor = (self._cursor + len(requests)) % L
        return shards

    def state_dict(self) -> Dict:
        return {"cursor": int(self._cursor)}

    def load_state_dict(self, state: Dict) -> None:
        self._cursor = int(state.get("cursor", 0))


class LeastOutstandingRouter(RouterPolicy):
    """Join-shortest-queue on predicted outstanding work: each request (in
    arrival order) goes to the group with the least outstanding service
    seconds, counting both the busy-state and what this wave already
    assigned — size-aware, but blind to chunked-dispatch dynamics."""

    name = "least_outstanding"

    def route(self, requests: List[Request], view) -> List[List[Request]]:
        G = len(view.busy)
        load = np.array([b.sum() for b in view.busy])
        # on a skewed fleet the same request costs more service seconds on
        # a slowed group (capacity < 1); uniform fleets take the exact
        # historical path
        slow = (np.ones(G) if getattr(view, "capacity", None) is None
                else 1.0 / np.maximum(np.asarray(view.capacity), 1e-9))
        idx = _routable_index(view)
        if idx is not None:
            dead = np.ones(G, dtype=bool)
            dead[idx] = False
            load[dead] = np.inf         # JSQ never joins a dead group
        shards: List[List[Request]] = [[] for _ in range(G)]
        for r in requests:
            g = int(np.argmin(load))
            shards[g].append(r)
            load[g] += request_cost(r, view.cost) * slow[g]
        return shards


class WhatIfRouter(RouterPolicy):
    """What-if-priced routing: choose among candidate partitions of the
    admission wave by predicted fleet completion.

    Candidate partitions (the routing search space, all O(n) to build):

    - ``stripe``   — round-robin striping (the baseline itself);
    - ``lpt``      — longest-processing-time greedy onto the least-loaded
      group (size- and busy-aware);
    - ``waterfill``— contiguous shards sized to equalize predicted per-group
      work including the carried busy-state;
    - ``focus``    — the whole wave to the least-busy group (wins when the
      wave is small against the busy-state spread).

    Every (partition, group) shard is priced for every candidate
    ``(algorithm, chunk)`` in one batched ``what_if_routes`` call against
    the group's *current* busy offsets; a partition's predicted completion
    is the max over groups of the per-shard minimum (the group's own
    sim-assisted policy picks its algorithm, so the achievable makespan is
    the candidate-set argmin).  One consultation per admission wave.

    ``algs`` defaults to a pruned pricing portfolio spread across the
    static-to-dynamic axis — STATIC / GSS / TSS / mFAC2 — which ranks
    partitions as well as the full set at a quarter of the schedule-building
    cost; pass ``range(12)`` to price every portfolio algorithm.
    """

    name = "whatif"

    #: default pricing portfolio: a static/dynamic/adaptive spread with
    #: O(P log N) chunk counts (no SS chunk-of-1 rows, no steal replays)
    PRICING_ALGS = (0, 2, 4, 6)

    def __init__(self, algs: Optional[Sequence[int]] = None,
                 chunk_variants: bool = True):
        self.algs = list(algs) if algs is not None else list(self.PRICING_ALGS)
        self.chunk_variants = chunk_variants
        #: last wave's (partition -> predicted completion), for
        #: introspection and tests
        self.last_prices: Dict[str, float] = {}
        self.choices: List[str] = []

    # -- candidate partitions ------------------------------------------------
    def _partitions(self, requests: List[Request], view
                    ) -> Dict[str, List[List[Request]]]:
        G = len(view.busy)
        costs = np.array([request_cost(r, view.cost) for r in requests])
        base = np.array([b.sum() for b in view.busy])

        stripe: List[List[Request]] = [[] for _ in range(G)]
        for j, r in enumerate(requests):
            stripe[j % G].append(r)

        # LPT greedy: heaviest first onto the least-loaded group, shards
        # restored to arrival order
        lpt_idx: List[List[int]] = [[] for _ in range(G)]
        load = base.copy()
        for j in np.argsort(-costs, kind="stable"):
            g = int(np.argmin(load))
            lpt_idx[g].append(int(j))
            load[g] += costs[j]
        lpt = [[requests[j] for j in sorted(ix)] for ix in lpt_idx]

        # waterfill: contiguous arrival-order shards sized so that
        # busy + shard work equalizes across groups
        total = base.sum() + costs.sum()
        cap = np.maximum(total / G - base, 0.0)
        cap = cap / cap.sum() if cap.sum() > 0 else np.full(G, 1.0 / G)
        cuts = np.searchsorted(np.cumsum(costs),
                               np.cumsum(cap)[:-1] * costs.sum())
        water = [list(s) for s in np.split(np.asarray(requests, dtype=object),
                                           cuts)]

        focus: List[List[Request]] = [[] for _ in range(G)]
        focus[int(np.argmin([b.max() for b in view.busy]))] = list(requests)

        return {"stripe": stripe, "lpt": lpt, "waterfill": water,
                "focus": focus}

    # -- routing -------------------------------------------------------------
    def route(self, requests: List[Request], view) -> List[List[Request]]:
        G = len(view.busy)
        idx = _routable_index(view)
        if idx is not None:
            # price partitions over the live sub-fleet only; dead groups
            # receive empty shards (their queued work was already migrated)
            shards = self.route(requests, _subview(view, idx))
            return _scatter(shards, idx, G)
        if not requests or G == 1:
            return [list(requests)] + [[] for _ in range(G - 1)]
        parts = self._partitions(requests, view)

        slots: List[Tuple[str, int]] = []      # (partition, group) per slot
        prefixes: List[np.ndarray] = []
        avails: List[np.ndarray] = []
        cands: List[Tuple[int, int, int]] = []
        for pname, shards in parts.items():
            for g, shard in enumerate(shards):
                if not shard:
                    continue
                slot = len(slots)
                slots.append((pname, g))
                pref = view.cost_prefix(shard)
                if getattr(view, "capacity", None) is not None:
                    # a slowed group serves the same shard 1/capacity times
                    # slower — scale its what-if cost prefix so the pricing
                    # pass sees the perturbed fleet, not the nominal one
                    pref = pref * (1.0 / float(view.capacity[g]))
                prefixes.append(pref)
                avails.append(view.busy[g])
                chunks = [0]
                if self.chunk_variants:
                    ec = exp_chunk(len(shard), view.n_replicas)
                    if ec != 0:
                        chunks.append(ec)
                cands.extend((slot, a, cp) for a in self.algs
                             for cp in chunks)

        mks = view.price_routes(prefixes, avails, cands)
        best_slot = np.full(len(slots), np.inf)
        for (slot, _a, _cp), mk in zip(cands, mks):
            best_slot[slot] = min(best_slot[slot], mk)

        completion = {p: max(b.max(initial=0.0) for b in view.busy)
                      for p in parts}  # floor: groups left untouched drain
        for (pname, g), mk in zip(slots, best_slot):
            completion[pname] = max(completion[pname], float(mk))
        self.last_prices = dict(completion)
        best = min(completion, key=completion.get)
        self.choices.append(best)
        return parts[best]


#: router registry (aliases included); ``make_router`` resolves these
ROUTERS: Dict[str, Type[RouterPolicy]] = {
    "round_robin": RoundRobinRouter, "rr": RoundRobinRouter,
    "least_outstanding": LeastOutstandingRouter,
    "lor": LeastOutstandingRouter,
    "whatif": WhatIfRouter, "what_if": WhatIfRouter,
}


def make_router(router: Union[str, RouterPolicy, None], **kw) -> RouterPolicy:
    """Resolve a router: an instance passes through, a name builds one."""
    if router is None:
        router = "whatif"
    if isinstance(router, RouterPolicy):
        return router
    try:
        cls = ROUTERS[str(router).lower()]
    except KeyError:
        raise ValueError(f"unknown router {router!r}; "
                         f"available: {sorted(ROUTERS)}") from None
    return cls(**kw)
