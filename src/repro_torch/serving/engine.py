"""Serving engine — the paper's technique at dispatch granularity (L3);
the port's copy of ``repro.serving.engine``.

Structure of the adaptation:

    OpenMP threads        -> data-parallel replica groups
    loop iterations       -> queued requests (heterogeneous token counts)
    chunk of iterations   -> batch of requests a replica self-assigns
    scheduling algorithm  -> the SAME 12-algorithm portfolio (repro_torch.core)
    loop instance         -> one dispatch wave over the pending queue
    LIB (Eq. 8)           -> imbalance of replica busy-times per wave
    selection methods     -> RandomSel/ExhaustiveSel/ExpertSel/QLearn/SARSA
                             /Hybrid (expert-seeded RL), via SelectionService

``DispatchSimulator`` runs waves through the host self-scheduling loop
(replica service time = token-count cost model measured from a real decode
step or supplied analytically); its what-if pricing goes through the
simulation backend, the ``event_finish`` kernel on the card by default.
``ContinuousBatcher`` is the live path: real decode steps on slots,
which calibrate the per-token cost.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import (N_ALGORITHMS, SelectionService, exp_chunk, is_sim_policy,
                    percent_load_imbalance, resolve_sim_policy)
from ..core.api import Observation
from ..core.portfolio import make_algorithm
from ..core.simpolicy import Candidate, SimUnavailable
from ..data.pipeline import Request
from ..sim.backends import get_backend


@dataclass
class WaveStats:
    wave: int
    algorithm: int
    n_requests: int
    makespan: float
    lib: float
    chunks: int


@dataclass
class ReplicaCostModel:
    """Service time of a batch of requests on one replica group.

    t = fixed + per_token * sum(tokens) + per_request * n
    (calibrate per_token from a measured decode step)."""
    fixed: float = 2e-3
    per_token: float = 10e-6
    per_request: float = 0.5e-3

    def cost(self, tokens: np.ndarray) -> float:
        return (self.fixed + self.per_token * float(tokens.sum())
                + self.per_request * len(tokens))


class WaveWhatIf:
    """Candidate simulator over ``DispatchSimulator.what_if`` — the serving
    side of simulation-assisted selection.  ``run_wave`` binds the pending
    request queue before consulting the policy; ``price`` fans the candidate
    set (algorithm x chunk variant) into batched what-if calls against the
    *current* replica busy-state.

    Predictions carry the wave makespan ONLY (``what_if_wave`` returns no
    per-replica finishes), so every reward ranks candidates by predicted LT:
    "LT+LIB"/"p95"/"throughput" reduce to their loop-time fallbacks, and a
    pure "LIB" reward sees zero spread everywhere — SimPolicy then takes its
    expert fallback on every wave.  Use reward="LT" with sim-assisted
    dispatch."""

    def __init__(self, sim: "DispatchSimulator"):
        self._sim = sim
        self._requests: Optional[List[Request]] = None

    def set_requests(self, requests: List[Request]) -> None:
        self._requests = requests

    def candidates(self) -> List[Candidate]:
        if self._requests is None:
            raise SimUnavailable("WaveWhatIf has no pending wave bound")
        out = [Candidate(a) for a in range(N_ALGORITHMS)]
        ec = exp_chunk(len(self._requests), self._sim.R)
        if ec != self._sim.chunk_param:
            out += [Candidate(a, ec) for a in range(N_ALGORITHMS)]
        return out

    def price(self, cands: Sequence[Candidate]) -> List[Observation]:
        if self._requests is None:
            raise SimUnavailable("WaveWhatIf has no pending wave bound")
        # one batched what_if per distinct chunk parameter
        groups: Dict[Optional[int], List[int]] = {}
        for i, c in enumerate(cands):
            groups.setdefault(c.chunk_param, []).append(i)
        out: List[Optional[Observation]] = [None] * len(cands)
        for cp, idxs in groups.items():
            mk = self._sim.what_if(self._requests,
                                   algs=[cands[i].alg for i in idxs],
                                   chunk_param=cp)
            for i, m in zip(idxs, mk):
                out[i] = Observation(loop_time=float(m))
        return out


class DispatchSimulator:
    """Chunk-self-scheduled request dispatch over R replica groups."""

    def __init__(self, n_replicas: int, selector: Optional[str] = None,
                 reward: str = "LT", chunk_param: int = 0, seed: int = 0,
                 cost_model: Optional[ReplicaCostModel] = None,
                 dispatch_overhead: float = 0.2e-3,
                 selector_kw: Optional[dict] = None,
                 backend: Optional[str] = None,
                 region: str = "dispatch"):
        self.R = n_replicas
        self.chunk_param = chunk_param
        #: SelectionService region id — the fleet layer names one region per
        #: replica group so warm-start snapshots (store_dir) never collide
        self.region = region
        self.h = dispatch_overhead
        self.cost = cost_model or ReplicaCostModel()
        #: simulation backend for ``what_if`` queries (None: the port's
        #: default, the batched engine on the card; it evaluates the whole
        #: candidate set in one event-core call)
        self.backend = backend
        # no explicit selector: REPRO_SIM_POLICY can flip the dispatcher to
        # simulation-assisted selection from the environment
        selector = selector or resolve_sim_policy("QLearn")
        kw = dict(selector_kw or {})
        kw.setdefault("seed", seed)
        # SimPolicy / SimHybrid consult this simulator's own what_if before
        # every wave (SimAS-style): zero exploration on live dispatches.
        # A caller-supplied wave pricer (anything with ``set_requests``) is
        # bound the same way, so it sees every pending queue too.
        self._whatif = None
        if is_sim_policy(selector):
            sim = kw.get("simulator")
            if sim is None:
                sim = kw["simulator"] = WaveWhatIf(self)
            if hasattr(sim, "set_requests"):
                self._whatif = sim
        # any make_policy name works here, incl. "Hybrid"; the reward may be
        # a serving-centric registry entry ("p95", "throughput", "LT+LIB")
        self.service = SelectionService(selector, reward=reward, **kw)
        self.stats: List[WaveStats] = []
        self._replica_free = np.zeros(n_replicas)
        #: (R,) availability mask while a masked wave is in flight, so the
        #: wave's what-if pricing routes around failed replicas too
        self._wave_active: Optional[np.ndarray] = None

    def _wave_prefix(self, requests: List[Request]) -> np.ndarray:
        """(N+1,) cumulative batch-cost model over the request sequence:
        cost of chunk [a, b) = prefix[b] - prefix[a] (+ the fixed term per
        dispatch, folded into the per-chunk overhead)."""
        tokens = np.array([r.prompt_len + r.gen_len for r in requests],
                          dtype=np.float64)
        return (self.cost.per_token * np.concatenate([[0.0],
                                                      np.cumsum(tokens)])
                + self.cost.per_request * np.arange(len(tokens) + 1))

    def what_if(self, requests: List[Request],
                algs: Optional[Sequence[int]] = None,
                chunk_param: Optional[int] = None) -> np.ndarray:
        """Batched what-if: predicted wave makespan for each candidate
        scheduling algorithm over the *current* replica busy-state, without
        dispatching anything (the SimAS-style consultation a policy can use
        to rank its candidate set before committing).  ``chunk_param``
        prices a chunk-parameter variant (default: the dispatcher's own)."""
        algs = list(algs) if algs is not None else list(range(N_ALGORITHMS))
        if chunk_param is None:
            chunk_param = self.chunk_param
        free = self._replica_free - self._replica_free.min()
        if self._wave_active is not None:
            # masked (failed) replicas cannot serve this wave: push their
            # availability past the whole wave's work so priced schedules
            # route around them, exactly like the dispatch loop will
            free = free.copy()
            free[~self._wave_active] += self._wave_prefix(requests)[-1] \
                + self.cost.fixed * len(requests)
        return get_backend(self.backend).what_if_wave(
            self._wave_prefix(requests), self.R, free, self.h,
            self.cost.fixed, algs, chunk_param=chunk_param)

    def run_wave(self, requests: List[Request], wave_id: int = 0,
                 active: Optional[np.ndarray] = None,
                 replica_scale: Optional[np.ndarray] = None) -> WaveStats:
        """One loop instance: dispatch all pending requests with the selected
        scheduling algorithm; replicas self-assign request-chunks.

        ``active`` — optional (R,) mask: failed replicas receive no chunks
        (their carried busy offsets pass through untouched); ``replica_scale``
        — optional (R,) per-replica service-time multipliers (stragglers).
        Both default to the exact historical homogeneous path.
        """
        if active is not None:
            active = np.asarray(active, dtype=bool)
            if active.shape != (self.R,):
                raise ValueError(f"active mask must have shape ({self.R},)")
            if not active.any():
                raise ValueError("run_wave needs at least one active replica")
            if active.all():
                active = None           # clean path, bit-identical
        if replica_scale is not None:
            replica_scale = np.asarray(replica_scale, dtype=np.float64)
            if replica_scale.shape != (self.R,):
                raise ValueError(f"replica_scale must have shape ({self.R},)")
            if np.all(replica_scale == 1.0):
                replica_scale = None    # clean path, bit-identical
        self._wave_active = active
        try:
            return self._run_wave(requests, wave_id, active, replica_scale)
        finally:
            self._wave_active = None

    def _run_wave(self, requests: List[Request], wave_id: int,
                  active: Optional[np.ndarray],
                  replica_scale: Optional[np.ndarray]) -> WaveStats:
        if self._whatif is not None:    # bind the wave the decision is about
            self._whatif.set_requests(requests)
        ranks = np.arange(self.R) if active is None else \
            np.flatnonzero(active)
        P = len(ranks)                  # replicas that can take work
        inst = self.service.instance(self.region)
        with inst:
            d = inst.decision.with_instance_defaults(self.chunk_param)
            alg_idx = d.action
            chunk_param = d.chunk_param
            tokens = np.array([r.prompt_len + r.gen_len for r in requests])
            N = len(tokens)
            alg = make_algorithm(alg_idx)
            alg.reset(N, P, chunk_param)

            free = self._replica_free - self._replica_free.min()
            cursor = 0
            chunks = 0
            if alg_idx == 0 and chunk_param <= 0:
                bounds = np.linspace(0, N, P + 1).round().astype(int)
                for k, r in enumerate(ranks):
                    if bounds[k + 1] > bounds[k]:
                        dt = self.cost.cost(tokens[bounds[k]:bounds[k + 1]])
                        if replica_scale is not None:
                            dt *= replica_scale[r]
                        free[r] += dt
                chunks = P
            else:
                # self-scheduling argmin restricted to active replicas;
                # algorithms see contiguous PE ranks 0..P-1
                while alg.remaining > 0:
                    k = int(np.argmin(free[ranks]))
                    r = int(ranks[k])
                    c = alg.next_chunk(k)
                    if c <= 0:
                        break
                    batch = tokens[cursor:cursor + c]
                    cursor += c
                    dt = self.cost.cost(batch)
                    if replica_scale is not None:
                        dt *= replica_scale[r]
                    alg.report(k, c, dt, dt + self.h)
                    free[r] += self.h + dt
                    chunks += 1

            makespan = float(free[ranks].max())
            lib = percent_load_imbalance(free[ranks])
            # full structured observation: the policy's reward function can
            # draw on tail latency / throughput, not just (LT, LIB)
            inst.report(loop_time=makespan, lib=lib,
                        throughput=N / max(makespan, 1e-12),
                        tail_latency=float(np.percentile(free[ranks], 95)),
                        pe_times=free[ranks].tolist())
        self._replica_free = free
        st = WaveStats(wave=wave_id, algorithm=alg_idx, n_requests=N,
                       makespan=makespan, lib=lib, chunks=chunks)
        self.stats.append(st)
        return st

    @property
    def busy(self) -> np.ndarray:
        """Per-replica busy offsets carried into the next wave (relative:
        ``run_wave`` re-bases them so the minimum is the dispatch origin).
        The fleet simulator reads/writes this around each routed shard to
        keep its absolute clock and the dispatcher's relative one in sync."""
        return self._replica_free.copy()

    @busy.setter
    def busy(self, offsets) -> None:
        offsets = np.asarray(offsets, dtype=np.float64)
        if offsets.shape != (self.R,):
            raise ValueError(f"busy offsets must have shape ({self.R},)")
        self._replica_free = offsets.copy()

    def run(self, requests: List[Request], wave_size: int = 256
            ) -> List[WaveStats]:
        out = []
        for w, i in enumerate(range(0, len(requests), wave_size)):
            out.append(self.run_wave(requests[i:i + wave_size], w))
        return out

    def summary(self) -> Dict[str, float]:
        mk = np.array([s.makespan for s in self.stats])
        lib = np.array([s.lib for s in self.stats])
        return {"total_makespan": float(mk.sum()),
                "mean_lib": float(lib.mean()),
                "waves": len(self.stats)}


class ContinuousBatcher:
    """Live continuous batching over a real decode step (single replica
    group).  ``serve_step(params, cache, tokens)`` returns (logits, cache);
    the next tokens are the logits' argmax."""

    def __init__(self, serve_step, init_cache_fn, batch_slots: int,
                 eos_check: Optional[Callable] = None):
        self.serve_step = serve_step
        self.init_cache_fn = init_cache_fn
        self.slots = batch_slots
        self.active: List[Optional[Request]] = [None] * batch_slots
        self.remaining = np.zeros(batch_slots, np.int64)
        # deque: _refill pops from the head every decode step — list.pop(0)
        # was O(queue) per refill
        self.queue: Deque[Request] = deque()
        self.completed: List[Tuple[int, float]] = []
        self.tokens_out = 0

    def submit(self, requests: List[Request]):
        self.queue.extend(requests)

    def _refill(self):
        for i in range(self.slots):
            if self.active[i] is None and self.queue:
                r = self.queue.popleft()
                self.active[i] = r
                self.remaining[i] = r.gen_len

    def run(self, params, cache, tokens, max_steps: int = 1000):
        """Decode until queue + slots drain (or max_steps); the wall time
        ends after the device has finished the last step."""
        steps = 0
        t0 = time.perf_counter()
        self._refill()
        while steps < max_steps and any(a is not None for a in self.active):
            logits, cache = self.serve_step(params, cache, tokens)
            tokens = logits.argmax(-1).to(tokens.dtype)
            steps += 1
            self.tokens_out += int(sum(a is not None for a in self.active))
            for i, a in enumerate(self.active):
                if a is None:
                    continue
                self.remaining[i] -= 1
                if self.remaining[i] <= 0:
                    self.completed.append((a.rid, time.perf_counter() - t0))
                    self.active[i] = None
            self._refill()
        if tokens.device.type == "cuda":
            torch.cuda.synchronize(tokens.device)
        dt = time.perf_counter() - t0
        return {"steps": steps, "tokens": self.tokens_out,
                "tokens_per_s": self.tokens_out / max(dt, 1e-9),
                "completed": len(self.completed), "wall": dt}
