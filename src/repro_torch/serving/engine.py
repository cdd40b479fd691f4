"""Serving engine, live half: the replica cost model and continuous
batching over the port's decode step.

The port of ``ReplicaCostModel`` and ``ContinuousBatcher`` of
``repro.serving.engine``; the dispatch simulator waits for its slice
(ROADMAP queue 1).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, List, Optional, Tuple

import numpy as np
import torch

from ..data.pipeline import Request


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
