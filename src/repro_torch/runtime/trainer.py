"""Fault-tolerant training runtime.

The port of ``repro.runtime.trainer``:

* checkpoint/restart — atomic checkpoints in the reference's format
  (``repro_torch.checkpoint``), async save off the critical path,
  deterministic O(1) data resume (``repro_torch.data``; the enc-dec
  family's batches also carry the step's stub frame embeddings,
  ``TokenPipeline.train_batch_at``), restored onto the trainer's device;
* failure handling — ``failure_rate`` injects :class:`SimulatedFailure` at
  step boundaries; the trainer restores the latest checkpoint and replays;
* preemption — SIGTERM triggers a final synchronous save before exit;
* straggler response — when step time drifts >10 % above its running mean
  (the paper's ExhaustiveSel LIB-re-trigger rule), the autotuner's policy
  re-opens exploration so a new plan can be chosen.

The trainer runs on the card (``device=None``) and raises without one;
``device="cpu"`` trains on the CPU.  ``step_fn`` is called as it is (the
reference wraps it in ``jax.jit``).  Its first weights come from
``init_params(cfg, seed)`` on the trainer's device; a run starts from other
weights when they are saved as the step-0 checkpoint of its directory.

Where the reference's straggler re-trigger reads
``service._record(region).selector``, which its ``RegionRecord`` no longer
has (the field is ``policy``), and so raises ``AttributeError`` the first
time a step runs slow, the port re-opens the policy it finds there
(ROADMAP §3).
"""

from __future__ import annotations

import signal
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..checkpoint.manager import CheckpointManager
from ..configs.base import ModelConfig
from ..data.pipeline import DataConfig, TokenPipeline
from ..device import resolve_device
from ..distributed.autotune import StepAutoTuner, block_until_ready
from ..models.model import init_params
from ..optim.adamw import AdamWConfig, adamw_init


class SimulatedFailure(RuntimeError):
    pass


@dataclass
class TrainerConfig:
    ckpt_dir: str
    ckpt_every: int = 25
    async_ckpt: bool = True
    failure_rate: float = 0.0        # P(node failure) per step (injected)
    failure_seed: int = 1234
    max_restarts: int = 10
    straggler_threshold: float = 1.10


class Trainer:
    def __init__(self, cfg: ModelConfig, opt_cfg: AdamWConfig,
                 data_cfg: DataConfig, tcfg: TrainerConfig,
                 step_fn: Optional[Callable] = None,
                 autotuner: Optional[StepAutoTuner] = None,
                 seed: int = 0, device=None):
        if (step_fn is None) == (autotuner is None):
            raise ValueError("exactly one of step_fn / autotuner")
        self.cfg, self.opt_cfg, self.data_cfg, self.tcfg = (
            cfg, opt_cfg, data_cfg, tcfg)
        self.device = resolve_device(device)
        self.step_fn = step_fn
        self.autotuner = autotuner
        self.pipeline = TokenPipeline(data_cfg)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir)
        self.seed = seed
        self.metrics_log: List[Dict] = []
        self._preempted = False
        self._restarts = 0
        self._fail_rng = np.random.default_rng(tcfg.failure_seed)

    # -- lifecycle -------------------------------------------------------------
    def _init_state(self):
        params = init_params(self.cfg, self.seed, device=self.device)
        opt = adamw_init(params, self.opt_cfg)
        return params, opt

    def _restore_or_init(self):
        """The latest checkpoint on the trainer's device, else a fresh
        state.  The restore's template lies on the meta device, so the card
        holds the restored state alone (at full width, params and AdamW
        state are 32.1 GB)."""
        latest = self.ckpt.latest_step()
        if latest is None:
            return (0,) + self._init_state()
        like = init_params(self.cfg, self.seed, device="meta")
        state = self.ckpt.restore(
            latest, {"params": like, "opt": adamw_init(like, self.opt_cfg)},
            device=self.device)
        return latest, state["params"], state["opt"]

    def install_preemption_handler(self):
        def handler(signum, frame):
            self._preempted = True
        signal.signal(signal.SIGTERM, handler)

    # -- training ---------------------------------------------------------------
    def train(self, n_steps: int) -> Dict:
        """Train up to step ``n_steps`` (from the latest checkpoint, if
        any), then save the final state synchronously.  The result carries
        the final step and state, restarts, whether SIGTERM cut the run, the
        losses, and the final save's wall seconds (``final_save_s``)."""
        start, params, opt = self._restore_or_init()
        step = start
        step_times: List[float] = []
        while step < n_steps:
            try:
                batch = {k: torch.from_numpy(v).to(self.device)
                         for k, v in self.pipeline.train_batch_at(
                             step, self.cfg).items()}
                if (self.tcfg.failure_rate > 0.0 and
                        self._fail_rng.random() < self.tcfg.failure_rate):
                    raise SimulatedFailure(f"injected node failure @ {step}")
                t0 = time.perf_counter()
                if self.autotuner is not None:
                    (params, opt, metrics), plan, dt = self.autotuner.step(
                        params, opt, batch)
                else:
                    params, opt, metrics = self.step_fn(params, opt, batch)
                    block_until_ready(metrics["loss"])
                    dt = time.perf_counter() - t0
                    plan = "fixed"
                step_times.append(dt)
                self._straggler_check(step_times)
                self.metrics_log.append({
                    "step": step, "loss": float(metrics["loss"]),
                    "plan": plan, "time": dt})
                step += 1
                if step % self.tcfg.ckpt_every == 0:
                    save = (self.ckpt.async_save if self.tcfg.async_ckpt
                            else self.ckpt.save)
                    save(step, {"params": params, "opt": opt})
                if self._preempted:
                    break
            except SimulatedFailure:
                self._restarts += 1
                if self._restarts > self.tcfg.max_restarts:
                    raise
                # relaunch path: restore latest checkpoint, replay data;
                # the lost state is dropped first, so it and the restored
                # one are never on the card together
                self.ckpt.wait()
                params = opt = None
                step, params, opt = self._restore_or_init()
        self.ckpt.wait()
        t0 = time.perf_counter()
        self.ckpt.save(step, {"params": params, "opt": opt})
        final_save_s = time.perf_counter() - t0
        return {"final_step": step, "params": params, "opt": opt,
                "restarts": self._restarts,
                "preempted": self._preempted,
                "losses": [m["loss"] for m in self.metrics_log],
                "final_save_s": final_save_s}

    def _straggler_check(self, times: List[float]) -> None:
        """Paper's LIB-drift rule applied to step-time drift: re-open the
        plan search when the current step runs >10 % above the mean."""
        if self.autotuner is None or len(times) < 5:
            return
        mean = float(np.mean(times[:-1]))
        if times[-1] > self.tcfg.straggler_threshold * mean:
            sel = self.autotuner.service._record(
                self.autotuner.region).policy
            if hasattr(sel, "_selected"):
                sel._times[:] = np.inf
                sel._phase = 0
                sel._selected = None
