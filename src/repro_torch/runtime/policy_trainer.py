"""Offline trainer for the learned selection policy.

The counterpart of ``repro.runtime.policy_trainer``.  The net is one
feature layer and a ``gelu_mlp`` block (``repro_torch.models.layers``),
held as a dict of float32 tensors on the trainer's device; the loss's
gradient comes from autograd and the update is
``repro_torch.optim.adamw`` (the reference's AdamW, written out).  The
run discipline is the reference's: atomic checkpoints through
:class:`~repro_torch.checkpoint.manager.CheckpointManager` (the
reference's on-disk format, so a checkpoint crosses packages), async
checkpointing off the critical path, SIGTERM → final synchronous save,
``failure_rate`` fault injection with restore-and-replay, and
**bit-identical resume** on one device: batches and their augmentation
are the reference's numpy, a pure function of ``(seed, step)``, so an
interrupted run restored from its latest checkpoint replays to exactly
the uninterrupted result.

Training data is the counterfactual transition log
(``repro_torch.sim.translog``): every row carries the priced cost of *all
12* portfolio algorithms for its context, so the net is fit by plain
supervised regression of row-centered log costs — a contextual bandit with
full feedback.  :class:`TransitionDataset` holds out whole ``(app,
system)`` cells, and feature normalization is folded into the first layer
at export time (in float64), so the deployed numpy forward
(:func:`repro_torch.core.learned.mlp_forward`) consumes raw feature rows.

The trainer runs on the card (``device=None``) and raises without one;
``device="cpu"`` trains on the CPU.  Its first weights are He-normal,
drawn from an explicit CPU ``torch.Generator`` seeded with ``cfg.seed``
and moved to the trainer's device, so one seed starts the same net on
every device (the card's own generator would draw other numbers, and what
the net learns from 250 steps depends on where it starts).  A run starts
from other weights — the reference's, say, through
``repro_torch.convert.policy_trainer_state_from_jax`` — when they are
saved as the step-0 checkpoint of its directory.
"""

from __future__ import annotations

import math
import signal
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..checkpoint.manager import CheckpointManager
from ..core.learned import N_FEATURES, make_learned_state
from ..device import resolve_device
from ..models.layers import gelu_mlp
from ..optim.adamw import AdamWConfig, AdamWState, adamw_init, adamw_update
from .trainer import SimulatedFailure

__all__ = ["TransitionDataset", "PolicyTrainerConfig", "PolicyTrainer",
           "forward", "train_policy_state"]


def forward(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """The training-side net: feature layer + one ``gelu_mlp`` block.  The
    deployed numpy twin is ``repro_torch.core.learned.mlp_forward`` (same
    tanh GELU approximation, so argmins agree)."""
    h0 = F.gelu(x @ params["w0"] + params["b0"], approximate="tanh")
    return gelu_mlp(h0, params["w1"], params["b1"], params["w2"],
                    params["b2"])


class TransitionDataset:
    """Translog arrays + cell-keyed split + deterministic batching.

    ``holdout_cells`` names ``"app|system"`` keys whose rows are excluded
    from training entirely — the held-out set the regret gates read.
    Targets are row-centered log costs (the per-row mean is scale and has
    no bearing on the argmin; centering removes it so the net spends
    capacity on *ranking* algorithms, not predicting absolute runtimes).

    ``batch_at(step)`` is a pure function of ``(seed, step)``, which is
    what makes checkpoint-restored training bit-identical.
    """

    def __init__(self, arrays: Dict[str, np.ndarray],
                 holdout_cells: Sequence[str] = (), seed: int = 0):
        X = np.asarray(arrays["features"], np.float64)
        costs = np.asarray(arrays["costs"], np.float64)
        if len(X) == 0:
            raise ValueError("empty transition log")
        if X.shape[1] != N_FEATURES:
            raise ValueError(f"translog has {X.shape[1]} features, this "
                             f"build extracts {N_FEATURES}")
        cell = np.asarray(arrays["cell"], np.int64)
        self.cell_keys = [str(k) for k in arrays["cell_keys"]]
        logc = np.log(np.maximum(costs, 1e-12))
        self.X = X
        self.costs = costs
        self.Y = logc - logc.mean(axis=1, keepdims=True)
        self.cell = cell
        self.seed = int(seed)
        self.holdout_cells = sorted(set(holdout_cells))
        unknown = [c for c in self.holdout_cells if c not in self.cell_keys]
        if unknown:
            raise ValueError(f"holdout cells {unknown} not in the log "
                             f"(have {self.cell_keys})")
        hold_ids = {self.cell_keys.index(c) for c in self.holdout_cells}
        mask = np.array([c in hold_ids for c in cell])
        self.train_idx = np.flatnonzero(~mask)
        self.holdout_idx = np.flatnonzero(mask)
        if len(self.train_idx) == 0:
            raise ValueError("holdout split leaves no training rows")
        # normalization over the TRAIN split only (no holdout leakage)
        Xt = X[self.train_idx]
        self.mu = Xt.mean(axis=0)
        self.sigma = np.maximum(Xt.std(axis=0), 1e-6)

    @property
    def n_train(self) -> int:
        return len(self.train_idx)

    @property
    def n_actions(self) -> int:
        return self.costs.shape[1]

    def normalize(self, X: np.ndarray) -> np.ndarray:
        return (np.asarray(X, np.float64) - self.mu) / self.sigma

    def batch_at(self, step: int, batch_size: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Deterministic O(1) batch for ``step`` — pure in (seed, step), so
        replaying steps after a restore reproduces the exact gradient
        sequence of the uninterrupted run."""
        rng = np.random.default_rng((self.seed, int(step)))
        idx = self.train_idx[rng.integers(0, self.n_train, batch_size)]
        return (self.normalize(self.X[idx]).astype(np.float32),
                self.Y[idx].astype(np.float32))

    def split(self, which: str = "holdout"
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(normalized X, centered-log-cost Y, raw costs) of a split."""
        idx = self.train_idx if which == "train" else self.holdout_idx
        return (self.normalize(self.X[idx]).astype(np.float32),
                self.Y[idx].astype(np.float32), self.costs[idx])


@dataclass
class PolicyTrainerConfig:
    ckpt_dir: str
    hidden: int = 32                 # width of both hidden layers
    n_steps: int = 400
    batch_size: int = 128
    seed: int = 0
    ckpt_every: int = 25
    async_ckpt: bool = True
    #: stddev of Gaussian jitter added to (z-scored) features per batch —
    #: the net must transfer to (app, system) pairings it never saw, and
    #: an unregularized MLP extrapolates arbitrarily into novel feature
    #: combinations; input noise forces a smooth ranking surface
    aug_sigma: float = 0.25
    failure_rate: float = 0.0        # P(node failure) per step (injected)
    failure_seed: int = 1234
    max_restarts: int = 10


class PolicyTrainer:
    """Supervised contextual-bandit training with the reference Trainer's
    fault-tolerance discipline (checkpoint/restart, SIGTERM final save,
    injected failures, bit-identical resume)."""

    def __init__(self, dataset: TransitionDataset, cfg: PolicyTrainerConfig,
                 opt_cfg: Optional[AdamWConfig] = None,
                 device: Union[str, torch.device, None] = None):
        self.ds = dataset
        self.cfg = cfg
        self.device = resolve_device(device)
        self.opt_cfg = opt_cfg or AdamWConfig(
            lr=3e-3, weight_decay=1e-4, clip_norm=1.0,
            warmup_steps=max(10, cfg.n_steps // 20),
            total_steps=cfg.n_steps)
        self.ckpt = CheckpointManager(cfg.ckpt_dir)
        self.metrics_log: List[Dict] = []
        self._preempted = False
        self._restarts = 0
        self._fail_rng = np.random.default_rng(cfg.failure_seed)

    # -- lifecycle ----------------------------------------------------------
    def _init_state(self) -> Tuple[Dict[str, torch.Tensor], AdamWState]:
        """He-normal weights from ``cfg.seed`` (the same on every device),
        zero biases and moments, on the trainer's device."""
        h, a = self.cfg.hidden, self.ds.n_actions
        gen = torch.Generator(device="cpu").manual_seed(self.cfg.seed)

        def dense(fan_in, fan_out):
            scale = math.sqrt(2.0 / fan_in)
            return (torch.randn((fan_in, fan_out), generator=gen,
                                dtype=torch.float32) * scale).to(self.device)

        def zeros(n):
            return torch.zeros((n,), dtype=torch.float32, device=self.device)

        params = {"w0": dense(N_FEATURES, h), "b0": zeros(h),
                  "w1": dense(h, h), "b1": zeros(h),
                  "w2": dense(h, a), "b2": zeros(a)}
        return params, adamw_init(params, self.opt_cfg)

    def _restore_or_init(self):
        latest = self.ckpt.latest_step()
        params, opt = self._init_state()
        if latest is None:
            return 0, params, opt
        state = self.ckpt.restore(latest, {"params": params, "opt": opt})
        return latest, state["params"], state["opt"]

    def install_preemption_handler(self):
        def handler(signum, frame):
            self._preempted = True
        signal.signal(signal.SIGTERM, handler)

    # -- training -----------------------------------------------------------
    def _step(self, params, opt, x, y):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss = torch.mean((forward(leaves, x) - y) ** 2)
        names = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        params, opt, metrics = adamw_update(
            dict(zip(names, grads)), opt,
            {k: v.detach() for k, v in leaves.items()}, self.opt_cfg)
        return params, opt, {"loss": loss.detach(), **metrics}

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def train(self, n_steps: Optional[int] = None) -> Dict:
        n_steps = self.cfg.n_steps if n_steps is None else int(n_steps)
        step, params, opt = self._restore_or_init()
        while step < n_steps:
            try:
                x, y = self.ds.batch_at(step, self.cfg.batch_size)
                if self.cfg.aug_sigma > 0.0:
                    # augmentation is pure in (seed, step) like the batch
                    # itself, so resume stays bit-identical
                    arng = np.random.default_rng(
                        (self.cfg.seed, int(step), 1))
                    x = x + arng.normal(
                        scale=self.cfg.aug_sigma,
                        size=x.shape).astype(np.float32)
                if (self.cfg.failure_rate > 0.0 and
                        self._fail_rng.random() < self.cfg.failure_rate):
                    raise SimulatedFailure(f"injected node failure @ {step}")
                params, opt, metrics = self._step(
                    params, opt, self._tensor(x), self._tensor(y))
                self.metrics_log.append({"step": step,
                                         "loss": float(metrics["loss"])})
                step += 1
                if step % self.cfg.ckpt_every == 0:
                    state = {"params": params, "opt": opt}
                    if self.cfg.async_ckpt:
                        self.ckpt.async_save(step, state)
                    else:
                        self.ckpt.save(step, state)
                if self._preempted:
                    break
            except SimulatedFailure:
                self._restarts += 1
                if self._restarts > self.cfg.max_restarts:
                    raise
                # relaunch path: restore latest checkpoint, replay data
                self.ckpt.wait()
                step, params, opt = self._restore_or_init()
        self.ckpt.wait()
        self.ckpt.save(step, {"params": params, "opt": opt})
        return {"final_step": step, "params": params, "opt": opt,
                "restarts": self._restarts,
                "preempted": self._preempted,
                "losses": [m["loss"] for m in self.metrics_log]}

    # -- evaluation + export ------------------------------------------------
    @torch.no_grad()
    def regret(self, params, which: str = "holdout") -> float:
        """Mean relative regret of the net's argmin vs the per-row best
        counterfactual cost, over a dataset split; the forward runs on the
        trainer's device."""
        x, _, costs = self.ds.split(which)
        if len(x) == 0:
            return float("nan")
        pred = forward(params, self._tensor(x)).cpu().numpy()
        chosen = costs[np.arange(len(costs)), pred.argmin(axis=1)]
        best = costs.min(axis=1)
        return float(np.mean((chosen - best) / np.maximum(best, 1e-12)))

    def export_state(self, params, meta: Optional[dict] = None) -> dict:
        """The deployable ``LearnedPolicy`` state.  The net was trained on
        z-scored features; the deployed forward takes raw rows, so the
        normalization is folded into the first layer in float64:
        ``z @ w0 + b0 == x @ (w0/sigma) + (b0 - (mu/sigma) @ w0)``."""
        p = {k: v.detach().cpu().numpy().astype(np.float64)
             for k, v in params.items()}
        sigma, mu = self.ds.sigma, self.ds.mu
        folded = dict(p)
        folded["w0"] = p["w0"] / sigma[:, None]
        folded["b0"] = p["b0"] - (mu / sigma) @ p["w0"]
        info = {"n_steps": self.cfg.n_steps, "hidden": self.cfg.hidden,
                "seed": self.cfg.seed, "n_train": self.ds.n_train,
                "holdout_cells": self.ds.holdout_cells}
        info.update(meta or {})
        return make_learned_state(
            {k: np.asarray(v, np.float32) for k, v in folded.items()},
            reward="LT", meta=info)


def train_policy_state(arrays: Dict[str, np.ndarray], ckpt_dir: str,
                       holdout_cells: Sequence[str] = (),
                       cfg: Optional[PolicyTrainerConfig] = None,
                       opt_cfg: Optional[AdamWConfig] = None,
                       device: Union[str, torch.device, None] = None
                       ) -> Tuple[dict, Dict]:
    """One-call train-and-export on ``device`` (the card by default):
    returns (LearnedPolicy state, the trainer's result dict augmented with
    train/holdout regret)."""
    ds = TransitionDataset(arrays, holdout_cells=holdout_cells)
    cfg = cfg or PolicyTrainerConfig(ckpt_dir=ckpt_dir)
    if cfg.ckpt_dir != ckpt_dir:
        cfg = PolicyTrainerConfig(**{**cfg.__dict__, "ckpt_dir": ckpt_dir})
    tr = PolicyTrainer(ds, cfg, opt_cfg=opt_cfg, device=device)
    tr.install_preemption_handler()
    result = tr.train()
    result["train_regret"] = tr.regret(result["params"], "train")
    if len(ds.holdout_idx):
        result["holdout_regret"] = tr.regret(result["params"], "holdout")
    return tr.export_state(result["params"]), result
