"""Step-plan autotuning — the paper's technique at training-step
granularity (L2).

The port of ``repro.distributed.autotune``.  The OpenMP runtime chose a
*scheduling algorithm* per loop instance; a training runtime's equivalent
degree of freedom is the *execution plan* of the repeated step: activation
checkpointing, microbatch count, attention implementation, gradient
compression.

``StepAutoTuner`` holds a portfolio of plans, builds them lazily, and
drives any selection policy by name (explore-first Q-Learn / SARSA with
the Eq. 11 reward, ExhaustiveSel with its LIB re-trigger, RandomSel, the
expert-seeded Hybrid, SimPolicy over :class:`PlanWhatIf`) through
``SelectionService.instance`` with:

    LT  reward = measured wall-clock step time
    LIB reward = percent load imbalance over per-expert token loads (MoE) or
                 any per-worker load vector the step reports

Each region id (e.g. "train_step") learns independently, as LB4OMP's loop
registry does.  The reference's ``jax.jit`` has no counterpart: a plan's
step runs eagerly, and its timing ends in ``torch.cuda.synchronize`` where
the reference calls ``block_until_ready``.  The plan builder builds and
warms the CUDA kernels (and cuBLAS) for each plan, so that cost is charged
to ``compile_times`` as the reference's compilation is, not to a timed
step.  The reference's sharding constraints (``distributed/ctx.py``) are
no-ops on one card and are left out.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core import (SelectionService, is_sim_policy, percent_load_imbalance,
                    resolve_sim_policy)
from ..core.api import Observation
from ..core.simpolicy import Candidate
from ..device import resolve_device
from ..optim.adamw import AdamWConfig


@dataclass(frozen=True)
class ExecutionPlan:
    name: str
    microbatches: int = 1
    remat: bool = True
    # kept for parity with the reference; the port's builder refuses any
    # other value (one attention, the flash kernel; nothing to shard)
    attn_impl: str = "auto"
    fsdp: bool = True
    compress: Optional[str] = None     # None | "int8" | "topk"


DEFAULT_PLANS: Tuple[ExecutionPlan, ...] = (
    ExecutionPlan("mb1_remat", microbatches=1, remat=True),
    ExecutionPlan("mb2_remat", microbatches=2, remat=True),
    ExecutionPlan("mb4_remat", microbatches=4, remat=True),
    ExecutionPlan("mb1_noremat", microbatches=1, remat=False),
    ExecutionPlan("mb2_noremat", microbatches=2, remat=False),
)


class PlanWhatIf:
    """Calibrated analytic cost model over an execution-plan portfolio — the
    autotuner's candidate simulator (SimAS-style).

    The *prior* prices a plan in relative units from its structure: remat
    recomputes the forward pass (~30 % extra FLOPs), every extra microbatch
    pays a launch/pipeline overhead, gradient compression pays an
    encode/decode term.  Every measured step then *calibrates* the model:
    per-plan EMAs override the prior where a plan has been observed, and the
    global seconds-per-unit scale (fit from all observed plans) converts the
    prior of never-executed plans into seconds.  A retuning epoch therefore
    re-prices the whole portfolio from ONE measured plan — candidates are
    evaluated in simulation, not on live steps.

    Predictions carry step time only (no per-worker load vector), so
    sim-assisted tuning should run under the default "LT" reward; a "LIB"
    reward would see zero predicted spread and fall back to the expert
    ladder on every step."""

    REMAT_MULT = 1.30
    MB_OVERHEAD = 0.03
    COMPRESS_MULT = {None: 0.0, "int8": 0.05, "topk": 0.08}
    EMA = 0.3           # per-plan measurement smoothing

    def __init__(self, plans: Sequence[ExecutionPlan]):
        self.plans = list(plans)
        self._measured: Dict[int, float] = {}   # plan index -> EMA seconds
        self._scale: Optional[float] = None     # seconds per prior unit

    def prior(self, plan: ExecutionPlan) -> float:
        """Relative cost of one step under ``plan`` (unitless)."""
        mult = self.REMAT_MULT if plan.remat else 1.0
        mult *= 1.0 + self.MB_OVERHEAD * (plan.microbatches - 1)
        mult *= 1.0 + self.COMPRESS_MULT.get(plan.compress, 0.05)
        return mult

    def observe(self, idx: int, step_time: float) -> None:
        """Fold one measured step into the calibration."""
        prev = self._measured.get(idx)
        self._measured[idx] = step_time if prev is None else \
            (1.0 - self.EMA) * prev + self.EMA * step_time
        scales = [t / self.prior(self.plans[i])
                  for i, t in self._measured.items()]
        self._scale = float(np.median(scales))

    def candidates(self) -> List[Candidate]:
        return [Candidate(i) for i in range(len(self.plans))]

    def price(self, cands: Sequence[Candidate]) -> List[Observation]:
        scale = self._scale if self._scale is not None else 1.0
        out = []
        for c in cands:
            t = self._measured.get(c.alg)
            if t is None:
                t = scale * self.prior(self.plans[c.alg])
            out.append(Observation(loop_time=float(t)))
        return out


def block_until_ready(out):
    """Wait for the card(s) holding any tensor of ``out`` (nested tuples,
    lists and dicts) and return ``out``: ``jax.block_until_ready``'s
    counterpart."""
    devices = set()

    def walk(x):
        if torch.is_tensor(x):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif isinstance(x, (tuple, list)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)

    walk(out)
    for d in devices:
        torch.cuda.synchronize(d)
    return out


class StepAutoTuner:
    """Online selection over built step variants.

    build_fn(plan) -> step callable; the tuner builds on first use and
    charges the build's wall time to ``compile_times`` (apart from the
    timed steps).

    With ``method="SimPolicy"`` (or ``REPRO_SIM_POLICY`` set and no explicit
    method) the retuning epochs run in simulation: a :class:`PlanWhatIf`
    prices the whole portfolio before every step, only the predicted winner
    is built and executed, and each measured step recalibrates the model
    — the explore-first phase never burns live steps on losing plans."""

    def __init__(self, plans: List[ExecutionPlan], build_fn,
                 method: Optional[str] = None, reward: str = "LT",
                 seed: int = 0, region: str = "train_step",
                 store_dir: Optional[str] = None,
                 sim_model: Optional[PlanWhatIf] = None):
        self.plans = list(plans)
        self.build_fn = build_fn
        self.region = region
        method = method or resolve_sim_policy("ExhaustiveSel")
        self.sim_model = None
        policy_kw = {}
        if is_sim_policy(method):
            self.sim_model = sim_model or PlanWhatIf(self.plans)
            policy_kw["simulator"] = self.sim_model
        elif sim_model is not None:
            raise ValueError(
                f"sim_model= given but method {method!r} never consults a "
                f"simulator; use method='SimPolicy' or 'SimHybrid'")
        # any make_policy name works (incl. "Hybrid"); with store_dir the
        # learned plan table warm-starts across runs (paper §5)
        self.service = SelectionService(method, reward=reward, seed=seed,
                                        n_actions=len(self.plans),
                                        store_dir=store_dir, **policy_kw)
        self._compiled: Dict[int, Callable] = {}
        self.compile_times: Dict[int, float] = {}
        self.history: List[Tuple[str, float, float]] = []

    def _get(self, idx: int) -> Callable:
        if idx not in self._compiled:
            t0 = time.perf_counter()
            self._compiled[idx] = self.build_fn(self.plans[idx])
            self.compile_times[idx] = time.perf_counter() - t0
        return self._compiled[idx]

    def step(self, *args):
        """Run one training step with the currently-selected plan.
        Returns (outputs, plan_name, step_time)."""
        with self.service.instance(self.region) as inst:
            idx = inst.action
            fn = self._get(idx)
            t0 = time.perf_counter()
            out = block_until_ready(fn(*args))
            dt = time.perf_counter() - t0
            lib = self._lib_signal(out)
            inst.report(loop_time=dt, lib=lib)
        if self.sim_model is not None:  # recalibrate the plan cost model
            self.sim_model.observe(idx, dt)
        self.history.append((self.plans[idx].name, dt, lib))
        return out, self.plans[idx].name, dt

    @staticmethod
    def _lib_signal(out) -> float:
        """Paper Eq. 8 over per-worker loads when the step reports them
        (MoE expert loads; per-replica times)."""
        if isinstance(out, tuple) and len(out) == 3 and isinstance(out[2], dict):
            metrics = out[2]
            if "expert_load" in metrics:
                load = metrics["expert_load"]
                load = (load.detach().double().cpu().numpy()
                        if torch.is_tensor(load)
                        else np.asarray(load, dtype=np.float64))
                load = load.sum(axis=0) if load.ndim > 1 else load
                if load.max() > 0:
                    return percent_load_imbalance(load)
        return 0.0

    @property
    def selected_plan(self) -> str:
        """Peek at the plan the policy would pick now (no feedback owed)."""
        return self.plans[self.service.policy(self.region).decide().action].name

    def save(self) -> List[str]:
        """Persist the learned plan table for warm starts (needs store_dir)."""
        return self.service.save()


def warm_kernels(cfg: ModelConfig, device: torch.device) -> None:
    """Build the model kernels of a training step (nvcc, at first use) and
    run each once, forward and backward, at a tiny size in the model's
    dtype, with one product on cuBLAS: rmsnorm in every family but the
    enc-dec one (whisper's norms are LayerNorms, plain PyTorch, as the
    reference's are XLA's), the SSD scan in the SSM and hybrid families
    (at the config's state width, so that the kernels of its tile width
    are built), flash attention in the families that have attention (the
    enc-dec family's encoder, decoder and cross attention); a no-op on
    the CPU."""
    if device.type != "cuda":
        return
    from ..kernels.flash_attention import flash_attention
    from ..kernels.rmsnorm import rmsnorm
    from ..kernels.ssd_scan import ssd_scan
    dt = getattr(torch, cfg.param_dtype)

    def leaf(shape, dtype=dt, value=1.0):
        return torch.full(shape, value, dtype=dtype, device=device,
                          requires_grad=True)

    x, w = leaf((2, 8, 16)), leaf((16,))
    with torch.enable_grad():
        out = (x.reshape(16, 16) @ w.expand(16, 16)).float().sum()
        if cfg.family != "encdec":
            out = out + rmsnorm(x, w).sum()
        if cfg.family in ("ssm", "hybrid"):
            f32 = torch.float32
            bc = leaf((1, 64, cfg.ssm_state), f32)
            y, _ = ssd_scan(leaf((1, 64, 2, cfg.ssm_headdim)),
                            leaf((1, 64, 2), f32, 0.1), leaf((2,), f32, -1.0),
                            bc, bc, chunk=32)
            out = out + y.float().sum()
        if cfg.family != "ssm":
            hd, K = cfg.head_dim, max(cfg.n_kv_heads, 1)
            H = K * max(cfg.n_heads // K, 1)
            kv = leaf((1, 64, K, hd))
            out = out + flash_attention(leaf((1, 64, H, hd)), kv,
                                        kv).float().sum()
        out.backward()
    torch.cuda.synchronize(device)


def make_plan_builder(cfg: ModelConfig, opt_cfg: AdamWConfig, device=None):
    """Standard builder: plan -> train step on ``device`` (default the
    card), with the kernels built and warmed there.  A plan with another
    ``attn_impl`` or ``fsdp`` than the default is refused: it would build
    the same step as its default twin, and the tuner would spend steps
    exploring a copy."""
    from ..launch.steps import make_train_step
    from .compression import EFCompressor
    dev = resolve_device(device)

    def build(plan: ExecutionPlan):
        if (plan.attn_impl, plan.fsdp) != ("auto", True):
            raise ValueError(
                f"plan {plan.name!r} sets attn_impl={plan.attn_impl!r}, "
                f"fsdp={plan.fsdp}: the port has one attention (the flash "
                f"kernel) and nothing to shard on one card, so such a plan "
                f"would be the same step as its default twin")
        c = dataclasses.replace(cfg, remat=plan.remat)
        comp = EFCompressor(plan.compress) if plan.compress else None
        step = make_train_step(c, opt_cfg, microbatches=plan.microbatches,
                               compressor=comp)
        warm_kernels(c, dev)
        return step

    return build


__all__ = ["ExecutionPlan", "DEFAULT_PLANS", "PlanWhatIf", "StepAutoTuner",
           "block_until_ready", "make_plan_builder", "warm_kernels"]
