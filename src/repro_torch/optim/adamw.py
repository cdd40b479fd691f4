"""AdamW with warm-up and decay schedules and global-norm clipping.

The counterpart of ``repro.optim.adamw``: plain functions on dicts of
tensors, the update written out as the reference writes it — clip the
gradients by their global norm, bias-correct both moments, then
``delta = mhat / (sqrt(vhat) + eps) + weight_decay * p`` and
``p - lr * delta``.  ``torch.optim.AdamW`` decays the weights before the
step and puts ``eps`` elsewhere, so it would not agree with the reference.
Every quantity is a float32 tensor on the parameters' device; the step
count is an int32 scalar tensor.  Moments may be kept in a reduced dtype
(``moment_dtype``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, NamedTuple, Tuple, Union

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"       # cosine | linear | constant
    moment_dtype: str = "float32"


def _moment_dtype(cfg: AdamWConfig) -> torch.dtype:
    return getattr(torch, cfg.moment_dtype)


def adamw_init(params: Dict[str, torch.Tensor],
               cfg: AdamWConfig) -> AdamWState:
    mdt = _moment_dtype(cfg)
    any_p = next(iter(params.values()))
    zeros = {k: torch.zeros(p.shape, dtype=mdt, device=p.device)
             for k, p in params.items()}
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=any_p.device),
        m=zeros, v={k: z.clone() for k, z in zeros.items()})


def schedule_lr(cfg: AdamWConfig, step: Union[int, torch.Tensor]
                ) -> torch.Tensor:
    """The learning rate at ``step`` (before the update that step makes):
    linear warm-up over ``warmup_steps``, then cosine, linear or constant
    decay to ``total_steps``; float32."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - frac
    else:
        decay = torch.ones_like(frac)
    return cfg.lr * warm * decay


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The float32 L2 norm of every leaf together, leaves in key order."""
    leaves = [torch.sum(torch.square(tree[k].float())) for k in sorted(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def adamw_update(grads: Dict[str, torch.Tensor], state: AdamWState,
                 params: Dict[str, torch.Tensor], cfg: AdamWConfig
                 ) -> Tuple[Dict[str, torch.Tensor], AdamWState, Dict]:
    """Returns (new_params, new_state, metrics); the inputs stay as they
    were (new tensors throughout, as the reference's functional update)."""
    gnorm = global_norm(grads)
    if cfg.clip_norm > 0:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    else:
        scale = torch.ones_like(gnorm)
    step = state.step + 1
    lr = schedule_lr(cfg, state.step).to(gnorm.device)
    bc1 = 1.0 - cfg.b1 ** step.float()
    bc2 = 1.0 - cfg.b2 ** step.float()
    mdt = _moment_dtype(cfg)
    new_p, new_m, new_v = {}, {}, {}
    for k in params:
        p = params[k]
        g = grads[k].float() * scale
        m32 = state.m[k].float() * cfg.b1 + (1 - cfg.b1) * g
        v32 = state.v[k].float() * cfg.b2 + (1 - cfg.b2) * g * g
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = (mhat / (torch.sqrt(vhat) + cfg.eps)
                 + cfg.weight_decay * p.float())
        new_p[k] = (p.float() - lr * delta).to(p.dtype)
        new_m[k] = m32.to(mdt)
        new_v[k] = v32.to(mdt)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, AdamWState(step=step, m=new_m, v=new_v), metrics
