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

Parameters, gradients and moments are dicts of tensors, nested as the
model's are (``{"layers": {"wq": ...}}``); their leaves are visited in
the reference's ``jax.tree.leaves`` order (sorted keys, recursively).
:func:`adamw_update` is functional, as the reference's; the model's train
step uses :func:`adamw_update_`, which writes the same float32 operations'
results into the parameters and moments in place, a slice of each leaf at
a time: a functional update of a model at full width would hold the old
and the new state and a whole stack's float32 temporaries at once.

On a device mesh (DTensor trees, each gradient and moment laid out as its
parameter) :func:`global_norm` sums each rank's shards' squares into one
partial sum, all-reduced once, and :func:`adamw_update_` updates each
rank's shards in place with the same operations; the order of the
norm's float32 sums is then the ranks' shards', not the reference's
leaf order alone.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, NamedTuple, Tuple, Union

import torch

from ..kernels.common import is_dtensor as _dtensor


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Dict
    v: Dict


def tree_leaves(tree: Dict) -> List[torch.Tensor]:
    """The tensors of a nested dict in ``jax.tree.leaves`` order."""
    return [x for _, x in tree_items(tree)]


def tree_items(tree: Dict, prefix: Tuple[str, ...] = ()
               ) -> Iterator[Tuple[Tuple[str, ...], torch.Tensor]]:
    """(key path, tensor) pairs of a nested dict, keys sorted at every
    level."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from tree_items(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def tree_map(fn: Callable, tree: Dict, *rest: Dict) -> Dict:
    """``fn`` over the leaves of nested dicts of one structure."""
    return {k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def tree_get(tree: Dict, path: Tuple[str, ...]) -> torch.Tensor:
    for k in path:
        tree = tree[k]
    return tree


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


def adamw_init(params: Dict, cfg: AdamWConfig) -> AdamWState:
    mdt = _moment_dtype(cfg)

    def zeros(p):
        return torch.zeros(p.shape, dtype=mdt, device=p.device)

    return AdamWState(
        step=torch.zeros((), dtype=torch.int32,
                         device=tree_leaves(params)[0].device),
        m=tree_map(zeros, params), v=tree_map(zeros, params))


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


def _local(t):
    return t.to_local() if _dtensor(t) else t


def global_norm(tree: Dict) -> torch.Tensor:
    """The float32 L2 norm of every leaf together, leaves in
    ``jax.tree.leaves`` order.  Of DTensor leaves: each rank sums the
    squares of its shards in that order (a leaf replicated over a mesh
    axis is counted by that axis's rank 0 only), and that partial sum is
    all-reduced once; a replicated scalar."""
    leaves = tree_leaves(tree)
    if not _dtensor(leaves[0]):
        leaves = [torch.sum(torch.square(x.float())) for x in leaves]
        return torch.sqrt(torch.sum(torch.stack(leaves)))
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = leaves[0].device_mesh
    coord = mesh.get_coordinate()
    parts = []
    for x in leaves:
        if any(p.is_partial() for p in x.placements):
            raise ValueError("global_norm takes leaves laid out as their "
                             "parameters, not partial sums")
        s = torch.sum(torch.square(x.to_local().float()))
        if any(p.is_replicate() and c for p, c in zip(x.placements, coord)):
            s = torch.zeros_like(s)
        parts.append(s)
    total = DTensor.from_local(torch.sum(torch.stack(parts)), mesh,
                               [Partial()] * mesh.ndim, run_check=False)
    return torch.sqrt(total.redistribute(mesh, [Replicate()] * mesh.ndim))


def _coefficients(grads: Dict, state: AdamWState, cfg: AdamWConfig):
    """The step's clip scale, new step count, learning rate and bias
    corrections, and the metrics."""
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
    return scale, step, lr, bc1, bc2, {"grad_norm": gnorm, "lr": lr}


def _update(g, m, v, p, cfg, scale, lr, bc1, bc2):
    """One leaf's (new p, m32, v32), in the reference's float32 order."""
    g = g.float() * scale
    m32 = m.float() * cfg.b1 + (1 - cfg.b1) * g
    v32 = v.float() * cfg.b2 + (1 - cfg.b2) * g * g
    mhat = m32 / bc1
    vhat = v32 / bc2
    delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
    return (p.float() - lr * delta).to(p.dtype), m32, v32


@torch.no_grad()
def adamw_update(grads: Dict, state: AdamWState, params: Dict,
                 cfg: AdamWConfig) -> Tuple[Dict, AdamWState, Dict]:
    """Returns (new_params, new_state, metrics); the inputs stay as they
    were (new tensors throughout, as the reference's functional update)."""
    scale, step, lr, bc1, bc2, metrics = _coefficients(grads, state, cfg)
    mdt = _moment_dtype(cfg)
    flat = tree_map(lambda g, m, v, p: _update(g, m, v, p, cfg, scale, lr,
                                               bc1, bc2),
                    grads, state.m, state.v, params)
    new_p = tree_map(lambda t: t[0], flat)
    new_m = tree_map(lambda t: t[1].to(mdt), flat)
    new_v = tree_map(lambda t: t[2].to(mdt), flat)
    return new_p, AdamWState(step=step, m=new_m, v=new_v), metrics


#: elements of one slice of the in-place update (256 MB of float32)
SLICE_ELEMENTS = 1 << 26


@torch.no_grad()
def adamw_update_(grads: Dict, state: AdamWState, params: Dict,
                  cfg: AdamWConfig) -> Tuple[Dict, AdamWState, Dict]:
    """:func:`adamw_update` written into ``params`` and ``state``'s moments
    in place; returns (params, new_state, metrics) with the same tensors.
    Each leaf is walked in slices along its leading axis (a stacked leaf
    layer by layer) of at most ``SLICE_ELEMENTS``, so the float32
    temporaries are one slice's; the operations are elementwise and the
    same, so the result equals the functional update bit for bit.
    DTensor leaves are updated on each rank's shards, the gradients and
    moments laid out as their parameters."""
    scale, step, lr, bc1, bc2, metrics = _coefficients(grads, state, cfg)
    scale, lr, bc1, bc2 = (_local(t) for t in (scale, lr, bc1, bc2))
    for path, p in tree_items(params):
        g, m, v = (tree_get(t, path) for t in (grads, state.m, state.v))
        if _dtensor(p):
            if any(t.placements != p.placements for t in (g, m, v)):
                raise ValueError(f"{'/'.join(path)}: gradient and moments "
                                 f"must be laid out as the parameter")
            p, g, m, v = (t.to_local() for t in (p, g, m, v))
        n = p.shape[0] if p.dim() else 1
        rows = max(1, SLICE_ELEMENTS // max(p[0].numel() if p.dim() else 1,
                                            1))
        for lo in range(0, n, rows):
            sl = (slice(lo, lo + rows),) if p.dim() else (Ellipsis,)
            new_p, m32, v32 = _update(g[sl], m[sl], v[sl], p[sl], cfg,
                                      scale, lr, bc1, bc2)
            p[sl].copy_(new_p)
            m[sl].copy_(m32)
            v[sl].copy_(v32)
    return params, AdamWState(step=step, m=state.m, v=state.v), metrics
