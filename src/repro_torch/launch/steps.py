"""Step builders of the trainer and the serving engine:
``make_train_step`` (forward, backward and AdamW, with optional
microbatched gradient accumulation and gradient compression) and
``make_serve_step`` / ``make_prefill_step``.

The port of ``repro.launch.steps`` but its shape stand-ins
(``input_specs``, ``params_shape``, ``opt_shape``), which wait for the
dry-run slice (ROADMAP queue 1).  The reference's ``jax.value_and_grad``
is autograd over detached copies of the parameters
(:func:`value_and_grad`); its ``lax.scan`` over microbatches is a Python
loop; the update is :func:`repro_torch.optim.adamw_update_`, in place.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..configs.base import ModelConfig
from ..models.decode import decode_step, prefill
from ..models.model import loss_fn
from ..optim.adamw import AdamWConfig, AdamWState, adamw_update_, tree_map


def value_and_grad(fn: Callable, params: Dict, *args) -> Tuple:
    """``((loss, aux), grads)`` of ``fn(params, *args) -> (loss, aux)``:
    grads nested as ``params``, each in its parameter's dtype (zeros for a
    parameter the loss does not reach, as ``jax.grad`` gives)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, aux = fn(leaves, *args)
    loss.backward()
    grads = tree_map(lambda t: t.grad if t.grad is not None
                     else torch.zeros_like(t), leaves)
    return (loss.detach(), aux), grads


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    microbatches: int = 1, compressor=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics); ``params`` and the moments are updated in place and
    returned.

    microbatches > 1 splits the batch along B into that many slices and
    sums their gradients in float32, then divides by the count, as the
    reference does (microbatch 1 keeps the parameters' dtype);
    ``compressor`` optionally compresses the gradients before the update
    (see ``repro_torch.distributed.compression``).  The reference's
    ``attn_impl`` has no counterpart: the port has one attention, the
    flash kernel."""

    def lf(p, b):
        return loss_fn(cfg, p, b)

    def train_step(params, opt_state: AdamWState, batch):
        if microbatches == 1:
            (loss, aux), grads = value_and_grad(lf, params, batch)
        else:
            B = batch["tokens"].shape[0]
            if B % microbatches:
                raise ValueError(f"batch {B} does not split into "
                                 f"{microbatches} microbatches")
            n = B // microbatches
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            for i in range(microbatches):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                (l, _), g = value_and_grad(lf, params, mb)
                tree_map(lambda acc, gi: acc.add_(gi), grads, g)
                del g
                loss = loss + l
            grads = tree_map(lambda g: g / microbatches, grads)
            loss = loss / microbatches
            aux = {}
        if compressor is not None:
            grads = compressor(grads)
        params, new_opt, metrics = adamw_update_(grads, opt_state, params,
                                                 opt_cfg)
        metrics = {"loss": loss, **metrics}
        if "expert_load" in aux:
            metrics["expert_load"] = aux["expert_load"]
        return params, new_opt, metrics

    return train_step


def make_serve_step(cfg: ModelConfig):
    """serve_step(params, cache, token) -> (logits, cache): one decode
    step, the cache updated in place (``models.decode_step``)."""
    def serve_step(params, cache, token):
        return decode_step(cfg, params, cache, token)
    return serve_step


def make_prefill_step(cfg: ModelConfig, attn_impl: str = "auto"):
    """prefill_step(params, batch) -> (logits, cache) of
    ``batch["tokens"]`` and, for the enc-dec family, ``batch["embeds"]``
    (``models.prefill``)."""
    def prefill_step(params, batch):
        return prefill(cfg, params, batch["tokens"],
                       embeds=batch.get("embeds"), attn_impl=attn_impl)
    return prefill_step


__all__ = ["make_train_step", "make_serve_step", "make_prefill_step",
           "value_and_grad"]
