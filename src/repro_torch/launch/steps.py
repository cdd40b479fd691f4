"""Step builders of the trainer and the serving engine:
``make_train_step`` (forward, backward and AdamW, with optional
microbatched gradient accumulation and gradient compression) and
``make_serve_step`` / ``make_prefill_step``; and the shape stand-ins of
every (arch x shape) cell (``params_shape``, ``opt_shape``,
``input_specs``), which allocate nothing.

The port of ``repro.launch.steps``.  The reference's ``jax.value_and_grad``
is autograd over detached copies of the parameters
(:func:`value_and_grad`); its ``lax.scan`` over microbatches is a Python
loop; the update is :func:`repro_torch.optim.adamw_update_`, in place.
Its ``jax.eval_shape`` stand-ins are tensors on the ``meta`` device (the
parameters and the AdamW state) and :class:`TensorSpec` records of shape
and dtype (the model inputs and the decode cache).

The train and prefill steps take DTensor trees as they take plain ones
(the dense family partitioned on a device mesh, ``models/model.py``):
the gradients come back laid out as their parameters, a replicated
parameter's partial sums all-reduced; microbatches split each rank's
own rows; the update runs on each rank's shards (``optim.adamw``).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..distributed.ctx import is_dtensor, redistribute, strides
from ..models.decode import (TensorSpec, decode_cache_specs, decode_step,
                             prefill)
from ..models.model import _dtype, init_params, loss_fn
from ..optim.adamw import (AdamWConfig, AdamWState, adamw_init,
                           adamw_update_, tree_map)


def value_and_grad(fn: Callable, params: Dict, *args) -> Tuple:
    """``((loss, aux), grads)`` of ``fn(params, *args) -> (loss, aux)``:
    grads nested as ``params``, each in its parameter's dtype (zeros for a
    parameter the loss does not reach, as ``jax.grad`` gives) and, for a
    DTensor parameter, laid out as it is."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, aux = fn(leaves, *args)
    loss.backward()
    grads = tree_map(_grad, leaves)
    return (loss.detach(), aux), grads


def _grad(t):
    if t.grad is None:
        return torch.zeros_like(t)
    if is_dtensor(t):       # a replicated leaf's partial sums all-reduced
        return redistribute(t.grad, t.placements)
    return t.grad


def _microbatch(x, i: int, n: int):
    """The i-th of ``n`` microbatches of a batch leaf: rows i*B/n to
    (i+1)*B/n; of a DTensor, the i-th slice of each rank's own rows, laid
    out as x (so the ranks' rows interleave where the plain split takes
    contiguous ones)."""
    if not is_dtensor(x):
        b = x.shape[0] // n
        return x[i * b:(i + 1) * b]
    from torch.distributed.tensor import DTensor
    loc = x.to_local()
    b = loc.shape[0] // n
    if b * n != loc.shape[0]:
        raise ValueError(f"a rank's {loc.shape[0]} rows do not split into "
                         f"{n} microbatches")
    shape = torch.Size((x.shape[0] // n,) + tuple(x.shape[1:]))
    return DTensor.from_local(loc[i * b:(i + 1) * b], x.device_mesh,
                              x.placements, run_check=False, shape=shape,
                              stride=strides(shape))


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
            grads = tree_map(_zeros32, params)
            loss = (None if is_dtensor(batch["tokens"]) else
                    torch.zeros((), dtype=torch.float32,
                                device=batch["tokens"].device))
            for i in range(microbatches):
                mb = {k: _microbatch(v, i, microbatches)
                      for k, v in batch.items()}
                (l, _), g = value_and_grad(lf, params, mb)
                tree_map(lambda acc, gi: acc.add_(gi), grads, g)
                del g
                loss = l if loss is None else loss + l
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


def _zeros32(p):
    """A float32 gradient accumulator for ``p`` (laid out as p)."""
    if is_dtensor(p):
        return torch.zeros_like(p, dtype=torch.float32)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


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


# ---------------------------------------------------------------------------
# shape stand-ins
# ---------------------------------------------------------------------------

def params_shape(cfg: ModelConfig) -> Dict:
    """The parameter tree of ``cfg``: its keys, shapes and dtypes, as
    tensors on the ``meta`` device (no memory)."""
    return init_params(cfg, 0, device="meta")


def opt_shape(cfg: ModelConfig, opt_cfg: AdamWConfig) -> AdamWState:
    """The AdamW state of ``cfg``'s parameters (the step, m and v) on the
    ``meta`` device."""
    return adamw_init(params_shape(cfg), opt_cfg)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """The model inputs of one cell as :class:`TensorSpec` records: the
    train kind's int32 ``tokens`` and ``labels`` (B, S), the prefill
    kind's ``tokens``, each with the enc-dec family's ``embeds`` (B,
    encoder_seq, d_model) in the parameters' dtype; the decode kind's
    ``token`` (B,) and its cache of S positions
    (``models.decode_cache_specs``)."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"token": TensorSpec((B,), torch.int32),
                "cache": decode_cache_specs(cfg, B, S)}
    if shape.kind not in ("train", "prefill"):
        raise ValueError(shape.kind)
    out = {"tokens": TensorSpec((B, S), torch.int32)}
    if shape.kind == "train":
        out["labels"] = TensorSpec((B, S), torch.int32)
    if cfg.family == "encdec":
        out["embeds"] = TensorSpec((B, cfg.encoder_seq, cfg.d_model),
                                   _dtype(cfg))
    return out


__all__ = ["make_train_step", "make_serve_step", "make_prefill_step",
           "value_and_grad", "params_shape", "opt_shape", "input_specs",
           "TensorSpec"]
