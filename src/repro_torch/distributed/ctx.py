"""Activation-sharding context: the model stack's flags.

The port of ``repro.distributed.ctx``.  The reference installs a context
that constrains the block-boundary activations, the grouped MoE tokens
and the expert weights to a device mesh, and carries three flags to the
model: ``moe_groups`` (the MoE dispatch's token groups), ``attn_bf16``
and ``attn_remat`` (its chunked attention's score dtype and per-chunk
rematerialization).

On one card there is no mesh to constrain to, so the ``constrain_*``
functions are identities here (the port's model leaves the sharding hints
out).  ``moe_groups`` is read by the MoE block's prefill
(``models/model.py::_moe_block_apply``).  Nothing in the port reads
``attn_bf16`` or ``attn_remat``: they feed only the reference's chunked
attention, and the port's attention is the flash kernel, whose scores are
always float32 and never stored.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

_STATE: dict = {"attn_bf16": False, "attn_remat": False, "moe_groups": 1}


@contextmanager
def activation_sharding(dp, tp: Optional[str], dp_size: int, tp_size: int,
                        attn_bf16: bool = False, attn_remat: bool = False,
                        moe_groups: int = 1):
    """Install the flags until the context closes.  The mesh axes' names
    and sizes (``dp``, ``tp``, ``dp_size``, ``tp_size``) are the
    reference's arguments; on one card nothing reads them."""
    prev = dict(_STATE)
    _STATE.update(attn_bf16=attn_bf16, attn_remat=attn_remat,
                  moe_groups=moe_groups)
    try:
        yield
    finally:
        _STATE.update(prev)


def attn_bf16() -> bool:
    return _STATE["attn_bf16"]


def attn_remat() -> bool:
    return _STATE["attn_remat"]


def moe_groups() -> int:
    return _STATE["moe_groups"]


def constrain_expert_weights(w, kind: str):
    """Identity on one card (the reference gathers FSDP expert weights)."""
    return w


def constrain_tokens_grouped(xg):
    """Identity on one card (the reference spreads the MoE groups over the
    data axes)."""
    return xg


def constrain_boundary(x):
    """Identity on one card (the reference shards block-boundary
    activations over the mesh)."""
    return x


__all__ = ["activation_sharding", "attn_bf16", "attn_remat", "moe_groups",
           "constrain_expert_weights", "constrain_tokens_grouped",
           "constrain_boundary"]
