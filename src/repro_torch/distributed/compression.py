"""Gradient compression with error feedback.

The port of ``repro.distributed.compression``.  ``EFCompressor`` adds the
compression residual of step t back into the gradient at step t+1
(Seide et al. / Karimireddy et al.).  Two codecs:

* ``int8`` — per-tensor absmax scaling to int8 (4x smaller all-reduce);
* ``topk`` — keep the top-k fraction by magnitude (sparse sync).

The compressor keeps its residual as a Python attribute.  The port's train
step runs eagerly, so the residual carries from one step to the next, as
the code says.  The reference calls it inside a ``jax.jit``-compiled step,
where the attribute is set only while tracing: there every step starts
from a zero residual, and the attribute is left holding a tracer
(ROADMAP §3 records the difference; ``tests/test_torch_autotune.py`` pins
both).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..optim.adamw import tree_map


def _compress_int8(g: torch.Tensor) -> torch.Tensor:
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q.float() * scale


def _compress_topk(g: torch.Tensor, frac: float) -> torch.Tensor:
    flat = g.reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.topk(flat.abs(), k).values[-1]
    return torch.where(g.abs() >= thresh, g, torch.zeros_like(g))


class EFCompressor:
    """Stateful wrapper: holds the error-feedback residual (a nested dict of
    float32 tensors shaped as the gradients)."""

    def __init__(self, codec: str = "int8", topk_frac: float = 0.01):
        if codec not in ("int8", "topk"):
            raise ValueError(f"unknown codec {codec!r}; use 'int8' or "
                             "'topk'")
        self.codec = codec
        self.topk_frac = topk_frac
        self.residual: Optional[Dict] = None

    def init(self, params: Dict) -> None:
        self.residual = tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)

    def _one(self, g: torch.Tensor, r: torch.Tensor):
        x = g.float() + r
        if self.codec == "int8":
            c = _compress_int8(x)
        else:
            c = _compress_topk(x, self.topk_frac)
        return c, x - c

    def __call__(self, grads: Dict) -> Dict:
        if self.residual is None:
            self.init(grads)
        pairs = tree_map(self._one, grads, self.residual)
        self.residual = tree_map(lambda t: t[1], pairs)
        return tree_map(lambda t: t[0], pairs)


def compression_ratio(codec: str, topk_frac: float = 0.01) -> float:
    return 0.25 if codec == "int8" else topk_frac * 2  # value+index


__all__ = ["EFCompressor", "compression_ratio"]
