"""repro_torch.models — the hybrid (Zamba2) family: init, forward, prefill
and decode, on the port's kernels."""

from .decode import (decode_cache_specs, decode_step, init_decode_cache,
                     pad_cache, prefill)
from .model import forward, init_params, logits_fn

__all__ = ["init_params", "forward", "logits_fn", "decode_step", "prefill",
           "init_decode_cache", "decode_cache_specs", "pad_cache"]
