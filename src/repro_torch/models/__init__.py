"""repro_torch.models — the dense family (init, forward, loss; trained) and
the hybrid (Zamba2) family (init, forward, prefill and decode; served), on
the port's kernels."""

from .decode import (decode_cache_specs, decode_step, init_decode_cache,
                     pad_cache, prefill)
from .model import (chunked_ce_loss, forward, init_params, logits_fn,
                    loss_fn, padded_vocab)

__all__ = ["init_params", "forward", "logits_fn", "loss_fn",
           "chunked_ce_loss", "padded_vocab", "decode_step", "prefill",
           "init_decode_cache", "decode_cache_specs", "pad_cache"]
