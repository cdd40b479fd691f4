"""repro_torch.models — the architecture zoo: the dense (with qwen2-vl's
M-RoPE backbone), MoE, SSM (Mamba2), hybrid (Zamba2) and enc-dec (the
Whisper backbone) families: init, forward, loss, caches, prefill and
decode, on the port's kernels; the dense family is also trained."""

from .decode import (decode_cache_specs, decode_step, init_decode_cache,
                     prefill)
from .model import (chunked_ce_loss, forward, init_params, logits_fn,
                    loss_fn, padded_vocab)

__all__ = ["init_params", "forward", "logits_fn", "loss_fn",
           "chunked_ce_loss", "padded_vocab", "decode_step", "prefill",
           "init_decode_cache", "decode_cache_specs"]
