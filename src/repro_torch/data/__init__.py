"""repro_torch.data — the training token stream and the serving request
generator."""

from .pipeline import (DataConfig, Request, TokenPipeline, field_rng,
                       request_lengths, synthetic_requests)

__all__ = ["DataConfig", "TokenPipeline", "Request", "field_rng",
           "request_lengths", "synthetic_requests"]
