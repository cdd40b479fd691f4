"""repro_torch.data — the serving request generator."""

from .pipeline import (Request, field_rng, request_lengths,
                       synthetic_requests)

__all__ = ["Request", "field_rng", "request_lengths", "synthetic_requests"]
