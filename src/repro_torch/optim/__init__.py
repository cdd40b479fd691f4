"""repro_torch.optim — AdamW as plain functions on dicts of tensors."""

from .adamw import (AdamWConfig, AdamWState, adamw_init, adamw_update,
                    global_norm, schedule_lr)

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "global_norm", "schedule_lr"]
