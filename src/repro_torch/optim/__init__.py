"""repro_torch.optim — AdamW as plain functions on (nested) dicts of
tensors: the functional update and the in-place one."""

from .adamw import (AdamWConfig, AdamWState, adamw_init, adamw_update,
                    adamw_update_, global_norm, schedule_lr, tree_items,
                    tree_leaves, tree_map)

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "adamw_update_", "global_norm", "schedule_lr", "tree_items",
           "tree_leaves", "tree_map"]
