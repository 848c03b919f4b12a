"""The optimizer of the LM training path."""

from repro_torch.optim.adamw import (
    AdamWState, adamw_apply, adamw_init, clip_by_global_norm, default_decay_mask, global_norm, lr_at,
)

__all__ = ["AdamWState", "adamw_apply", "adamw_init", "clip_by_global_norm", "default_decay_mask",
           "global_norm", "lr_at"]
