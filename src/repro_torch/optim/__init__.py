"""Optimizer substrate: AdamW and its schedule on trees of tensors."""

from .adamw import (AdamWConfig, AdamWState, adamw_init, adamw_update,
                    adamw_update_, global_norm, opt_state_specs)
from .schedule import cosine_schedule

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "adamw_update_", "global_norm", "opt_state_specs", "cosine_schedule"]
