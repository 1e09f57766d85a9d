from .adamw import (AdamWConfig, AdamWState, adamw_init, adamw_update,
                    cosine_schedule, global_norm)

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "cosine_schedule", "global_norm"]
