from .adamw import AdamWState, adamw_init, adamw_update, clip_by_global_norm
from .schedules import constant, cosine_with_warmup

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "constant",
    "cosine_with_warmup",
]
