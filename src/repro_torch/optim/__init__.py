"""Optimizers and schedules, the port of ``repro.optim`` (no library
optimizer): AdamW with decoupled weight decay, global-norm clipping, bias
correction, a configurable moment dtype and an Adafactor-style factored
second moment, over a model's named parameters."""
from .adamw import (  # noqa: F401
    AdamWConfig, adamw_init, adamw_update, clip_by_global_norm,
)
from .schedule import warmup_cosine  # noqa: F401

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "clip_by_global_norm",
           "warmup_cosine"]
