"""Optimizers and LR schedules of the port (``repro.optim``'s formulas).

Functional style: an ``Optimizer`` is (init, update) where
  state = init(params)
  updates, state = update(grads, state, params)
  params = apply_updates(params, updates)
"""

from .optimizers import (
    Optimizer,
    adamw,
    apply_updates,
    clip_by_global_norm,
    global_norm,
    lion,
    sgd,
)
from .schedules import constant, cosine_warmup, linear_warmup

__all__ = [
    "Optimizer",
    "adamw",
    "apply_updates",
    "clip_by_global_norm",
    "constant",
    "cosine_warmup",
    "global_norm",
    "linear_warmup",
    "lion",
    "sgd",
]
