"""Learning-rate schedules as step -> lr callables (port of
``repro.optim.schedules``).  The step is converted to float32 and the lr
comes back as a 0-d float32 tensor on the CPU, as the reference computes
it in float32."""

from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def linear_warmup(lr: float, warmup: int, total: int, final_frac: float = 0.1):
    """Linear warmup then linear decay to final_frac * lr."""

    def fn(step):
        step = _step(step)
        warm = lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        decay = lr * (1.0 - (1.0 - final_frac) * frac)
        return torch.where(step < warmup, warm, decay)

    return fn


def cosine_warmup(lr: float, warmup: int, total: int, final_frac: float = 0.1):
    """Linear warmup then cosine decay to final_frac * lr."""

    def fn(step):
        step = _step(step)
        warm = lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = final_frac + (1.0 - final_frac) * 0.5 * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, lr * cos)

    return fn
