"""Shared layers of the port's model stack: init helpers, dense, norms.

The subset of the reference's ``repro.models.layers`` that the SSM family
uses.  Conventions:
  * weights keep the reference's layouts (a dense weight is (d_in, d_out),
    applied as ``x @ w``), so the reference's parameters carry across as
    they are (``repro_torch.convert.lm_params_from_numpy``);
  * every init helper draws from an explicit ``torch.Generator``;
  * activations follow ``cfg.dtype``; norm and SSM math run in float32, or
    in float64 for a float64 model (``wide``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def wide(dtype: torch.dtype) -> torch.dtype:
    """The compute dtype for activations of ``dtype``: float32, or float64."""
    return torch.promote_types(dtype, torch.float32)


def _normal(gen: torch.Generator, shape, scale: float, dtype: torch.dtype) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn in float32 on the generator's device, then cast."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (scale * w).to(dtype)


def param(t: torch.Tensor) -> nn.Parameter:
    """A serving-only parameter: no gradient is recorded through it."""
    return nn.Parameter(t, requires_grad=False)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype: torch.dtype) -> nn.Parameter:
    return param(_normal(gen, (d_in, d_out), d_in**-0.5, dtype))


def dense(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return x @ w


class RMSNorm(nn.Module):
    """The reference's ``norm_init`` / ``apply_norm`` for ``norm="rmsnorm"``."""

    def __init__(self, scale: torch.Tensor):
        super().__init__()
        self.scale = param(scale)


def norm_init(cfg: ModelConfig, device: torch.device) -> RMSNorm:
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(
            f"norm={cfg.norm!r} is not ported yet (ROADMAP Queue 1 item 9)"
        )
    return RMSNorm(torch.ones(cfg.d_model, dtype=cdtype(cfg), device=device))


def apply_norm(p: RMSNorm, x: torch.Tensor) -> torch.Tensor:
    xf = x.to(wide(x.dtype))
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + 1e-6)
    return (y * p.scale.to(xf.dtype)).to(x.dtype)


def rms_norm_gated(scale: torch.Tensor, x: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """Mamba2's gated RMSNorm: norm(x * silu(gate)) * scale.

    ``x * silu(gate)`` is formed in the activation dtype and only then cast
    to float32, as the reference does: in bf16 the product is rounded once
    more before the norm.
    """
    xf = (x * F.silu(gate)).to(wide(x.dtype))
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + 1e-6) * scale.to(xf.dtype)).to(x.dtype)
