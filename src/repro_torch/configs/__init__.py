"""Architecture registry of the port.

Usage:  cfg = get_config("mamba2-370m")
        cfg = get_config("mamba2-370m", variant="smoke")  # reduced smoke config

The names are the reference's (``repro.configs.ARCH_NAMES``); only
``mamba2-370m`` is ported.  The others need attention, MLP, MoE,
encoder-decoder or VLM layers, which come with ROADMAP Queue 1 item 9, and
``get_config`` refuses them.
"""

from __future__ import annotations

from ..models.config import ModelConfig, reduced
from . import mamba2_370m

ARCH_NAMES = [
    "smollm-135m",
    "llama4-scout-17b-a16e",
    "internlm2-1.8b",
    "qwen2-vl-2b",
    "jamba-1.5-large-398b",
    "mamba2-370m",
    "nemotron-4-15b",
    "whisper-tiny",
    "qwen3-moe-30b-a3b",
    "qwen1.5-32b",
]

_MODULES = {"mamba2-370m": mamba2_370m}


def get_config(name: str, *, variant: str | None = None) -> ModelConfig:
    if name not in ARCH_NAMES:
        raise ValueError(f"unknown architecture {name!r}")
    if name not in _MODULES:
        raise NotImplementedError(
            f"{name} is not ported yet: its attention/MLP/MoE layers come with "
            "ROADMAP Queue 1 item 9 (the LLM stack)"
        )
    cfg = _MODULES[name].config()
    if variant in (None, "full"):
        return cfg
    if variant == "smoke":
        return reduced(cfg)
    raise ValueError(f"unknown variant {variant!r}")


__all__ = ["ARCH_NAMES", "get_config"]
