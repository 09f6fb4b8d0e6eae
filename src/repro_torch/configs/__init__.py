"""Architecture registry of the port.

Usage:  cfg = get_config("smollm-135m")
        cfg = get_config("smollm-135m", variant="long")   # sliding-window attention
        cfg = get_config("smollm-135m", variant="smoke")  # reduced smoke config

The names are the reference's (``repro.configs.ARCH_NAMES``), all ten
ported: the dense decoders ``smollm-135m``, ``internlm2-1.8b``,
``nemotron-4-15b`` and ``qwen1.5-32b``, the MoE decoders
``qwen3-moe-30b-a3b`` and ``llama4-scout-17b-a16e``, the SSM
``mamba2-370m``, the attention/Mamba2/MoE hybrid ``jamba-1.5-large-398b``,
the VLM ``qwen2-vl-2b`` and the encoder-decoder ``whisper-tiny``.
"""

from __future__ import annotations

import dataclasses

from ..models.config import ModelConfig, reduced
from . import (
    internlm2_1_8b,
    jamba_1_5_large_398b,
    llama4_scout_17b_a16e,
    mamba2_370m,
    nemotron_4_15b,
    qwen1_5_32b,
    qwen2_vl_2b,
    qwen3_moe_30b_a3b,
    sensor_field,
    smollm_135m,
    whisper_tiny,
)

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

_MODULES = {
    "smollm-135m": smollm_135m,
    "internlm2-1.8b": internlm2_1_8b,
    "mamba2-370m": mamba2_370m,
    "nemotron-4-15b": nemotron_4_15b,
    "qwen1.5-32b": qwen1_5_32b,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b,
    "llama4-scout-17b-a16e": llama4_scout_17b_a16e,
    "jamba-1.5-large-398b": jamba_1_5_large_398b,
    "qwen2-vl-2b": qwen2_vl_2b,
    "whisper-tiny": whisper_tiny,
}

# sliding window used for the long_500k sub-quadratic variant of attention archs
LONG_CONTEXT_WINDOW = 8192


def long_context_variant(cfg: ModelConfig) -> ModelConfig:
    """Sub-quadratic variant for long contexts: SSM is natively O(1)-state;
    attention-bearing archs get a sliding window (a ring-buffer KV cache of
    LONG_CONTEXT_WINDOW slots)."""
    if cfg.family == "ssm":
        return cfg
    if cfg.is_encoder_decoder:
        raise ValueError(f"{cfg.name}: long_500k is skipped for enc-dec")
    return dataclasses.replace(cfg, sliding_window=LONG_CONTEXT_WINDOW)


def get_config(name: str, *, variant: str | None = None) -> ModelConfig:
    if name not in ARCH_NAMES:
        raise ValueError(f"unknown architecture {name!r}")
    cfg = _MODULES[name].config()
    if variant in (None, "full"):
        return cfg
    if variant == "long":
        return long_context_variant(cfg)
    if variant == "smoke":
        return reduced(cfg)
    raise ValueError(f"unknown variant {variant!r}")


def sensor_field_config() -> sensor_field.SensorFieldConfig:
    """The paper's field-estimation workload (``configs.sensor_field``)."""
    return sensor_field.config()


__all__ = ["ARCH_NAMES", "LONG_CONTEXT_WINDOW", "get_config", "long_context_variant",
           "sensor_field_config"]
