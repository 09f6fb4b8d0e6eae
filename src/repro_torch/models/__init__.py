"""The port's model stack: the Mamba2 (SSM family) serving path so far."""

from .config import ModelConfig, reduced
from .model import (
    decode_step,
    forward_logits,
    greedy_decode,
    init_cache,
    init_params,
    prefill,
)

__all__ = [
    "ModelConfig",
    "decode_step",
    "forward_logits",
    "greedy_decode",
    "init_cache",
    "init_params",
    "prefill",
    "reduced",
]
