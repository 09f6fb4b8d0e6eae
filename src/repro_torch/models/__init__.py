"""The port's model stack: dense decoders (GQA attention + MLP), MoE
decoders (GQA attention + GShard top-k experts) and Mamba2 (SSM family),
serving and training."""

from .config import ModelConfig, reduced
from .model import (
    cross_entropy,
    decode_step,
    forward_logits,
    greedy_decode,
    init_cache,
    init_params,
    loss_fn,
    make_train_step,
    prefill,
)

__all__ = [
    "ModelConfig",
    "cross_entropy",
    "decode_step",
    "forward_logits",
    "greedy_decode",
    "init_cache",
    "init_params",
    "loss_fn",
    "make_train_step",
    "prefill",
    "reduced",
]
