"""The port's model stack, serving and training: dense decoders (GQA
attention + MLP), MoE decoders (GQA attention + GShard top-k experts),
Mamba2 (SSM family), the attention/Mamba2/MoE hybrid, the VLM decoder
(M-RoPE behind a patch prefix) and the encoder-decoder (``encdec``)."""

from .config import ModelConfig, reduced
from .model import (
    cross_entropy,
    decode_start,
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
    "decode_start",
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
