"""Model API of the port, serving half (the reference's ``repro.models.model``):

    params          = init_params(cfg, seed, device=)
    logits, metrics = forward_logits(cfg, params, batch)
    cache           = init_cache(cfg, batch_size, max_seq, device=)
    logits, cache   = prefill(cfg, params, batch, cache)
    logits, cache   = decode_step(cfg, params, token, cache, position)
    tokens, cache   = greedy_decode(cfg, params, prompt, n_steps, max_seq)

``batch`` is a dict holding ``tokens`` (B, S).  The loss and the train step
come with the training slice (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

import torch

from .. import device as _device
from . import transformer as T
from .config import ModelConfig
from .layers import cdtype
from .transformer import Decoder


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device: str | torch.device = "cuda") -> Decoder:
    """Random parameters on ``device``, drawn from a ``torch.Generator``
    seeded with ``seed`` (the reference's ``jax.random`` keys draw other
    numbers: tests carry the reference's parameters across instead)."""
    dev = _device.resolve(device)
    return T.init_decoder_params(torch.Generator(device=dev).manual_seed(seed), cfg)


def forward_logits(cfg: ModelConfig, params: Decoder, batch: dict):
    return T.decoder_forward(params, cfg, batch["tokens"])


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None, *,
               device: str | torch.device = "cuda") -> list[dict]:
    return T.init_decoder_cache(cfg, batch, max_seq, dtype or cdtype(cfg),
                                _device.resolve(device))


def prefill(cfg: ModelConfig, params: Decoder, batch: dict, cache: list[dict]):
    """Process the prompt; returns (last-position logits (B, 1, V), cache)."""
    return T.decoder_prefill(params, cfg, batch["tokens"], cache)


def decode_step(cfg: ModelConfig, params: Decoder, token: torch.Tensor,
                cache: list[dict], position):
    """One-token serve step: returns (logits (B, 1, V), new cache)."""
    return T.decoder_decode_step(params, cfg, token, cache, position)


def greedy_decode(cfg: ModelConfig, params: Decoder, prompt: torch.Tensor, n_steps: int,
                  max_seq: int) -> tuple[torch.Tensor, list[dict]]:
    """Prefill + ``n_steps`` greedy decode steps: ((B, n_steps) int64, cache)."""
    b, s0 = prompt.shape
    cache = init_cache(cfg, b, max_seq, device=prompt.device)
    logits, cache = prefill(cfg, params, {"tokens": prompt}, cache)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    out = []
    for i in range(n_steps):
        logits, cache = decode_step(cfg, params, tok, cache, s0 + i)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        out.append(tok)
    return torch.cat(out, dim=1), cache
