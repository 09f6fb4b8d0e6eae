"""Decoder-only stack of the port, SSM family: embed -> n_layers x (norm ->
Mamba2 mixer -> residual) -> final norm -> tied head.

The reference's ``repro.models.transformer`` scans stacked super-blocks
with ``lax.scan``; here each layer is an ``nn.Module`` in an
``nn.ModuleList`` and the stack is a Python loop.  The cache is a list with
one ``{"state", "conv"}`` dict per layer.  Attention layers (kind ``"a"``),
FFN / MoE sub-layers, VLM patches, M-RoPE, encoder-decoder stacks and
untied heads are not ported yet (ROADMAP Queue 1 item 9) and raise.
"""

from __future__ import annotations

import torch
from torch import nn

from . import layers as L
from . import ssm as S
from .config import ModelConfig


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 item 9)")


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is a pure-SSM decoder with a tied head."""
    if cfg.is_encoder_decoder:
        raise _not_ported("the encoder-decoder stack")
    if any(cfg.layer_kind(i) != "m" for i in range(cfg.n_layers)):
        raise _not_ported("attention layers (layer kind 'a')")
    if cfg.has_ffn:
        raise _not_ported("FFN and MoE sub-layers")
    if cfg.n_patches or cfg.rope_mode == "mrope":
        raise _not_ported("VLM patches and M-RoPE")
    if not cfg.tie_embeddings:
        raise _not_ported("an untied LM head")


class MixerLayer(nn.Module):
    """norm1 -> Mamba2 mixer, added to the residual stream."""

    def __init__(self, norm1: L.RMSNorm, ssm: S.SSMMixer):
        super().__init__()
        self.norm1 = norm1
        self.ssm = ssm


class Decoder(nn.Module):
    def __init__(self, embed: torch.Tensor, final_norm: L.RMSNorm, layers: list[MixerLayer]):
        super().__init__()
        self.embed = L.param(embed)  # (V, d); the head is embed^T
        self.final_norm = final_norm
        self.layers = nn.ModuleList(layers)


def init_decoder_params(gen: torch.Generator, cfg: ModelConfig) -> Decoder:
    check_supported(cfg)
    dev = gen.device
    embed = L._normal(gen, (cfg.vocab_size, cfg.d_model), 0.02, L.cdtype(cfg))
    layers = [MixerLayer(L.norm_init(cfg, dev), S.ssm_init(gen, cfg))
              for _ in range(cfg.n_layers)]
    return Decoder(embed, L.norm_init(cfg, dev), layers)


def embed_inputs(params: Decoder, cfg: ModelConfig, tokens: torch.Tensor,
                 patch_embeds=None) -> torch.Tensor:
    if patch_embeds is not None:
        raise _not_ported("VLM patches")
    return params.embed[tokens]


def _head(params: Decoder, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return L.apply_norm(params.final_norm, x) @ params.embed.T


def _zero_metrics(cfg: ModelConfig, device) -> dict[str, torch.Tensor]:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"aux_loss": z, "z_loss": z.clone(),
            "expert_load": torch.zeros(max(cfg.n_experts, 1), device=device)}


def decoder_forward(
    params: Decoder, cfg: ModelConfig, tokens: torch.Tensor, *, patch_embeds=None
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Returns (logits (B, S, V), MoE metrics, all zero for the SSM family)."""
    check_supported(cfg)
    x = embed_inputs(params, cfg, tokens, patch_embeds)
    for layer in params.layers:
        x = x + S.ssm_forward(layer.ssm, cfg, L.apply_norm(layer.norm1, x))
    return _head(params, cfg, x), _zero_metrics(cfg, x.device)


def init_decoder_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype,
                       device) -> list[dict]:
    """One ``{"state", "conv"}`` dict per layer; the SSM cache does not grow
    with ``max_seq``."""
    check_supported(cfg)
    return [S.init_ssm_cache(cfg, batch, dtype, device) for _ in range(cfg.n_layers)]


def decoder_prefill(
    params: Decoder, cfg: ModelConfig, tokens: torch.Tensor, cache: list[dict], *,
    patch_embeds=None,
) -> tuple[torch.Tensor, list[dict]]:
    """Run the full prompt, fill the cache, return last-position logits (B, 1, V)."""
    check_supported(cfg)
    x = embed_inputs(params, cfg, tokens, patch_embeds)
    new_cache = []
    for layer, c in zip(params.layers, cache):
        h, state, conv = S.ssm_forward_with_state(layer.ssm, cfg,
                                                  L.apply_norm(layer.norm1, x))
        new_cache.append({"state": state, "conv": conv.to(c["conv"].dtype)})
        x = x + h
    return _head(params, cfg, x[:, -1:]), new_cache


def decoder_decode_step(
    params: Decoder, cfg: ModelConfig, token: torch.Tensor, cache: list[dict], position
) -> tuple[torch.Tensor, list[dict]]:
    """One token (B, 1) through the stack against the cache: (logits (B, 1, V),
    cache).  ``position`` is the absolute index; the SSM stack needs none."""
    x = params.embed[token]
    new_cache = []
    for layer, c in zip(params.layers, cache):
        h, c = S.ssm_decode(layer.ssm, cfg, L.apply_norm(layer.norm1, x), c)
        new_cache.append(c)
        x = x + h
    return _head(params, cfg, x), new_cache
