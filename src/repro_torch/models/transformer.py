"""Decoder-only stack of the port, dense, MoE and SSM families: embed ->
n_layers x layer -> final norm -> head (tied: embed^T, or the untied
``lm_head``).

A layer of kind ``"a"`` (``AttnLayer``) is norm1 -> attention -> residual,
then norm2 -> FFN -> residual, the FFN an MLP or, where
``cfg.layer_is_moe(i)``, the MoE layer; a layer of kind ``"m"``
(``MixerLayer``) is norm1 -> Mamba2 mixer -> residual.  The reference's
``repro.models.transformer`` scans stacked super-blocks with ``lax.scan``;
here each layer is an ``nn.Module`` in an ``nn.ModuleList`` and the stack
is a Python loop.  The cache is a list with one dict per layer:
``{"k", "v", "pos"}`` for attention, ``{"state", "conv"}`` for SSM.  The
forward sums the MoE layers' router metrics over the stack; prefill and
decode discard them, as the reference does.  ``"a"``/``"m"`` hybrids, VLM
patches, M-RoPE, encoder-decoder stacks and LayerNorm are not ported yet
(ROADMAP Queue 1 items 9.3-9.5) and raise.
"""

from __future__ import annotations

import torch
from torch import nn

from . import layers as L
from . import ssm as S
from .config import ModelConfig


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 item {item})")


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is a dense or MoE decoder or a pure-SSM decoder."""
    if cfg.is_encoder_decoder:
        raise _not_ported("the encoder-decoder stack", "9.5")
    if len(set(cfg.pattern)) > 1:
        raise _not_ported("'a'/'m' hybrid stacks", "9.3")
    if cfg.n_patches or cfg.rope_mode == "mrope":
        raise _not_ported("VLM patches and M-RoPE", "9.4")
    if cfg.norm != "rmsnorm":
        raise _not_ported(f"norm={cfg.norm!r}", "9.5")
    if cfg.pattern == ("m",) and cfg.has_ffn:
        raise _not_ported("an FFN after a Mamba2 mixer", "9.3")


class MixerLayer(nn.Module):
    """norm1 -> Mamba2 mixer, added to the residual stream."""

    def __init__(self, norm1: L.RMSNorm, ssm: S.SSMMixer):
        super().__init__()
        self.norm1 = norm1
        self.ssm = ssm


class AttnLayer(nn.Module):
    """norm1 -> attention and norm2 -> FFN, each added to the residual stream.
    The FFN is held under the reference's key: ``mlp``, or ``moe``."""

    def __init__(self, norm1: L.RMSNorm, attn: L.Attention, norm2: L.RMSNorm,
                 ffn: L.MLP | L.MoE):
        super().__init__()
        self.norm1, self.attn, self.norm2 = norm1, attn, norm2
        setattr(self, "moe" if isinstance(ffn, L.MoE) else "mlp", ffn)


class Decoder(nn.Module):
    def __init__(self, embed: torch.Tensor, final_norm: L.RMSNorm,
                 layers: list[MixerLayer | AttnLayer], lm_head: torch.Tensor | None = None):
        super().__init__()
        self.embed = L.param(embed)  # (V, d); tied, the head is embed^T
        self.final_norm = final_norm
        self.layers = nn.ModuleList(layers)
        self.register_parameter("lm_head", None if lm_head is None else L.param(lm_head))


def _layer_init(gen: torch.Generator, cfg: ModelConfig, i: int) -> MixerLayer | AttnLayer:
    dev = gen.device
    if cfg.layer_kind(i) == "m":
        return MixerLayer(L.norm_init(cfg, dev), S.ssm_init(gen, cfg))
    ffn = L.moe_init(gen, cfg) if cfg.layer_is_moe(i) else L.mlp_init(gen, cfg, cfg.d_ff)
    return AttnLayer(L.norm_init(cfg, dev), L.attn_init(gen, cfg), L.norm_init(cfg, dev), ffn)


def init_decoder_params(gen: torch.Generator, cfg: ModelConfig) -> Decoder:
    check_supported(cfg)
    dt = L.cdtype(cfg)
    embed = L._normal(gen, (cfg.vocab_size, cfg.d_model), 0.02, dt)
    lm_head = None
    if not cfg.tie_embeddings:
        lm_head = L._normal(gen, (cfg.d_model, cfg.vocab_size), cfg.d_model**-0.5, dt)
    layers = [_layer_init(gen, cfg, i) for i in range(cfg.n_layers)]
    return Decoder(embed, L.norm_init(cfg, gen.device), layers, lm_head)


def build_positions(cfg: ModelConfig, batch: int, seq: int, *, device=None) -> torch.Tensor:
    """(B, S) position ids ``0 .. seq - 1`` (standard RoPE)."""
    if cfg.rope_mode == "mrope":
        raise _not_ported("M-RoPE positions", "9.4")
    return torch.arange(seq, device=device).expand(batch, seq)


def _angles(cfg: ModelConfig, b: int, s: int, device):
    """RoPE angles for a prompt from position 0, or None for an SSM stack."""
    if "a" not in cfg.pattern:
        return None
    return L.rope_angles(cfg, build_positions(cfg, b, s, device=device))


def embed_inputs(params: Decoder, cfg: ModelConfig, tokens: torch.Tensor,
                 patch_embeds=None) -> torch.Tensor:
    if patch_embeds is not None:
        raise _not_ported("VLM patches", "9.4")
    return params.embed[tokens]


def _head(params: Decoder, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    head = params.embed.T if params.lm_head is None else params.lm_head
    return L.apply_norm(params.final_norm, x) @ head


def _ffn(layer: AttnLayer, cfg: ModelConfig, i: int, x: torch.Tensor):
    """x + FFN(norm2(x)), and the MoE layer's metrics (None for an MLP)."""
    is_moe = cfg.layer_is_moe(i)
    h, metrics = L.ffn_apply(layer.moe if is_moe else layer.mlp, cfg,
                             L.apply_norm(layer.norm2, x), is_moe=is_moe)
    return x + h, metrics


def _zero_metrics(cfg: ModelConfig, device) -> dict[str, torch.Tensor]:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"aux_loss": z, "z_loss": z.clone(),
            "expert_load": torch.zeros(max(cfg.n_experts, 1), device=device)}


def decoder_forward(
    params: Decoder, cfg: ModelConfig, tokens: torch.Tensor, *, patch_embeds=None
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Returns (logits (B, S, V), the MoE metrics summed over layers: zero
    for a stack without MoE layers)."""
    check_supported(cfg)
    x = embed_inputs(params, cfg, tokens, patch_embeds)
    b, s, _ = x.shape
    angles = _angles(cfg, b, s, x.device)
    acc = _zero_metrics(cfg, x.device)
    for i, layer in enumerate(params.layers):
        if cfg.layer_kind(i) == "m":
            x = x + S.ssm_forward(layer.ssm, cfg, L.apply_norm(layer.norm1, x))
            continue
        h = L.attn_forward(layer.attn, cfg, L.apply_norm(layer.norm1, x), angles,
                           window=cfg.sliding_window)
        x, m = _ffn(layer, cfg, i, x + h)
        if m is not None:
            acc = {key: acc[key] + m[key] for key in acc}
    return _head(params, cfg, x), acc


def attn_cache_len(cfg: ModelConfig, max_seq: int) -> int:
    return min(max_seq, cfg.sliding_window) if cfg.sliding_window else max_seq


def init_decoder_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype,
                       device) -> list[dict]:
    """One dict per layer: a ring-buffer KV cache of ``attn_cache_len``
    slots for attention, the SSM state and conv tail (which do not grow
    with ``max_seq``) for a mixer."""
    check_supported(cfg)
    return [L.init_kv_cache(cfg, batch, attn_cache_len(cfg, max_seq), dtype, device)
            if cfg.layer_kind(i) == "a" else S.init_ssm_cache(cfg, batch, dtype, device)
            for i in range(cfg.n_layers)]


def decoder_prefill(
    params: Decoder, cfg: ModelConfig, tokens: torch.Tensor, cache: list[dict], *,
    patch_embeds=None,
) -> tuple[torch.Tensor, list[dict]]:
    """Run the full prompt, fill the cache, return last-position logits (B, 1, V).

    Attention layers write their keys and values into ``cache``'s dicts in
    place (``layers.prefill_into_cache``); SSM layers get new dicts.
    """
    check_supported(cfg)
    x = embed_inputs(params, cfg, tokens, patch_embeds)
    b, s, _ = x.shape
    angles = _angles(cfg, b, s, x.device)
    new_cache = []
    for i, (layer, c) in enumerate(zip(params.layers, cache)):
        h = L.apply_norm(layer.norm1, x)
        if cfg.layer_kind(i) == "m":
            h, state, conv = S.ssm_forward_with_state(layer.ssm, cfg, h)
            new_cache.append({"state": state, "conv": conv.to(c["conv"].dtype)})
            x = x + h
            continue
        h, c = L.prefill_into_cache(layer.attn, cfg, h, angles, c, window=cfg.sliding_window)
        new_cache.append(c)
        x, _ = _ffn(layer, cfg, i, x + h)
    return _head(params, cfg, x[:, -1:]), new_cache


def decoder_decode_step(
    params: Decoder, cfg: ModelConfig, token: torch.Tensor, cache: list[dict], position: int
) -> tuple[torch.Tensor, list[dict]]:
    """One token (B, 1) through the stack against the cache: (logits (B, 1, V),
    cache).  ``position`` is the token's absolute index, a host int;
    attention layers write their slot of ``cache`` in place
    (``layers.attn_decode``), the SSM stack reads no position."""
    x = params.embed[token]
    new_cache = []
    for i, (layer, c) in enumerate(zip(params.layers, cache)):
        h = L.apply_norm(layer.norm1, x)
        if cfg.layer_kind(i) == "m":
            h, c = S.ssm_decode(layer.ssm, cfg, h, c)
            new_cache.append(c)
            x = x + h
            continue
        h, c = L.attn_decode(layer.attn, cfg, h, c, position, window=cfg.sliding_window)
        new_cache.append(c)
        x, _ = _ffn(layer, cfg, i, x + h)
    return _head(params, cfg, x), new_cache
