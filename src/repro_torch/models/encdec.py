"""Encoder-decoder (Whisper-style) model of the port — arXiv:2212.04356; the
reference's ``repro.models.encdec``.

The audio frontend (log-mel + conv downsampler) is a stub, as in the
reference: the caller supplies frame embeddings (B, encoder_seq, d_model).
Everything downstream is real: sinusoidal encoder positions,
bidirectional encoder self-attention, causal decoder self-attention with
learned positions, cross-attention, GELU MLPs, LayerNorm, the tied output
head, and a decode path with a self-attention KV ring and the cross K/V
computed once per prompt.

The modules mirror the reference's keys (``enc_layers``, ``dec_layers``,
``self_attn``, ``norm_x``, ``cross_attn``, ``enc_norm``, ``dec_norm``,
``dec_pos``); the reference stacks the layers on a leading axis and scans
them, the port holds them in ``nn.ModuleList``s and loops.  The cache is
``{"self": [one KV ring per decoder layer], "cross_k", "cross_v"}``, the
cross K/V (n_layers, B, T, K, hd) as the reference stacks them.
"""

from __future__ import annotations

import torch
from torch import nn

from . import layers as L
from .config import ModelConfig


class EncLayer(nn.Module):
    """norm1 -> bidirectional attention, norm2 -> MLP, each residual."""

    def __init__(self, norm1, attn: L.Attention, norm2, mlp: L.MLP):
        super().__init__()
        self.norm1, self.attn, self.norm2, self.mlp = norm1, attn, norm2, mlp


class DecLayer(nn.Module):
    """norm1 -> causal self-attention, norm_x -> cross-attention over the
    encoder states, norm2 -> MLP, each residual."""

    def __init__(self, norm1, self_attn: L.Attention, norm_x, cross_attn: L.Attention,
                 norm2, mlp: L.MLP):
        super().__init__()
        self.norm1, self.self_attn = norm1, self_attn
        self.norm_x, self.cross_attn = norm_x, cross_attn
        self.norm2, self.mlp = norm2, mlp


class EncDec(nn.Module):
    def __init__(self, embed: torch.Tensor, dec_pos: torch.Tensor,
                 enc_layers: list[EncLayer], dec_layers: list[DecLayer], enc_norm, dec_norm):
        super().__init__()
        self.embed = L.param(embed)  # (V, d); the head is embed^T
        self.dec_pos = L.param(dec_pos)  # (max_target_positions, d)
        self.enc_layers = nn.ModuleList(enc_layers)
        self.dec_layers = nn.ModuleList(dec_layers)
        self.enc_norm, self.dec_norm = enc_norm, dec_norm


def _sinusoid(length: int, dim: int, device) -> torch.Tensor:
    """(length, dim) float32: sin then cos of pos / 10000^(2i / dim)."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / (10000.0 ** (2 * i / dim))
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def enc_layer_init(gen: torch.Generator, cfg: ModelConfig) -> EncLayer:
    dev = gen.device
    return EncLayer(L.norm_init(cfg, dev), L.attn_init(gen, cfg), L.norm_init(cfg, dev),
                    L.mlp_init(gen, cfg, cfg.d_ff))


def dec_layer_init(gen: torch.Generator, cfg: ModelConfig) -> DecLayer:
    dev = gen.device
    return DecLayer(L.norm_init(cfg, dev), L.attn_init(gen, cfg), L.norm_init(cfg, dev),
                    L.attn_init(gen, cfg), L.norm_init(cfg, dev), L.mlp_init(gen, cfg, cfg.d_ff))


def init_encdec_params(gen: torch.Generator, cfg: ModelConfig) -> EncDec:
    dt = L.cdtype(cfg)
    enc = [enc_layer_init(gen, cfg) for _ in range(cfg.n_encoder_layers)]
    dec = [dec_layer_init(gen, cfg) for _ in range(cfg.n_layers)]
    embed = L._normal(gen, (cfg.vocab_size, cfg.d_model), 0.02, dt)
    dec_pos = L._normal(gen, (cfg.max_target_positions, cfg.d_model), 0.02, dt)
    return EncDec(embed, dec_pos, enc, dec, L.norm_init(cfg, gen.device),
                  L.norm_init(cfg, gen.device))


def _kv(p: L.Attention, cfg: ModelConfig, enc: torch.Tensor):
    """A cross-attention's keys and values (B, T, K, hd) of the encoder states."""
    b, t, _ = enc.shape
    return (L.dense(p.wk, enc).reshape(b, t, cfg.n_kv_heads, cfg.hd),
            L.dense(p.wv, enc).reshape(b, t, cfg.n_kv_heads, cfg.hd))


def _cross_attend(p: L.Attention, cfg: ModelConfig, x: torch.Tensor, enc_k: torch.Tensor,
                  enc_v: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) attends to every encoder state (an all-true mask)."""
    b, s, _ = x.shape
    q = L.dense(p.wq, x).reshape(b, s, cfg.n_heads, cfg.hd)
    mask = torch.ones((b, s, enc_k.shape[1]), dtype=torch.bool, device=x.device)
    return L.dense(p.wo, L._sdpa(q, enc_k, enc_v, mask, cfg))


def encode(params: EncDec, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, T, d), the stub embeddings -> encoder states (B, T, d).

    The frames and the float32 sinusoid are each cast to the model's dtype
    before they are added, as the reference does."""
    dt = L.cdtype(cfg)
    x = frames.to(dt) + _sinusoid(frames.shape[1], cfg.d_model, frames.device).to(dt)
    for lp in params.enc_layers:
        h = L.attn_forward(lp.attn, cfg, L.apply_norm(lp.norm1, x), None, causal=False,
                           rope=False)
        x = x + h
        x = x + L.mlp(lp.mlp, cfg, L.apply_norm(lp.norm2, x))
    return L.apply_norm(params.enc_norm, x)


def _dec_positions(params: EncDec, cfg: ModelConfig, start: int, length: int) -> torch.Tensor:
    """The learned positions start .. start + length - 1, clipped to the last
    of ``max_target_positions``."""
    idx = torch.arange(start, start + length, device=params.dec_pos.device)
    return params.dec_pos[torch.clamp(idx, 0, cfg.max_target_positions - 1)]


def encdec_forward(params: EncDec, cfg: ModelConfig, tokens: torch.Tensor,
                   frames: torch.Tensor) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Teacher-forced decoder logits (B, S, V), and zero router terms."""
    enc = encode(params, cfg, frames)
    s = tokens.shape[1]
    x = params.embed[tokens] + _dec_positions(params, cfg, 0, s)[None]
    for lp in params.dec_layers:
        h = L.attn_forward(lp.self_attn, cfg, L.apply_norm(lp.norm1, x), None, causal=True,
                           rope=False)
        x = x + h
        ek, ev = _kv(lp.cross_attn, cfg, enc)
        x = x + _cross_attend(lp.cross_attn, cfg, L.apply_norm(lp.norm_x, x), ek, ev)
        x = x + L.mlp(lp.mlp, cfg, L.apply_norm(lp.norm2, x))
    logits = L.apply_norm(params.dec_norm, x) @ params.embed.T  # whisper ties the head
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits, {"aux_loss": zero, "z_loss": zero.clone()}


def init_encdec_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype, device) -> dict:
    """``{"self": [n_layers KV rings of max_seq slots], "cross_k", "cross_v"}``,
    the cross K/V zero (n_layers, B, encoder_seq, K, hd) until the prefill."""
    shape = (cfg.n_layers, batch, cfg.encoder_seq, cfg.n_kv_heads, cfg.hd)
    return {
        "self": [L.init_kv_cache(cfg, batch, max_seq, dtype, device) for _ in range(cfg.n_layers)],
        "cross_k": torch.zeros(shape, dtype=dtype, device=device),
        "cross_v": torch.zeros(shape, dtype=dtype, device=device),
    }


def encdec_prefill(params: EncDec, cfg: ModelConfig, frames: torch.Tensor, cache: dict, *,
                   kv=_kv) -> dict:
    """Encode the frames and compute every decoder layer's cross K/V into a
    new cache (the self rings are passed on as they are); no logits.
    ``params`` is read in order (``enc_layers``, ``enc_norm``, each of
    ``dec_layers``), so a view that gathers each module where it is read
    serves; ``kv`` (``_kv``) gives a layer's cross K/V (``sharding.serve``
    passes one that keeps the rank's part)."""
    enc = encode(params, cfg, frames)
    kvs = [kv(lp.cross_attn, cfg, enc) for lp in params.dec_layers]
    return {"self": cache["self"],
            "cross_k": torch.stack([k for k, _ in kvs]).to(cache["cross_k"].dtype),
            "cross_v": torch.stack([v for _, v in kvs]).to(cache["cross_v"].dtype)}


def encdec_decode_step(params: EncDec, cfg: ModelConfig, token: torch.Tensor, cache: dict,
                       position: int, *, attn=L.attn_decode, cross=_cross_attend
                       ) -> tuple[torch.Tensor, dict]:
    """One token (B, 1) at absolute ``position`` (a host int; its learned
    position clipped to the last) -> (logits (B, 1, V), cache).  The self
    rings are written IN PLACE (``layers.attn_decode``).  ``attn`` and
    ``cross`` are the self- and cross-attention (``sharding.serve`` passes
    its split ones)."""
    pos_idx = min(max(position, 0), cfg.max_target_positions - 1)
    x = params.embed[token] + params.dec_pos[pos_idx][None, None, :]
    for i, lp in enumerate(params.dec_layers):
        h, _ = attn(lp.self_attn, cfg, L.apply_norm(lp.norm1, x), cache["self"][i], position,
                    rope=False)
        x = x + h
        x = x + cross(lp.cross_attn, cfg, L.apply_norm(lp.norm_x, x), cache["cross_k"][i],
                      cache["cross_v"][i])
        x = x + L.mlp(lp.mlp, cfg, L.apply_norm(lp.norm2, x))
    return L.apply_norm(params.dec_norm, x) @ params.embed.T, cache
