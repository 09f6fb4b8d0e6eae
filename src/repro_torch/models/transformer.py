"""Decoder-only stack of the port, every decoder family (dense, MoE, SSM,
the attention/Mamba2 hybrid and the VLM): embed (with the VLM's patch
prefix) -> n_layers x layer -> final norm -> head (tied: embed^T, or the
untied ``lm_head``).

A layer of kind ``"a"`` (``AttnLayer``) is norm1 -> attention -> residual,
a layer of kind ``"m"`` (``MixerLayer``) norm1 -> Mamba2 mixer ->
residual; where ``cfg.has_ffn`` either is followed by norm2 -> FFN ->
residual, the FFN an MLP or, where ``cfg.layer_is_moe(i)``, the MoE layer.
The reference's ``repro.models.transformer`` scans stacked super-blocks of
``cfg.block_len`` layers with ``lax.scan``; here each layer is an
``nn.Module`` in an ``nn.ModuleList`` and the stack is a Python loop
(layer i is slot ``i % block_len`` of block ``i // block_len`` there).
The cache is a list with one dict per layer: ``{"k", "v", "pos"}`` for
attention, ``{"state", "conv"}`` for SSM.  The forward sums the MoE
layers' router metrics over the stack, those after a mixer too; prefill
and decode discard them, as the reference does.  With ``cfg.remat`` the
forward checkpoints each super-block of ``cfg.block_len`` layers, as the
reference wraps its scan body in ``jax.checkpoint``; prefill and decode
keep no activations for a backward and are never wrapped.  The
encoder-decoder is ``models.encdec``.
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from . import layers as L
from . import ssm as S
from .config import ModelConfig

Norm = L.RMSNorm | L.LayerNorm


class MixerLayer(nn.Module):
    """norm1 -> Mamba2 mixer, added to the residual stream; then, in a hybrid,
    norm2 -> FFN, held under the reference's key (``mlp`` or ``moe``)."""

    def __init__(self, norm1: Norm, ssm: S.SSMMixer, norm2: Norm | None = None,
                 ffn: L.MLP | L.MoE | None = None):
        super().__init__()
        self.norm1 = norm1
        self.ssm = ssm
        if ffn is not None:
            self.norm2 = norm2
            setattr(self, "moe" if isinstance(ffn, L.MoE) else "mlp", ffn)


class AttnLayer(nn.Module):
    """norm1 -> attention and norm2 -> FFN, each added to the residual stream.
    The FFN is held under the reference's key: ``mlp``, or ``moe``."""

    def __init__(self, norm1: Norm, attn: L.Attention, norm2: Norm, ffn: L.MLP | L.MoE):
        super().__init__()
        self.norm1, self.attn, self.norm2 = norm1, attn, norm2
        setattr(self, "moe" if isinstance(ffn, L.MoE) else "mlp", ffn)


class Decoder(nn.Module):
    def __init__(self, embed: torch.Tensor, final_norm: Norm,
                 layers: list[MixerLayer | AttnLayer], lm_head: torch.Tensor | None = None):
        super().__init__()
        self.embed = L.param(embed)  # (V, d); tied, the head is embed^T
        self.final_norm = final_norm
        self.layers = nn.ModuleList(layers)
        self.register_parameter("lm_head", None if lm_head is None else L.param(lm_head))


def _ffn_init(gen: torch.Generator, cfg: ModelConfig, i: int) -> L.MLP | L.MoE:
    return L.moe_init(gen, cfg) if cfg.layer_is_moe(i) else L.mlp_init(gen, cfg, cfg.d_ff)


def _layer_init(gen: torch.Generator, cfg: ModelConfig, i: int) -> MixerLayer | AttnLayer:
    dev = gen.device
    if cfg.layer_kind(i) == "m":
        ssm = S.ssm_init(gen, cfg)
        if not cfg.has_ffn:
            return MixerLayer(L.norm_init(cfg, dev), ssm)
        return MixerLayer(L.norm_init(cfg, dev), ssm, L.norm_init(cfg, dev),
                          _ffn_init(gen, cfg, i))
    ffn = _ffn_init(gen, cfg, i)  # drawn before the attention: a seed's weights stay put
    return AttnLayer(L.norm_init(cfg, dev), L.attn_init(gen, cfg), L.norm_init(cfg, dev), ffn)


def init_decoder_params(gen: torch.Generator, cfg: ModelConfig) -> Decoder:
    if cfg.is_encoder_decoder:
        raise ValueError(f"{cfg.name} is an encoder-decoder: models.encdec builds it")
    dt = L.cdtype(cfg)
    embed = L._normal(gen, (cfg.vocab_size, cfg.d_model), 0.02, dt)
    lm_head = None
    if not cfg.tie_embeddings:
        lm_head = L._normal(gen, (cfg.d_model, cfg.vocab_size), cfg.d_model**-0.5, dt)
    layers = [_layer_init(gen, cfg, i) for i in range(cfg.n_layers)]
    return Decoder(embed, L.norm_init(cfg, gen.device), layers, lm_head)


def build_positions(cfg: ModelConfig, batch: int, seq: int, *, device=None) -> torch.Tensor:
    """(B, S) standard or (B, 3, S) M-RoPE position ids.

    For the VLM the first ``min(n_patches, seq)`` tokens are vision patches
    on a ~square grid of ``side`` columns: temporal id 0, spatial ids (row,
    col); the text tokens then advance all three streams together from
    ``side`` (Qwen2-VL's M-RoPE), as the reference lays them out.
    """
    idx = torch.arange(seq, device=device)
    if cfg.rope_mode != "mrope":
        return idx.expand(batch, seq)
    npatch = min(cfg.n_patches, seq)
    side = max(int(npatch**0.5), 1)
    is_text = idx >= npatch
    text = idx - npatch + side
    streams = [torch.where(is_text, text, torch.zeros_like(idx)),
               torch.where(is_text, text, idx // side),
               torch.where(is_text, text, idx % side)]
    return torch.stack(streams).expand(batch, 3, seq)


def mrope_decode_position(cfg: ModelConfig, position: int) -> int:
    """The rotary position of a decoded (text) token at absolute ``position``
    after the full vision prefix: the streams' value, as in
    ``build_positions``."""
    side = max(int(cfg.n_patches**0.5), 1)
    return position - cfg.n_patches + side


def _angles(cfg: ModelConfig, b: int, s: int, device):
    """RoPE angles for a prompt from position 0, or None for an SSM stack."""
    if "a" not in cfg.pattern:
        return None
    return L.rope_angles(cfg, build_positions(cfg, b, s, device=device))


def embed_inputs(params: Decoder, cfg: ModelConfig, tokens: torch.Tensor,
                 patch_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """The tokens' embeddings (B, S, d), behind the VLM's patch embeddings
    (B, n_patches, d), cast to the model's dtype, where they are given."""
    x = params.embed[tokens]
    if cfg.n_patches and patch_embeds is not None:
        x = torch.cat([patch_embeds.to(x.dtype), x], dim=1)
    return x


def _head(params: Decoder, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    head = params.lm_head
    if head is None:
        head = params.embed.T
    return L.apply_norm(params.final_norm, x) @ head


def _ffn(layer: MixerLayer | AttnLayer, cfg: ModelConfig, i: int, x: torch.Tensor,
         moe_reduce=None):
    """x + FFN(norm2(x)), and the MoE layer's metrics (None for an MLP); x
    and None where the stack has no FFN (mamba2)."""
    if not cfg.has_ffn:
        return x, None
    is_moe = cfg.layer_is_moe(i)
    h, metrics = L.ffn_apply(layer.moe if is_moe else layer.mlp, cfg,
                             L.apply_norm(layer.norm2, x), is_moe=is_moe,
                             moe_reduce=moe_reduce)
    return x + h, metrics


def _zero_metrics(cfg: ModelConfig, device) -> dict[str, torch.Tensor]:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"aux_loss": z, "z_loss": z.clone(),
            "expert_load": torch.zeros(max(cfg.n_experts, 1), device=device)}


# The products whose outputs remat_policy="dots" saves: the counterpart of
# the reference's jax.checkpoint_policies.dots_saveable (every dot_general's
# output saved, everything else recomputed).  `@`, `dense` and the einsums
# of `_sdpa` and `moe_apply` lower to these.
DOTS = (torch.ops.aten.mm, torch.ops.aten.addmm, torch.ops.aten.bmm, torch.ops.aten.baddbmm)
REMAT_POLICIES = ("full", "dots")


def _dots_saveable(ctx, op, *args, **kwargs) -> ckpt.CheckpointPolicy:
    if op.overloadpacket in DOTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat_context(cfg: ModelConfig):
    """``checkpoint``'s ``context_fn`` for ``cfg.remat_policy``."""
    if cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}: one of {REMAT_POLICIES}")
    if cfg.remat_policy == "dots":
        return functools.partial(ckpt.create_selective_checkpoint_contexts, _dots_saveable)
    return ckpt.noop_context_fn


def _layers(params: Decoder, cfg: ModelConfig, lo: int, hi: int, x: torch.Tensor,
            acc: dict[str, torch.Tensor], angles, moe_reduce):
    """Layers ``lo .. hi - 1`` on the residual stream ``x``: (x, ``acc`` plus
    each MoE layer's metrics, added layer by layer)."""
    for i in range(lo, hi):
        layer = params.layers[i]
        h = L.apply_norm(layer.norm1, x)
        if cfg.layer_kind(i) == "m":
            h = S.ssm_forward(layer.ssm, cfg, h)
        else:
            h = L.attn_forward(layer.attn, cfg, h, angles, window=cfg.sliding_window)
        x, m = _ffn(layer, cfg, i, x + h, moe_reduce)
        if m is not None:
            acc = {key: acc[key] + m[key] for key in acc}
    return x, acc


def decoder_forward(
    params: Decoder, cfg: ModelConfig, tokens: torch.Tensor, *,
    patch_embeds: torch.Tensor | None = None, moe_reduce=None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Returns (logits (B, S_total, V), the MoE metrics summed over layers:
    zero for a stack without MoE layers).  S_total counts the VLM's patch
    prefix where ``patch_embeds`` is given.  ``moe_reduce`` is each MoE
    layer's ``layers.moe_apply`` ``reduce``.

    With ``cfg.remat``, where a gradient is being recorded, each super-block
    of ``cfg.block_len`` layers runs under a non-reentrant ``checkpoint``
    (``autograd.grad`` needs non-reentrant): ``remat_policy="full"`` keeps
    only the block's inputs and recomputes the rest in the backward,
    ``"dots"`` also keeps the outputs of the ``DOTS`` products.  The metrics'
    sum is carried through the blocks, so the values are those without
    remat, bitwise.  Every rank recomputes its blocks in the same order, so
    a ``moe_reduce`` collective re-run in the backward pairs up."""
    remat = _remat_context(cfg) if cfg.remat else None
    x = embed_inputs(params, cfg, tokens, patch_embeds)
    b, s, _ = x.shape
    angles = _angles(cfg, b, s, x.device)
    acc = _zero_metrics(cfg, x.device)
    n = len(params.layers)
    if remat is None or not torch.is_grad_enabled() or not (
            x.requires_grad or any(p.requires_grad for p in params.parameters())):
        x, acc = _layers(params, cfg, 0, n, x, acc, angles, moe_reduce)
    else:
        for lo in range(0, n, cfg.block_len):
            x, acc = ckpt.checkpoint(_layers, params, cfg, lo, min(lo + cfg.block_len, n), x,
                                     acc, angles, moe_reduce, use_reentrant=False,
                                     context_fn=remat)
    return _head(params, cfg, x), acc


def attn_cache_len(cfg: ModelConfig, max_seq: int) -> int:
    return min(max_seq, cfg.sliding_window) if cfg.sliding_window else max_seq


def init_decoder_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype,
                       device) -> list[dict]:
    """One dict per layer: a ring-buffer KV cache of ``attn_cache_len``
    slots for attention, the SSM state and conv tail (which do not grow
    with ``max_seq``) for a mixer."""
    return [L.init_kv_cache(cfg, batch, attn_cache_len(cfg, max_seq), dtype, device)
            if cfg.layer_kind(i) == "a" else S.init_ssm_cache(cfg, batch, dtype, device)
            for i in range(cfg.n_layers)]


def prefill_mixer(layer: MixerLayer | AttnLayer, cfg: ModelConfig, i: int, h: torch.Tensor,
                  angles, c: dict) -> tuple[torch.Tensor, dict]:
    """Layer i's attention or Mamba2 mixer over the normed prompt ``h``:
    (its output, the layer's cache).  Attention writes its keys and values
    into ``c`` in place (``layers.prefill_into_cache``); a mixer returns a
    new dict."""
    if cfg.layer_kind(i) == "m":
        h, state, conv = S.ssm_forward_with_state(layer.ssm, cfg, h)
        return h, {"state": state, "conv": conv.to(c["conv"].dtype)}
    return L.prefill_into_cache(layer.attn, cfg, h, angles, c, window=cfg.sliding_window)


def decoder_prefill(
    params: Decoder, cfg: ModelConfig, tokens: torch.Tensor, cache: list[dict], *,
    patch_embeds: torch.Tensor | None = None, mixer=prefill_mixer, ffn=_ffn,
) -> tuple[torch.Tensor, list[dict]]:
    """Run the full prompt (behind the VLM's patch prefix, where given), fill
    the cache, return last-position logits (B, 1, V).

    Attention layers write their keys and values into ``cache``'s dicts in
    place (``layers.prefill_into_cache``); SSM layers get new dicts.  The
    prompt, its prefix included, must fit the attention cache.

    ``params`` is read once per step in stack order (``embed``, each of
    ``layers``, ``final_norm``, the head), so a view that gathers each
    module where it is read serves as well as a ``Decoder``; ``mixer`` and
    ``ffn`` (``prefill_mixer``, ``_ffn``) are the layer's two halves, which
    ``sharding.serve`` replaces by its split ones.
    """
    x = embed_inputs(params, cfg, tokens, patch_embeds)
    b, s, _ = x.shape
    angles = _angles(cfg, b, s, x.device)
    new_cache = []
    for i, (layer, c) in enumerate(zip(params.layers, cache)):
        h, c = mixer(layer, cfg, i, L.apply_norm(layer.norm1, x), angles, c)
        new_cache.append(c)
        x, _ = ffn(layer, cfg, i, x + h)
    return _head(params, cfg, x[:, -1:]), new_cache


def decoder_decode_step(
    params: Decoder, cfg: ModelConfig, token: torch.Tensor, cache: list[dict], position: int,
    *, attn=L.attn_decode, ssm=S.ssm_decode, ffn=_ffn,
) -> tuple[torch.Tensor, list[dict]]:
    """One token (B, 1) through the stack against the cache: (logits (B, 1, V),
    cache).  ``position`` is the token's absolute index, a host int, the
    VLM's patch prefix included; under M-RoPE the rotary position is
    derived from it (``mrope_decode_position``: decoded tokens are text).
    Attention layers write their slot of ``cache`` in place
    (``layers.attn_decode``), the SSM stack reads no position.  ``params``
    is read as in ``decoder_prefill``; ``attn``, ``ssm`` and ``ffn`` are
    the layer's parts (``sharding.serve`` passes its split ones)."""
    x = params.embed[token]
    rope_position = mrope_decode_position(cfg, position) if cfg.rope_mode == "mrope" else None
    new_cache = []
    for i, (layer, c) in enumerate(zip(params.layers, cache)):
        h = L.apply_norm(layer.norm1, x)
        if cfg.layer_kind(i) == "m":
            h, c = ssm(layer.ssm, cfg, h, c)
        else:
            h, c = attn(layer.attn, cfg, h, c, position, window=cfg.sliding_window,
                        rope_position=rope_position)
        new_cache.append(c)
        x, _ = ffn(layer, cfg, i, x + h)
    return _head(params, cfg, x), new_cache
