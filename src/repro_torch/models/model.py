"""Model API of the port (the reference's ``repro.models.model``):

    params          = init_params(cfg, seed, device=)
    logits, metrics = forward_logits(cfg, params, batch)
    loss, metrics   = loss_fn(cfg, params, batch)
    train_step      = make_train_step(cfg, optimizer[, group, dp_mode, gossip_schedule])
    cache           = init_cache(cfg, batch_size, max_seq, device=)
    logits, cache   = prefill(cfg, params, batch, cache)
    logits, cache   = decode_step(cfg, params, token, cache, position)
    tokens, cache   = greedy_decode(cfg, params, prompt, n_steps, max_seq)

``batch`` is a dict holding ``tokens`` (B, S), and ``labels`` and ``mask``
(B, S) for the loss, plus ``patch_embeds`` (B, n_patches, d) for the VLM
stub or ``frames`` (B, encoder_seq, d) for the audio stub.  An
encoder-decoder config (``cfg.is_encoder_decoder``) runs
``models.encdec``, every other config ``models.transformer``.  For an
MoE model the loss adds the router's load-balance and z terms, summed
over its MoE layers, so the train step trains the router.  The train
step optionally applies the paper's SOP-consensus gossip over a
``torch.distributed`` group instead of all-reduce gradient averaging.
Parameters are created frozen (serving needs no graph); the train step
turns their gradients on for its own backward and off again.
"""

from __future__ import annotations

import torch

from .. import device as _device
from .. import tree
from ..core import consensus
from ..optim import Optimizer, apply_updates
from . import encdec as ED
from . import transformer as T
from .config import ModelConfig
from .encdec import EncDec
from .layers import cdtype
from .transformer import Decoder

Params = Decoder | EncDec


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device: str | torch.device = "cuda") -> Params:
    """Random parameters on ``device``, drawn from a ``torch.Generator``
    seeded with ``seed`` (the reference's ``jax.random`` keys draw other
    numbers: tests carry the reference's parameters across instead)."""
    gen = torch.Generator(device=_device.resolve(device)).manual_seed(seed)
    if cfg.is_encoder_decoder:
        return ED.init_encdec_params(gen, cfg)
    return T.init_decoder_params(gen, cfg)


def forward_logits(cfg: ModelConfig, params: Params, batch: dict, *, moe_reduce=None):
    """(logits (B, S, V), metrics).  With ``patch_embeds`` the logits are
    those of the text positions (the patch prefix's are sliced off).
    ``moe_reduce``: ``layers.moe_apply``'s ``reduce`` (the encoder-decoder
    has no MoE layer)."""
    if cfg.is_encoder_decoder:
        return ED.encdec_forward(params, cfg, batch["tokens"], batch["frames"])
    logits, metrics = T.decoder_forward(params, cfg, batch["tokens"],
                                        patch_embeds=batch.get("patch_embeds"),
                                        moe_reduce=moe_reduce)
    if cfg.n_patches and "patch_embeds" in batch:
        logits = logits[:, cfg.n_patches:]  # align back to the text positions
    return logits, metrics


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean token cross-entropy, with the logsumexp in float32."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    ce = (logz - gold) * mask
    return ce.sum() / torch.clamp(mask.sum(), min=1.0)


def loss_fn(cfg: ModelConfig, params: Params, batch: dict, *, moe_reduce=None):
    """(loss, {"loss", "ce"}): the masked cross-entropy, plus the router
    terms (and their metrics) where ``cfg.n_experts > 0``, as the reference
    forms it.  ``moe_reduce``: see ``layers.moe_apply``."""
    logits, m = forward_logits(cfg, params, batch, moe_reduce=moe_reduce)
    ce = cross_entropy(logits, batch["labels"], batch["mask"])
    metrics = {"loss": ce, "ce": ce}
    if cfg.n_experts:
        metrics["loss"] = (ce + cfg.router_aux_weight * m["aux_loss"]
                           + cfg.router_z_weight * m["z_loss"])
        metrics.update(aux_loss=m["aux_loss"], z_loss=m["z_loss"])
    return metrics["loss"], metrics


def make_train_step(
    cfg: ModelConfig,
    optimizer: Optimizer,
    *,
    group=None,
    dp_mode: str = "allreduce",  # allreduce | sop_gossip | none
    gossip_schedule: list[list[int]] | None = None,
):
    """Build ``step(params, opt_state, batch, gossip_round=0) -> (params,
    opt_state, metrics)``; ``params`` (a ``Decoder`` or ``EncDec``) is
    updated in place.

    dp_mode="allreduce": gradients and metrics averaged over ``group`` (the
      paper's fully-connected / centralized special case, Lemma 3.1); every
      rank applies the same update, so replicas stay bitwise equal.
    dp_mode="sop_gossip": gradients stay local; after the optimizer update
      the parameters take one SOP pairwise-projection round over ``group``
      (round-robin over ``gossip_schedule``: the round index is a host int)
      and ``metrics["consensus_sq"]`` reports the disagreement.
    ``group=None`` or dp_mode="none": no collective (one replica).
    """
    if dp_mode not in ("allreduce", "sop_gossip", "none"):
        raise ValueError(f"unknown dp_mode {dp_mode!r}")
    if group is not None and dp_mode == "sop_gossip" and gossip_schedule is None:
        raise ValueError("sop_gossip needs a schedule")

    def step(params: Params, opt_state: dict, batch: dict, gossip_round: int = 0):
        leaves = tree.leaves(params)
        with torch.enable_grad():
            for p in leaves:
                p.requires_grad_(True)
            loss, metrics = loss_fn(cfg, params, batch)
            grads = list(torch.autograd.grad(loss, leaves))
            for p in leaves:
                p.requires_grad_(False)
        metrics = {k: v.detach() for k, v in metrics.items()}
        if group is not None and dp_mode == "allreduce":
            grads = consensus.allreduce_average(grads, group)
            metrics = consensus.allreduce_average(metrics, group)
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = apply_updates(params, updates)
        if group is not None and dp_mode == "sop_gossip":
            params = consensus.gossip_round(params, group, gossip_schedule, gossip_round)
            metrics["consensus_sq"] = consensus.consensus_sq_distance(params, group)
        return params, opt_state, metrics

    return step


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None, *,
               device: str | torch.device = "cuda") -> list[dict] | dict:
    """A decoder's list of per-layer caches, or the encoder-decoder's
    ``{"self", "cross_k", "cross_v"}``; ``max_seq`` slots of attention
    (a VLM's patch prefix takes slots too)."""
    dtype, dev = dtype or cdtype(cfg), _device.resolve(device)
    if cfg.is_encoder_decoder:
        return ED.init_encdec_cache(cfg, batch, max_seq, dtype, dev)
    return T.init_decoder_cache(cfg, batch, max_seq, dtype, dev)


def prefill(cfg: ModelConfig, params: Params, batch: dict, cache):
    """Process the prompt; returns (last-position logits (B, 1, V), cache),
    or (None, cache) for an encoder-decoder (its prefill encodes
    ``batch["frames"]`` and computes the cross K/V).  Attention layers fill
    ``cache``'s key/value tensors in place."""
    if cfg.is_encoder_decoder:
        return None, ED.encdec_prefill(params, cfg, batch["frames"], cache)
    return T.decoder_prefill(params, cfg, batch["tokens"], cache,
                             patch_embeds=batch.get("patch_embeds"))


def decode_step(cfg: ModelConfig, params: Params, token: torch.Tensor, cache, position: int):
    """One-token serve step at absolute ``position`` (a host int; a VLM's
    patch prefix counts): returns (logits (B, 1, V), cache).  Attention
    layers write into ``cache`` in place; keep a clone to reuse the cache
    from before the step."""
    if cfg.is_encoder_decoder:
        return ED.encdec_decode_step(params, cfg, token, cache, position)
    return T.decoder_decode_step(params, cfg, token, cache, position)


def decode_start(cfg: ModelConfig, prompt_len: int, batch_extra: dict | None = None) -> int:
    """The absolute position of the first decoded token: 0 for an
    encoder-decoder (from BOS), ``n_patches + prompt_len`` behind a VLM's
    patch prefix, else ``prompt_len``."""
    if cfg.is_encoder_decoder:
        return 0
    if cfg.n_patches and "patch_embeds" in (batch_extra or {}):
        return cfg.n_patches + prompt_len
    return prompt_len


def greedy_decode(cfg: ModelConfig, params: Params, prompt: torch.Tensor, n_steps: int,
                  max_seq: int, *, batch_extra: dict | None = None
                  ) -> tuple[torch.Tensor, list[dict] | dict]:
    """Prefill + ``n_steps`` greedy decode steps: ((B, n_steps) int64, cache).

    ``batch_extra`` holds ``patch_embeds`` or ``frames`` where the family
    needs them.  An encoder-decoder starts from BOS token 0 at position 0.
    Behind a VLM's patch prefix the decode starts at ``n_patches + S0``
    (``decode_start``), and ``max_seq`` must hold the prefix too; the
    reference starts at ``S0`` there, which rotates and caches the decoded
    tokens at positions the prefill already took (ROADMAP Queue 3).  For
    every other family this is the reference's ``greedy_decode``, token for
    token.
    """
    b, s0 = prompt.shape
    cache = init_cache(cfg, b, max_seq, device=prompt.device)
    logits, cache = prefill(cfg, params, {"tokens": prompt, **(batch_extra or {})}, cache)
    if logits is None:
        tok = torch.zeros((b, 1), dtype=torch.long, device=prompt.device)
    else:
        tok = torch.argmax(logits[:, -1:], dim=-1)
    start = decode_start(cfg, s0, batch_extra)
    out = []
    for i in range(n_steps):
        logits, cache = decode_step(cfg, params, tok, cache, start + i)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        out.append(tok)
    return torch.cat(out, dim=1), cache
