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
(B, S) for the loss.  For an MoE model the loss adds the router's
load-balance and z terms, summed over its MoE layers, so the train step
trains the router.  The train step optionally applies the paper's
SOP-consensus gossip over a ``torch.distributed`` group instead of
all-reduce gradient averaging.  Parameters are created frozen (serving
needs no graph); the train step turns their gradients on for its own
backward and off again.
"""

from __future__ import annotations

import torch

from .. import device as _device
from .. import tree
from ..core import consensus
from ..optim import Optimizer, apply_updates
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


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean token cross-entropy, with the logsumexp in float32."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    ce = (logz - gold) * mask
    return ce.sum() / torch.clamp(mask.sum(), min=1.0)


def loss_fn(cfg: ModelConfig, params: Decoder, batch: dict):
    """(loss, {"loss", "ce"}): the masked cross-entropy, plus the router
    terms (and their metrics) where ``cfg.n_experts > 0``, as the reference
    forms it."""
    logits, m = forward_logits(cfg, params, batch)
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
    opt_state, metrics)``; ``params`` (a ``Decoder``) is updated in place.

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

    def step(params: Decoder, opt_state: dict, batch: dict, gossip_round: int = 0):
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
               device: str | torch.device = "cuda") -> list[dict]:
    return T.init_decoder_cache(cfg, batch, max_seq, dtype or cdtype(cfg),
                                _device.resolve(device))


def prefill(cfg: ModelConfig, params: Decoder, batch: dict, cache: list[dict]):
    """Process the prompt; returns (last-position logits (B, 1, V), cache).
    Attention layers fill ``cache``'s key/value tensors in place."""
    return T.decoder_prefill(params, cfg, batch["tokens"], cache)


def decode_step(cfg: ModelConfig, params: Decoder, token: torch.Tensor,
                cache: list[dict], position: int):
    """One-token serve step at absolute ``position`` (a host int): returns
    (logits (B, 1, V), cache).  Attention layers write into ``cache`` in
    place; keep a clone to reuse the cache from before the step."""
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
