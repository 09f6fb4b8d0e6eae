"""AdamW / SGD-momentum / Lion, plus global-norm clipping (port of
``repro.optim.optimizers``).

Functional, as in the reference: an ``Optimizer`` is (init, update) with

    state            = init(params)
    updates, state   = update(grads, state, params)
    params           = apply_updates(params, updates)

over the trees of ``repro_torch.tree`` (a module's parameters, or lists /
dicts of tensors).  ``update`` takes ``norm=``, the gradients' global norm
where the caller computes it (over slices of the gradients; AdamW clips
to it, SGD and Lion do not clip).  Moments are float32 lists aligned with
the parameters' leaves; ``state["step"]`` is a 0-d int32 tensor on the
CPU, so the schedule never reads the device.  The formulas are the reference's, not
``torch.optim``'s: the gradient is cast to float32 and clipped to a global
norm before the moments, the update (decay included, on every leaf) is
formed in float32 and added as ``(p + u).to(p.dtype)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from .. import tree as T

Tree = Any
Schedule = Callable[[Any], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], dict]
    update: Callable[[Tree, dict, Tree], tuple[list, dict]]


def global_norm(tree: Tree) -> torch.Tensor:
    total = 0.0
    for x in T.leaves(tree):
        total = total + torch.sum(torch.square(x))
    return torch.sqrt(torch.as_tensor(total))


def clip_by_global_norm(tree: Tree, max_norm: float, norm: torch.Tensor | None = None
                        ) -> tuple[Tree, torch.Tensor]:
    """``tree`` scaled to a global norm of at most ``max_norm``; ``norm`` is
    ``global_norm(tree)`` unless the caller gives it (the norm of a tree
    whose leaves are slices of the gradients)."""
    norm = global_norm(tree) if norm is None else norm
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return T.tree_map(lambda x: x * scale, tree), norm


def apply_updates(params: Tree, updates: Tree) -> Tree:
    """``(p + u).to(p.dtype)`` per leaf; a module's parameters take the new
    values in place."""
    with torch.no_grad():
        return T.tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def _zeros(params: Tree) -> list[torch.Tensor]:
    return [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in T.leaves(params)]


def _f32(tree: Tree) -> list[torch.Tensor]:
    return [g.to(torch.float32) for g in T.leaves(tree)]


def adamw(
    schedule: Schedule,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: float | None = 1.0,
) -> Optimizer:
    """AdamW with decoupled weight decay; moments kept in f32."""

    def init(params):
        return {"step": torch.zeros((), dtype=torch.int32), "mu": _zeros(params),
                "nu": _zeros(params)}

    def update(grads, state, params, *, norm=None):
        grads = _f32(grads)
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm, norm)
        step = state["step"] + 1
        lr = float(schedule(step))
        mu = [b1 * m + (1 - b1) * g for m, g in zip(state["mu"], grads)]
        nu = [b2 * v + (1 - b2) * g * g for v, g in zip(state["nu"], grads)]
        sf = step.to(torch.float32)
        bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** sf)
        bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** sf)
        updates = [
            -lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * p.to(torch.float32))
            for m, v, p in zip(mu, nu, T.leaves(params))
        ]
        return updates, {"step": step, "mu": mu, "nu": nu}

    return Optimizer(init=init, update=update)


def sgd(schedule: Schedule, *, momentum: float = 0.9, nesterov: bool = False) -> Optimizer:
    def init(params):
        return {"step": torch.zeros((), dtype=torch.int32), "mom": _zeros(params)}

    def update(grads, state, params, *, norm=None):
        del params, norm
        step = state["step"] + 1
        lr = float(schedule(step))
        grads = _f32(grads)
        mom = [momentum * m + g for m, g in zip(state["mom"], grads)]
        if nesterov:
            updates = [-lr * (momentum * m + g) for m, g in zip(mom, grads)]
        else:
            updates = [-lr * m for m in mom]
        return updates, {"step": step, "mom": mom}

    return Optimizer(init=init, update=update)


def lion(
    schedule: Schedule,
    *,
    b1: float = 0.9,
    b2: float = 0.99,
    weight_decay: float = 0.1,
) -> Optimizer:
    """Lion (sign-momentum): one moment, handy for huge models."""

    def init(params):
        return {"step": torch.zeros((), dtype=torch.int32), "mu": _zeros(params)}

    def update(grads, state, params, *, norm=None):
        del norm
        step = state["step"] + 1
        lr = float(schedule(step))
        grads = _f32(grads)
        updates = [
            -lr * (torch.sign(b1 * m + (1 - b1) * g) + weight_decay * p.to(torch.float32))
            for m, g, p in zip(state["mu"], grads, T.leaves(params))
        ]
        mu = [b2 * m + (1 - b2) * g for m, g in zip(state["mu"], grads)]
        return updates, {"step": step, "mu": mu}

    return Optimizer(init=init, update=update)
