"""Trees of tensors: the port's counterpart of ``jax.tree`` for the code that
maps over parameters (``core.consensus``, ``optim``, the train step).

A tree is a tensor, a ``dict`` / ``list`` / ``tuple`` nesting of trees, or an
``nn.Module``, whose leaves are its parameters in ``named_parameters`` order.
A dict's leaves come in sorted-key order, as ``jax.tree.leaves`` gives them.
Trees of different kinds zip leaf by leaf, so a list of gradients pairs with
the module it came from.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch import nn

Tree = Any


def leaves(tree: Tree) -> list[torch.Tensor]:
    """The tensors of ``tree``, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, nn.Module):
        return [p for _, p in tree.named_parameters()]
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def rebuild(tree: Tree, new: list[torch.Tensor]) -> Tree:
    """``tree`` with its leaves replaced, in order, by ``new``.

    A dict, list, tuple or tensor comes back as a new tree; an ``nn.Module``
    takes the new values into its parameters in place and comes back itself.
    """
    if len(new) != len(leaves(tree)):
        raise ValueError(f"{len(new)} leaves for a tree of {len(leaves(tree))}")
    if isinstance(tree, nn.Module):
        with torch.no_grad():
            for p, x in zip(tree.parameters(), new):
                if x is not p:
                    p.copy_(x)
        return tree
    return _rebuild(tree, iter(new))


def _rebuild(tree: Tree, it) -> Tree:
    if isinstance(tree, torch.Tensor):
        return next(it)
    if isinstance(tree, dict):
        out = {key: _rebuild(tree[key], it) for key in sorted(tree)}
        return {key: out[key] for key in tree}
    return type(tree)(_rebuild(v, it) for v in tree)


def tree_map(fn: Callable[..., torch.Tensor], tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` zipped with those of ``rest``; the
    result has ``tree``'s structure (``rebuild``)."""
    cols = [leaves(tree)] + [leaves(r) for r in rest]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError(f"trees of {[len(c) for c in cols]} leaves do not zip")
    return rebuild(tree, [fn(*xs) for xs in zip(*cols)])
