"""Tree checkpointing with the reference's on-disk layout.

Port of ``repro.checkpoint.ckpt``.  Layout:
``<dir>/step_<N>/arrays.npz`` + ``<dir>/step_<N>/manifest.json``; writes
are atomic (tmp dir + rename), so a crashed save never corrupts the latest
checkpoint.

Leaves are tensors and numpy arrays, taken in the order of the reference's
``jax.tree.flatten``: dict keys sorted, lists and tuples in order, a
dataclass's fields in declaration order.  A dataclass's other fields (ints,
floats, the kernel) are static, as in the reference's registered
dataclasses, and ``None`` holds no leaf.  The port's ``SNTrainProblem``,
``SNTrainState``, ``SensorTopology`` and ``LifecycleLayout`` declare the
reference's fields in the reference's order, so a ``save_train`` of either
package restores into the other bitwise.  The manifest's ``treedef`` is a
description of the leaf paths; ``restore`` reads only the arrays.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import tempfile
import zipfile
from typing import Any

import numpy as np
import torch

Tree = Any
_LEAF = (torch.Tensor, np.ndarray)


def _items(tree: Tree, path: str = ""):
    """(path, leaf) pairs of ``tree`` in the reference's flatten order."""
    if isinstance(tree, _LEAF):
        yield path, tree
    elif isinstance(tree, dict):
        for key in sorted(tree):
            yield from _items(tree[key], f"{path}{key}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, f"{path}{i}.")
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            v = getattr(tree, f.name)
            if isinstance(v, _LEAF) or dataclasses.is_dataclass(v):
                yield from _items(v, f"{path}{f.name}.")


def _numpy(leaf) -> np.ndarray:
    return leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)


def _rebuild(tmpl: Tree, arrays) -> Tree:
    """``tmpl`` with its leaves replaced, in order, from the iterator ``arrays``."""
    if isinstance(tmpl, torch.Tensor):
        return torch.from_numpy(next(arrays)).to(device=tmpl.device, dtype=tmpl.dtype)
    if isinstance(tmpl, np.ndarray):
        return np.asarray(next(arrays), dtype=tmpl.dtype)
    if isinstance(tmpl, dict):
        out = {key: _rebuild(tmpl[key], arrays) for key in sorted(tmpl)}
        return {key: out[key] for key in tmpl}
    if isinstance(tmpl, (list, tuple)):
        return type(tmpl)(_rebuild(v, arrays) for v in tmpl)
    if dataclasses.is_dataclass(tmpl):
        new = {}
        for f in dataclasses.fields(tmpl):
            v = getattr(tmpl, f.name)
            if isinstance(v, _LEAF) or dataclasses.is_dataclass(v):
                new[f.name] = _rebuild(v, arrays)
        return dataclasses.replace(tmpl, **new)
    return tmpl


def save(directory: str, step: int, tree: Tree) -> str:
    """Write ``tree``'s leaves as ``step_<N>`` under ``directory``, atomically."""
    items = list(_items(tree))
    keyed = [(f"leaf_{i:05d}", _numpy(leaf)) for i, (_, leaf) in enumerate(items)]
    final = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **dict(keyed))
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(
                {
                    "step": step,
                    "treedef": "repro_torch(" + ", ".join(p[:-1] for p, _ in items) + ")",
                    "n_leaves": len(keyed),
                    "dtypes": [str(a.dtype) for _, a in keyed],
                    "shapes": [list(a.shape) for _, a in keyed],
                },
                f,
            )
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    finally:
        if os.path.exists(tmp):
            shutil.rmtree(tmp, ignore_errors=True)
    return final


def step_valid(directory: str, step: int) -> bool:
    """True when ``step_<N>`` is a complete, readable checkpoint: the
    manifest parses, the npz is a sound zip archive (per-member CRCs
    checked) and its members are exactly the manifest's leaves."""
    path = os.path.join(directory, f"step_{step:08d}")
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        n_leaves = int(manifest["n_leaves"])
        with zipfile.ZipFile(os.path.join(path, "arrays.npz")) as zf:
            if zf.testzip() is not None:  # CRC failure: a truncated member
                return False
            names = {name.removesuffix(".npy") for name in zf.namelist()}
        return names == {f"leaf_{i:05d}" for i in range(n_leaves)}
    except (OSError, ValueError, KeyError, zipfile.BadZipFile):
        return False


def latest_step(directory: str, *, verify: bool = True) -> int | None:
    """Largest step with a checkpoint in ``directory`` (None if none).

    ``verify=True`` skips steps that fail ``step_valid``, so a truncated or
    partly written snapshot is ignored and the newest intact step returned.
    """
    if not os.path.isdir(directory):
        return None
    steps = sorted(
        (
            int(m.group(1))
            for name in os.listdir(directory)
            if (m := re.fullmatch(r"step_(\d+)", name))
        ),
        reverse=True,
    )
    for step in steps:
        if not verify or step_valid(directory, step):
            return step
    return None


def restore(directory: str, step: int, like: Tree) -> Tree:
    """Restore into the structure of ``like`` (shapes verified); each leaf
    takes the template leaf's dtype and device."""
    path = os.path.join(directory, f"step_{step:08d}")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = [data[f"leaf_{i:05d}"] for i in range(len(data.files))]
    leaves = [leaf for _, leaf in _items(like)]
    if len(leaves) != len(arrays):
        raise ValueError(f"checkpoint has {len(arrays)} leaves, template has {len(leaves)}")
    for i, (tmpl, arr) in enumerate(zip(leaves, arrays)):
        if tuple(tmpl.shape) != tuple(arr.shape):
            raise ValueError(f"leaf {i}: shape {arr.shape} != template {tuple(tmpl.shape)}")
    return _rebuild(like, iter(arrays))


def save_train(directory: str, step: int, problem, state) -> str:
    """Snapshot a full ``SNTrainProblem`` + ``SNTrainState`` pair.

    One atomic ``save`` of ``{"problem": problem, "state": state}``
    captures everything the solver owns: topology tables, factors, scatter
    plans, liveness, forgetting weights, messages and coefficients.  npz
    storage is lossless, so the round trip is bitwise (the watchdog's
    rollback anchor, ``repro_torch.core.monitor``).
    """
    return save(directory, step, {"problem": problem, "state": state})


def restore_train(directory: str, step: int, problem, state) -> tuple:
    """Bitwise inverse of ``save_train``.

    ``problem``/``state`` are live templates: their static fields (kernel,
    ``n_stream``, layout ints) carry over, and every tensor is replaced by
    the snapshot's, on the template's device in the template's dtype.
    Returns ``(problem, state)``.
    """
    tree = restore(directory, step, {"problem": problem, "state": state})
    return tree["problem"], tree["state"]
