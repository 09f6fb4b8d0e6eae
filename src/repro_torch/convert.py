"""Carry a problem, state or serving plan across as numpy arrays.

The reference's ``SNTrainProblem``, ``SNTrainState`` and ``ServingPlan``
leaves, read out as numpy arrays, become the port's dataclasses on
``device``.  Keys are the field names; nested dataclasses use a dotted
prefix (``"topology.positions"``, ``"layout.slot_owner"``).  Static fields
(``n_stream``, ``topology.n_colors``, ``grid_shape``, ``k``, ...) are
plain Python values in the same dict.  Dtypes are kept as given.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import device as _device
from .core.kernels_math import Kernel
from .core.plans import LifecycleLayout
from .core.serving import ServingPlan
from .core.sn_train import SNTrainProblem, SNTrainState
from .core.topology import SensorTopology

_STATIC = {"n_colors": int, "n_base": int, "radius": float, "n_recolor": int,
           "n_stream": int, "k": int, "grid_shape": tuple}


def _build(cls, d: dict, prefix: str, dev: torch.device, **given):
    kw = dict(given)
    for f in dataclasses.fields(cls):
        if f.name in kw:
            continue
        key = prefix + f.name
        if key not in d:
            if f.default is dataclasses.MISSING:
                raise KeyError(f"missing {key!r}")
            continue
        v = d[key]
        if f.name in _STATIC:
            kw[f.name] = _STATIC[f.name](np.asarray(v).tolist())
        else:
            kw[f.name] = torch.as_tensor(np.array(v), device=dev)  # a writable copy
    return cls(**kw)


def problem_from_numpy(
    d: dict, *, kernel: Kernel, device: str | torch.device = "cuda"
) -> SNTrainProblem:
    """An ``SNTrainProblem`` on ``device`` from the reference's leaves."""
    dev = _device.resolve(device)
    topo = _build(SensorTopology, d, "topology.", dev)
    layout = _build(LifecycleLayout, d, "layout.", dev)
    return _build(SNTrainProblem, d, "", dev, topology=topo, layout=layout, kernel=kernel)


def state_from_numpy(d: dict, *, device: str | torch.device = "cuda") -> SNTrainState:
    """An ``SNTrainState`` on ``device`` from ``{"z": ..., "coef": ...}``."""
    return _build(SNTrainState, d, "", _device.resolve(device))


def serving_plan_from_numpy(d: dict, *, device: str | torch.device = "cuda") -> ServingPlan:
    """A ``ServingPlan`` on ``device`` from the reference's leaves."""
    return _build(ServingPlan, d, "", _device.resolve(device))
