"""The plain reference's build of a deployment: neighbourhoods, the
distance-2 colouring, the local Gram blocks and their systems.

The neighbourhood and colouring rules are frozen copies of the host
builders the program was ported from (``src/repro/core/topology.py``:
``geometric_adjacency`` and ``greedy_coloring``; ``src/repro/core/plans.py``:
``padded_neighborhoods`` and ``color_classes``), in NumPy, so that the
reference sweeps the colours in the order the paper's algorithm is run in.
The Gram blocks and systems are worked out again here in the precision
asked for.  Imports nothing of the program.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .precision import Precision


@dataclasses.dataclass(frozen=True)
class Build:
    positions: np.ndarray  # (n, d) float32, as placed
    nbr_idx: np.ndarray  # (n, D) int64 neighbours in ascending id, padded with the row's id
    nbr_mask: np.ndarray  # (n, D) bool
    degrees: np.ndarray  # (n,) |N_i|, the sensor itself included
    colors: np.ndarray  # (n,) distance-2 colour of each sensor
    members: list  # per colour, its sensors (int64 arrays)
    lambdas: np.ndarray  # (n,) float64 regularisers

    @property
    def n(self) -> int:
        return self.positions.shape[0]


def lambdas(rule: dict, degrees: np.ndarray) -> np.ndarray:
    """Per-sensor lambda: ``{"rule": "const", "value": v}`` or the paper's
    ``{"rule": "kappa_over_deg2", "kappa": k}`` (Sec. 4.1: k / |N_i|^2)."""
    deg = degrees.astype(np.float64)
    if rule["rule"] == "const":
        return np.full(deg.shape, float(rule["value"]))
    if rule["rule"] == "kappa_over_deg2":
        return float(rule["kappa"]) / deg**2
    raise ValueError(f"unknown lambda rule {rule!r}")


def greedy_colouring(conflict: np.ndarray) -> np.ndarray:
    """Welsh-Powell greedy colouring of a bool conflict graph."""
    conflict = conflict.copy()
    np.fill_diagonal(conflict, False)
    order = np.argsort(-conflict.sum(axis=1), kind="stable")
    colors = -np.ones(conflict.shape[0], dtype=np.int64)
    for v in order:
        used = set(colors[conflict[v]].tolist())
        c = 0
        while c in used:
            c += 1
        colors[v] = c
    return colors


def build(positions: np.ndarray, radius: float, lam_rule: dict) -> Build:
    """Sensors are neighbours iff closer than ``radius``, each its own
    neighbour; two sensors share a colour only if they share no neighbour."""
    pos = np.asarray(positions, np.float64)
    d2 = np.sum((pos[:, None, :] - pos[None, :, :]) ** 2, axis=-1)
    adj = d2 < radius**2
    np.fill_diagonal(adj, True)
    n = adj.shape[0]
    degrees = adj.sum(axis=1)
    nbr_idx = np.repeat(np.arange(n)[:, None], int(degrees.max()), axis=1)
    nbr_mask = np.zeros(nbr_idx.shape, bool)
    for i in range(n):
        nb = np.nonzero(adj[i])[0]
        nbr_idx[i, : len(nb)] = nb
        nbr_mask[i, : len(nb)] = True
    a = adj.astype(np.float32)  # counts below 2**24 are exact
    colors = greedy_colouring((a @ a) > 0)
    members = [np.nonzero(colors == c)[0] for c in range(int(colors.max()) + 1)]
    return Build(np.asarray(positions, np.float32), nbr_idx, nbr_mask, degrees, colors,
                 members, lambdas(lam_rule, degrees))


def sq_dists(x: torch.Tensor, y: torch.Tensor, prec: Precision) -> torch.Tensor:
    """(..., P, R) squared distances between points x (..., P, d) and y
    (..., R, d), summed from the coordinates' differences, each difference
    an operand of its own square (rounded to TF32 in that precision)."""
    diff = prec.operand(x.to(prec.dtype)[..., :, None, :] - y.to(prec.dtype)[..., None, :, :])
    return torch.sum(diff * diff, dim=-1)


def gram_blocks(b: Build, gamma: float, prec: Precision, device) -> torch.Tensor:
    """(n, D, D) local Gram blocks ``exp(-gamma |x_i - x_j|^2)`` over each
    sensor's neighbours, zero outside the real lanes."""
    x = torch.as_tensor(b.positions, device=device)[torch.as_tensor(b.nbr_idx, device=device)]
    mask = torch.as_tensor(b.nbr_mask, device=device)
    outer = mask[:, :, None] & mask[:, None, :]
    return torch.where(outer, torch.exp(-gamma * sq_dists(x, x, prec)), 0.0)


def systems(b: Build, gram: torch.Tensor) -> torch.Tensor:
    """``K_s + lambda_s I`` on the real lanes, the identity on the padded ones."""
    mask = torch.as_tensor(b.nbr_mask, device=gram.device)
    lam = torch.as_tensor(b.lambdas, device=gram.device).to(gram.dtype)
    return gram + torch.diag_embed(torch.where(mask, lam[:, None], 1.0))
