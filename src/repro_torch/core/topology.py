"""Sensor-network topology: geometric graphs, padded neighborhoods, coloring.

Port of ``repro.core.topology``.  Sensors at positions ``x_i`` are
neighbors iff within radius ``r``, and every sensor is its own neighbor
(paper Sec. 3.1).  The graph is built host-side with numpy and frozen into
padded tensors on the caller's device.  Two sensors may update in the same
parallel step iff they share no neighbor, so the square of the graph is
colored greedily and the sweep runs color class by color class (paper
Sec. 3.3).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import device as _device
from . import plans


@dataclasses.dataclass(frozen=True)
class SensorTopology:
    """Frozen, padded representation of a sensor network graph.

    positions: (n, d) float32 coordinates (spare rows parked at ``plans.FAR``).
    adj: (n, n) bool adjacency with self loops.
    nbr_idx: (n, D) int32 neighbor ids, padded with the sensor's own id.
    nbr_mask: (n, D) bool validity of ``nbr_idx``.
    degrees: (n,) int32 |N_i| (self loop included, as in the paper).
    colors: (n,) int32 distance-2 greedy coloring (spares: singletons).
    n_colors: number of classes (spare and recolor budgets included).
    color_members: (n_colors, M) int32 members per color, padded with n.
    color_mask: (n_colors, M) bool.
    n_base: build-time sensor count; rows [n_base, n) are join capacity.
    radius: the geometric connection radius (0.0 for ``ring_topology``).
    n_recolor: reserved empty recolor classes (the last rows of the tables).
    """

    positions: torch.Tensor
    adj: torch.Tensor
    nbr_idx: torch.Tensor
    nbr_mask: torch.Tensor
    degrees: torch.Tensor
    colors: torch.Tensor
    n_colors: int
    color_members: torch.Tensor
    color_mask: torch.Tensor
    n_base: int = -1
    radius: float = 0.0
    n_recolor: int = 0

    @property
    def n(self) -> int:
        return int(self.positions.shape[0])

    @property
    def d_max(self) -> int:
        return int(self.nbr_idx.shape[1])

    @property
    def n_spare(self) -> int:
        return self.n - (self.n_base if self.n_base >= 0 else self.n)

    @property
    def device(self) -> torch.device:
        return self.positions.device


def geometric_adjacency(positions: np.ndarray, radius: float) -> np.ndarray:
    """Bool (n, n) adjacency: ||x_i - x_j|| < radius, self loops included."""
    pos = np.asarray(positions, dtype=np.float64)
    if pos.ndim == 1:
        pos = pos[:, None]
    d2 = np.sum((pos[:, None, :] - pos[None, :, :]) ** 2, axis=-1)
    adj = d2 < radius**2
    np.fill_diagonal(adj, True)
    return adj


def greedy_coloring(conflict: np.ndarray) -> tuple[np.ndarray, int]:
    """Greedy (Welsh-Powell order) coloring of a bool conflict graph."""
    n = conflict.shape[0]
    conflict = conflict.copy()
    np.fill_diagonal(conflict, False)
    order = np.argsort(-conflict.sum(axis=1), kind="stable")
    colors = -np.ones(n, dtype=np.int64)
    for v in order:
        used = set(colors[conflict[v]].tolist())
        c = 0
        while c in used:
            c += 1
        colors[v] = c
    return colors.astype(np.int32), int(colors.max()) + 1


def _assemble(
    pos: np.ndarray,
    adj: np.ndarray,
    d_max: int | None,
    n_spare: int,
    radius: float,
    n_recolor: int | None,
    device: torch.device,
) -> SensorTopology:
    n_base = adj.shape[0]
    n = n_base + n_spare
    if n_recolor is None:
        n_recolor = 2 * n_spare  # the reference's default recolor budget
    if n_spare:
        spare_pos = np.full((n_spare, pos.shape[1]), plans.FAR, np.float32)
        spare_pos[:, 0] += np.arange(n_spare, dtype=np.float32)
        pos = np.concatenate([pos, spare_pos])
        adj_full = np.zeros((n, n), dtype=bool)
        adj_full[:n_base, :n_base] = adj
    else:
        adj_full = adj
    nbr_idx, nbr_mask, degrees = plans.padded_neighborhoods(adj_full, d_max)
    colors, n_colors, color_members, color_mask = plans.color_classes(
        adj, greedy_coloring, n_spare=n_spare, n_recolor=n_recolor
    )
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return SensorTopology(
        positions=t(pos),
        adj=t(adj_full),
        nbr_idx=t(nbr_idx),
        nbr_mask=t(nbr_mask),
        degrees=t(degrees),
        colors=t(colors),
        n_colors=n_colors,
        color_members=t(color_members),
        color_mask=t(color_mask),
        n_base=n_base,
        radius=float(radius),
        n_recolor=int(n_recolor),
    )


def build_topology(
    positions: np.ndarray,
    radius: float,
    *,
    d_max: int | None = None,
    n_max: int | None = None,
    n_recolor: int | None = None,
    device: str | torch.device = "cuda",
) -> SensorTopology:
    """Build the frozen topology of a geometric sensor graph on ``device``.

    d_max: pad neighborhoods wider than the max degree (streaming headroom).
    n_max: total row capacity; ``n_max - len(positions)`` spare rows.
    n_recolor: reserved empty recolor classes (default ``2 * n_spare``).
    """
    dev = _device.resolve(device)
    pos = np.asarray(positions, dtype=np.float32)
    if pos.ndim == 1:
        pos = pos[:, None]
    n = pos.shape[0]
    n_spare = 0 if n_max is None else int(n_max) - n
    if n_spare < 0:
        raise ValueError(f"n_max={n_max} < n={n}")
    adj = geometric_adjacency(pos, radius)
    return _assemble(pos, adj, d_max, n_spare, radius, n_recolor, dev)


def pad_topology(
    topology: SensorTopology, n_max: int, n_recolor: int | None = None
) -> SensorTopology:
    """Re-pad an unpadded topology to ``n_max`` rows of join capacity."""
    if topology.n_spare:
        raise ValueError("pad_topology expects an unpadded topology")
    n_spare = int(n_max) - topology.n
    if n_spare < 0:
        raise ValueError(f"n_max={n_max} < n={topology.n}")
    if n_spare == 0 and not n_recolor:
        return topology
    return _assemble(
        topology.positions.cpu().numpy(), topology.adj.cpu().numpy(),
        topology.d_max, n_spare, topology.radius, n_recolor, topology.device,
    )


def uniform_sensors(
    n: int, *, d: int = 1, lo: float = -1.0, hi: float = 1.0, seed: int = 0
) -> np.ndarray:
    """Paper Sec 4.1: n sensors uniform on [-1, 1]^d (numpy, host side)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, size=(n, d)).astype(np.float32)


def ring_topology(
    n: int, *, hops: int = 1, device: str | torch.device = "cuda"
) -> SensorTopology:
    """A ring graph (non-geometric, radius 0: no join capacity)."""
    dev = _device.resolve(device)
    pos = np.stack(
        [np.cos(2 * np.pi * np.arange(n) / n), np.sin(2 * np.pi * np.arange(n) / n)],
        axis=1,
    ).astype(np.float32)
    adj = np.zeros((n, n), dtype=bool)
    for i in range(n):
        for h in range(1, hops + 1):
            adj[i, (i + h) % n] = True
            adj[i, (i - h) % n] = True
    np.fill_diagonal(adj, True)
    return _assemble(pos, adj, None, 0, 0.0, None, dev)
