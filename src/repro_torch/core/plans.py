"""Network plan layer: the host-side builders and the slot-liveness helper.

Port of the numpy builders of ``repro.core.plans`` (build time, identical
integer tables) and of ``alive_slots``.  The device-side lifecycle
repairs of the reference (join/leave) belong to a later slice.

  ``padded_neighborhoods``  adjacency -> fixed-shape (n, D) neighbor table;
  ``color_classes``         distance-2 greedy coloring plus the spare-color
                            budget (one singleton color per spare row);
  ``assign_stream_slots``   the reserved message-slot layout;
  ``slot_owner_map``        message slot -> owning sensor row;
  ``build_color_plans``     the per-color scatter plans;
  ``build_cell_lists``      the serving grid's per-cell candidate lists.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Spare rows park here until a join gives them a real position: far enough
# that an RBF kernel underflows to 0 and no in-domain query selects them,
# near enough that f32 squared distances stay finite.
FAR = 1.0e6


@dataclasses.dataclass(frozen=True)
class LifecycleLayout:
    """Event-invariant lifecycle metadata of a capacity-padded problem.

    slot_owner: (n_z,) int32 owning sensor row per message slot (sensor
                slots own themselves, reserved slots belong to the row whose
                free lane they back, the sentinel belongs to row ``n``).
    nbr_idx0:   (n+1, D) int32 pristine build-time slot table.
    n_base:     number of real (build-time) sensors.
    """

    slot_owner: torch.Tensor
    nbr_idx0: torch.Tensor
    n_base: int


def padded_neighborhoods(
    adj: np.ndarray, d_max: int | None = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fixed-shape neighbor table of a bool adjacency (self loops included).

    Rows with no neighbors (spare rows) get degree 0 and a fully masked row
    padded with the row's own index.  Returns
    ``(nbr_idx (n, D) int32, nbr_mask (n, D) bool, degrees (n,) int32)``.
    """
    n = adj.shape[0]
    degrees = adj.sum(axis=1).astype(np.int32)
    dm = int(degrees.max()) if d_max is None else int(d_max)
    if dm < int(degrees.max()):
        raise ValueError(f"d_max={dm} < max degree {int(degrees.max())}")
    nbr_idx = np.zeros((n, dm), dtype=np.int32)
    nbr_mask = np.zeros((n, dm), dtype=bool)
    for i in range(n):
        nbrs = np.nonzero(adj[i])[0]
        nbr_idx[i, : len(nbrs)] = nbrs
        nbr_idx[i, len(nbrs):] = i  # pad with self (masked)
        nbr_mask[i, : len(nbrs)] = True
    return nbr_idx, nbr_mask, degrees


def color_classes(
    adj: np.ndarray, greedy_coloring, n_spare: int = 0, n_recolor: int = 0
) -> tuple[np.ndarray, int, np.ndarray, np.ndarray]:
    """Distance-2 color classes of the base graph + the spare-color budgets.

    The ``n_base`` rows of ``adj`` are colored greedily on G^2 (two sensors
    conflict iff they share a neighbor).  Each spare row gets its own
    reserved singleton color, and ``n_recolor`` EMPTY classes are appended
    for the symmetric-join recoloring.  Returns ``(colors (n,), n_colors,
    color_members (n_colors, M), color_mask (n_colors, M))``, members padded
    with ``n`` (the sentinel row id); spare and recolor classes start empty.
    """
    n_base = adj.shape[0]
    g2 = (adj.astype(np.int64) @ adj.astype(np.int64)) > 0
    base_colors, n_base_colors = greedy_coloring(g2)
    n = n_base + n_spare
    colors = np.concatenate(
        [base_colors, n_base_colors + np.arange(n_spare, dtype=np.int32)]
    ).astype(np.int32)
    n_colors = n_base_colors + n_spare + n_recolor
    max_members = max(
        int(np.bincount(base_colors, minlength=n_base_colors).max()),
        1 if (n_spare or n_recolor) else 0,
    )
    color_members = np.full((n_colors, max_members), n, dtype=np.int32)
    color_mask = np.zeros((n_colors, max_members), dtype=bool)
    for c in range(n_base_colors):
        members = np.nonzero(colors == c)[0]
        color_members[c, : len(members)] = members
        color_mask[c, : len(members)] = True
    return colors, n_colors, color_members, color_mask


def assign_stream_slots(
    nbr_idx: np.ndarray, degrees: np.ndarray
) -> tuple[np.ndarray, int]:
    """Reserve a fixed global message id for every free padded lane.

    Returns ``(idx_full (n+1, D) int32, n_stream)``: row ``i``'s free lanes
    ``[deg_i, D)`` hold the reserved ids ``n + offset_i + ...`` and the
    appended sentinel row points every lane at the write sentinel
    ``n + n_stream``.
    """
    n, d_max = nbr_idx.shape
    deg = np.asarray(degrees)
    free = d_max - deg
    n_stream = int(free.sum())
    sentinel = n + n_stream
    offsets = n + np.concatenate([[0], np.cumsum(free)[:-1]])
    idx_np = np.asarray(nbr_idx).copy()
    for i in range(n):
        idx_np[i, deg[i]:] = offsets[i] + np.arange(free[i])
    return (
        np.concatenate([idx_np, np.full((1, d_max), sentinel)]).astype(np.int32),
        n_stream,
    )


def slot_owner_map(idx_full: np.ndarray, n_stream: int) -> np.ndarray:
    """(n_z,) int32: the sensor row whose liveness governs each slot."""
    n = idx_full.shape[0] - 1
    owner = np.arange(n + n_stream + 1, dtype=np.int32)
    owner[n:] = n  # sentinel default
    for i in range(n):
        stream = idx_full[i][idx_full[i] >= n]
        owner[stream] = i
    owner[n + n_stream] = n
    return owner


def build_color_plans(
    color_members: np.ndarray,
    color_mask: np.ndarray,
    idx_full: np.ndarray,
    n_stream: int,
    alive0: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side static scatter plans, one per color class.

      plan_z[c][j]    = j               keep z[j], or
                      = n_z + m*D + k   slot j is owned by lane k of the
                                        color's m-th member;
      plan_coef[c][r] = r               keep coef row r, or
                      = (n+1) + m       row r is the color's m-th member.

    Rows dead at build start at "keep"; the sentinel slot and sentinel
    coefficient row always keep.
    """
    n, d_max = idx_full.shape
    n = n - 1
    n_z = n + n_stream + 1
    members = np.asarray(color_members)
    cmask = np.asarray(color_mask)
    alive0 = np.asarray(alive0, bool)
    n_colors, _ = members.shape
    plan_z = np.tile(np.arange(n_z, dtype=np.int32), (n_colors, 1))
    plan_coef = np.tile(np.arange(n + 1, dtype=np.int32), (n_colors, 1))
    for c in range(n_colors):
        m_pos = np.nonzero(cmask[c])[0]  # positions of real members
        mem = members[c, m_pos]
        live = alive0[mem]
        m_pos, mem = m_pos[live], mem[live]
        plan_coef[c, mem] = (n + 1) + m_pos
        slots = idx_full[mem]  # (m_live, D) unique ids (no sentinel)
        flat = m_pos[:, None] * d_max + np.arange(d_max)[None, :]
        plan_z[c, slots.reshape(-1)] = n_z + flat.reshape(-1)
    plan_z[:, n_z - 1] = n_z - 1
    plan_coef[:, n] = n
    return plan_z, plan_coef


def build_layout(
    idx_full: np.ndarray, n_stream: int, n_base: int, *, device: torch.device
) -> LifecycleLayout:
    """Assemble the ``LifecycleLayout`` on ``device`` from the host builders."""
    return LifecycleLayout(
        slot_owner=torch.as_tensor(slot_owner_map(idx_full, n_stream), device=device),
        nbr_idx0=torch.as_tensor(idx_full, dtype=torch.int32, device=device),
        n_base=int(n_base),
    )


def color_assignments(
    colors: np.ndarray, color_members: np.ndarray, color_mask: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side initial (color_of (n+1,), member_pos (n+1,)) assignment.

    The sentinel row holds ``n_colors``, an out-of-range placeholder.
    """
    n = colors.shape[0]
    n_colors = color_members.shape[0]
    color_of = np.concatenate([np.asarray(colors), [n_colors]]).astype(np.int32)
    member_pos = np.zeros(n + 1, dtype=np.int32)
    members = np.asarray(color_members)
    cmask = np.asarray(color_mask)
    for c in range(n_colors):
        m_pos = np.nonzero(cmask[c])[0]
        member_pos[members[c, m_pos]] = m_pos
    return color_of, member_pos


def build_cell_lists(
    pos: np.ndarray,
    live: np.ndarray,
    k: int,
    cells_per_dim: int | None,
    lo,
    hi,
    spare: int = 0,
    slack: int = 0,
) -> dict:
    """Host-side serving-grid precompute.

    Buckets the LIVE sensors into a uniform grid and lists, per cell, every
    sensor within ``d_{k+slack} + 2h`` of the cell center (the (k+slack)-th
    live-sensor distance plus twice the cell half-diagonal): exact kNN for
    any in-cell query.  ``spare`` reserves extra padded candidate columns.
    """
    pos = np.asarray(pos, np.float64)
    live = np.asarray(live, bool)
    lpos = pos[live]
    n, d = pos.shape
    n_live = lpos.shape[0]
    kk = int(min(k + slack, n_live))
    lo = lpos.min(axis=0) if lo is None else np.broadcast_to(
        np.asarray(lo, np.float64), (d,)
    )
    hi = lpos.max(axis=0) if hi is None else np.broadcast_to(
        np.asarray(hi, np.float64), (d,)
    )
    span = np.maximum(hi - lo, 1e-6)
    if cells_per_dim is None:
        cells_per_dim = max(1, int(round((n_live / 4.0) ** (1.0 / d))))
    g = int(cells_per_dim)
    cell = span / g
    half_diag = 0.5 * float(np.linalg.norm(cell))

    grid_shape = (g,) * d
    n_cells = g**d
    centers = np.stack(
        np.meshgrid(
            *[lo[j] + (np.arange(g) + 0.5) * cell[j] for j in range(d)],
            indexing="ij",
        ),
        axis=-1,
    ).reshape(n_cells, d)

    dc = np.sqrt(
        np.maximum(
            np.sum((centers[:, None, :] - lpos[None, :, :]) ** 2, axis=-1), 0.0
        )
    )  # (C, n_live)
    d_k = np.sort(dc, axis=1)[:, kk - 1]
    radius = d_k + 2.0 * half_diag + 1e-7  # exactness bound, see above
    member = dc <= radius[:, None]

    live_ids = np.nonzero(live)[0]
    k_max = int(member.sum(axis=1).max()) + int(spare)
    cells = np.full((n_cells, k_max), n, dtype=np.int32)  # sentinel pad
    mask = np.zeros((n_cells, k_max), dtype=bool)
    for c in range(n_cells):
        ids = live_ids[np.nonzero(member[c])[0]]
        cells[c, : len(ids)] = ids
        mask[c, : len(ids)] = True
    return dict(
        origin=lo,
        cell=cell,
        centers=centers,
        radii=radius,
        cells=cells,
        mask=mask,
        grid_shape=grid_shape,
    )


def alive_slots(alive: torch.Tensor, slot_owner: torch.Tensor) -> torch.Tensor:
    """(n_z,) message-slot liveness from (n+1,) row liveness."""
    return alive[slot_owner]
