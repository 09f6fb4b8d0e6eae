"""Network plan layer: the host-side builders and the slot-liveness helper.

Port of ``repro.core.plans``: the numpy builders (build time, identical
integer tables), ``alive_slots`` and the device-side repairs that the
join/leave events (``streaming.add_sensor``/``remove_sensor``) and the
serving-plan repairs run.

  ``padded_neighborhoods``  adjacency -> fixed-shape (n, D) neighbor table;
  ``color_classes``         distance-2 greedy coloring plus the spare-color
                            budget (one singleton color per spare row);
  ``assign_stream_slots``   the reserved message-slot layout;
  ``slot_owner_map``        message slot -> owning sensor row;
  ``build_color_plans``     the per-color scatter plans;
  ``build_cell_lists``      the serving grid's per-cell candidate lists;
  ``plan_rows_remove``/``plan_rows_add``, ``color_plans_remove``/``_add``,
  ``members_clear``/``members_set``, ``resolve_join_conflicts``,
  ``cells_remove``/``cells_add``, ``degree_headroom``: the fixed-shape
                            repairs of the device tables.
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


# ---------------------------------------------------------------------------
# Device-side repairs (fixed shapes; each event touches O(degree) rows, their
# color classes and O(1) grid cells).  The scatter-plan repairs write the
# given tables IN PLACE and return them.  Every gather precedes the writes,
# and a gated-off entry writes back the value it read, so it is a no-op.  The
# reference pads row lists with the sentinel row n, whose color is the
# out-of-range ``n_colors``; JAX clamps that read and drops that write.  Here
# the color is clamped for both, and the sentinel row's lanes all hold the
# sentinel slot, whose plan codes never change, so the write is the same
# no-op without an out-of-range index.
# ---------------------------------------------------------------------------


def _clamped(colors: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return torch.clamp(colors.long(), max=table.shape[0] - 1)


def plan_rows_remove(plan_z, plan_coef, colors_r, slots_r, idx_rows, gate_r):
    """Revert R rows' scatter codes to "keep" in their colors' plans.

    ``colors_r``/``slots_r`` (R,), ``idx_rows`` (R, D) the rows' CURRENT
    slot tables, ``gate_r`` (R,) bool.  Scatter-collision contract (the
    reference's): any two gated rows occupy distinct colors or have
    disjoint slot tables; a removal's affected rows have distinct colors,
    a join's adopters (pre-join colors and tables) disjoint tables.
    """
    c = _clamped(colors_r, plan_z)[:, None].expand(idx_rows.shape)
    idx = idx_rows.long()
    cur = plan_z[c, idx]
    plan_z[c, idx] = torch.where(gate_r[:, None], idx.to(plan_z.dtype), cur)
    cc, sl = _clamped(colors_r, plan_coef), slots_r.long()
    curc = plan_coef[cc, sl]
    plan_coef[cc, sl] = torch.where(gate_r, sl.to(plan_coef.dtype), curc)
    return plan_z, plan_coef


def plan_rows_add(plan_z, plan_coef, colors_r, m_pos_r, slots_r, idx_rows, gate_r):
    """Install R rows' scatter codes (the inverse of ``plan_rows_remove``).

    Codes follow ``build_color_plans``: slot ``idx_rows[r, k]`` takes
    ``n_z + m*D + k`` with ``m = m_pos_r[r]``, and the coefficient row
    ``(n+1) + m``.  Lanes retired to the sentinel slot stay at "keep".
    Same collision contract as ``plan_rows_remove``.
    """
    n_z = plan_z.shape[1]
    d = idx_rows.shape[1]
    idx = idx_rows.long()
    ar = torch.arange(d, device=idx.device)
    codes = n_z + m_pos_r.long()[:, None] * d + ar[None, :]
    codes = torch.where(idx == n_z - 1, idx, codes)  # the sentinel slot keeps
    c = _clamped(colors_r, plan_z)[:, None].expand(idx.shape)
    cur = plan_z[c, idx]
    plan_z[c, idx] = torch.where(gate_r[:, None], codes.to(plan_z.dtype), cur)
    n_rows = plan_coef.shape[1]
    cc, sl = _clamped(colors_r, plan_coef), slots_r.long()
    curc = plan_coef[cc, sl]
    plan_coef[cc, sl] = torch.where(gate_r, (n_rows + m_pos_r.long()).to(plan_coef.dtype), curc)
    return plan_z, plan_coef


def color_plans_remove(plan_z, plan_coef, color_of, slot, idx_row, gate):
    """One-row ``plan_rows_remove``; ``slot`` and ``gate`` are (1,) tensors."""
    return plan_rows_remove(plan_z, plan_coef, color_of[slot], slot, idx_row[None], gate)


def color_plans_add(plan_z, plan_coef, color_of, member_pos, slot, idx_row, gate):
    """One-row ``plan_rows_add``; ``slot`` and ``gate`` are (1,) tensors."""
    return plan_rows_add(
        plan_z, plan_coef, color_of[slot], member_pos[slot], slot, idx_row[None], gate
    )


def _member_hits(shape, colors_r, m_pos_r, gate_r) -> torch.Tensor:
    """(n_colors, M, R) bool: entry (c, m) addressed by gated row r."""
    dev = colors_r.device
    c_ax = torch.arange(shape[0], device=dev)[:, None, None]
    m_ax = torch.arange(shape[1], device=dev)[None, :, None]
    return (
        (c_ax == colors_r.long()[None, None, :])
        & (m_ax == m_pos_r.long()[None, None, :])
        & gate_r[None, None, :]
    )


def members_clear(color_members, color_mask, colors_r, m_pos_r, gate_r, sentinel: int):
    """Clear R member-table entries ((colors_r[r], m_pos_r[r]) each), in place.

    A full-table masked update (an out-of-range color addresses nothing),
    O(n_colors * M * R) compares.
    """
    hit = _member_hits(color_members.shape, colors_r, m_pos_r, gate_r).any(-1)
    color_members.masked_fill_(hit, sentinel)
    color_mask &= ~hit
    return color_members, color_mask


def members_set(color_members, color_mask, colors_r, m_pos_r, slots_r, gate_r):
    """Install R member-table entries in place: (colors_r[r], m_pos_r[r])
    takes row ``slots_r[r]``.  Gated targets must be distinct and empty (the
    recolor pool and singleton-class contract)."""
    hit = _member_hits(color_members.shape, colors_r, m_pos_r, gate_r)
    val = torch.sum(hit * slots_r.long()[None, None, :], dim=-1)
    any_hit = hit.any(-1)
    color_members.copy_(torch.where(any_hit, val.to(color_members.dtype), color_members))
    color_mask |= any_hit
    return color_members, color_mask


def resolve_join_conflicts(color_of, color_mask, adopters, valid, recolor_start: int):
    """Conflict-aware recoloring of a symmetric join's adopters.

    Every adopter's neighborhood gains the newcomer's slot, so two
    same-color adopters would violate the distance-2 rule.  The FIRST
    adopter of each color stays; the rest move into empty reserved recolor
    classes (``recolor_start`` onward), in order.  Returns ``(new_colors
    (A,), moved (A,) bool, feasible () bool)``; ``feasible`` is False when
    the pool has fewer empty classes than conflicts (the caller drops the
    join).
    """
    a = adopters.shape[0]
    c = color_of[adopters.long()]
    same = (c[:, None] == c[None, :]) & valid[:, None] & valid[None, :]
    earlier = torch.tril(torch.ones((a, a), dtype=torch.bool, device=c.device), diagonal=-1)
    moved = (same & earlier).any(dim=1)
    free = ~color_mask[recolor_start:].any(dim=1)
    rank = torch.cumsum(moved.long(), 0)  # 1-based rank among the moves
    csum = torch.cumsum(free.long(), 0)
    pick = torch.searchsorted(csum, rank)  # the rank-th empty class (left side)
    new_c = torch.where(moved, recolor_start + pick, c.long())
    feasible = moved.sum() <= free.sum()
    return new_c.to(color_of.dtype), moved, feasible


def cells_remove(cells, cell_mask, slot, gate):
    """Mask sensor ``slot`` out of every cell's candidate list (a new mask)."""
    return cell_mask & ~((cells == slot) & gate)


def cells_add(cells, cell_mask, centers, radii, x, slot, gate):
    """Insert a joined sensor at ``x`` into every covering cell's list, in place.

    A cell lists the sensor iff ``|x - center| <= radius`` (the build-time
    covering bound stays valid, since adds only shrink kNN distances).  The
    sensor takes each such cell's first free column; full cells are
    skipped and counted in the returned ``overflowed`` (0-d tensor).
    """
    d2 = torch.sum((centers - x[None, :]) ** 2, dim=-1)
    want = gate & (d2 <= radii**2)
    free_col = torch.argmin(cell_mask.to(torch.uint8), dim=1)  # first False per cell
    rows = torch.arange(cells.shape[0], device=cells.device)
    has_free = ~cell_mask[rows, free_col]
    do = want & has_free
    cur = cells[rows, free_col]
    cells[rows, free_col] = torch.where(do, slot.to(cells.dtype), cur)
    cell_mask[rows, free_col] = has_free.logical_not() | do
    return cells, cell_mask, torch.sum(want & ~has_free)


def degree_headroom(degrees: torch.Tensor, alive: torch.Tensor, d_max: int) -> torch.Tensor:
    """(n,) free reciprocal-anchor lanes per live row (0 for dead rows).

    A symmetric join adopts a candidate only if its row has a lane to spare
    (``degrees < d_max``); check before a churn campaign: a live row at 0
    loses couplings to joins near it.
    """
    alive = alive.to(torch.bool)[: degrees.shape[0]]
    free = torch.clamp(d_max - degrees, min=0)
    return torch.where(alive, free, 0).to(degrees.dtype)
