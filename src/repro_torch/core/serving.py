"""Static query plans for kNN-fusion serving (paper Sec. 3.3, Eq. 19).

Port of ``repro.core.serving``.  The testing phase answers a query x by
averaging the k sensors nearest x.  Sensors are bucketed into a uniform
grid at build time, and every cell gets a padded candidate list that is
provably enough for exact kNN of any query inside it, so serving touches
one cell's row per query: O(Q*k*D) instead of the dense O(Q*n*D).

Engines (``fusion.fuse(rule="knn", engine=...)`` dispatches here):

  ``"plan"``  the PyTorch realization of the plan path (any kernel, any
              dtype), the reference the CUDA kernel is tested against;
  ``"cuda"``  the hand-written kernel ``repro_torch.kernels.knn_fuse``
              (RBF only), the counterpart of the reference's ``"pallas"``;
  ``"dense"`` (in ``fusion``) the all-sensors oracle.

Ties in distance break toward the lower sensor id in every engine.  When
fewer than k candidates are live, every engine averages the valid picks
only.  ``compute_dtype="bf16"`` stores the anchor tables in bf16; the
selection stays full precision and accumulation stays in the coefficient
dtype.  ``prune`` ANDs a keep mask into liveness.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import spans
from . import plans
from .sn_train import SNTrainProblem, SNTrainState, effective_coef


@dataclasses.dataclass(frozen=True)
class ServingPlan:
    """Frozen-shape query-time plan: uniform grid + per-cell candidate lists.

    origin (d,) grid origin; inv_cell (d,) reciprocal cell edges; centers
    (C, d); radii (C,) per-cell candidate radius; cells (C, K_max) int32
    candidate ids padded with n (the sentinel row); cell_mask (C, K_max)
    bool; grid_shape per-dim cell counts; k the largest exact kNN order.
    """

    origin: torch.Tensor
    inv_cell: torch.Tensor
    centers: torch.Tensor
    radii: torch.Tensor
    cells: torch.Tensor
    cell_mask: torch.Tensor
    grid_shape: tuple
    k: int = 1

    @property
    def n_cells(self) -> int:
        return int(self.cells.shape[0])

    @property
    def k_max(self) -> int:
        return int(self.cells.shape[1])


def make_serving_plan(
    problem: SNTrainProblem,
    *,
    k: int = 8,
    cells_per_dim: int | None = None,
    lo=None,
    hi=None,
    spare: int = 0,
    slack: int = 0,
) -> ServingPlan:
    """Host-side precomputation of the kNN query plan, on the problem's device.

    k: largest kNN order served exactly; cells_per_dim defaults to ~4
    sensors per cell; lo/hi override the plan domain (default: the live
    sensors' bounding box); spare/slack reserve lifecycle capacity.
    """
    n = problem.n
    live = problem.alive[:n].cpu().numpy()
    k = int(min(k, int(live.sum())))
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    grid = plans.build_cell_lists(
        problem.topology.positions.cpu().numpy(), live, k, cells_per_dim, lo, hi,
        spare=spare, slack=slack,
    )
    dt, dev = problem.topology.positions.dtype, problem.device
    return ServingPlan(
        origin=torch.as_tensor(grid["origin"], dtype=dt, device=dev),
        inv_cell=torch.as_tensor(1.0 / grid["cell"], dtype=dt, device=dev),
        centers=torch.as_tensor(grid["centers"], dtype=dt, device=dev),
        radii=torch.as_tensor(grid["radii"], dtype=dt, device=dev),
        cells=torch.as_tensor(grid["cells"], device=dev),
        cell_mask=torch.as_tensor(grid["mask"], device=dev),
        grid_shape=grid["grid_shape"],
        k=k,
    )


def plan_remove_sensor(plan: ServingPlan, slot) -> ServingPlan:
    """Lifecycle repair: drop a removed sensor from every candidate list.

    Pairs with ``streaming.remove_sensor``; one fixed-shape compare over the
    (C, K_max) table, whose freed columns become holes a later
    ``plan_add_sensor`` reuses.  Removals never shrink a cell's radius, so
    kNN stays exact while at most the plan's build ``slack`` candidates of
    any one cell have been removed.  Returns a new plan (``cells`` shared).
    """
    slot = torch.as_tensor(slot, device=plan.cells.device).to(plan.cells.dtype)
    mask = plans.cells_remove(plan.cells, plan.cell_mask, slot, True)
    return dataclasses.replace(plan, cell_mask=mask)


def plan_add_sensor(plan: ServingPlan, x, slot) -> tuple[ServingPlan, torch.Tensor]:
    """Lifecycle repair: insert a joined sensor into every covering cell.

    Pairs with ``streaming.add_sensor``: the sensor at ``x`` enters the
    first free column of every cell whose build-time exactness radius covers
    it.  Returns ``(plan, overflowed)``, ``overflowed`` a 0-d tensor counting
    the covering cells whose rows were full (build the plan with more
    ``spare`` columns if it is ever nonzero).  The returned plan holds new
    tables; the given one is left as it was.
    """
    dev = plan.cells.device
    x = torch.as_tensor(x, dtype=plan.centers.dtype, device=dev).reshape(-1)
    slot = torch.as_tensor(slot, device=dev).to(plan.cells.dtype)
    cells, mask, overflowed = plans.cells_add(
        plan.cells.clone(), plan.cell_mask.clone(), plan.centers, plan.radii, x, slot,
        torch.ones((), dtype=torch.bool, device=dev),
    )
    return dataclasses.replace(plan, cells=cells, cell_mask=mask), overflowed


def query_cells(plan: ServingPlan, xq: torch.Tensor) -> torch.Tensor:
    """Flattened (row-major) cell id per query, (Q,) int32 (out-of-domain
    clipped).  The grid's extents are host ints, so nothing is copied to
    the device."""
    rel = (xq - plan.origin[None, :]) * plan.inv_cell[None, :]
    idx = torch.clamp(torch.floor(rel).to(torch.int32), min=0)
    cid = torch.clamp(idx[:, 0], max=plan.grid_shape[0] - 1)
    for j, g in enumerate(plan.grid_shape[1:], start=1):
        cid = cid * g + torch.clamp(idx[:, j], max=g - 1)
    return cid.to(torch.int32)


_ALIASES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
            "f32": torch.float32, "float32": torch.float32,
            "f64": torch.float64, "float64": torch.float64,
            "f16": torch.float16, "float16": torch.float16}


def _norm_compute_dtype(compute_dtype) -> torch.dtype | None:
    """The serving storage dtype: None (native), a name ("bf16", "f32", ...)
    or a floating ``torch.dtype``."""
    if compute_dtype is None:
        return None
    dt = _ALIASES.get(compute_dtype) if isinstance(compute_dtype, str) else compute_dtype
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(
            "compute_dtype must be None or a float dtype (e.g. 'bf16', 'f32'); "
            f"got {compute_dtype!r}"
        )
    return dt


def _wide(dt: torch.dtype) -> torch.dtype:
    """Arithmetic dtype for a storage dtype: itself if >= 4 bytes, else f32."""
    return dt if dt.itemsize >= 4 else torch.float32


def knn_select_valid(
    plan: ServingPlan,
    positions: torch.Tensor,
    xq: torch.Tensor,
    k: int,
    alive: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """((Q, k) selected ids, (Q, k) validity) via the cell plan.

    Picks beyond the live candidates are marked invalid.
    """
    cid = query_cells(plan, xq)
    cand = plan.cells[cid]
    cmask = plan.cell_mask[cid]
    if alive is not None:
        cmask = cmask & alive[cand]
    pos_pad = torch.cat([positions, positions.new_zeros((1, positions.shape[1]))])
    cpos = pos_pad[cand]
    d2 = torch.sum((xq[:, None, :] - cpos) ** 2, dim=-1)
    d2 = torch.where(cmask, d2, float("inf"))
    vals, top = torch.sort(d2, dim=1, stable=True)  # ties: lower column first
    return cand.gather(1, top[:, :k]), torch.isfinite(vals[:, :k])


def knn_select(
    plan: ServingPlan,
    positions: torch.Tensor,
    xq: torch.Tensor,
    k: int,
    alive: torch.Tensor | None = None,
) -> torch.Tensor:
    """(Q, k) ids of each query's k nearest sensors via the cell plan: the
    ids column of ``knn_select_valid``.  Ties break toward the lower sensor
    id; where fewer than k live candidates exist the tail ids are dead or
    padded rows (``knn_select_valid``'s validity marks them)."""
    return knn_select_valid(plan, positions, xq, k, alive)[0]


def _eval_selected(
    kernel, nbr_pos, nbr_mask, coef, sel, valid, xq, k: int,
    compute_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Mean over VALID picks of f_{sel[q,j]}(xq[q]), for every field: (B, Q).

    nbr_pos (B, R, D, d), nbr_mask/coef (B, R, D), sel/valid (Q, k).
    ``compute_dtype`` rounds the anchors before the kernel evaluation;
    the contraction and the average stay in the coefficient dtype.
    """
    b, q = nbr_pos.shape[0], xq.shape[0]
    dm = nbr_pos.shape[-2]
    sel = sel.long()
    npos = nbr_pos[:, sel]  # (B, Q, k, D, d)
    cf = torch.where(nbr_mask[:, sel], coef[:, sel], 0.0)  # (B, Q, k, D)
    if compute_dtype is not None:
        npos = npos.to(compute_dtype).to(_wide(xq.dtype))
    if compute_dtype is not None and kernel.name == "rbf":
        # direct (x - x_j)^2 form, the same arithmetic as the CUDA kernel
        dd = torch.sum((xq[None, :, None, None, :] - npos) ** 2, dim=-1)
        kv = torch.exp(-kernel.gamma * dd)
    else:
        kv = kernel(xq[None, :, None, :], npos.reshape(b, q, k * dm, -1))
        kv = kv.reshape(b, q, k, dm)
    f = torch.sum(kv.to(cf.dtype) * cf, dim=-1)  # (B, Q, k)
    cnt = torch.sum(valid, dim=-1)
    return torch.sum(torch.where(valid, f, 0.0), dim=-1) / torch.clamp(cnt, min=1)


def knn_fuse(
    problem: SNTrainProblem,
    state: SNTrainState,
    xq,
    k: int = 1,
    *,
    plan: ServingPlan | None = None,
    engine: str = "plan",
    ecoef: torch.Tensor | None = None,
    compute_dtype=None,
    prune: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plan-based kNN fusion (paper Eq. 19): (Q,) single-field, (B, Q) batched.

    ``plan`` defaults to ``make_serving_plan(problem, k=k)``; ``ecoef``
    supplies precomputed ``effective_coef``; ``compute_dtype`` sets the
    anchor storage dtype; ``prune`` is an (n+1,) keep mask ANDed into
    liveness.  The selected set depends only on the shared positions, so
    selection runs once for all B fields.
    """
    if engine not in ("plan", "cuda"):
        raise ValueError(f"engine must be 'plan' or 'cuda', got {engine!r}")
    if k < 1 or k > problem.n:
        raise ValueError(f"k must be in [1, n={problem.n}], got {k}")
    with spans.span("serve.knn"):
        if plan is None:
            plan = make_serving_plan(problem, k=k)
        if k > plan.k:
            raise ValueError(
                f"plan guarantees exact kNN only up to k={plan.k}; got k={k} "
                "(rebuild with make_serving_plan(problem, k=...))"
            )
        if engine == "cuda" and problem.kernel.name != "rbf":
            raise NotImplementedError(
                "engine='cuda' fuses the RBF kernel only; use engine='plan' "
                "for other kernels"
            )
        with spans.span("serve.knn.prep"):
            cdt = _norm_compute_dtype(compute_dtype)
            alive = problem.alive
            if prune is not None:
                alive = alive & prune.to(torch.bool)
            dt = problem.nbr_pos.dtype
            xq = torch.as_tensor(xq, dtype=dt, device=problem.device)
            xq = xq[None] if xq.ndim == 1 else xq
            positions = problem.topology.positions.to(dt)
            if ecoef is None:
                ecoef = effective_coef(problem, state)
            if problem.batched:
                nbr_pos, nbr_mask, coef = problem.nbr_pos, problem.nbr_mask, ecoef
            else:
                nbr_pos, nbr_mask, coef = problem.nbr_pos[None], problem.nbr_mask[None], ecoef[None]
            if engine == "cuda":  # the kernel's operands and its sentinel sensor row
                xq, nbr_pos, nbr_mask, coef = (
                    t.contiguous() for t in (xq, nbr_pos, nbr_mask, coef))
                pos_pad = torch.cat([positions, positions.new_zeros((1, xq.shape[1]))])

        if engine == "cuda":
            from ..kernels.knn_fuse import knn_fuse_fused

            with spans.span("serve.knn.cells"):
                qcell = query_cells(plan, xq)
            out = knn_fuse_fused(
                xq, qcell, plan.cells, plan.cell_mask, pos_pad, nbr_pos, nbr_mask, coef,
                alive=alive, gamma=problem.kernel.gamma, k=k, compute_dtype=cdt,
            )
        else:
            sel, valid = knn_select_valid(plan, positions, xq, k, alive)
            out = _eval_selected(
                problem.kernel, nbr_pos, nbr_mask, coef, sel, valid, xq, k,
                compute_dtype=cdt,
            )
    return out if problem.batched else out[0]


# Representer pruning operates on ServingPlans; it lives in core.pruning and
# is re-exported here, as the reference does.
from .pruning import (  # noqa: E402
    PruneReport,
    answer_bound,
    prune_mask,
    prune_plan,
    representer_energy,
)
