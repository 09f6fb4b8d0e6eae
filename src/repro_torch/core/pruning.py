"""Representer pruning: sparsify the serving path by coefficient energy.

Port of ``repro.core.pruning``.  The serving read-out answers a query by
averaging the k nearest live sensors' local representers
f_s(x) = sum_j c_{s,j} K(x, x_j) (paper Eq. 19).  After training, and more
so after forgetting, evictions and churn, many sensors carry near-zero
effective coefficients while still taking candidate-list columns of the
serving plan.  This module scores sensors by coefficient energy and drops
the dead weight.

Energy and the pointwise bound: per-sensor energy is the masked L1 norm of
the true representer coefficients (``sn_train.effective_coef``), maxed over
fields,

    E_s = max_b sum_j |ecoef[b, s, j]| * nbr_mask[b, s, j].

For kernels with sup K <= 1 (rbf, the serving kernel) |f_s(x)| <= E_s
everywhere, so pruning a sensor behaves exactly like the sensor dying, and
the answer moves by at most ``answer_bound`` of the two selections.

Two pruning paths:

  ``prune_mask``  on the device, no host read: an (n+1,) keep mask ANDed
                  into the ``alive`` gate of the serving engines
                  (``serving.knn_fuse(prune=...)``).  ``energy_tau`` becomes
                  a 0-d tensor in the coefficient dtype, so a daemon
                  re-prunes on every publish, with any tau, and builds
                  nothing.
  ``prune_plan``  host-side compaction: the plan's candidate lists with the
                  pruned and dead sensors removed, survivors left-packed in
                  their original column order, padded with the sentinel
                  ``problem.n`` to ``K_max`` = max(widest surviving cell,
                  ``plan.k``, 1) + ``spare``.  The tables equal the
                  reference's bitwise; the compaction runs as one stable
                  sort on the device instead of the reference's loop over
                  cells.

Churn repairs (``serving.plan_add_sensor``/``plan_remove_sensor``) operate on
the unpruned capacity plan, with the keep mask re-derived on top after every
event: a compacted plan has no spare columns and is serving-frozen.  The
keep mask ANDs in ``alive``, so a removed sensor never comes back through
pruning; only a real re-join does.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .sn_train import SNTrainProblem, SNTrainState, effective_coef


def _lane_energy(nbr_mask: torch.Tensor, ecoef: torch.Tensor) -> torch.Tensor:
    """(n+1, D) per-sensor per-lane |coef|, masked, maxed over fields."""
    e = torch.abs(ecoef) * (nbr_mask != 0).to(ecoef.dtype)
    return torch.amax(e, dim=0) if e.ndim == 3 else e


def _ecoef(problem, state, ecoef, who: str) -> torch.Tensor:
    if ecoef is not None:
        return ecoef
    if state is None:
        raise ValueError(f"{who} needs state or ecoef")
    return effective_coef(problem, state)


def representer_energy(
    problem: SNTrainProblem,
    state: SNTrainState | None = None,
    *,
    ecoef: torch.Tensor | None = None,
    per_lane: bool = False,
) -> torch.Tensor:
    """Per-sensor coefficient energy E_s, (n+1,) (or (n+1, D) per lane).

    E_s is the max over fields of the masked L1 norm of the sensor's
    effective coefficients; for the rbf kernel |f_s(x)| <= E_s everywhere.
    Pass ``ecoef`` when a snapshot already holds ``effective_coef``.
    """
    lane = _lane_energy(problem.nbr_mask, _ecoef(problem, state, ecoef, "representer_energy"))
    return lane if per_lane else lane.sum(dim=-1)


def _keep_mask(nbr_mask, alive, ecoef, tau) -> torch.Tensor:
    e = _lane_energy(nbr_mask, ecoef).sum(dim=-1)
    return (e > tau) & (alive != 0)


def prune_mask(
    problem: SNTrainProblem,
    state: SNTrainState | None = None,
    *,
    energy_tau,
    ecoef: torch.Tensor | None = None,
) -> torch.Tensor:
    """(n+1,) bool keep mask: alive AND energy above ``energy_tau``.

    The device-side fast path, with no host read: AND it into the serving
    ``alive`` gate (``serving.knn_fuse(..., prune=keep)``).  ``energy_tau``
    (a float or a tensor) is cast to a 0-d tensor in the coefficient dtype
    on the coefficients' device, as the reference casts it.  Dead rows and
    the sentinel are never kept.
    """
    ecoef = _ecoef(problem, state, ecoef, "prune_mask")
    tau = torch.as_tensor(energy_tau, dtype=ecoef.dtype, device=ecoef.device)
    return _keep_mask(problem.nbr_mask, problem.alive, ecoef, tau)


class PruneReport(NamedTuple):
    """Host-side summary of a ``prune_plan`` compaction."""

    n_live: int  # live sensors before pruning
    n_kept: int  # live sensors surviving the energy threshold
    n_pruned: int  # n_live - n_kept
    k_max_before: int  # candidate-list width of the input plan
    k_max_after: int  # width of the compacted plan
    energy_tau: float
    keep: np.ndarray  # (n+1,) bool keep mask (host copy)


def prune_plan(
    problem: SNTrainProblem,
    state: SNTrainState | None,
    plan,
    *,
    energy_tau,
    ecoef: torch.Tensor | None = None,
    spare: int = 0,
):
    """Compact ``plan``'s candidate lists to the kept sensors only.

    Drops pruned and dead entries from every cell's row, left-packs the
    survivors in their column order and pads with the sentinel to the new
    ``K_max`` = max(widest surviving cell, ``plan.k``, 1) + ``spare``.
    Returns ``(compacted_plan, PruneReport)``; the compacted plan serves
    exact kNN over the kept sensors, with answers identical to the
    ``prune_mask`` fast path.  Reads the new width and the report's counts
    on the host.
    """
    keep = prune_mask(problem, state, energy_tau=energy_tau, ecoef=ecoef)
    cells, mask = plan.cells, plan.cell_mask.to(torch.bool)
    c, k_max = cells.shape
    sentinel = problem.n  # padded problem row n is never alive
    new_mask = mask & keep[cells.long()]
    counts = new_mask.sum(dim=1)
    k_floor = int(getattr(plan, "k", 1))
    k_new = max(int(counts.max()) if c else 0, k_floor, 1) + int(spare)
    # survivors first, each group in its original column order
    order = torch.sort((~new_mask).to(torch.int8), dim=1, stable=True).indices
    packed = new_mask.gather(1, order)
    width = min(k_new, k_max)
    new_cells = torch.full((c, k_new), sentinel, dtype=cells.dtype, device=cells.device)
    new_cells[:, :width] = torch.where(packed[:, :width], cells.gather(1, order)[:, :width],
                                       new_cells[:, :width])
    new_packed = torch.zeros((c, k_new), dtype=torch.bool, device=cells.device)
    new_packed[:, :width] = packed[:, :width]
    compacted = dataclasses.replace(plan, cells=new_cells, cell_mask=new_packed)

    keep_h = keep.cpu().numpy()
    n_live = int((problem.alive[:sentinel] != 0).sum())
    n_kept = int(keep_h[:sentinel].sum())
    report = PruneReport(
        n_live=n_live,
        n_kept=n_kept,
        n_pruned=n_live - n_kept,
        k_max_before=k_max,
        k_max_after=k_new,
        energy_tau=float(energy_tau),
        keep=keep_h,
    )
    return compacted, report


def answer_bound(
    energy: np.ndarray,
    sel_u: np.ndarray,
    valid_u: np.ndarray,
    sel_p: np.ndarray,
    valid_p: np.ndarray,
) -> np.ndarray:
    """Per-query bound on |unpruned answer - pruned answer|, (Q,).

    Both answers are means of per-sensor predictions over their valid
    selections; with U/P those sets, C = U & P and v_u/v_p their sizes,

        |u - p| <= |1/v_u - 1/v_p| * sum_{s in C} E_s
                   + (1/v_u) * sum_{s in U - C} E_s
                   + (1/v_p) * sum_{s in P - C} E_s

    using |f_s(x)| <= E_s.  An empty selection contributes 0 (the engines
    answer 0 there).  Host-side numpy, the oracle the property tests hold
    serving to; tensors are accepted and copied to the host.
    """
    energy, sel_u, valid_u, sel_p, valid_p = (
        v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        for v in (energy, sel_u, valid_u, sel_p, valid_p)
    )
    valid_u, valid_p = valid_u.astype(bool), valid_p.astype(bool)
    q = sel_u.shape[0]
    out = np.zeros((q,), energy.dtype)
    for i in range(q):
        u = set(sel_u[i, valid_u[i]].tolist())
        p = set(sel_p[i, valid_p[i]].tolist())
        common = u & p
        vu, vp = len(u), len(p)
        inv_u = 1.0 / vu if vu else 0.0
        inv_p = 1.0 / vp if vp else 0.0
        e = lambda s: float(sum(energy[j] for j in s))  # noqa: E731
        out[i] = (
            abs(inv_u - inv_p) * e(common)
            + inv_u * e(u - common)
            + inv_p * e(p - common)
        )
    return out
