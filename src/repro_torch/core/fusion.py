"""Fusion-center aggregation rules (paper Sec. 3.3 'Aggregation').

Port of ``repro.core.fusion``.  After SN-Train every sensor holds a global
estimate ``f_s(x) = sum_{j in N_s} c_{s,j} K(x, x_j)``; the fusion center
combines them:

  * single-sensor:         f(x) = f_s(x)
  * k-nearest-neighbor:    f(x) = mean_{s in kNN(x)} f_s(x)        (Eq. 19)
  * connectivity-averaged: f(x) = sum_s |N_s| f_s(x) / sum_s |N_s| (Eq. 20)

Single-field problems give (Q,), batched problems (B, Q); dtypes follow the
problem.  ``fuse(rule="knn"/"nn", engine=...)``: ``"dense"`` evaluates all
n sensors (the oracle); ``"plan"`` and ``"cuda"`` go through the static
cell plans of ``repro_torch.core.serving``.  ``global_coefficients``
collapses the averaged rules to one kernel expansion per field, which the
conn serving route evaluates with ``kernels.ops.kernel_matvec``.
"""

from __future__ import annotations

import torch

from .sn_train import SNTrainProblem, SNTrainState, effective_coef


def _eval_all(kernel, nbr_pos, nbr_mask, coef, xq) -> torch.Tensor:
    """f_s(xq) for every sensor row s: (..., n+1, Q)."""
    kv = kernel(xq, nbr_pos)  # (..., n+1, Q, D)
    return (kv @ torch.where(nbr_mask, coef, 0.0)[..., None])[..., 0]


def evaluate_sensors(problem: SNTrainProblem, state: SNTrainState, xq) -> torch.Tensor:
    """Per-sensor estimates at the queries: (n, Q), batched (B, n, Q)."""
    xq = torch.as_tensor(xq, dtype=problem.nbr_pos.dtype, device=problem.device)
    xq = xq[None] if xq.ndim == 1 else xq
    preds = _eval_all(
        problem.kernel, problem.nbr_pos, problem.nbr_mask,
        effective_coef(problem, state), xq,
    )
    return preds[..., : problem.n, :]


def single_sensor(preds: torch.Tensor, s: int = 0) -> torch.Tensor:
    return preds[..., s, :]


def knn_fusion(
    preds: torch.Tensor, positions: torch.Tensor, xq, k: int,
    alive: torch.Tensor | None = None,
) -> torch.Tensor:
    """Average the k LIVE sensors nearest each query (the dense O(Q*n) oracle).

    Ties break toward the lower sensor id; with fewer than k live sensors
    only the live picks are averaged.
    """
    xq = torch.as_tensor(xq, dtype=preds.dtype, device=preds.device)
    xq = xq[None] if xq.ndim == 1 else xq
    positions = positions.to(preds.dtype)
    d2 = torch.sum((xq[:, None, :] - positions[None, :, :]) ** 2, dim=-1)  # (Q, n)
    if alive is not None:
        d2 = torch.where(alive[None, :], d2, torch.tensor(float("inf"), dtype=d2.dtype,
                                                          device=d2.device))
    vals, idx = torch.sort(d2, dim=1, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    pt = preds.transpose(-1, -2)  # (..., Q, n)
    gathered = torch.gather(pt, -1, idx.expand(pt.shape[:-2] + idx.shape))
    if alive is None:
        return torch.mean(gathered, dim=-1)
    valid = torch.isfinite(vals)
    return torch.sum(torch.where(valid, gathered, 0.0), dim=-1) / torch.clamp(
        torch.sum(valid, dim=-1), min=1
    )


def nearest_neighbor(preds, positions, xq, alive=None) -> torch.Tensor:
    return knn_fusion(preds, positions, xq, k=1, alive=alive)


def network_average(preds: torch.Tensor, alive: torch.Tensor | None = None) -> torch.Tensor:
    if alive is None:
        return torch.mean(preds, dim=-2)
    w = alive.to(preds.dtype)
    return (w[:, None] * preds).sum(-2) / w.sum()


def connectivity_averaged(
    preds: torch.Tensor, degrees: torch.Tensor, alive: torch.Tensor | None = None
) -> torch.Tensor:
    """Degree-weighted average (paper Eq. 20) over the LIVE sensors."""
    w = degrees.to(preds.dtype)
    if alive is not None:
        w = torch.where(alive, w, 0.0)
    return (w[:, None] * preds).sum(-2) / w.sum()


def global_coefficients(
    problem: SNTrainProblem, state: SNTrainState, rule: str = "conn"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Collapse the per-sensor representers into ONE expansion per field.

    f(x) = sum_a cglob[a] K(x, anchor_a) equals the 'avg' or 'conn' fusion
    exactly; the anchors are the n sensor positions followed by the
    n_stream arrival positions.  Returns (anchors, coefs): (A, d), (A,)
    single-field or (B, A, d), (B, A) batched, A = n + n_stream.
    """
    n, s_cap = problem.n, problem.n_stream
    cdt = state.coef.dtype
    live = problem.alive[:n]
    deg = torch.where(live, problem.topology.degrees, 0).to(cdt)
    if rule == "conn":
        w = deg / deg.sum()
    elif rule == "avg":
        w = live.to(cdt) / live.sum()
    else:
        raise ValueError(f"global_coefficients supports 'avg'/'conn', got {rule!r}")
    w_pad = torch.cat([w, w.new_zeros((1,))])  # sentinel sensor row
    ecoef = effective_coef(problem, state)
    contrib = torch.where(problem.nbr_mask, ecoef, 0.0) * w_pad[:, None]  # (..., n+1, D)
    lead = contrib.shape[:-2]
    ids = problem.nbr_idx.reshape(-1).long()
    cglob = torch.zeros(lead + (n + s_cap + 1,), dtype=cdt, device=problem.device)
    cglob = cglob.index_add_(-1, ids, contrib.reshape(lead + (-1,)))
    positions = problem.topology.positions.to(problem.stream_pos.dtype)
    anchors = torch.cat(
        [positions.expand(lead + tuple(positions.shape)), problem.stream_pos], dim=-2
    )
    return anchors, cglob[..., : n + s_cap]


def fuse(
    problem: SNTrainProblem,
    state: SNTrainState,
    xq,
    rule: str = "nn",
    *,
    k: int = 1,
    sensor: int = 0,
    engine: str = "dense",
    plan=None,
    ecoef: torch.Tensor | None = None,
    compute_dtype=None,
    prune: torch.Tensor | None = None,
) -> torch.Tensor:
    """Dispatcher over the paper's rules; (Q,) single-field, (B, Q) batched.

    engine: for "nn"/"knn", "dense" (the oracle here) or "plan"/"cuda"
    (``serving.knn_fuse``, where ecoef/compute_dtype/prune apply).  The
    other rules accept only "dense".
    """
    if rule in ("nn", "knn") and engine != "dense":
        from . import serving

        return serving.knn_fuse(
            problem, state, xq, k=(1 if rule == "nn" else k), plan=plan,
            engine=engine, ecoef=ecoef, compute_dtype=compute_dtype, prune=prune,
        )
    if ecoef is not None or compute_dtype is not None or prune is not None:
        raise ValueError(
            "ecoef/compute_dtype/prune apply to the plan/cuda kNN engines only; "
            f"rule {rule!r} engine {engine!r} is the full-precision dense oracle"
        )
    if engine != "dense":
        raise ValueError(
            f"engine={engine!r} applies to the kNN rules only; "
            f"rule {rule!r} supports engine='dense'"
        )
    preds = evaluate_sensors(problem, state, xq)
    live = problem.alive[: problem.n]
    positions = problem.topology.positions
    if rule == "single":
        return single_sensor(preds, sensor)
    if rule == "nn":
        return nearest_neighbor(preds, positions, xq, live)
    if rule == "knn":
        return knn_fusion(preds, positions, xq, k, live)
    if rule == "avg":
        return network_average(preds, live)
    if rule == "conn":
        return connectivity_averaged(preds, problem.topology.degrees, live)
    raise ValueError(f"unknown fusion rule {rule!r}")
