"""Generic successive-orthogonal-projection (SOP) machinery (paper Sec. 2.1).

Port of ``repro.core.sop``.  Given closed convex sets C_1..C_m with
projections P_i, SOP iterates

    x_0 = x_hat,   x_k = P_{C_{k mod m + 1}}(x_{k-1})            (paper Eq. 1)

Lemma 2.1 (Fejer monotonicity): ||x_k - x|| <= ||x_{k-1} - x|| for any
x in C = intersection; for subspaces, x_k -> P_C(x_hat).

Plain functions on tensors; the reference's ``lax.scan`` loops are Python
loops here.  The specialized, padded sensor instantiation lives in
``sn_train.py``.
"""

from __future__ import annotations

import torch


def project_affine(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Orthogonal projection of x onto {v : A v = b}:
    P(x) = x - A^T (A A^T + 1e-10 I)^{-1} (A x - b)."""
    m = a.shape[0]
    gram = a @ a.T + 1e-10 * torch.eye(m, dtype=x.dtype, device=x.device)
    resid = a @ x - b
    return x - a.T @ torch.linalg.solve(gram, resid)


def sop_sweep(
    x0: torch.Tensor, a_stack: torch.Tensor, b_stack: torch.Tensor, n_sweeps: int = 1
) -> torch.Tensor:
    """``n_sweeps`` full passes of SOP over m affine sets, in order.

    a_stack: (m, k, dim), b_stack: (m, k).  Serial by definition (Eq. 1).
    """
    return sop_sweep_with_trace(x0, a_stack, b_stack, n_sweeps)[0]


def sop_sweep_with_trace(
    x0: torch.Tensor, a_stack: torch.Tensor, b_stack: torch.Tensor, n_sweeps: int = 1
) -> tuple[torch.Tensor, torch.Tensor]:
    """Like ``sop_sweep``, and every post-projection iterate: the trace is
    (n_sweeps * m, dim), used to verify Lemma 2.1 pointwise."""
    x, trace = x0, []
    for _ in range(n_sweeps):
        for a, b in zip(a_stack, b_stack):
            x = project_affine(x, a, b)
            trace.append(x)
    return x, torch.stack(trace)


def project_intersection(
    x0: torch.Tensor, a_stack: torch.Tensor, b_stack: torch.Tensor
) -> torch.Tensor:
    """Direct projection onto the intersection of all affine sets (oracle);
    the least-norm correction of the pseudo-inverse handles the rank
    deficiency that overlapping sets give."""
    a = a_stack.reshape(-1, a_stack.shape[-1])
    b = b_stack.reshape(-1)
    return x0 - torch.linalg.pinv(a) @ (a @ x0 - b)


def fejer_distances(trace: torch.Tensor, feasible_point: torch.Tensor) -> torch.Tensor:
    """||x_k - x*|| for every iterate in the trace (must be non-increasing)."""
    return torch.linalg.norm(trace - feasible_point[None, :], dim=-1)
