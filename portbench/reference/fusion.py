"""The plain reference of field serving (paper Sec. 3.3 'Aggregation').

Every sensor s answers with its local estimate
``f_s(x) = sum_{j in N_s} c_{s,j} exp(-gamma |x - x_j|^2)``; the fusion
center combines them:

  kNN (Eq. 19):  f(x) = mean of f_s(x) over the k sensors nearest x,
                 found here over all n sensors, with no plan;
  conn (Eq. 20): f(x) = sum_s |N_s| f_s(x) / sum_s |N_s|, collapsed to one
                 expansion over the sensor positions (``conn_coefficients``).

Where a query's k-th and (k+1)-th nearest sensors lie within ``tie`` of
each other in squared distance, either may be picked: the answer with the
(k+1)-th in place of the k-th is returned beside the first.
"""

from __future__ import annotations

import torch

from .build import Build, sq_dists
from .precision import Precision

CHUNK = 4096  # queries per block


def knn_answers(b: Build, coef: torch.Tensor, xq: torch.Tensor, k: int, gamma: float,
                prec: Precision, tie: float):
    """((B, Q) answers, (B, Q) the tie alternative, (Q,) bool tie) for
    coefficients ``coef`` (B, n, D) at queries ``xq`` (Q, d)."""
    dev = coef.device
    pos = torch.as_tensor(b.positions, device=dev)
    idx = torch.as_tensor(b.nbr_idx, device=dev)
    mask = torch.as_tensor(b.nbr_mask, device=dev)
    coef = torch.where(mask, coef.to(prec.dtype), 0.0)
    outs, alts, ties = [], [], []
    for q0 in range(0, xq.shape[0], CHUNK):
        x = xq[q0:q0 + CHUNK]
        d2 = sq_dists(x, pos, prec)  # (Q, n)
        vals, picks = torch.topk(d2, k + 1, dim=1, largest=False, sorted=True)
        ties.append(vals[:, k] - vals[:, k - 1] <= tie)
        anchors = pos[idx[picks]]  # (Q, k+1, D, d)
        kv = torch.exp(-gamma * sq_dists(x[:, None, None, :], anchors, prec)[..., 0, :])
        f = prec.einsum("qpj,bqpj->bqp", kv, coef[:, picks])  # (B, Q, k+1)
        head = torch.sum(f[..., : k - 1], dim=-1)
        outs.append((head + f[..., k - 1]) / k)
        alts.append((head + f[..., k]) / k)
    return torch.cat(outs, 1), torch.cat(alts, 1), torch.cat(ties)


def conn_coefficients(b: Build, coef: torch.Tensor, prec: Precision) -> torch.Tensor:
    """(B, n) coefficients of the collapsed conn expansion over the sensor positions."""
    dev = coef.device
    deg = torch.as_tensor(b.degrees, device=dev).to(prec.dtype)
    w = deg / deg.sum()
    mask = torch.as_tensor(b.nbr_mask, device=dev)
    idx = torch.as_tensor(b.nbr_idx, device=dev)[mask]
    contrib = (prec.operand(coef) * prec.operand(w)[None, :, None])[:, mask]
    out = coef.new_zeros((coef.shape[0], b.n), dtype=prec.dtype)
    return out.index_add_(1, idx, contrib)


def conn_answers(b: Build, cglob: torch.Tensor, xq: torch.Tensor, gamma: float,
                 prec: Precision) -> torch.Tensor:
    """(B, Q) values of the conn expansions ``cglob`` (B, n) at ``xq`` (Q, d)."""
    pos = torch.as_tensor(b.positions, device=cglob.device)
    outs = []
    for q0 in range(0, xq.shape[0], CHUNK):
        kv = torch.exp(-gamma * sq_dists(xq[q0:q0 + CHUNK], pos, prec))  # (Q, n)
        outs.append(prec.einsum("qn,bn->bq", kv, cglob))
    return torch.cat(outs, 1)
