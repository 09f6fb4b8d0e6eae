"""The work the cells' inputs need, counted from shapes and the deployment's
own build (never from the program's tables): what the roofline and MFU
readers divide by time.

``sweep_work`` is frozen from ``chip_smoke.py:color_step_work`` and
``color_sweep_bound`` (real lanes only: a member's g = |N_s| lanes, all of
which send, since every sensor is alive).  ``rbf_term_flops`` is one term
``c exp(-gamma |x - a|^2)``: d subtractions, d products, d - 1 sums, the
scale, the exp (one operation), the product and the sum into the answer.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference.build import Build


def rbf_term_flops(d: int) -> int:
    return 3 * d + 3


def sweep_work(b: Build, fields: int, sweeps: int, itemsize: int) -> tuple[float, float]:
    """(bytes, operations) one training call of ``sweeps`` sweeps needs.

    Bytes, once per call: per (field, sensor) the lower triangle of its
    factor g(g+1)/2, the Gram rows of its g sending lanes g^2 and its mask
    bytes g, z and coef read on its g lanes, coef written on g and z on g;
    per sensor its g slot ids (4 bytes) and their liveness, its id, two
    liveness bytes and lambda.  Operations per (field, sensor) and sweep:
    the two triangular solves 2 g^2, the rhs 2 g, the evaluation 2 g^2.
    """
    g = b.degrees.astype(np.float64)
    e = itemsize
    per_field = (e * (g * (g + 1) / 2 + g * g) + g + e * 4 * g).sum()
    per_sensor = (4 + 1 + 1 + e + 5 * g).sum()
    flops = (4 * g * g + 2 * g).sum()
    return float(fields * per_field + per_sensor), float(fields * sweeps * flops)


def knn_picks(b: Build, xq: torch.Tensor, k: int, chunk: int = 8192) -> tuple[int, int]:
    """(real lanes summed over every query's k nearest sensors, real lanes
    of the distinct sensors picked) for queries ``xq`` (Q, d); float64,
    over all sensors."""
    pos = torch.as_tensor(b.positions, device=xq.device).to(torch.float64)
    deg = torch.as_tensor(b.degrees, device=xq.device)
    lanes, seen = 0, torch.zeros(b.n, dtype=torch.bool, device=xq.device)
    for q0 in range(0, xq.shape[0], chunk):
        x = xq[q0:q0 + chunk].to(torch.float64)
        d2 = torch.sum((x[:, None, :] - pos[None]) ** 2, dim=-1)
        picks = torch.topk(d2, k, dim=1, largest=False).indices
        lanes += int(deg[picks].sum())
        seen[picks.reshape(-1)] = True
    return lanes, int(deg[seen].sum())


def knn_request(b: Build, xq: torch.Tensor, k: int, fields: int, itemsize: int
                ) -> tuple[float, float, float]:
    """(bytes, operations, exps) one kNN request needs: the queries read and
    the answers written, the sensor positions read for the selection, and
    the picked sensors' real lanes (anchor, coefficient and mask byte) for
    every field; the RBF terms of every pick's real lanes for every field."""
    q, d = xq.shape
    lanes, picked_lanes = knn_picks(b, xq, k)
    nbytes = (q * d * itemsize + fields * q * itemsize + b.n * d * itemsize
              + fields * picked_lanes * (d * itemsize + itemsize + 1))
    terms = fields * lanes
    return nbytes, terms * rbf_term_flops(d), terms


def conn_request(q: int, d: int, nonzero: torch.Tensor) -> tuple[float, float, float]:
    """(bytes, operations, exps) one conn request over ``nonzero`` (B,)
    non-zero coefficients per field needs (float32): the queries read and
    the answers written, each field's non-zero anchors and coefficients
    read once, one RBF term per (query, non-zero anchor)."""
    nz = float(nonzero.sum())
    fields = int(nonzero.shape[0])
    terms = q * nz
    return 4.0 * (q * d + fields * q + nz * (d + 1)), terms * rbf_term_flops(d), terms
