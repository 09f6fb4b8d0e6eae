"""General-shape wrappers around the kernels: query bucketing and padding."""

from __future__ import annotations

import torch

from .kernel_matvec import kernel_matvec_batched


def bucket_rows(q: int, min_rows: int = 8) -> int:
    """Round a row count up to its power-of-two bucket (min ``min_rows``).

    Serving pads each query grid to its bucket, so the padded shapes take
    O(log Q) distinct values across request sizes; padded rows are exact
    (zeros, sliced off by the callers).
    """
    return 1 << max(q - 1, min_rows - 1).bit_length()


def kernel_matvec(
    xq: torch.Tensor, anchors: torch.Tensor, coef: torch.Tensor, *, gamma: float = 1.0
) -> torch.Tensor:
    """f(xq) = sum_j coef_j exp(-gamma |xq - x_j|^2), float32, any shapes.

    Multi-field: coef (B, N) with anchors (N, d) shared or (B, N, d) per
    field returns (B, Q); a single field's (N,) coef returns (Q,).  Queries
    are padded to their ``bucket_rows`` bucket and sliced back.
    """
    q = xq.shape[0]
    xq = xq.to(torch.float32)
    pad = bucket_rows(q) - q
    if pad:
        xq = torch.cat([xq, xq.new_zeros((pad, xq.shape[1]))])
    anchors = anchors.to(torch.float32).contiguous()
    coef = coef.to(torch.float32)
    single = coef.ndim == 1
    out = kernel_matvec_batched(
        xq.contiguous(), anchors, (coef[None] if single else coef).contiguous(),
        gamma=gamma,
    )
    return out[0, :q] if single else out[:, :q]
