"""Fused RBF kernel matvec (kernel: ``csrc/kernel_matvec.cu``).

Replaces the TPU kernels ``src/repro/kernels/kernel_matvec.py``
(``_batched_kernel`` for B fields, ``_kernel`` for one):

    out[b, q] = sum_j coef[b, j] exp(-gamma |xq_q - a_{b,j}|^2)

in float32 always (the reference's contract), with the expanded square
clamped at 0 and no (Q, N) matrix in memory.  Bound on the H100: the
float32 exp over the (query, non-zero anchor) pairs.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0

_SIG = {
    "kernel_matvec_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
    + [ctypes.c_longlong, ctypes.c_double, ctypes.c_void_p],
}
MAX_DIM = 8


def kernel_matvec_ref(xq, anchors, coef, gamma: float) -> torch.Tensor:
    """Plain PyTorch version: anchors (N, d) or (B, N, d), coef (B, N) -> (B, Q)."""
    xq, anchors, coef = (t.to(torch.float32) for t in (xq, anchors, coef))
    sq_q = torch.sum(xq * xq, dim=-1)[:, None]
    sq_a = torch.sum(anchors * anchors, dim=-1)[..., None, :]
    cross = xq @ anchors.transpose(-1, -2)
    d2 = torch.clamp(sq_q + sq_a - 2.0 * cross, min=0.0)
    return (torch.exp(-gamma * d2) @ coef[..., None])[..., 0]


def kernel_matvec_batched(
    xq: torch.Tensor, anchors: torch.Tensor, coef: torch.Tensor, *, gamma: float
) -> torch.Tensor:
    """(B, Q) float32 evaluation of B expansions on one query grid.

    xq (Q, d); anchors (N, d) shared or (B, N, d) per field; coef (B, N);
    all float32.  CPU tensors run the plain version.
    """
    global launches
    if xq.device.type == "cpu":
        return kernel_matvec_ref(xq, anchors, coef, gamma)
    req = _build.require
    dev = xq.device
    req(dev.type == "cuda", f"kernel_matvec runs on cpu or cuda, got {dev}")
    req(xq.ndim == 2 and coef.ndim == 2, "xq must be (Q, d) and coef (B, N)")
    q, d = xq.shape
    b, n = coef.shape
    req(1 <= d <= MAX_DIM, f"kernel_matvec takes 1 <= d <= {MAX_DIM}, got {d}")
    if anchors.ndim == 2:
        req(tuple(anchors.shape) == (n, d), "shared anchors must be (N, d)")
        bstride = 0
    else:
        req(tuple(anchors.shape) == (b, n, d), "anchors must be (B, N, d)")
        bstride = n * d
    for key, t in dict(xq=xq, anchors=anchors, coef=coef).items():
        req(t.dtype == torch.float32, f"{key} must be float32, got {t.dtype}")
    _build.require_cuda_inputs(dev, dict(xq=xq, anchors=anchors, coef=coef))
    out = torch.empty((b, q), dtype=torch.float32, device=dev)
    lib = _build.library("kernel_matvec", _SIG)
    p = _build.ptr
    err = lib.kernel_matvec_launch(
        p(xq), p(anchors), p(coef), p(out), q, n, d, b, bstride, float(gamma),
        _build.stream(dev),
    )
    _build.check(err, lib, "kernel_matvec")
    launches += 1
    return out
