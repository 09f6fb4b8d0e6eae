"""Fused RBF kernel matvec (kernel: ``csrc/kernel_matvec.cu``).

Replaces the TPU kernels ``src/repro/kernels/kernel_matvec.py``
(``_batched_kernel`` for B fields, ``_kernel`` for one):

    out[b, q] = sum_j coef[b, j] exp(-gamma |xq_q - a_{b,j}|^2)

in float32 always (the reference's contract), with the expanded square
clamped at 0 and no (Q, N) matrix in memory.  Bound on the H100: the exps
of the (query, non-zero anchor) pairs, on the SFU.  The kernel skips zero
coefficients and splits each field's non-zero anchors evenly over the CTAs
of a thread-block cluster (``launch_plan``); the sums are deterministic.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import _build

launches = 0

_SIG = {
    "kernel_matvec_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
    + [ctypes.c_longlong, ctypes.c_double] + [ctypes.c_int] * 5
    + [ctypes.c_longlong, ctypes.c_void_p],
}
MAX_DIM = 8
THREADS = 128  # threads per CTA
MAX_CLUSTER = 8  # CTAs per cluster without the non-portable opt-in
MAX_SPAN = 2048  # anchors per CTA per window
TARGET_CTAS = 4 * 132  # four CTAs per SM of the H100


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How ``kernel_matvec_batched`` lays (Q queries, N anchors, B fields) out.

    The grid is (tiles x cluster, B).  The ``cluster`` CTAs of a cluster
    share one tile of THREADS x ``per_thread`` queries and split the field's
    non-zero anchors evenly between them, window by window: a window is
    ``cluster`` x ``span`` consecutive anchors, each CTA compacts the
    non-zero ones of its ``span`` and takes 1/cluster of the window's
    compacted list.  Rows hold ``padded_dim`` coordinates.
    """

    per_thread: int
    tiles: int
    cluster: int
    span: int
    padded_dim: int
    smem_bytes: int


def launch_plan(q: int, b: int, n: int, d: int) -> LaunchPlan:
    """The plan for Q queries against N anchors of d coordinates in B fields.

    It depends on the shapes alone (the kernel balances the non-zero
    anchors itself), so a call never reads its data on the host.  The
    anchor axis is split over ceil(N / THREADS) CTAs, at most MAX_CLUSTER;
    each CTA's span is its even share of N rounded up to THREADS, at most
    MAX_SPAN.  Queries per thread are the most of 4, 2, 1 that still give
    TARGET_CTAS CTAs (1 if none does): more queries per thread reuse each
    anchor read for more exps, more CTAs fill the SMs.
    """
    _build.require(1 <= d <= MAX_DIM, f"kernel_matvec takes 1 <= d <= {MAX_DIM}, got {d}")
    cluster = min(MAX_CLUSTER, max(1, -(-n // THREADS)))
    share = -(-n // cluster)
    span = min(MAX_SPAN, max(1, -(-share // THREADS)) * THREADS)
    per = 1
    for p in (4, 2):
        if -(-q // (THREADS * p)) * b * cluster >= TARGET_CTAS:
            per = p
            break
    padded = 2 if d <= 2 else 4 if d <= 4 else 8
    row = -(-(padded + 2) // 4) * 4  # floats per compacted anchor row
    smem = 4 * (span * (row + 1) + per * THREADS)
    return LaunchPlan(per_thread=per, tiles=max(1, -(-q // (THREADS * per))),
                      cluster=cluster, span=span, padded_dim=padded, smem_bytes=smem)


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
    req(b <= 65535, f"kernel_matvec takes at most 65535 fields, got {b}")
    out = torch.empty((b, q), dtype=torch.float32, device=dev)
    plan = launch_plan(q, b, n, d)
    lib = _build.library("kernel_matvec", _SIG)
    p = _build.ptr
    err = lib.kernel_matvec_launch(
        p(xq), p(anchors), p(coef), p(out), q, n, d, b, bstride, float(gamma),
        plan.per_thread, plan.tiles, plan.cluster, plan.span, plan.padded_dim,
        plan.smem_bytes, _build.stream(dev),
    )
    _build.check(err, lib, "kernel_matvec")
    launches += 1
    return out
