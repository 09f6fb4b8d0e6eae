"""kNN-fusion serving kernel (kernel: ``csrc/knn_fuse.cu``).

Replaces the TPU kernel ``src/repro/kernels/knn_fuse.py``
(``_knn_fuse_kernel``).  Per query: take the candidate row of its grid
cell from the static serving plan, select the k nearest valid candidates
(plan mask AND ``alive``, ties to the lower column), evaluate each pick's
local RBF expansion ``sum_j coef_j exp(-gamma |x - x_j|^2)`` over its D
anchors under ``nbr_mask`` for every field, and average over the valid
picks (0 if none).

Precision: anchors (``nbr_pos``) may be stored narrower (bf16) and are
widened before any arithmetic; queries, sensor positions and the selection
keep full precision; evaluation runs in the query dtype and the output is
in the coefficient dtype (which equals the query dtype here).

Bound on the H100: bytes (the picked sensors' anchor rows).  The kernel
runs one warp per query: the selection once per query (not once per field
as on the TPU), as warp-wide arg-mins, then the evaluation spread over the
lanes.
"""

from __future__ import annotations

import ctypes

import torch

from .. import spans
from . import _build
from .ops import bucket_rows

launches = 0

_SIG = {
    "knn_fuse_launch": [ctypes.c_int] * 2 + [ctypes.c_void_p] * 11
    + [ctypes.c_int] * 9 + [ctypes.c_double, ctypes.c_void_p],
}
_DTYPES = {torch.float32: 0, torch.float64: 1}
_ANCHOR_DTYPES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}


def default_block_q() -> int:
    """Queries per thread block of the CUDA kernel: one warp per query.

    On the TPU the tile was sized by VMEM and doubled for bf16 anchors.  On
    the H100 a query's selection and evaluation are one warp's work (its
    candidates and picks sit in shared memory), so the block is sized for
    parallelism: 8 warps, so Q = 4096 gives 512 blocks, about 4 per SM of
    the 132, and the whole grid is one wave.  It does not depend on the
    anchor storage dtype.
    """
    return 8


def knn_fuse_ref(
    xq, qcell, cells, cell_mask, alive, spos, nbr_pos, nbr_mask, coef,
    *, gamma: float, k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ((B, Q) output, (Q, k) int32 picks, -1 past the valid ones)."""
    ar = xq.dtype
    cand = cells[qcell]  # (Q, K)
    valid = cell_mask[qcell] & alive[cand]
    cpos = spos[cand].to(ar)
    d2 = torch.sum((xq[:, None, :] - cpos) ** 2, dim=-1)
    inf = torch.tensor(float("inf"), dtype=ar, device=xq.device)
    d2 = torch.where(valid, d2, inf)
    npos = nbr_pos.to(ar)
    b, q = coef.shape[0], xq.shape[0]
    acc = torch.zeros((b, q), dtype=coef.dtype, device=xq.device)
    cnt = torch.zeros((q,), dtype=torch.int32, device=xq.device)
    cols = torch.arange(cand.shape[1], device=xq.device)
    picks = []
    for _ in range(k):  # argmin / disable / repeat; argmin takes the first min
        best = torch.argmin(d2, dim=1)
        ok = torch.isfinite(d2.gather(1, best[:, None])[:, 0])
        sel = cand.gather(1, best[:, None])[:, 0].long()
        d2 = torch.where(cols[None, :] == best[:, None], inf, d2)
        cf = torch.where(nbr_mask[:, sel], coef[:, sel], 0.0)  # (B, Q, D)
        dd = torch.sum((xq[None, :, None, :] - npos[:, sel]) ** 2, dim=-1)
        f = torch.sum(torch.exp(-gamma * dd).to(coef.dtype) * cf, dim=-1)
        acc = acc + torch.where(ok[None, :], f, 0.0)
        cnt = cnt + ok.to(torch.int32)
        picks.append(torch.where(ok, sel, -1).to(torch.int32))
    out = acc / torch.clamp(cnt, min=1).to(coef.dtype)
    return out, torch.stack(picks, dim=1)


def knn_fuse_fused(
    xq: torch.Tensor,
    qcell: torch.Tensor,
    cells: torch.Tensor,
    cell_mask: torch.Tensor,
    spos: torch.Tensor,
    nbr_pos: torch.Tensor,
    nbr_mask: torch.Tensor,
    coef: torch.Tensor,
    *,
    alive: torch.Tensor | None = None,
    gamma: float = 1.0,
    k: int = 1,
    compute_dtype: torch.dtype | None = None,
    with_selection: bool = False,
):
    """General-shape wrapper: pad the query axis, launch, slice back.

    xq (Q, d) float32/float64; qcell (Q,) int32 flattened cell ids; cells
    (C, K) int32; cell_mask (C, K) bool; spos (R, d) sensor positions with
    a sentinel row, in the query dtype; nbr_pos (B, R, D, d); nbr_mask
    (B, R, D) bool; coef (B, R, D) in the query dtype; alive (R,) bool
    (None: all alive).  ``compute_dtype`` stores the anchor table in that
    dtype (e.g. bf16).  Queries are padded to their power-of-two bucket
    (``bucket_rows``); padded rows point at cell 0 and are sliced off.
    Returns (B, Q), or ((B, Q), (Q, k) picks) with ``with_selection``.
    """
    global launches
    with spans.span("kernel.knn_fuse") as s:
        if compute_dtype is not None:
            nbr_pos = nbr_pos.to(compute_dtype)
        q = xq.shape[0]
        if alive is None:
            alive = torch.ones((nbr_pos.shape[1],), dtype=torch.bool, device=xq.device)
        q_pad = bucket_rows(q)
        s.count(rows=q, padded=q_pad - q)
        if q_pad != q:
            xq = torch.cat([xq, xq.new_zeros((q_pad - q, xq.shape[1]))])
            qcell = torch.cat([qcell, qcell.new_zeros((q_pad - q,))])

        if xq.device.type == "cpu":
            out, sel = knn_fuse_ref(
                xq, qcell, cells, cell_mask, alive, spos, nbr_pos, nbr_mask, coef,
                gamma=gamma, k=k,
            )
        else:
            out, sel = _launch(
                xq, qcell, cells, cell_mask, alive, spos, nbr_pos, nbr_mask, coef,
                gamma, k, with_selection,
            )
            launches += 1
    if with_selection:
        return out[:, :q], sel[:q]
    return out[:, :q]


def _launch(xq, qcell, cells, cell_mask, alive, spos, nbr_pos, nbr_mask, coef,
            gamma: float, k: int, with_selection: bool):
    req = _build.require
    dev = xq.device
    req(dev.type == "cuda", f"knn_fuse runs on cpu or cuda, got {dev}")
    req(xq.ndim == 2 and qcell.shape == (xq.shape[0],), "xq must be (Q, d), qcell (Q,)")
    q, d = xq.shape
    req(cells.ndim == 2 and cell_mask.shape == cells.shape, "cells/cell_mask must be (C, K)")
    c, kmax = cells.shape
    req(nbr_pos.ndim == 4 and nbr_pos.shape[-1] == d, "nbr_pos must be (B, R, D, d)")
    b, r, dm, _ = nbr_pos.shape
    req(nbr_mask.shape == (b, r, dm) and coef.shape == (b, r, dm),
        "nbr_mask and coef must be (B, R, D)")
    req(spos.shape == (r, d) and alive.shape == (r,), "spos must be (R, d), alive (R,)")
    req(1 <= k <= kmax, f"k must be in [1, K_max={kmax}], got {k}")
    req(xq.dtype in _DTYPES, f"knn_fuse takes float32/float64 queries, got {xq.dtype}")
    req(spos.dtype == xq.dtype and coef.dtype == xq.dtype,
        "spos and coef must have the query dtype")
    req(nbr_pos.dtype in _ANCHOR_DTYPES, f"unsupported anchor dtype {nbr_pos.dtype}")
    req(qcell.dtype == torch.int32 and cells.dtype == torch.int32,
        "qcell and cells must be int32")
    req(cell_mask.dtype == torch.bool and alive.dtype == torch.bool
        and nbr_mask.dtype == torch.bool, "cell_mask, alive and nbr_mask must be bool")
    _build.require_cuda_inputs(dev, dict(
        xq=xq, qcell=qcell, cells=cells, cell_mask=cell_mask, alive=alive,
        spos=spos, nbr_pos=nbr_pos, nbr_mask=nbr_mask, coef=coef,
    ))
    out = torch.empty((b, q), dtype=coef.dtype, device=dev)
    sel = torch.empty((q, k), dtype=torch.int32, device=dev) if with_selection else None
    lib = _build.library("knn_fuse", _SIG)
    p = _build.ptr
    err = lib.knn_fuse_launch(
        _DTYPES[xq.dtype], _ANCHOR_DTYPES[nbr_pos.dtype], p(xq), p(qcell),
        p(cells), p(cell_mask), p(alive), p(spos), p(nbr_pos), p(nbr_mask),
        p(coef), p(out), p(sel), q, d, c, kmax, r, b, dm, k, default_block_q(),
        float(gamma), _build.stream(dev),
    )
    _build.check(err, lib, "knn_fuse")
    return out, sel
