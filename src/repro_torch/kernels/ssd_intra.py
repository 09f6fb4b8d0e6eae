"""Mamba2 SSD intra-chunk term (kernel: ``csrc/ssd_intra.cu``).

Replaces the TPU kernel ``src/repro/kernels/ssd_intra.py`` (``_kernel``,
launched by ``ssd_intra_pallas``).  For each (batch, chunk, head), in
float32:

    CB = C B^T                                     (cs, cs), shared by all heads
    M  = CB * tril(exp(da_cum[l] - da_cum[m]))     masked before the exp
    Y  = M (dt x)

so the (cs, cs, H) decay tensor of the plain version never reaches device
memory.  Both products run on the H100's tensor cores in 3xTF32 (float32
accuracy from three TF32 products per term); bound on the H100: the bytes
of its inputs and output (see the kernel source).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0

_SIG = {
    "ssd_intra_launch": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
}
MAX_HEAD_DIM = 64  # P: the kernel's register tile covers 64 columns
MAX_CHUNK = 512  # cs: the CB tiles of one chunk row live in shared memory
BLOCK_H = 4  # heads per block; two blocks of a cluster share one chunk's CB tiles


def ssd_intra_ref(x, dt, da_cum, bmat, cmat, chunk: int) -> torch.Tensor:
    """Plain PyTorch version: (B, S, H, P) float32 (float64 for float64
    inputs), S % chunk == 0.

    The contraction runs pairwise: ``M = cb[..., None] * decay`` (b, z, l,
    m, h), then ``(M * dt) (x)`` as one batched product over m, so no (l,
    m, h, p) intermediate forms.
    """
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    nc = s // chunk
    wd = torch.promote_types(x.dtype, torch.float32)
    xc = x.to(wd).reshape(b, nc, chunk, h, p)
    dtc = dt.to(wd).reshape(b, nc, chunk, h)
    dac = da_cum.to(wd).reshape(b, nc, chunk, h)
    bc = bmat.to(wd).reshape(b, nc, chunk, n)
    cc = cmat.to(wd).reshape(b, nc, chunk, n)
    diff = dac[:, :, :, None, :] - dac[:, :, None, :, :]  # (b, z, l, m, h)
    tril = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    # mask BEFORE exp: upper-triangle differences are positive and overflow
    decay = torch.exp(diff.masked_fill(~tril[:, :, None], float("-inf")))
    cb = torch.einsum("bzln,bzmn->bzlm", cc, bc)
    m = cb[..., None] * decay * dtc[:, :, None, :, :]  # (b, z, l, m, h)
    y = torch.einsum("bzlmh,bzmhp->bzlhp", m, xc)
    return y.reshape(b, s, h, p)


def ssd_intra(
    x: torch.Tensor,
    dt: torch.Tensor,
    da_cum: torch.Tensor,
    bmat: torch.Tensor,
    cmat: torch.Tensor,
    *,
    chunk: int,
    block_h: int = BLOCK_H,
) -> torch.Tensor:
    """Intra-chunk SSD term, (B, S, H, P) float32.

    x (B, S, H, P); dt and da_cum (B, S, H), da_cum the inclusive cumsum of
    dt * a within each chunk; bmat, cmat (B, S, N); all float32, S % chunk
    == 0; any 1 <= chunk <= 512, 1 <= P <= 64, N and H.  ``block_h`` heads
    share one block; two blocks of a cluster (2 ``block_h`` heads) share one
    set of CB tiles, so CB is formed ceil(H / block_h) / 2 times per chunk.
    H need not be a multiple of it.  CPU tensors run the plain version.

    The kernel has no backward (nor has the reference's): an input that
    requires grad raises on every device, so a train step cannot get
    gradients through the plain version on the CPU and none on the card.
    """
    global launches
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, da_cum, bmat, cmat)):
        raise RuntimeError(
            "ssd_intra has no backward: train with ssd_fused=False (the plain "
            "ssd_chunked), as the reference's training launcher does"
        )
    if x.device.type == "cpu":
        return ssd_intra_ref(x, dt, da_cum, bmat, cmat, chunk)
    req = _build.require
    dev = x.device
    req(dev.type == "cuda", f"ssd_intra runs on cpu or cuda, got {dev}")
    req(x.ndim == 4, "x must be (B, S, H, P)")
    b, s, h, p = x.shape
    req(bmat.ndim == 3 and bmat.shape[:2] == (b, s), "bmat must be (B, S, N)")
    n = bmat.shape[-1]
    req(tuple(cmat.shape) == (b, s, n), "cmat must be (B, S, N)")
    req(tuple(dt.shape) == (b, s, h) and tuple(da_cum.shape) == (b, s, h),
        "dt and da_cum must be (B, S, H)")
    req(1 <= chunk <= MAX_CHUNK and s % chunk == 0,
        f"ssd_intra takes 1 <= chunk <= {MAX_CHUNK} dividing S, got chunk={chunk}, S={s}")
    req(1 <= p <= MAX_HEAD_DIM, f"ssd_intra takes 1 <= P <= {MAX_HEAD_DIM}, got {p}")
    req(block_h >= 1, f"block_h must be >= 1, got {block_h}")
    named = dict(x=x, dt=dt, da_cum=da_cum, bmat=bmat, cmat=cmat)
    for key, t in named.items():
        req(t.dtype == torch.float32, f"{key} must be float32, got {t.dtype}")
    _build.require_cuda_inputs(dev, named)
    out = torch.empty((b, s, h, p), dtype=torch.float32, device=dev)
    lib = _build.library("ssd_intra", _SIG)
    ptr = _build.ptr
    err = lib.ssd_intra_launch(
        ptr(x), ptr(dt), ptr(da_cum), ptr(bmat), ptr(cmat), ptr(out),
        b, s, h, p, n, chunk, block_h, _build.stream(dev),
    )
    _build.check(err, lib, "ssd_intra")
    launches += 1
    return out
