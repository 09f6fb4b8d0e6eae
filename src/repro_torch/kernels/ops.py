"""General-shape wrappers around the kernels: query bucketing, padding and
the chunked SSD scan around the intra-chunk kernel."""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from .gram import rbf_gram as _rbf_gram
from .kernel_matvec import kernel_matvec_batched
from .ssd_intra import BLOCK_H, ssd_intra


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


def rbf_gram(x1: torch.Tensor, x2: torch.Tensor, *, gamma: float = 1.0) -> torch.Tensor:
    """(M, N) float32 Gram matrix exp(-gamma |x1_i - x2_j|^2), any shapes.

    The kernel takes ragged M and N itself, so nothing is padded.
    """
    return _rbf_gram(
        x1.to(torch.float32).contiguous(), x2.to(torch.float32).contiguous(), gamma=gamma
    )


def ssd_chunked_with(intra, x, dt, a, bmat, cmat, chunk: int, h0=None):
    """The chunked SSD dual form, its intra-chunk term computed by ``intra``.

    x (B, S, H, P), dt (B, S, H) post-softplus, a (H,) negative, bmat and
    cmat (B, S, N), h0 (B, H, P, N) or None.  Returns (y (B, S, H, P),
    final state (B, H, P, N)), both float32 (float64 for float64 inputs,
    which only the plain ``intra`` takes).  S is padded to a multiple of
    ``chunk`` with zero dt, so the padded steps decay by exp(0) = 1 and add
    0, and the final state stays exact.  ``intra(x, dt, da_cum, bmat, cmat,
    chunk=)`` returns the (B, S, H, P) intra-chunk term; the boundary states,
    the inter-chunk recurrence and ``y_inter`` are plain PyTorch.
    """
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    wd = torch.promote_types(x.dtype, torch.float32)
    x, dt, bmat, cmat = (t.to(wd) for t in (x, dt, bmat, cmat))
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt, bmat, cmat = (F.pad(t, (0, 0, 0, pad)) for t in (dt, bmat, cmat))
    x, dt, bmat, cmat = (t.contiguous() for t in (x, dt, bmat, cmat))
    sp = s + pad
    nc = sp // chunk
    da_cum = torch.cumsum((dt * a).reshape(b, nc, chunk, h), dim=2)  # inclusive
    da_sum = da_cum[:, :, -1, :]  # (b, nc, h)

    y_intra = intra(x, dt, da_cum.reshape(b, sp, h), bmat, cmat, chunk=chunk)

    # chunk boundary states
    xc = x.reshape(b, nc, chunk, h, p)
    bc = bmat.reshape(b, nc, chunk, n)
    cc = cmat.reshape(b, nc, chunk, n)
    w = dt.reshape(b, nc, chunk, h) * torch.exp(da_sum[:, :, None, :] - da_cum)
    states = torch.einsum("bzmn,bzmhp->bzhpn", bc, xc * w[..., None])

    # inter-chunk linear recurrence, emitting the state BEFORE each chunk
    chunk_decay = torch.exp(da_sum)
    carry = x.new_zeros((b, h, p, n)) if h0 is None else h0.to(wd)
    h_prev = []
    for z in range(nc):
        h_prev.append(carry)
        carry = carry * chunk_decay[:, z, :, None, None] + states[:, z]
    y_inter = torch.einsum("bzln,bzhpn->bzlhp", cc, torch.stack(h_prev, 1))
    y_inter = y_inter * torch.exp(da_cum)[..., None]
    y = (y_intra.reshape(b, nc, chunk, h, p) + y_inter).reshape(b, sp, h, p)[:, :s]
    return y, carry


def ssd_chunked_fused(x, dt, a, bmat, cmat, chunk: int, h0=None, *, block_h: int = BLOCK_H):
    """``models.ssm.ssd_chunked`` with its intra-chunk term in the ssd_intra
    kernel (no (cs, cs, H) decay tensor in device memory).

    Returns (y (B, S, H, P) float32, final state (B, H, P, N) float32).
    ``block_h`` heads share one block of the kernel; H is not padded.
    """
    intra = functools.partial(ssd_intra, block_h=block_h)
    return ssd_chunked_with(intra, x, dt, a, bmat, cmat, chunk, h0)
