"""Tiled RBF Gram matrix (kernel: ``csrc/gram.cu``).

Replaces the TPU kernel ``src/repro/kernels/gram.py`` (``_kernel``,
launched by ``rbf_gram_pallas``):

    K[i, j] = exp(-gamma max(|x1_i|^2 + |x2_j|^2 - 2 x1_i . x2_j, 0))

in float32, the expanded square clamped at 0 as the reference does.  Bound
on the H100: the bytes of the (M, N) output.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0

_SIG = {
    "rbf_gram_launch": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
    + [ctypes.c_double, ctypes.c_void_p],
}
MAX_DIM = 8


def rbf_gram_ref(x1: torch.Tensor, x2: torch.Tensor, gamma: float) -> torch.Tensor:
    """Plain PyTorch version: (M, N) float32."""
    x1, x2 = x1.to(torch.float32), x2.to(torch.float32)
    sq1 = torch.sum(x1 * x1, dim=-1)[:, None]
    sq2 = torch.sum(x2 * x2, dim=-1)[None, :]
    d2 = torch.clamp(sq1 + sq2 - 2.0 * (x1 @ x2.T), min=0.0)
    return torch.exp(-gamma * d2)


def rbf_gram(x1: torch.Tensor, x2: torch.Tensor, *, gamma: float) -> torch.Tensor:
    """(M, N) float32 Gram matrix of x1 (M, d) against x2 (N, d), float32.

    CPU tensors run the plain version.
    """
    global launches
    if x1.device.type == "cpu":
        return rbf_gram_ref(x1, x2, gamma)
    req = _build.require
    dev = x1.device
    req(dev.type == "cuda", f"rbf_gram runs on cpu or cuda, got {dev}")
    req(x1.ndim == 2 and x2.ndim == 2 and x1.shape[1] == x2.shape[1],
        "x1 must be (M, d) and x2 (N, d)")
    m, d = x1.shape
    n = x2.shape[0]
    req(1 <= d <= MAX_DIM, f"rbf_gram takes 1 <= d <= {MAX_DIM}, got {d}")
    for key, t in dict(x1=x1, x2=x2).items():
        req(t.dtype == torch.float32, f"{key} must be float32, got {t.dtype}")
    _build.require_cuda_inputs(dev, dict(x1=x1, x2=x2))
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    lib = _build.library("gram", _SIG)
    err = lib.rbf_gram_launch(
        _build.ptr(x1), _build.ptr(x2), _build.ptr(out), m, n, d, float(gamma),
        _build.stream(dev),
    )
    _build.check(err, lib, "gram")
    launches += 1
    return out
