"""Centralized regularized kernel least squares (paper Sec. 2.2).

Port of ``repro.core.centralized``: the fusion-center baseline

    c = (K + lambda I)^{-1} y      (Eq. 6)
    f(x) = sum_i c_i K(x, x_i)     (Eq. 5)

solved by Cholesky.  ``predict(..., use_kernel=True)`` evaluates an RBF
model through the fused kernel matvec (``repro_torch.kernels.ops``).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import device as _device
from .kernels_math import Kernel


@dataclasses.dataclass(frozen=True)
class KRRModel:
    anchors: torch.Tensor  # (n, d) training inputs
    coef: torch.Tensor  # (n,) representer coefficients
    kernel: Kernel


def fit_krr(
    x, y, kernel: Kernel, lam: float, *, dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cuda",
) -> KRRModel:
    """Train: c = (K + lambda I)^{-1} y on ``device``."""
    dev = _device.resolve(device)
    x = torch.as_tensor(x, dtype=dtype, device=dev)
    x = x[None] if x.ndim == 1 else x
    y = torch.as_tensor(y, dtype=dtype, device=dev)
    k = kernel(x, x)
    chol = torch.linalg.cholesky(k + lam * torch.eye(x.shape[0], dtype=dtype, device=dev))
    coef = torch.cholesky_solve(y[:, None], chol)[:, 0]
    return KRRModel(anchors=x, coef=coef, kernel=kernel)


def predict(model: KRRModel, xq, *, use_kernel: bool = False) -> torch.Tensor:
    """f(x) = sum_i c_i K(x, x_i) for a batch of queries (Q, d)."""
    xq = torch.as_tensor(xq, dtype=model.anchors.dtype, device=model.anchors.device)
    xq = xq[None] if xq.ndim == 1 else xq
    if use_kernel and model.kernel.name == "rbf":
        from ..kernels.ops import kernel_matvec

        return kernel_matvec(xq, model.anchors, model.coef, gamma=model.kernel.gamma)
    return model.kernel(xq, model.anchors) @ model.coef


def mse(model: KRRModel, xq, yq, **kw) -> torch.Tensor:
    """Mean squared error of ``predict(model, xq, **kw)`` against ``yq``."""
    pred = predict(model, xq, **kw)
    yq = torch.as_tensor(yq, dtype=pred.dtype, device=pred.device)
    return torch.mean((pred - yq) ** 2)
