"""Positive (semi-)definite kernels and Gram-matrix helpers (paper Sec. 2.2).

Port of ``repro.core.kernels_math``: linear (Case 1), Gaussian/RBF
(Case 2), Matern-3/2 and polynomial kernels.  Point sets are ``(..., n, d)``
tensors; leading dimensions batch, so one call builds every sensor's local
Gram block.  ``Kernel.pairs`` evaluates paired points elementwise instead.
"""

from __future__ import annotations

import dataclasses
import math

import torch


def _atleast_2d(x: torch.Tensor) -> torch.Tensor:
    return x[None] if x.ndim == 1 else x


def pairwise_sq_dists(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distances, shape (..., n1, n2), expanded form.

    ``|x1|^2 + |x2|^2 - 2 x1.x2`` clamped at 0, as the reference computes it.
    """
    x1, x2 = _atleast_2d(x1), _atleast_2d(x2)
    sq1 = torch.sum(x1 * x1, dim=-1)[..., :, None]
    sq2 = torch.sum(x2 * x2, dim=-1)[..., None, :]
    cross = x1 @ x2.transpose(-1, -2)
    return torch.clamp(sq1 + sq2 - 2.0 * cross, min=0.0)


def linear_kernel(x1, x2, *, bias: float = 1.0) -> torch.Tensor:
    """K(x, x') = x.x' + bias (the bias carries Case 1's intercept)."""
    x1, x2 = _atleast_2d(x1), _atleast_2d(x2)
    return x1 @ x2.transpose(-1, -2) + bias


def rbf_kernel(x1, x2, *, gamma: float = 1.0) -> torch.Tensor:
    """K(x, x') = exp(-gamma ||x - x'||^2) (paper Example 2)."""
    return torch.exp(-gamma * pairwise_sq_dists(x1, x2))


def matern32_kernel(x1, x2, *, length: float = 1.0) -> torch.Tensor:
    """Matern nu=3/2: (1 + sqrt(3) r / l) exp(-sqrt(3) r / l)."""
    r = torch.sqrt(pairwise_sq_dists(x1, x2) + 1e-12)
    s = math.sqrt(3.0) * r / length
    return (1.0 + s) * torch.exp(-s)


def poly_kernel(x1, x2, *, degree: int = 2, bias: float = 1.0) -> torch.Tensor:
    x1, x2 = _atleast_2d(x1), _atleast_2d(x2)
    return (x1 @ x2.transpose(-1, -2) + bias) ** degree


@dataclasses.dataclass(frozen=True)
class Kernel:
    """A named kernel and its hyperparameters (hashable, like the reference)."""

    name: str = "rbf"
    gamma: float = 1.0  # rbf
    bias: float = 1.0  # linear / poly
    length: float = 1.0  # matern32
    degree: int = 2  # poly

    def __call__(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        if self.name == "rbf":
            return rbf_kernel(x1, x2, gamma=self.gamma)
        if self.name == "linear":
            return linear_kernel(x1, x2, bias=self.bias)
        if self.name == "matern32":
            return matern32_kernel(x1, x2, length=self.length)
        if self.name == "poly":
            return poly_kernel(x1, x2, degree=self.degree, bias=self.bias)
        raise KeyError(self.name)

    def pairs(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        """K(x1[..., :], x2[..., :]) for paired (broadcast) points: (..., d) -> (...).

        The matrix form's formulas, but every product and sum is elementwise
        (no matmul, no reduction kernel), so an entry's bits do not depend on
        the batch shape it is computed in: streaming's wave and its
        one-arrival absorb write the same Gram entries.
        """
        cross = _dot(x1, x2)
        if self.name == "linear":
            return cross + self.bias
        if self.name == "poly":
            return (cross + self.bias) ** self.degree
        d2 = torch.clamp(_dot(x1, x1) + _dot(x2, x2) - 2.0 * cross, min=0.0)
        if self.name == "rbf":
            return torch.exp(-self.gamma * d2)
        if self.name == "matern32":
            s = math.sqrt(3.0) * torch.sqrt(d2 + 1e-12) / self.length
            return (1.0 + s) * torch.exp(-s)
        raise KeyError(self.name)


def _dot(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Paired dot products over the last axis, summed in coordinate order."""
    out = x1[..., 0] * x2[..., 0]
    for i in range(1, x1.shape[-1]):
        out = out + x1[..., i] * x2[..., i]
    return out


def gram_matrix(kernel: Kernel, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    return kernel(x1, x2)
