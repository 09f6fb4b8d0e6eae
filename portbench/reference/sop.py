"""The plain reference of the colored SOP sweep (paper Table 1, Eq. 18, Sec. 3.3).

Each sensor s keeps coefficients c_s over its neighbourhood N_s; the
network shares one message per sensor, z.  A projection at s:

    c_s <- (K_s + lambda_s I)^{-1} (z_{N_s} + lambda_s c_s)
    z_j <- (K_s c_s)_j   for j in N_s

The sweep starts from z = y, c = 0 and projects the colours in order, every
sensor of a colour at once (they share no neighbour, so no message is
written twice), for every field of a batch.  The local systems are
inverted once (they are the same for every field and every sweep).
"""

from __future__ import annotations

import torch

from .build import Build, gram_blocks, systems
from .precision import Precision


class Sweeper:
    """The deployment's local systems in one precision, on one device."""

    def __init__(self, b: Build, gamma: float, prec: Precision, device):
        self.b, self.prec, self.device = b, prec, device
        self.gram = gram_blocks(b, gamma, prec, device)
        self.inv = torch.linalg.inv(systems(b, self.gram))
        self.idx = torch.as_tensor(b.nbr_idx, device=device)
        self.mask = torch.as_tensor(b.nbr_mask, device=device)
        self.lam = torch.as_tensor(b.lambdas, device=device).to(prec.dtype)
        self.members = [torch.as_tensor(m, device=device) for m in b.members]

    def sweep(self, ys: torch.Tensor, n_sweeps: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(z (B, n), coef (B, n, D)) after ``n_sweeps`` sweeps from readings ys (B, n)."""
        p = self.prec
        z = ys.to(p.dtype).clone()
        coef = z.new_zeros(z.shape + (self.idx.shape[1],))
        for _ in range(n_sweeps):
            for m in self.members:
                idx, mask = self.idx[m], self.mask[m]
                rhs = torch.where(mask, z[:, idx] + self.lam[m][:, None] * coef[:, m], 0.0)
                c = torch.where(mask, p.einsum("mij,bmj->bmi", self.inv[m], rhs), 0.0)
                coef[:, m] = c
                zn = p.einsum("mij,bmj->bmi", self.gram[m], c)
                z[:, idx[mask]] = zn[:, mask]
        return z, coef
