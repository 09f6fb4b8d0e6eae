"""The one general traffic generator: every mix under ``traffic/`` is data
that this module reads.

Everything is drawn from ``--seed``: a deployment's sensor placement from
its configuration's own ``placement_seed`` (a deployment is one network),
and each call's readings and each request's points from a seed of their
own, ``item_seed(seed, stream, i)``, so the reference can draw the same
inputs again after the window.  Readings and points are drawn on the
device with one ``torch.Generator`` reseeded per item.  Request sizes are
a fixed set per mix (the same for every seed), in an order drawn from the
seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

READINGS, POINTS, ORDER, SAMPLE, WARM = 1, 2, 3, 4, 5  # seed streams


def item_seed(seed: int, stream: int, i: int) -> int:
    """A 63-bit seed for item ``i`` of ``stream`` under the run's ``seed``."""
    words = np.random.SeedSequence([seed % 2**64, stream, i]).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def placement(config: dict) -> np.ndarray:
    """(n, d) float32 sensor positions, uniform on the configuration's domain
    (the same draw as ``repro_torch.core.uniform_sensors``)."""
    lo, hi = config["domain"]
    rng = np.random.default_rng(config["placement_seed"])
    return rng.uniform(lo, hi, size=(config["n_sensors"], config["dim"])).astype(np.float32)


def readings(spec: dict, x: torch.Tensor, fields: int, seed: int, stream: int, i: int,
             gen: torch.Generator) -> torch.Tensor:
    """(fields, n) readings of item i: ``amplitude * sin(pi * f * x + phase)``
    plus Gaussian noise of ``sigma``, f and phase uniform per field over
    ``freq`` and ``phase``; ``x`` (n,) is the coordinate along ``axis``, in
    the readings' dtype on the generator's device."""
    gen.manual_seed(item_seed(seed, stream, i))
    dev, dt = x.device, x.dtype
    u = torch.rand((fields, 2), generator=gen, device=dev, dtype=dt)
    (f_lo, f_hi), (p_lo, p_hi) = spec["freq"], spec["phase"]
    freq = f_lo + (f_hi - f_lo) * u[:, :1]
    phase = p_lo + (p_hi - p_lo) * u[:, 1:]
    noise = torch.randn((fields, x.shape[0]), generator=gen, device=dev, dtype=dt)
    signal = torch.sin(math.pi * freq * x[None, :] + phase)
    return spec["amplitude"] * signal + spec["sigma"] * noise


def points(domain, q: int, dim: int, seed: int, i: int, gen: torch.Generator,
           dtype: torch.dtype) -> torch.Tensor:
    """(q, dim) query points of request i, uniform on ``domain``."""
    gen.manual_seed(item_seed(seed, POINTS, i))
    lo, hi = domain
    u = torch.rand((q, dim), generator=gen, device=gen.device, dtype=dtype)
    return lo + (hi - lo) * u


def sizes(spec: dict, seed: int) -> list[int]:
    """The mix's request sizes: ``count`` log-spaced sizes from ``q_min`` to
    ``q_max`` (the same set for every seed), in an order drawn from it."""
    qs = np.unique(np.round(np.geomspace(spec["q_min"], spec["q_max"], spec["count"])))
    order = np.random.default_rng(item_seed(seed, ORDER, 0)).permutation(len(qs))
    return [int(qs[j]) for j in order]


class Reservoir:
    """A uniform sample of ``size`` items of a stream of unknown length,
    drawn from the seed (Algorithm R): the items kept for the check."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng(item_seed(seed, SAMPLE, 0))
        self.kept: list[tuple[int, object]] = []  # (item index, what it produced)
        self.seen = 0

    def wants(self) -> int | None:
        """The slot the next item takes, or None; call once per item, in order."""
        self.seen += 1
        if len(self.kept) < self.size:
            return len(self.kept)
        j = int(self.rng.integers(0, self.seen))
        return j if j < self.size else None

    def put(self, slot: int, i: int, value) -> None:
        if slot == len(self.kept):
            self.kept.append((i, value))
        else:
            self.kept[slot] = (i, value)
