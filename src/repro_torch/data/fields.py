"""The paper's simulated sensor fields (Sec. 4.1).

Port of ``repro.data.fields`` (numpy, host side):

Case 1: eta(x) = 5x + 5,      noise sigma = 7, linear kernel.
Case 2: eta(x) = sin(pi x),   noise sigma = 1, Gaussian kernel.

Sensors are uniform on [-1, 1]; measurements y_i = eta(x_i) + n_i with
i.i.d. zero-mean Gaussian noise.  The generators return float32 numpy
arrays, the same draws as the reference's for the same seed.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from ..core.kernels_math import Kernel


@dataclasses.dataclass(frozen=True)
class FieldCase:
    name: str
    eta: Callable[[np.ndarray], np.ndarray]
    noise_sigma: float
    kernel: Kernel
    # paper Sec. 4.3 sweeps r over these ranges per case
    r_grid: tuple[float, ...]


def case1() -> FieldCase:
    return FieldCase(
        name="case1_linear",
        eta=lambda x: 5.0 * x + 5.0,
        noise_sigma=7.0,
        kernel=Kernel("linear", bias=1.0),
        r_grid=tuple(np.round(np.arange(0.1, 0.601, 0.05), 3).tolist()),
    )


def case2() -> FieldCase:
    return FieldCase(
        name="case2_sin",
        eta=lambda x: np.sin(np.pi * x),
        noise_sigma=1.0,
        kernel=Kernel("rbf", gamma=1.0),
        r_grid=tuple(np.round(np.arange(0.1, 2.101, 0.1), 3).tolist()),
    )


CASES = {"case1": case1, "case2": case2}


def sample_field(
    case: FieldCase,
    n_sensors: int,
    *,
    seed: int = 0,
    n_test: int = 500,
) -> dict[str, np.ndarray]:
    """One random draw of sensor positions, noisy measurements, and test set."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, size=(n_sensors, 1)).astype(np.float32)
    y = (case.eta(x[:, 0]) + case.noise_sigma * rng.normal(size=n_sensors)).astype(
        np.float32
    )
    xt = rng.uniform(-1.0, 1.0, size=(n_test, 1)).astype(np.float32)
    yt = case.eta(xt[:, 0]).astype(np.float32)  # clean targets: E|f(X)-eta(X)|^2
    return {"x": x, "y": y, "x_test": xt, "y_test": yt}
