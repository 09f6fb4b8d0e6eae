"""The paper's own workload: distributed field estimation with SN-Train.

Port of ``repro.configs.sensor_field``.  Not a transformer: this config
describes the sensor-network regression problem (paper Sec. 4).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SensorFieldConfig:
    name: str = "sensor-field"
    case: str = "case2"  # case1 (linear) | case2 (sinusoid)
    n_sensors: int = 50
    radius: float = 0.8
    kappa: float = 0.01  # lambda_i = kappa / |N_i|^2 (paper Sec. 4.1)
    n_sweeps: int = 100  # outer iterations T
    n_test: int = 500
    fusion: str = "nn"  # single | nn | knn | avg | conn


def config() -> SensorFieldConfig:
    return SensorFieldConfig()
