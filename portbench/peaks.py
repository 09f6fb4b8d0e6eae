"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit), and the least time work can take on it.

Frozen from ``chip_smoke.py`` (``PEAK_BYTES``, ``PEAK_EXPS``, ``bound``),
except float64: 67 TFLOP/s here, the FP64 tensor-core rate, so that no
float64 implementation can read above its peak (chip_smoke used 34, the
rate outside the tensor cores).  A share states its peak; the run records
the card's power limit beside it (``run.py``).
"""

from __future__ import annotations

BYTES_PER_S = 3.35e12  # HBM3
FLOPS = {"float32": 67e12, "float64": 67e12, "tf32": 495e12}
# exp2 results per second on the special-function units: 16 per SM per clock
# at compute capability 9.0 x 132 SMs x the 1.98 GHz boost clock
EXPS_PER_S = 16 * 132 * 1.98e9


def least_seconds(nbytes: float, flops: float, dtype: str, exps: float = 0.0) -> tuple[float, str]:
    """(seconds, "bytes" | "operations" | "exp"): the largest of the floors
    the bytes, the operations and the exps set."""
    floors = {"bytes": nbytes / BYTES_PER_S, "operations": flops / FLOPS[dtype],
              "exp": exps / EXPS_PER_S}
    by = max(floors, key=floors.get)
    return floors[by], by
