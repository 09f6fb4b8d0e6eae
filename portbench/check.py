"""How the program's outputs are held against the reference's.

Every number compared is a worst case: over fields, the largest gap
divided by the reference's largest magnitude in that field, and the worst
field.  A number that is not finite reads as infinity, so it fails every
limit.  Each cell's limits are data: ``limits/<workload>.json``, set from
the readings ``calibrate.py`` gives (see ``PERF.md``).
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import torch


def field_err(prog: torch.Tensor, ref: torch.Tensor, mask: torch.Tensor | None = None,
              gap: torch.Tensor | None = None) -> float:
    """Worst field's max |prog - ref| / max |ref|; fields on axis 0.

    ``mask`` (broadcast to the rest) picks the entries compared; ``gap``
    replaces |prog - ref| where given.  The divisor is at least the
    smallest normal float64, so an all-zero field compares absolutely.
    """
    ref = ref.to(torch.float64)
    if gap is None:
        gap = (prog.to(torch.float64) - ref).abs()
    gap = torch.where(torch.isnan(gap), math.inf, gap)
    if mask is not None:
        mask = torch.broadcast_to(mask, ref.shape)
        gap, ref = torch.where(mask, gap, 0.0), torch.where(mask, ref, 0.0)
    gap = gap.reshape(gap.shape[0], -1).amax(dim=1)
    scale = ref.abs().reshape(ref.shape[0], -1).amax(dim=1).clamp(min=2.2250738585072014e-308)
    out = float((gap / scale).max())
    return out if math.isfinite(out) else math.inf


def worst(*readings: float) -> float:
    return max(readings, default=0.0)


def limits(root: Path, workload: str) -> dict[str, float]:
    """The cell's limits, one per number compared."""
    with open(root / "limits" / f"{workload}.json") as f:
        return {k: float(v) for k, v in json.load(f)["limits"].items()}


def verdict(readings: dict[str, float], lims: dict[str, float]) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}}); a number
    the cell has no limit for, or a limit with no number, fails."""
    names = sorted(set(readings) | set(lims))
    table = {k: {"value": readings.get(k, math.inf), "limit": lims.get(k, -math.inf)}
             for k in names}
    ok = all(v["value"] <= v["limit"] for v in table.values())
    return ok, table
