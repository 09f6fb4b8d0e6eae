"""How the reference computes: its own precision, or a lower one for the control.

``float64`` is the reference.  The controls are the reference computed in
the nearest precision below the one a configuration states: ``tf32`` for a
float32 configuration (float32 arithmetic whose products take operands
rounded to TF32's 10-bit mantissa, as the tensor cores do), ``float32``
for a float64 one.  The rounding is done here, elementwise, so a control
reads the same on any device.
"""

from __future__ import annotations

import dataclasses

import torch

CONTROL_OF = {"float32": "tf32", "float64": "float32"}


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to the nearest TF32 value (ties to even)."""
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    lsb = torch.bitwise_and(torch.bitwise_right_shift(bits, 13), 1)
    bits = torch.bitwise_and(bits + 0xFFF + lsb, ~0x1FFF)
    return bits.view(torch.float32)


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str  # "float64" | "float32" | "tf32"

    @property
    def dtype(self) -> torch.dtype:
        return torch.float64 if self.name == "float64" else torch.float32

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as an operand of a product in this precision."""
        t = t.to(self.dtype)
        return tf32_round(t) if self.name == "tf32" else t

    def einsum(self, eq: str, *ops: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, *(self.operand(o) for o in ops))


REFERENCE = Precision("float64")


def control(config_dtype: str) -> Precision:
    return Precision(CONTROL_OF[config_dtype])
