"""Device resolution and the port's numeric settings.

The port never picks a device for the caller: entry points take
``device=`` with default ``"cuda"``, and a CUDA request on a machine
without CUDA raises instead of running on the CPU.  Tests pass
``device="cpu"`` explicitly.

float32 contract: the reference's parity tolerances (2e-5 for the kernel
matvec, 1e-5 for the sweep engines) assume IEEE float32 products, so
TF32 is switched off for matrix products and convolutions, once, here.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device`` for ``device`` (CUDA with its index); raises if it is
    CUDA and CUDA is absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but CUDA is not available; "
                "pass device='cpu' to run the plain PyTorch versions"
            )
        if dev.index is None:  # tensors report their card's index
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
