"""PyTorch/CUDA port of ``repro``: distributed kernel regression by
alternating projections (SN-Train) on one NVIDIA H100.

The JAX package ``repro`` is the reference; module names here mirror it
(``repro_torch.core.sn_train``, ``repro_torch.kernels.color_step``, ...).
Every entry point takes ``device=`` (default ``"cuda"``) and raises when
that device is missing: nothing here moves to the CPU on its own.  The
kernels that the TPU package wrote in Pallas are hand-written CUDA C++
under ``kernels/csrc/``, built with ``nvcc`` at first use.
"""

from . import device  # noqa: F401  (applies the float32 precision settings)
