"""Checkpointing of the port's trees: flat .npz + a JSON manifest, the
reference's on-disk layout (``repro.checkpoint``)."""

from .ckpt import (
    latest_step,
    restore,
    restore_train,
    save,
    save_train,
    step_valid,
)

__all__ = [
    "latest_step",
    "restore",
    "restore_train",
    "save",
    "save_train",
    "step_valid",
]
