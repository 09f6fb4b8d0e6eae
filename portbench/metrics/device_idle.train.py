"""device_idle.train: the device's idle share of the traced stretch of
training calls (``_idle.py``)."""

from portbench.metrics._idle import idle


def read(ctx):
    return idle(ctx, "train")
