"""device_idle.query: the device's idle share of the traced stretch of
requests (``_idle.py``)."""

from portbench.metrics._idle import idle


def read(ctx):
    return idle(ctx, "query")
