"""query_mfu: the RBF-evaluation operations of the traced requests (an exp
counts as one; ``counts``) over their wall time (host clock, each ending
with its answers in host memory) at 67 TFLOP/s float32, in percent."""

from portbench import peaks
from portbench.metrics._requests import traced_work


def read(ctx):
    work = traced_work(ctx)
    if not work:
        return None
    wall = sum(w[0] for w in work)
    return 100.0 * sum(w[2] for w in work) / (wall * peaks.FLOPS["float32"])
