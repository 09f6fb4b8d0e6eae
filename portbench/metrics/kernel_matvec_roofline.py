"""kernel_matvec_roofline: the least time the traced conn requests' inputs
need (``counts.conn_request`` over the non-zero coefficients these fields
have: the bytes at 3.35 TB/s, the exps at 4.18e12/s on the SFU, the
operations at 67 TFLOP/s, the largest) over the profiled device time of
``kernel_matvec_kernel``, in percent."""

from portbench import peaks, trace
from portbench.metrics._requests import traced_work


def read(ctx):
    if ctx.trace is None or ctx.work["rule"] != "conn":
        return None
    dev_s, launches = trace.kernel_seconds(ctx.trace, "kernel_matvec_kernel")
    work = traced_work(ctx)
    if launches == 0 or dev_s <= 0 or not work:
        return None
    least = sum(peaks.least_seconds(b, f, "float32", e)[0] for _, b, f, e in work)
    return 100.0 * least / dev_s
