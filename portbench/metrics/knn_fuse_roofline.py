"""knn_fuse_roofline: the least time the traced kNN requests' inputs need
in the kernel (``counts.knn_request``: the bytes at 3.35 TB/s, the
operations at 67 TFLOP/s, the exps at 4.18e12/s, the largest) over the
profiled device time of ``knn_fuse_kernel``, in percent."""

from portbench import peaks, trace
from portbench.metrics._requests import traced_work


def read(ctx):
    if ctx.trace is None or ctx.work["rule"] != "knn":
        return None
    dev_s, launches = trace.kernel_seconds(ctx.trace, "knn_fuse_kernel")
    work = traced_work(ctx)
    if launches == 0 or dev_s <= 0 or not work:
        return None
    least = sum(peaks.least_seconds(b, f, "float32", e)[0] for _, b, f, e in work)
    return 100.0 * least / dev_s
