"""color_step_roofline: the least time a training call's inputs need
(``counts.sweep_work`` at the published peaks: bytes at 3.35 TB/s, the
sweeps' operations at 67 TFLOP/s in float32 and float64) over the profiled
device time of ``color_sweep_kernel`` per call, in percent."""

from portbench import counts, peaks, trace

ITEMSIZE = {"float32": 4, "float64": 8}


def read(ctx):
    w, tr = ctx.work, ctx.trace
    if tr is None or w["kind"] != "train":
        return None
    dev_s, launches = trace.kernel_seconds(tr, "color_sweep_kernel")
    if launches == 0 or dev_s <= 0:
        return None
    nbytes, flops = counts.sweep_work(w["build"], w["fields"], w["sweeps"], ITEMSIZE[w["dtype"]])
    least, _ = peaks.least_seconds(nbytes, flops, w["dtype"])
    return 100.0 * least * launches / dev_s
