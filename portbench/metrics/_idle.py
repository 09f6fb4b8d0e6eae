"""The device's idle share of the traced window: 1 - (union of the
device's activity: kernels, copies, sets) / (the traced window), in
percent; shared by ``device_idle.*``."""


def idle(ctx, kind):
    tr = ctx.trace
    if tr is None or ctx.work["kind"] != kind or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
