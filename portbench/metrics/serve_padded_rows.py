"""serve_padded_rows: the share of the rows the serving kernel evaluates
that are padding, in percent: 100 x padded / (rows + padded), summed over
the traced requests.  The port counts both where it pads a request's Q
points to their power-of-two bucket: on ``repro_torch.kernel.knn_fuse``
(kNN) and ``repro_torch.serve.conn`` (conn); ``_spans.py``."""

from portbench.metrics._spans import SERVE_SPAN, counted, traced_requests


def read(ctx):
    w = ctx.work
    if w["kind"] != "query":
        return None
    reqs = traced_requests(ctx, SERVE_SPAN[w["rule"]])
    if not reqs:
        return None
    rows, padded = counted(reqs, "rows"), counted(reqs, "padded")
    if rows + padded <= 0:
        return None
    return 100.0 * padded / (rows + padded)
