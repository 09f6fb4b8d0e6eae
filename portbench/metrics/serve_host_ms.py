"""serve_host_ms: the mean duration of the port's serve call per traced
request, in ms: its ``repro_torch.serve.knn`` span (all of
``core/serving.knn_fuse``) in the kNN cell, ``repro_torch.serve.conn`` (all
of ``kernels/ops.kernel_matvec``) in the conn cell; host clock, profiler on
(``_spans.py``)."""

from portbench.metrics._spans import SERVE_SPAN, traced_requests


def read(ctx):
    w = ctx.work
    if w["kind"] != "query":
        return None
    reqs = traced_requests(ctx, SERVE_SPAN[w["rule"]])
    if not reqs:
        return None
    return sum(root.end - root.start for root, _ in reqs) * 1e-6 / len(reqs)
