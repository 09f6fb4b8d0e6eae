"""query_p95_ms.knn_host: the 95th percentile of the latency of every kNN
request of the window (host clock), as ``query_p95_ms`` reads it.  In the
kNN cell the card idles for most of a request, so the host paces this
tail: it stands there as a per-layer reading of the host's serve path."""

from portbench.metrics.query_p95_ms import read as p95


def read(ctx):
    return p95(ctx) if ctx.work.get("rule") == "knn" else None
