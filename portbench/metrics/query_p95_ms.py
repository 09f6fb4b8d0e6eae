"""query_p95_ms: the 95th percentile of the latency of every request of the
window, from the client's send to its answers in host memory (host
clock; one client, closed loop)."""

import statistics


def read(ctx):
    if ctx.work["kind"] != "query":
        return None
    lat = [(it[2] - it[1]) * 1e3 for it in ctx.window["items"]]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100, method="inclusive")[94]
