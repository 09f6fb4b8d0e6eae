"""launches_per_request.knn: the kernels the device ran per traced kNN
request (profiler; copies and sets not counted)."""


def read(ctx):
    tr, reqs = ctx.trace, ctx.window.get("traced") or []
    if tr is None or ctx.work["kind"] != "query" or ctx.work["rule"] != "knn" or not reqs:
        return None
    n = sum(c for name, (_, c) in tr["kernels"].items()
            if not name.startswith(("Memcpy", "Memset")))
    return n / len(reqs) if n else None
