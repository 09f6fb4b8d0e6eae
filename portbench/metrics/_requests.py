"""The traced requests' work, shared by the query readers: for each traced
request, its points drawn again from the seed and the least (bytes,
operations, exps) its route needs (``counts``)."""

from portbench import counts

ITEMSIZE = 4  # the query cells serve float32


def traced_work(ctx):
    """[(wall seconds, bytes, operations, exps)] of the traced requests, or []."""
    w, reqs = ctx.work, ctx.window.get("traced") or []
    if w["kind"] != "query":
        return []
    out = []
    for i, a, z, units in reqs:
        q = units // w["fields"]
        if w["rule"] == "knn":
            xq = w["points"](i, q)
            work = counts.knn_request(w["build"], xq, w["k"], w["fields"], ITEMSIZE)
        else:
            work = counts.conn_request(q, w["dim"], w["nonzero"])
        out.append((z - a,) + tuple(work))
    return out
