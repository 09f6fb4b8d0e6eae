"""query_fq_per_s: field-queries answered (points x fields, every request of
the window) over the window's seconds; a request ends when its answers are
in host memory (host clock)."""


def read(ctx):
    if ctx.work["kind"] != "query":
        return None
    return sum(it[3] for it in ctx.window["items"]) / ctx.window["seconds"]
