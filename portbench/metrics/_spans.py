"""The port's own spans in the traced stretch, shared by ``serve_host_ms``,
``serve_padded_rows`` and ``color_step_us``.

The port records its spans (``repro_torch.spans``) while the profiler runs,
on ``time.perf_counter_ns()``: the clock of the window's item times.  A
reader keeps the outermost spans that start inside a traced item and finds
nothing (None) unless every traced item holds exactly one, of the name it
expects: so a program without the recorder, the control (the reference in
the program's place) and an incomplete record all read None.
"""

SERVE_SPAN = {"knn": "serve.knn", "conn": "serve.conn"}  # the serve call, by route


def traced_requests(ctx, name: str):
    """[(the item's outermost span, every record under it)] for each traced
    item, in order, or None."""
    try:
        from repro_torch import spans
    except ImportError:
        return None
    items = ctx.window.get("traced") or []
    if not items:
        return None
    recs = spans.records()
    roots = [r for r in recs if r.parent is None]
    under: dict[int, list] = {}
    for r in recs:
        under.setdefault(r.request, []).append(r)
    out = []
    for _, a, z, _ in items:
        lo, hi = a * 1e9, z * 1e9  # perf_counter seconds -> its nanoseconds
        mine = [r for r in roots if lo <= r.start <= hi]
        if len(mine) != 1 or mine[0].name != name:
            return None
        out.append((mine[0], under[mine[0].index]))
    return out


def counted(requests, key: str) -> int:
    """The sum of one count over every record of the requests."""
    return sum(r.counts.get(key, 0) for _, recs in requests for r in recs)
