"""The port's spans: named, nested stretches of its own host code with
integer counts, recorded while a ``torch.profiler`` session runs.

``span(name)`` returns a context manager.  While the profiler is off it is
one shared object that does nothing: the whole cost is one check of the
profiler's flag, with no allocation and no clock read.  While it is on, the
span enters ``_RecordFunctionFast("repro_torch." + name)``, a host event on
the profiler's clock that nests the aten ops under it.  That event is not a
user annotation (``record_function``), which the profiler would also put
on the device's timeline as activity.  When the span ends it appends a
``Record`` to an in-memory ring of the newest ``RING`` records.

  with spans.span("kernel.knn_fuse") as s:
      ...
      s.count(rows=q, padded=q_pad - q)

A record holds the name (without the prefix), its start and end on
``time.perf_counter_ns()`` and the counts set on it.  A running span does
no more than that: its ``index`` (its place among the ring's records, in
the order they started), its parent's index (None for an outermost span)
and ``request`` (the index of the outermost span around it) are found from
the nesting of the times when ``records()`` reads the ring.  The ring holds
each record as one flat tuple of numbers and strings, which the garbage
collector stops tracking at its next pass.  ``reset()`` empties the ring;
``self_ns`` gives each record's self time and ``table`` sums the records by
name.  Spans nest within one thread: the port's calls into a layer are
made by one thread at a time.

The module-global ``launches`` counters of the kernel modules count
launches whether or not anything is profiled; the spans do not repeat them.
"""

from __future__ import annotations

import collections
import time

import torch

PREFIX = "repro_torch."
RING = 65536

Record = collections.namedtuple("Record", "name index parent request start end counts")

_enabled = torch.autograd._profiler_enabled
_Fast = torch._C._profiler._RecordFunctionFast
_clock = time.perf_counter_ns
_ring: collections.deque = collections.deque(maxlen=RING)


class _Off:
    """The span while the profiler is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, **counts) -> None:
        pass


OFF = _Off()


class Span:
    """A span while it runs; its record goes to the ring when it ends."""

    __slots__ = ("name", "start", "counts", "_rf")

    def __init__(self, name: str):
        self.name = name
        self.counts = ()  # flat: key, value, key, value, ...
        self._rf = _Fast(PREFIX + name)

    def __enter__(self):
        self._rf.__enter__()
        self.start = _clock()
        return self

    def __exit__(self, *exc):
        _ring.append((self.name, self.start, _clock()) + self.counts)
        self._rf.__exit__(*exc)
        return False

    def count(self, **counts: int) -> None:
        """Set integer counts on the span (``rows=``, ``padded=``, ``steps=``)."""
        for kv in counts.items():
            self.counts += kv


def span(name: str):
    """A span named ``repro_torch.<name>``, or ``OFF`` while the profiler is off."""
    if not _enabled():
        return OFF
    return Span(name)


def records() -> list[Record]:
    """The ring's records, in the order their spans started, with the
    parent and request that their nesting gives."""
    out: list[Record] = []
    around: list[Record] = []  # the records that hold the current one, outermost first
    for index, r in enumerate(sorted(_ring, key=lambda r: (r[1], -r[2]))):
        name, start, end = r[:3]
        while around and around[-1].end < end:
            around.pop()
        parent, request = (around[-1].index, around[-1].request) if around else (None, index)
        rec = Record(name, index, parent, request, start, end, dict(zip(r[3::2], r[4::2])))
        out.append(rec)
        around.append(rec)
    return out


def reset() -> None:
    """Empty the ring."""
    _ring.clear()


def self_ns(recs) -> dict[int, int]:
    """{index: self time in ns}: each record's duration less the part its
    child spans among ``recs`` cover."""
    out = {r.index: r.end - r.start for r in recs}
    for r in recs:
        if r.parent in out:
            out[r.parent] -= r.end - r.start
    return out


def table(recs) -> dict[str, dict]:
    """The records summed by name, in order of first start:
    {name: {"calls", "ms", "self_ms", <each count summed>}}."""
    own = self_ns(recs)
    out: dict[str, dict] = {}
    for r in sorted(recs, key=lambda r: r.index):
        row = out.setdefault(r.name, {"calls": 0, "ms": 0.0, "self_ms": 0.0})
        row["calls"] += 1
        row["ms"] += (r.end - r.start) * 1e-6
        row["self_ms"] += own[r.index] * 1e-6
        for k, v in r.counts.items():
            row[k] = row.get(k, 0) + v
    return out
