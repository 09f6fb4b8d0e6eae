"""The traced stretch of a ``--trace 1`` run: ``torch.profiler`` over a
steady run of items inside the window, and what the readers take from it.

Spans are the benchmark's own, recorded around each call into a layer
(``record_function``, so the profiler sees them beside the kernels).  From
the trace come the device's activity (kernels, copies and sets on the
card), its union (``busy_s``) over the traced window (``window_s``), the
device time of each kernel by name, and the idle gaps, each named after the
innermost host event that was running in its middle.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

STRETCH = "portbench.stretch"
TOP = 10


class Tracer:
    """Starts and stops the profiler around the stretch; ``span`` names a
    call into a layer while it runs (and costs nothing outside it)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None
        self.rf = None
        self.result = None

    @property
    def active(self) -> bool:
        return self.prof is not None

    def span(self, name: str):
        return record_function(name) if self.prof is not None else contextlib.nullcontext()

    def start(self, sync) -> None:
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        sync()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.rf = record_function(STRETCH)
        self.rf.__enter__()

    def stop(self, sync) -> None:
        sync()
        self.rf.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.result = summarise(self.prof)
        self.prof = None


def _union(intervals: list[tuple[float, float]]) -> tuple[float, list[tuple[float, float]]]:
    """(covered length, gaps between the merged intervals)."""
    total, gaps, cur = 0.0, [], None
    for s, e in sorted(intervals):
        if cur is None:
            cur = [s, e]
        elif s > cur[1]:
            total += cur[1] - cur[0]
            gaps.append((cur[1], s))
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        total += cur[1] - cur[0]
    return total, gaps


def summarise(prof) -> dict:
    """The stretch's window, device activity and idle gaps (seconds)."""
    events = prof.events()
    win = [e for e in events if e.name == STRETCH and e.device_type == DeviceType.CPU]
    w0, w1 = win[0].time_range.start, win[0].time_range.end  # microseconds
    device, host = [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith("portbench.") and t > s:
                device.append((e.name, max(s, w0), min(t, w1)))
        elif e.name != STRETCH:
            host.append((e.name, s, t))
    device = [d for d in device if d[2] > d[1]]
    busy, gaps = _union([(s, t) for _, s, t in device])
    if device:  # the stretch's ends are idle too where nothing ran
        first, last = min(d[1] for d in device), max(d[2] for d in device)
        gaps = [(w0, first)] + gaps + [(last, w1)]
    else:
        gaps = [(w0, w1)]
    by_kernel: dict[str, list] = {}
    for name, s, t in device:
        slot = by_kernel.setdefault(name, [0.0, 0])
        slot[0] += (t - s) * 1e-6
        slot[1] += 1
    idle: dict[str, float] = {}
    for s, t in gaps:
        if t <= s:
            continue
        mid = 0.5 * (s + t)
        around = [h for h in host if h[1] <= mid <= h[2]]
        name = min(around, key=lambda h: h[2] - h[1])[0] if around else "host: between events"
        idle[name] = idle.get(name, 0.0) + (t - s) * 1e-6
    return dict(
        window_s=(w1 - w0) * 1e-6,
        busy_s=busy * 1e-6,
        kernels={k: (v[0], v[1]) for k, v in by_kernel.items()},
        device_ops=_top((k, v[0]) for k, v in by_kernel.items()),
        idle_gaps=_top(idle.items()),
    )


def _top(pairs) -> list:
    """The TOP longest [name, seconds], names cut to 160 characters."""
    return sorted(([k[:160], v] for k, v in pairs), key=lambda kv: -kv[1])[:TOP]


def kernel_seconds(tr: dict, fragment: str) -> tuple[float, int]:
    """(device seconds, launches) of the kernels whose name holds ``fragment``."""
    hits = [v for k, v in tr["kernels"].items() if fragment in k]
    return sum(h[0] for h in hits), sum(h[1] for h in hits)
