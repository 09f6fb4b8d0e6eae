"""Runs one cell once: finds what the cell names, sets up, measures the
window, checks, reads the metrics.

Everything is found by name, so a cell, configuration, traffic mix or
metric is added as new files:

  ``BENCHMARK.json``           the cells (``workloads``) and metrics;
  ``configs/<config>.json``    a deployment;
  ``traffic/<traffic>.json``   a mix, whose ``kind`` names its driver
                               ``kinds/<kind>.py`` (set-up, one item of the
                               window, the check);
  ``limits/<workload>.json``   the limit of each number the check compares;
  ``metrics/<metric>.py``      each metric's reader: ``read(ctx)`` returns
                               its value, or None where it finds nothing.

The window is a closed loop: the next item (a call or a request) starts
when the last has ended, until ``seconds`` have passed.  ``--trace 1``
profiles a stretch of ``trace_items`` items in it (``trace.py``).
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import time
from pathlib import Path

import torch

from . import check, gen
from .reference import build as rbuild
from .reference.precision import Precision
from .trace import Tracer

ROOT = Path(__file__).resolve().parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """A workload and what it names, found under ``root``."""

    root: Path
    bench: dict
    workload: dict
    config: dict
    traffic: dict

    @classmethod
    def find(cls, name: str, root: Path = ROOT, bench: dict | None = None) -> "Cell":
        bench = bench if bench is not None else load_json(root.parent / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
        w = cells[name]
        return cls(root, bench, w, load_json(root / "configs" / f"{w['config']}.json"),
                   load_json(root / "traffic" / f"{w['traffic']}.json"))

    def kind(self):
        k = self.traffic["kind"]
        return importlib.import_module(f"portbench.kinds.{k}") if self.root == ROOT else \
            load_module(self.root / "kinds" / f"{k}.py", f"portbench.kinds.{k}")

    def metrics(self, trace: bool) -> list[dict]:
        """The cell's end-to-end metrics (``trace`` false) or per-layer ones."""
        name = self.workload["name"]
        mine = lambda m: name in m.get("workloads", [name])  # noqa: E731
        e2e = [m for m in self.bench["end_to_end"] if mine(m)]
        if not trace:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.bench["per_layer"]
                if mine(m) and ("workloads" in m or m["moves"] in names)]

    def reader(self, metric: str):
        path = self.root / "metrics" / f"{metric}.py"
        return load_module(path, "portbench_metric_" + metric.replace(".", "_"))


@dataclasses.dataclass
class Ctx:
    """What a cell's driver and the metric readers see."""

    cell: Cell
    seed: int
    device: torch.device
    control: Precision | None  # None: the program; else the reference in its place
    build: rbuild.Build
    window: dict = dataclasses.field(default_factory=dict)
    trace: dict | None = None
    work: dict | None = None

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
             control: Precision | None = None, t0: float | None = None) -> dict:
    """One run: the result's fields, with ``readings`` (each number compared)
    and, last, ``checks`` (each number beside its limit).  ``failed`` counts
    the checked items (calls or requests) with a number past its limit.  ``t0``: when the process
    started, for ``setup_s`` (default: now)."""
    t0 = time.perf_counter() if t0 is None else t0
    cfg = cell.config
    b = rbuild.build(gen.placement(cfg), cfg["radius"], cfg["lambda"])
    ctx = Ctx(cell, seed, device, control, b)
    drv = cell.kind().Cell(ctx)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    drv.setup()

    tracer = Tracer(device)
    want = cell.traffic["trace_items"] if trace else 0
    traced, items = [], []
    t_start = time.perf_counter()
    setup_s = t_start - t0
    i = 0
    while True:
        if want and not tracer.active and tracer.result is None and \
                time.perf_counter() - t_start >= 0.25 * seconds:
            tracer.start(ctx.sync)
        a = time.perf_counter()
        with tracer.span("portbench.item"):
            units = drv.item(i, tracer.span)
        z = time.perf_counter()
        items.append((i, a, z, units))
        if tracer.active:
            traced.append(items[-1])
            if len(traced) == want:
                tracer.stop(ctx.sync)
        i += 1
        if z - t_start >= seconds and (not want or tracer.result is not None):
            break
    t_end = items[-1][2]
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    ctx.window = dict(seconds=t_end - t_start, items=items, setup_s=setup_s,
                      traced=traced)
    ctx.trace = tracer.result
    readings = drv.check()
    ctx.work = drv.work()
    lims = check.limits(cell.root, cell.workload["name"])
    ok, table = check.verdict(readings, lims)
    failed = sum(1 for r in getattr(drv, "item_readings", [])
                 if any(v > lims.get(k, float("inf")) for k, v in r.items()))

    metrics = {}
    for m in cell.metrics(trace):
        v = cell.reader(m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = dict(platform="gpu" if device.type == "cuda" else device.type,
               kind=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
               count=1, memory_peak_bytes=int(peak))
    out = dict(correct=bool(ok and not failed), attempted=len(items), failed=failed,
               metrics=metrics, device=dev)
    if trace and ctx.trace is not None:
        dev.update(busy_s=ctx.trace["busy_s"], window_s=ctx.trace["window_s"])
        out["breakdown"] = dict(device_ops=ctx.trace["device_ops"],
                                idle_gaps=ctx.trace["idle_gaps"])
    out["readings"] = readings
    out["checks"] = {k: {"value": _num(v["value"]), "limit": _num(v["limit"])}
                     for k, v in table.items()}
    return out


def _num(x: float):
    """A JSON number; a reading that is not finite prints as null."""
    return x if x == x and abs(x) != float("inf") else None
