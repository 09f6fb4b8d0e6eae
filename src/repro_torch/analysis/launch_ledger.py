"""The kernel launches of each registered entry point: the counterpart of
``repro.analysis.compile_ledger``.

The reference ledger declares each jitted program's compile budget.  The
port compiles no program per shape: its CUDA kernels are built once per
source (``kernels/_build.py``, counted in ``_build.builds``) and every
wrapper counts its launches in its module's ``launches``.  So each entry of
the registry (``entries.registry``) declares how many launches of which
kernel ONE unit of it makes (a call, a sweep, or an SSM layer of a
prefill), and the ledger declares that nothing is built after warm-up.

Consumers take a :func:`snapshot` of the entries they exercise, do their
work, then call :meth:`CacheSnapshot.assert_within` with the units they
ran: every counted kernel must have launched exactly the ledger's count,
and no library may have been built.  :func:`expected` turns units into
the per-kernel counts ``chip_smoke.py`` asserts phase by phase.

The reference's ``const-leak`` / ``grid-recompile`` claim (one program
serves a whole grid of fault rates, tau and beta) becomes
:func:`grid_check` on the card: over such a grid every call launches the
ledger's count and builds nothing (rule ``grid-launch``).  :func:`audit`
is the registry's self-check (rule ``ledger``).
"""

from __future__ import annotations

import dataclasses
import importlib
from collections.abc import Iterable

import torch

from . import entries as _entries
from .report import Finding

# kernel name -> the module that holds its wrapper and ``launches`` counter
KERNELS = {
    "color_step": "repro_torch.kernels.color_step",
    "knn_fuse": "repro_torch.kernels.knn_fuse",
    "kernel_matvec": "repro_torch.kernels.kernel_matvec",
    "ssd_intra": "repro_torch.kernels.ssd_intra",
    "rbf_gram": "repro_torch.kernels.gram",
}
BUILDS = "repro_torch.kernels._build"  # its ``builds`` counts library builds

# a grid value no default argument holds (the reference's sentinel)
MAGIC = 0.6180339887498949


def _resolve_names(names: Iterable[str]) -> tuple[str, ...]:
    names = tuple(names)
    unknown = [n for n in names if n not in _entries.by_name()]
    if unknown:
        raise KeyError(f"not in the launch ledger: {unknown}")
    return names


def expected(units: dict[str, int]) -> dict[str, int]:
    """Launches per kernel (every kernel, zeros included) that ``units[name]``
    units of each named entry make."""
    out = {k: 0 for k in KERNELS}
    ledger = _entries.by_name()
    for name in _resolve_names(units):
        for kernel, per in ledger[name].launches:
            out[kernel] += per * units[name]
    return out


def counters() -> dict[str, int]:
    """The current launch counter of every kernel, and ``builds``."""
    out = {k: importlib.import_module(m).launches for k, m in KERNELS.items()}
    out["builds"] = importlib.import_module(BUILDS).builds
    return out


class CacheSnapshot:
    """Launch and build counters at a warm point, for a set of entries."""

    def __init__(self, names: tuple[str, ...]):
        self.names = names
        ledger = _entries.by_name()
        self.kernels = sorted({k for n in names for k, _ in ledger[n].launches})
        self._base = counters()

    def growth(self) -> dict[str, int]:
        """Launches of each counted kernel, and library builds, since the snapshot."""
        now = counters()
        return {k: now[k] - self._base[k] for k in self.kernels + ["builds"]}

    def assert_within(self, units: dict[str, int] | None = None, context: str = ""):
        """Every counted kernel launched exactly the ledger's count for
        ``units`` (entry -> calls, sweeps or layers run since the snapshot;
        None: nothing ran) and no library was built.  Returns the growth."""
        units = dict(units or {})
        unknown = sorted(set(units) - set(self.names))
        if unknown:
            raise KeyError(f"units for entries outside the snapshot: {unknown}")
        want = expected(units)
        growth = self.growth()
        where = f" ({context})" if context else ""
        for k in self.kernels:
            assert growth[k] == want[k], (
                f"launch budget broken{where}: {k} launched {growth[k]} time(s), "
                f"the ledger says {want[k]} for {units}")
        assert growth["builds"] == 0, (
            f"launch budget broken{where}: {growth['builds']} CUDA library build(s) "
            "after warm-up")
        return growth


def snapshot(names: Iterable[str]) -> CacheSnapshot:
    """Snapshot the counters for the named entries."""
    return CacheSnapshot(_resolve_names(names))


def audit(registry=None) -> list[Finding]:
    """The registry's self-check: every entry's target resolves to a
    callable, its unit is known and it launches positive counts of known
    kernels; every kernel module has an integer ``launches`` counter and
    ``_build`` its ``builds``."""
    registry = _entries.registry() if registry is None else registry
    findings = []
    for entry in registry:
        name = entry.name
        if entry.per not in _entries.UNITS:
            findings.append(Finding("ledger", name, "unit", f"unknown unit {entry.per!r}"))
        try:
            fn = entry.resolve()
        except (ImportError, AttributeError) as exc:
            findings.append(Finding("ledger", name, "resolve", f"{entry.target}: {exc}"))
            continue
        if not callable(fn):
            findings.append(Finding("ledger", name, "interface", f"{entry.target} is not callable"))
        for kernel, per in entry.launches:
            if kernel not in KERNELS or per <= 0:
                findings.append(Finding("ledger", name, "kernel",
                                        f"launches {per} of unknown kernel {kernel!r}"))
    for kernel, mod in KERNELS.items():
        if not isinstance(getattr(importlib.import_module(mod), "launches", None), int):
            findings.append(Finding("ledger", f"kernel:{kernel}", "counter",
                                    f"{mod} has no integer launches counter"))
    if not isinstance(getattr(importlib.import_module(BUILDS), "builds", None), int):
        findings.append(Finding("ledger", "builds", "counter", f"{BUILDS} has no builds counter"))
    return list({f.key: f for f in findings}.values())


def grid_check(fx, n_sweeps: int = 2) -> list[Finding]:
    """On the card: over grids of fault rates, pruning tau and forgetting
    beta, every call launches the ledger's count and builds nothing.

    ``fx`` is a canonical fixture on a CUDA device (``entries.canonical``).
    Each grid is warmed up once; a mismatch is a ``grid-launch`` finding of
    the entry at the grid value."""
    from ..core import faults, pruning, serving, streaming

    gen = torch.Generator(device=fx.device).manual_seed(0)
    findings = []

    def model(rate, crash):
        return faults.make_fault_model(rate, burst=(0.05, 0.5, 0.3), crash=crash,
                                       dtype=fx.dtype, device=fx.device)

    def with_beta(beta):
        b = torch.full_like(fx.prob.beta, beta)
        return dataclasses.replace(fx.prob, beta=b)

    grids = [
        ("faults.cuda", {"faults.cuda": 1}, (0.0, 0.1, MAGIC, 0.9),
         lambda r: faults.faulty_sweep(fx.prob, fx.state, model(r, None), gen, n_sweeps,
                                       engine="cuda")),
        ("faults.crash.cuda", {"faults.crash.cuda": n_sweeps}, (0.0, 0.1, MAGIC, 0.9),
         lambda r: faults.faulty_sweep(fx.prob, fx.state, model(r, (r, 0.5)), gen, n_sweeps,
                                       engine="cuda")),
        ("serving.knn.cuda", {"serving.knn.cuda": 1, "pruning.keep": 1}, (0.0, MAGIC, 0.3),
         lambda t: serving.knn_fuse(
             fx.prob, fx.state, fx.xq, 2, plan=fx.plan, engine="cuda",
             prune=pruning.prune_mask(fx.prob, fx.state, energy_tau=torch.full(
                 (), t, dtype=fx.dtype, device=fx.device)))),
        ("stream.absorb", {"stream.absorb": 1}, (1.0, MAGIC, 0.5),
         lambda b: streaming.absorb(with_beta(b), fx.state, fx.xq.new_zeros((), dtype=torch.long),
                                    fx.xq.new_full((), 3, dtype=torch.long), fx.xq[0], fx.xq[0, 0])),
    ]
    for name, units, grid, call in grids:
        call(grid[0])  # warm-up
        for v in grid:
            snap = snapshot(tuple(units))
            call(v)
            torch.cuda.synchronize(fx.device)
            try:
                snap.assert_within(units, context=f"{name} at {v!r}")
            except AssertionError as exc:
                findings.append(Finding("grid-launch", name, repr(v), str(exc)))
    return findings
