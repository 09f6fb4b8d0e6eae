"""Liveness audit: the runtime counterpart of the reference's
``alive-dead`` / ``alive-scatter`` rules (``repro.analysis.jaxpr_audit``).

The reference proves these by taint through the jaxpr; the port checks
them by running the entry points on the canonical problem:

``alive-dead``
    kill one live row (the entry's ``row``): some output of the entry must
    change.  An entry that accepts the liveness gate and drops it gives the
    same outputs either way.  The liveness table itself is not compared.

``alive-scatter``
    for the sweep entries (the reference's ``SWEEP`` checks): after a call
    with that row dead, the dead row's coefficients and the message slots
    only it owns (``layout.slot_owner``) equal their inputs bitwise; no
    table write reaches a dead row.

The CPU run covers every entry with the plain engines; on the card
``CUDA_ENTRIES`` run with ``engine="cuda"`` through the kernels.
"""

from __future__ import annotations

import dataclasses

import torch

from . import entries as _entries
from .entries import Entry, canonical, row_of
from .report import Finding

CUDA_ENTRIES = ("sweep.colored.cuda", "faults.cuda", "serving.knn.cuda", "serving.knn.quant")


def _leaves(obj, out: list, skip=("alive",)) -> list:
    """Every tensor of an entry's output, in a fixed order, without the
    liveness tables the check itself replaced."""
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            if f.name not in skip:
                _leaves(getattr(obj, f.name), out, skip)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _leaves(v, out, skip)
    elif isinstance(obj, dict):
        for k in sorted(obj):
            _leaves(obj[k], out, skip)
    return out


def _same(a, b) -> bool:
    la, lb = _leaves(a, []), _leaves(b, [])
    return len(la) == len(lb) and all(
        x.shape == y.shape and torch.equal(x, y) for x, y in zip(la, lb))


def audit_entry(entry: Entry, fx) -> list[Finding]:
    """The liveness rules of one entry on one canonical fixture."""
    prob = fx.sprob if entry.single else fx.prob
    state = fx.sstate if entry.single else fx.state
    row = row_of(entry, fx)
    if not bool(prob.alive[row]):
        raise ValueError(f"{entry.name}: the audited row {row} is not alive")
    live = entry.call(fx, None)
    alive = prob.alive.clone()
    alive[row] = False
    dead = entry.call(fx, alive)
    findings = []
    if _same(live, dead):
        findings.append(Finding(
            "alive-dead", entry.name, "",
            f"killing row {row} changes no output: the alive gate is accepted but dropped",
        ))
    if "alive-scatter" in entry.checks:
        owned = (prob.layout.slot_owner == row).nonzero()[:, 0]
        coef_ok = torch.equal(dead.coef[..., row, :], state.coef[..., row, :])
        z_ok = torch.equal(dead.z[..., owned], state.z[..., owned])
        if not (coef_ok and z_ok):
            what = " and ".join(w for w, ok in (("coef", coef_ok), ("messages", z_ok)) if not ok)
            findings.append(Finding(
                "alive-scatter", entry.name, "",
                f"dead row {row}'s {what} changed: a table write bypasses the liveness gate",
            ))
    return findings


def run(device="cuda", entries: list[Entry] | None = None) -> list[Finding]:
    """The liveness rules over the registry: every entry with the plain
    engines on the CPU, ``CUDA_ENTRIES`` on the card."""
    if entries is None:
        entries = [e for e in _entries.registry() if e.call is not None and "alive" in e.checks]
        if torch.device(device).type == "cuda":
            entries = [e for e in entries if e.name in CUDA_ENTRIES]
    fx = canonical(torch.float32, device)
    findings = []
    for entry in entries:
        findings += audit_entry(entry, fx)
    return findings
