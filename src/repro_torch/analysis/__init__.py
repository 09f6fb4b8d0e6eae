"""Invariant auditors of the port: the counterpart of ``repro.analysis``
and ``tools/audit.py``.

Five auditors, each a list of :class:`report.Finding` compared with the
shrink-only baseline ``audit_baseline.json`` beside this file:

  ast     ``ast_lint``: ``ast-host-sync`` over the ``SYNC_FREE`` registry,
          ``ast-alive-thread``, ``ast-receipt-json`` (static, no device);
  ledger  ``launch_ledger``: the entry -> kernel-launch registry's
          self-check (``ledger``) and, on the card, the grid check
          (``grid-launch``);
  dtype   ``dtype_audit``: ``dtype-narrow`` / ``weak-promo``;
  alive   ``alive_audit``: ``alive-dead`` / ``alive-scatter``;
  sync    ``sync_audit``: ``host-sync`` under
          ``torch.cuda.set_sync_debug_mode("error")`` (the card only).

Run ``python -m repro_torch.analysis --device cpu --skip sync`` on a
machine without a card; ``chip_smoke.py`` runs the card's part.
"""

from __future__ import annotations

import os
import time

from .report import Finding, compare_with_baseline, load_baseline

BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "audit_baseline.json")
AUDITORS = ("ast", "ledger", "dtype", "alive", "sync")
RULES = {
    "ast": ("ast-host-sync", "ast-alive-thread", "ast-receipt-json"),
    "ledger": ("ledger", "grid-launch"),
    "dtype": ("dtype-narrow", "weak-promo"),
    "alive": ("alive-dead", "alive-scatter"),
    "sync": ("host-sync",),
}


def run_auditor(name: str, device="cuda") -> list[Finding]:
    """One auditor's findings.  ``sync`` and the ledger's grid check need a
    CUDA ``device``; ``sync`` raises on any other."""
    import torch

    from . import alive_audit, ast_lint, dtype_audit, launch_ledger, sync_audit

    if name == "ast":
        return ast_lint.lint_paths()
    if name == "ledger":
        findings = launch_ledger.audit()
        if torch.device(device).type == "cuda":
            from .entries import canonical

            findings += launch_ledger.grid_check(canonical(torch.float32, device))
        return findings
    if name == "dtype":
        return dtype_audit.run(device)
    if name == "alive":
        return alive_audit.run(device)
    if name == "sync":
        return sync_audit.run(device)
    raise ValueError(f"unknown auditor {name!r}; choose from {AUDITORS}")


def scope(name: str, device="cuda") -> tuple[str, ...]:
    """The finding-key prefixes that an auditor's run on ``device`` covers:
    a baseline entry under one of them that no longer fires is stale.  Its
    rules, narrowed to what runs there: the ledger's grid check only with a
    CUDA device; the liveness rules there only for the entries of
    ``alive_audit.CUDA_ENTRIES``."""
    import torch

    from .alive_audit import CUDA_ENTRIES

    cuda = torch.device(device).type == "cuda"
    if name == "ledger" and not cuda:
        return ("ledger",)
    if name == "alive" and cuda:
        return tuple(f"{rule}:{e}" for rule in RULES["alive"] for e in CUDA_ENTRIES)
    return RULES[name]


def run(auditors=AUDITORS, device="cuda", baseline: dict | None = None) -> list[dict]:
    """Each auditor's findings against the baseline: a list of
    {auditor, findings, new, stale, baselined, seconds}.  Staleness counts
    only within the auditor's :func:`scope` on ``device``."""
    baseline = load_baseline(BASELINE) if baseline is None else baseline
    out = []
    for name in auditors:
        t0 = time.perf_counter()
        findings = list({f.key: f for f in run_auditor(name, device)}.values())
        seconds = time.perf_counter() - t0
        new, stale = compare_with_baseline(findings, baseline, scope(name, device))
        out.append(dict(auditor=name, findings=findings, new=new, stale=stale,
                        baselined=len(findings) - len(new), seconds=seconds))
    return out


def summary_line(result: dict) -> str:
    """The ``audit: ...`` line of one auditor's result."""
    return (f"audit: {result['auditor']}: {len(result['findings'])} finding(s), "
            f"{result['baselined']} baselined, {len(result['new'])} new, "
            f"{len(result['stale'])} stale, {result['seconds']:.2f} s")
