"""Findings and the shrink-only baseline protocol shared by all auditors.

Port of ``repro.analysis.report``.  A :class:`Finding` is one violation of
one rule at one stable location.  Its :meth:`Finding.key` deliberately
excludes line numbers and prose so the key survives unrelated edits; the
baseline file maps keys to a written justification.
``compare_with_baseline`` splits findings into ``new`` (not baselined: the
audit fails) and reports ``stale`` baseline entries (baselined but no
longer found: the audit also fails, forcing the entry to be deleted).
Together the two failure modes make the baseline monotone: it can only
shrink.

One difference from the reference: a run that skips some auditors (the
CPU run always skips the card's ``host-sync`` rule) still reports stale
entries for what DID run.  ``compare_with_baseline`` takes the run's
scope: key prefixes, each a rule (``ledger``) or a rule and an entry
(``alive-dead:serving.knn.cuda``).
"""

from __future__ import annotations

import dataclasses
import json
import os


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one stable location.

    rule:   violation class id (``host-sync``, ``dtype-narrow``,
            ``weak-promo``, ``grid-launch``, ``alive-dead``,
            ``alive-scatter``, ``ast-host-sync``, ``ast-alive-thread``,
            ``ast-receipt-json``, ``ledger``).
    where:  the audited object: an entry-point name or a
            ``relpath:qualname`` for AST findings.
    tag:    short stable discriminator when one rule can fire more than
            once per location (e.g. ``float64->float32``).
    detail: human explanation; NOT part of the key.
    """

    rule: str
    where: str
    tag: str = ""
    detail: str = ""

    @property
    def key(self) -> str:
        return f"{self.rule}:{self.where}:{self.tag}" if self.tag else f"{self.rule}:{self.where}"

    def __str__(self) -> str:
        msg = f"[{self.rule}] {self.where}"
        if self.tag:
            msg += f" ({self.tag})"
        if self.detail:
            msg += f": {self.detail}"
        return msg


def in_scope(key: str, scope) -> bool:
    """Whether a finding key falls under one of the ``scope`` prefixes."""
    return any(key == p or key.startswith(p + ":") for p in scope)


def load_baseline(path: str) -> dict[str, str]:
    """Baseline file -> {finding key: justification}.  Missing file = {}."""
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        data = json.load(f)
    baselined = data.get("baselined", {})
    if not isinstance(baselined, dict):
        raise ValueError(f"{path}: 'baselined' must be an object")
    return dict(baselined)


def save_baseline(path: str, baselined: dict[str, str]) -> None:
    """Write ``{finding key: justification}`` as the baseline file."""
    data = {
        "_comment": (
            "Shrink-only baseline for python -m repro_torch.analysis: every key "
            "below is a known, justified finding.  The audit fails on findings "
            "NOT listed here and on entries listed here that no longer fire "
            "(delete them).  Never add an entry without a justification."
        ),
        "baselined": dict(sorted(baselined.items())),
    }
    with open(path, "w") as f:
        json.dump(data, f, indent=2, sort_keys=False)
        f.write("\n")


def compare_with_baseline(
    findings: list[Finding], baseline: dict[str, str], scope=None
) -> tuple[list[Finding], list[str]]:
    """-> (new findings not in the baseline, stale baseline keys).

    ``scope``: the key prefixes the audit ran (None: everything).  A
    baseline entry outside them cannot be shown stale, so it is not.
    """
    keys = {f.key for f in findings}
    new = [f for f in findings if f.key not in baseline]
    stale = sorted(
        k for k in baseline
        if k not in keys and (scope is None or in_scope(k, scope))
    )
    return new, stale
