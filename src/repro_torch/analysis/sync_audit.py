"""The ``host-sync`` rule on the card.

Every entry of the registry with a ``card`` call (the functions that
``ast_lint.SYNC_FREE`` lists) is called on a canonical problem on the card
(float32, n = 40 with spare rows and stream headroom, B = 2, forgetting
on), with every value argument already a tensor on the card
(``entries.card_inputs``), under ``torch.cuda.set_sync_debug_mode("error")``.
PyTorch then raises at the first operation that waits for the card (a
device-to-host read, a blocking copy, a ``nonzero``); each raise becomes
``Finding("host-sync", entry, tag=<the innermost frame in repro_torch, as
"module:function">)``.  One call shows its first sync only: fix it and the
next one shows.

Each entry runs once before the audited call, so library builds and the
allocator's first requests are behind it.  The debug mode is reset in a
``finally``; it is never relaxed to ``"warn"``.
"""

from __future__ import annotations

import os
from collections.abc import Callable

import torch

from .. import device as _device
from . import entries as _entries
from .report import Finding

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SYNC_MESSAGE = "synchronizing CUDA operation"


def _frame_tag(tb) -> str:
    """``module:function`` of the innermost traceback frame in the package
    (outside this auditor)."""
    tag = "unknown"
    while tb is not None:
        path = os.path.abspath(tb.tb_frame.f_code.co_filename)
        rel = os.path.relpath(path, PACKAGE)
        if not rel.startswith("..") and not rel.startswith("analysis"):
            mod = rel[:-3].replace(os.sep, ".") if rel.endswith(".py") else rel
            tag = f"{mod}:{tb.tb_frame.f_code.co_name}"
        tb = tb.tb_next
    return tag


def audit_entry(name: str, target: str, call: Callable[[], object]) -> list[Finding]:
    """One warm-up ``call()``, then the audited call under the "error" mode."""
    call()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        call()
    except RuntimeError as exc:
        if _SYNC_MESSAGE not in str(exc):
            raise
        return [Finding("host-sync", name, _frame_tag(exc.__traceback__),
                        f"{target}: {str(exc).splitlines()[0]}")]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return []


def canonical_card(device="cuda"):
    """The sync audit's problem: float32, n = 40 with 4 spare rows and 4
    stream lanes of headroom, B = 2, beta 0.9, on the card."""
    return _entries.canonical(torch.float32, device, n=40, b=2, spares=4, headroom=4)


def run(device="cuda") -> list[Finding]:
    """The host-sync rule over the registry's card calls; raises without CUDA."""
    dev = _device.resolve(device)
    if dev.type != "cuda":
        raise ValueError(f"the host-sync audit runs on a CUDA device, got {dev}")
    c = _entries.card_inputs(canonical_card(dev))
    findings = []
    for e in _entries.registry():
        if e.card is not None:
            findings += audit_entry(e.name, e.target, lambda e=e: e.card(c))
    return findings
