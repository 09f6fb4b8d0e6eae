"""Float-dtype audit: the torch counterpart of the reference's
``dtype-narrow`` / ``weak-promo`` rules (``repro.analysis.jaxpr_audit``).

Each registered entry with ``"dtype"`` in its checks (``entries.registry``)
runs once on the
canonical problem in float32 and once in float64, under a
``torch.overrides.TorchFunctionMode`` that sees every torch function and
tensor method the entry calls:

``dtype-narrow``
    on a float64 problem, an op whose floating result is narrower than one
    of its floating tensor inputs (a cast such as ``x.to(torch.float32)``,
    a narrowing ``copy_`` or item assignment): the value is truncated.
    Reading float32 storage (positions are float32 by contract) is no
    finding; converting a float64 value down is.

``weak-promo``
    on a float32 problem, a floating result wider than float32 that is made
    from nothing wider (a float64 tensor created, or one mixed into float32
    arithmetic): a float64 value contaminated the arithmetic.  Ops that
    only pass such a value along are not counted again.

Entries declare ``allow_dtypes`` for intentional storage casts (the bf16
anchors of quantized serving, the float32 kernel matvec), as the
reference's do.  Dtypes do not depend on the device, so the CPU run
(plain engines) is the audit; on the card the same entries run through
the kernels' wrappers.
"""

from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode

from . import entries as _entries
from .entries import Entry, canonical
from .report import Finding


def _floats(obj, out: list) -> list:
    """Every floating tensor in ``obj`` (tensors, sequences, dicts, tuples)."""
    if isinstance(obj, torch.Tensor):
        if obj.is_floating_point():
            out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _floats(v, out)
    elif isinstance(obj, dict):
        for v in obj.values():
            _floats(v, out)
    return out


class DtypeRecorder(TorchFunctionMode):
    """Records (rule, old, new) for every narrowing/widening float result."""

    def __init__(self, problem_dtype: torch.dtype, allow: frozenset = frozenset()):
        super().__init__()
        self.dtype = problem_dtype
        self.width = problem_dtype.itemsize
        self.allow = allow
        self.seen: list[tuple[str, str, str, str]] = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = getattr(func, "__name__", str(func))
        if name == "__setitem__":  # the target's dtype is the result's
            ins, results = _floats(list(args[1:]), []), _floats(args[0], [])
        else:
            ins, results = _floats(list(args) + list(kwargs.values()), []), _floats(out, [])
        widest = max(ins, key=lambda t: t.dtype.itemsize, default=None)
        narrowest = min(ins, key=lambda t: t.dtype.itemsize, default=None)
        for r in results:
            new = r.dtype
            if widest is not None and new.itemsize < widest.dtype.itemsize:
                self._record("dtype-narrow", widest.dtype, new, name)
            elif new.itemsize > self.width and (
                    narrowest is None or narrowest.dtype.itemsize < new.itemsize):
                # a wide value made here or mixed in (not one passed along)
                old = narrowest.dtype if narrowest is not None else self.dtype
                self._record("weak-promo", old, new, name)
        return out

    def _record(self, rule, old, new, op):
        o, n = str(old).replace("torch.", ""), str(new).replace("torch.", "")
        if {o, n} & self.allow:
            return
        if rule == "dtype-narrow" and self.width <= 4 and n != "bfloat16" and n != "float16":
            return  # on f32 problems only narrowing below f32 is a finding
        self.seen.append((rule, o, n, op))


def audit_entry(entry: Entry, fx) -> list[Finding]:
    """One entry on one canonical fixture: its dtype findings, deduped."""
    rec = DtypeRecorder(fx.dtype, entry.allow_dtypes)
    with rec:
        entry.call(fx, None)
    out: dict[str, Finding] = {}
    for rule, old, new, op in rec.seen:
        f = Finding(rule, entry.name, f"{old}->{new}",
                    f"{op} on a {fx.dtype} problem: " + (
                        "implicit float narrowing; values are silently truncated"
                        if rule == "dtype-narrow" else
                        "promotion above the problem dtype; a float64 value "
                        "contaminated the arithmetic"))
        out.setdefault(f.key, f)
    return list(out.values())


def run(device="cuda", entries: list[Entry] | None = None) -> list[Finding]:
    """Every entry on the float32 and the float64 canonical problem on ``device``."""
    if entries is None:
        entries = [e for e in _entries.registry() if e.call is not None and "dtype" in e.checks]
    findings: dict[str, Finding] = {}
    for dt in (torch.float32, torch.float64):
        fx = canonical(dt, device)
        for entry in entries:
            for f in audit_entry(entry, fx):
                findings.setdefault(f.key, f)
    return list(findings.values())
