"""Invariant audit of the port: AST lint, launch ledger, dtype, liveness
and host-sync auditors against the shrink-only baseline.

Exit status:

  0  every finding is baselined and every baseline entry of the rules run
     still fires
  1  NEW findings (not baselined) or STALE baseline entries (fix the code
     or delete the entry: the baseline only shrinks)
  2  the audit itself crashed (a ``sync`` run without a card included)

  python -m repro_torch.analysis --device cpu --skip sync -v   # CPU machine
  python -m repro_torch.analysis -v                             # on a card
  python -m repro_torch.analysis --device cpu --skip sync --write-baseline
"""

from __future__ import annotations

import argparse
import sys

from . import AUDITORS, BASELINE, run, scope, summary_line
from .report import in_scope, load_baseline, save_baseline


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", default=BASELINE)
    ap.add_argument("--write-baseline", action="store_true",
                    help="overwrite the baseline's entries of what ran with the "
                         "current findings")
    ap.add_argument("--skip", default="", help="comma list of auditors to skip: "
                    + ",".join(AUDITORS))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the runtime auditors run; sync needs cuda")
    ap.add_argument("-v", "--verbose", action="store_true")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    skip = {s.strip() for s in args.skip.split(",") if s.strip()}
    unknown = skip - set(AUDITORS)
    if unknown:
        parser().error(f"unknown auditor(s) in --skip: {sorted(unknown)}")
    auditors = [a for a in AUDITORS if a not in skip]
    baseline = load_baseline(args.baseline)
    results = run(auditors, args.device, baseline)
    if args.write_baseline:
        # entries outside what ran stay; a kept finding keeps its justification
        ran = [p for a in auditors for p in scope(a, args.device)]
        entries = {k: v for k, v in baseline.items() if not in_scope(k, ran)}
        for f in (f for r in results for f in r["findings"]):
            entries[f.key] = baseline.get(f.key, f.detail)
        save_baseline(args.baseline, entries)
        print(f"wrote {len(entries)} entr(y/ies) to {args.baseline}")
        return 0
    bad = any(r["new"] or r["stale"] for r in results)
    for r in results:
        if args.verbose or r["new"] or r["stale"]:
            print(summary_line(r))
        for f in r["new"]:
            print(f"  NEW   {f.key}  {f}")
        for k in r["stale"]:
            print(f"  STALE {k}  (fixed? delete it from the baseline)")
    if args.verbose and not bad:
        print("audit: clean")
    return 1 if bad else 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SystemExit:
        raise
    except Exception:
        import traceback

        traceback.print_exc()
        sys.exit(2)
