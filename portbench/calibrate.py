"""Read the two ends a cell's limits are set between, on the card, at the
cell's own size: the largest reading of each number over sound runs of the
program on many seeds (the lower), and the smallest over runs of the
control on a few (the upper): the reference in the program's place,
computed one precision below the configuration's (``reference/precision.py``).

  python3 portbench/calibrate.py --workload <name> [--seeds 12] [--control-seeds 3]
      [--first-seed N] [--seconds 2]

All runs share one process (one set-up of CUDA and the kernels), each with
a short window at the cell's own load that compares as many items as a
run does.  Prints one JSON line: every run's readings, ``lower``, ``upper``
and their ratio per number.  The benchmark's own runs never run this.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1] / "src"),
                str(Path(__file__).resolve().parents[1])]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=4_000_000_000)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    import torch

    from portbench import harness
    from portbench.reference.precision import control

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", torch.cuda.current_device())
    cell = harness.Cell.find(args.workload)
    ctl = control(cell.config["dtype"])
    runs = {"program": [], "control": []}
    for j in range(args.seeds + args.control_seeds):
        side = "program" if j < args.seeds else "control"
        seed = args.first_seed + j
        res = harness.run_cell(cell, seed, args.seconds, False, dev,
                               control=None if side == "program" else ctl)
        runs[side].append(dict(seed=seed, correct=res["correct"], readings=res["readings"]))
        print(f"calibrate: {args.workload} {side} seed {seed}: {res['readings']}",
              file=sys.stderr, flush=True)
    names = sorted(runs["program"][0]["readings"])
    lower = {k: max(r["readings"][k] for r in runs["program"]) for k in names}
    upper = {k: min(r["readings"][k] for r in runs["control"]) for k in names}
    ratio = {k: (upper[k] / lower[k] if lower[k] > 0 else None) for k in names}
    print(json.dumps(dict(workload=args.workload, control=ctl.name, lower=lower, upper=upper,
                          ratio=ratio, runs=runs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
