"""Run one cell of the port's benchmark once, on the card.

  python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` (with ``--trace 1`` also
``busy_s`` and ``window_s``), ``breakdown`` (``--trace 1``) and, last,
``checks``: each number compared beside its limit, which are also the last
lines of standard error.  Exits non-zero with no result where there is no
CUDA device or fewer than the cell asks for, where the program is missing,
and where ``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro`` has
been imported by the time the window has closed.
"""

import time

T0 = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

# The program's build caches live in the checkout, at fixed paths: only the
# first run of a checkout builds (the port's own kernels go to
# build/repro_torch_kernels/, which the port fixes itself).
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(CHECKOUT / "build" / sub)
os.environ.setdefault("USE_FLAX", "0")
sys.path[:0] = [str(CHECKOUT / "src"), str(CHECKOUT)]


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def power_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from portbench import harness

    cell = harness.Cell.find(args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: cell {args.workload} needs {chips} CUDA device(s), found {n}",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (the program; missing in a checkout without src/)

    dev = torch.device("cuda", torch.cuda.current_device())
    res = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), dev, t0=T0)
    found = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if found:
        print(f"portbench: forbidden modules imported: {found}", file=sys.stderr)
        return 3
    res.pop("readings")
    print(f"portbench: {cell.workload['name']} seed {args.seed} on {power_limit()}: "
          f"correct={res['correct']} attempted={res['attempted']} failed={res['failed']}",
          file=sys.stderr)
    for k, v in res["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
