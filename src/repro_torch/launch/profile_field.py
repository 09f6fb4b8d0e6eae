"""Where the field serving requests' time goes on the card: the launcher's
kNN and conn requests at chip_smoke's main geometry (n=1000 sensors, B=16
fields, 30 sweeps, Q=4096 queries, k=3), each profiled for one call after a
warm-up call under ``torch.profiler``.

For each request it prints the wall time, the device time summed over every
kernel, the device's idle share (1 - device / wall; the profiler's own host
cost inflates it) and the kernels that took the most device time, beside
the port's own spans of that call (``repro_torch.spans``, which record
while the profiler runs: self and total ms per span, and the rows and
padded rows of the serving kernels), then one JSON line with the same
numbers.  Extra arguments are the launcher's field flags and override the
geometry (e.g. ``--engine plan``, or ``--device cpu`` for a rehearsal);
with ``--stream A`` the requests are profiled on the streamed and refreshed
fields, as the launcher serves them.

  PYTHONPATH=src python -m repro_torch.launch.profile_field
  PYTHONPATH=src python -m repro_torch.launch.profile_field --stream 2048 --on_full evict
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from .. import device as _device
from .. import spans
from ..core import colored_sweep, init_state
from . import serve
from .profile_lm import _window

FIELD_ARGV = ["--mode", "field", "--fields", "16", "--sensors", "1000", "--dim", "2",
              "--radius", repr(0.3 * (100.0 / 1000) ** 0.5), "--gamma", "1.0", "--lam", "0.1",
              "--sweeps", "30", "--queries", "4096", "--fusion", "knn", "conn", "--k", "3",
              "--engine", "cuda", "--seed", "0"]


@torch.inference_mode()
def main(argv: list[str] | None = None) -> dict:
    extra = sys.argv[1:] if argv is None else argv
    args = serve.parser().parse_args(FIELD_ARGV + list(extra))
    dev = _device.resolve(args.device)
    rng = np.random.default_rng(args.seed)
    prob = serve.build_problem(args, rng=rng)
    engine = "cuda" if args.engine == "cuda" else "plan"
    state = colored_sweep(prob, init_state(prob), n_sweeps=args.sweeps, engine=engine)
    if args.stream:
        prob, state, _ = serve.stream_fields(args, prob, state, rng, engine)
    xq = serve.query_grid(args, dev)
    out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "engine": args.engine,
           "fields": args.fields, "sensors": args.sensors, "queries": args.queries,
           "stream": args.stream, "on_full": args.on_full}
    for rule, note, run in serve.field_requests(args, prob, state, xq):
        run()  # warm-up
        spans.reset()
        w = out[rule] = _window(run, dev)
        w["spans"] = spans.table(spans.records())
        idle = "not measured" if w["idle_share"] is None else f"{w['idle_share']:.3f}"
        device = "not measured" if w["device_ms"] is None else f"{w['device_ms']:.3f} ms"
        print(f"{note}: wall {w['wall_ms']:.3f} ms, device {device} in "
              f"{w['launches']} kernels, idle share {idle}")
        for k in w["top"]:
            print(f"  {k['ms']:9.4f} ms  {k['calls']:5d}x  {k['name']}")
        print("  port spans (self ms, total ms, calls, counts):")
        for name, row in w["spans"].items():
            counts = "".join(f"  {k} {v}" for k, v in row.items()
                             if k not in ("calls", "ms", "self_ms"))
            print(f"  {row['self_ms']:9.4f} ms  {row['ms']:9.4f} ms  {row['calls']:3d}x  "
                  f"{spans.PREFIX}{name}{counts}")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
