"""Serving launcher of the port, field mode: build -> train -> serve.

B independent fields over one sensor network are trained with the colored
SN-Train sweep, then one query grid is answered under each rule given to
``--fusion``:

  ``conn``  collapses the network to global coefficients and evaluates
            them with the fused kernel matvec (paper Eq. 20);
  ``knn``   answers through the static cell plan (paper Eq. 19) with
            ``--engine {cuda,plan,dense}``.

``--engine cuda`` (the default) trains with the color-step kernel and
serves kNN with the knn_fuse kernel; ``plan`` and ``dense`` run the plain
PyTorch engines.  Streaming, churn, faults, pruning, the daemon and the LM
modes of the reference launcher are not ported yet and refuse to run.

Example (the benched geometry, on the GPU):
  PYTHONPATH=src python -m repro_torch.launch.serve --mode field \\
    --fields 16 --sensors 1000 --dim 2 --radius 0.0949 --sweeps 30 \\
    --queries 4096 --fusion knn conn --k 3
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import device as _device
from ..core import (
    Kernel,
    build_topology,
    colored_sweep,
    fusion,
    init_state,
    make_batch_problem,
    make_serving_plan,
    uniform_sensors,
)
from ..kernels.ops import kernel_matvec


def _timed(fn, dev: torch.device):
    """Run ``fn`` once to warm up, then once timed; returns (result, seconds)."""
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def build_problem(args: argparse.Namespace, dtype: torch.dtype = torch.float32):
    """The launcher's seeded batch problem (B sinusoid fields + noise) on ``args.device``."""
    dev = _device.resolve(args.device)
    b, n = args.fields, args.sensors
    rng = np.random.default_rng(args.seed)
    pos = uniform_sensors(n, d=args.dim, seed=args.seed)
    # Per-field targets: random-frequency/phase sinusoids + noise.
    freq = rng.uniform(0.5, 2.0, size=(b, 1))
    phase = rng.uniform(0, 2 * np.pi, size=(b, 1))
    ys = np.sin(np.pi * freq * pos[None, :, 0] + phase) + 0.3 * rng.normal(size=(b, n))
    topo = build_topology(pos, args.radius, device=dev)
    return make_batch_problem(
        topo, Kernel("rbf", gamma=args.gamma), ys, np.full((n,), args.lam, np.float32),
        beta=args.beta, dtype=dtype, device=dev,
    )


def serve_fields(args: argparse.Namespace) -> dict:
    """Build, train and serve one batch of fields; prints and returns the results.

    Returns ``problem``, the trained ``state``, the query grid ``xq``, the
    (B, Q) answers under each ``--fusion`` rule and the timings.
    """
    for flag in ("stream", "churn", "faults", "energy_tau"):
        if getattr(args, flag):
            raise NotImplementedError(f"--{flag} is not ported yet")
    dev = _device.resolve(args.device)
    b, n = args.fields, args.sensors
    prob = build_problem(args)
    state0 = init_state(prob)
    print(
        f"fields={b} sensors={n} D={prob.topology.d_max} "
        f"colors={prob.topology.n_colors} stream_capacity={prob.n_stream} device={dev}"
    )

    train_engine = "cuda" if args.engine == "cuda" else "plan"
    state, train_s = _timed(
        lambda: colored_sweep(prob, state0, n_sweeps=args.sweeps, engine=train_engine), dev
    )
    print(
        f"train[engine={train_engine}]: {args.sweeps} sweeps x {b} fields in "
        f"{train_s:.4f}s -> {b / train_s:.1f} fields/s"
    )

    xq = np.linspace(-1, 1, args.queries)[:, None].astype(np.float32)
    if args.dim > 1:
        xq = np.concatenate([xq] + [np.zeros_like(xq)] * (args.dim - 1), axis=1)
    xq = torch.as_tensor(xq, device=dev)
    res = dict(problem=prob, state=state, xq=xq, train_s=train_s)
    for rule in args.fusion:
        if rule == "knn":
            plan = None if args.engine == "dense" else make_serving_plan(prob, k=args.k)
            cdt = None if args.engine == "dense" or args.serve_dtype == "f32" else args.serve_dtype
            run = lambda: fusion.fuse(  # noqa: E731
                prob, state, xq, "knn", k=args.k, engine=args.engine, plan=plan,
                compute_dtype=cdt,
            )
            note = f"knn k={args.k} engine={args.engine}"
            if cdt is not None:
                note += f" dtype={args.serve_dtype}"
            if plan is not None:
                note += f" (plan: {plan.n_cells} cells, K_max={plan.k_max})"
        else:
            anchors, coefs = fusion.global_coefficients(prob, state, rule="conn")
            run = lambda: kernel_matvec(xq, anchors, coefs, gamma=args.gamma)  # noqa: E731
            note = "conn (global coefficients + fused matvec)"
        out, dt = _timed(run, dev)
        print(
            f"query[{note}]: {args.queries} points x {b} fields in {dt * 1e3:.3f}ms "
            f"-> {args.queries * b / dt:.0f} field-queries/s"
        )
        print(f"sample field 0 ({rule}):", [round(float(v), 3) for v in out[0, :6]])
        res[rule] = out
        res[f"{rule}_s"] = dt
    return res


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", default="field", choices=["field", "lm", "daemon"])
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fields", type=int, default=64, help="B concurrent fields")
    ap.add_argument("--sensors", type=int, default=50)
    ap.add_argument("--dim", type=int, default=1, help="sensor-space dimension")
    ap.add_argument("--radius", type=float, default=0.8)
    ap.add_argument("--gamma", type=float, default=1.0)
    ap.add_argument("--lam", type=float, default=0.1)
    ap.add_argument("--beta", type=float, default=1.0,
                    help="per-field forgetting factor in (0, 1]")
    ap.add_argument("--sweeps", type=int, default=30)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--fusion", nargs="+", default=["conn"], choices=["conn", "knn"],
                    help="query fusion rules to serve, in order")
    ap.add_argument("--k", type=int, default=3, help="kNN order for --fusion knn")
    ap.add_argument("--engine", default="cuda", choices=["cuda", "plan", "dense"],
                    help="cuda: train and serve kNN with the CUDA kernels; "
                         "plan/dense: the plain PyTorch engines")
    ap.add_argument("--serve_dtype", default="f32", choices=["f32", "bf16"],
                    help="anchor-table storage dtype for the plan/cuda kNN engines")
    # reference flags whose features are not ported yet: refused when set
    ap.add_argument("--stream", type=int, default=0, help="not ported yet")
    ap.add_argument("--churn", type=int, default=0, help="not ported yet")
    ap.add_argument("--faults", default="", help="not ported yet")
    ap.add_argument("--energy_tau", type=float, default=0.0, help="not ported yet")
    return ap


def main(argv: list[str] | None = None) -> dict:
    args = parser().parse_args(argv)
    if args.mode != "field":
        raise NotImplementedError(f"--mode {args.mode} is not ported yet")
    return serve_fields(args)


if __name__ == "__main__":
    main()
