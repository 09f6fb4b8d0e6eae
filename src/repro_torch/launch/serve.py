"""Serving launcher of the port: field mode (build -> train -> serve), daemon
mode (the long-lived serving loop) and LM mode (prefill + greedy decode).

``--mode daemon`` is the serving loop of ``repro_torch.launch.daemon``:
coalesced bucketed queries against a published snapshot while supervised
training ticks (watchdog, checkpoints, fault drills, representer pruning)
run behind it.  All other flags are the daemon's own (``python -m
repro_torch.launch.daemon --help``).  ``--hardened-env`` re-execs the
launcher once under ``hardened_env``, in any mode.

B independent fields over one sensor network are trained with the colored
SN-Train sweep, then one query grid is answered under each rule given to
``--fusion``:

  ``conn``  collapses the network to global coefficients and evaluates
            them with the fused kernel matvec (paper Eq. 20);
  ``knn``   answers through the static cell plan (paper Eq. 19) with
            ``--engine {cuda,plan,dense}``.

``--engine cuda`` (the default) trains with the color-step kernel and
serves kNN with the knn_fuse kernel; ``plan`` and ``dense`` run the plain
PyTorch engines.

``--mode lm`` serves ``--arch`` (only ``mamba2-370m`` is ported) from
random weights made from ``--seed``: one prompt of ``--batch`` x
``--prompt_len`` random tokens is prefilled, then ``--gen`` tokens are
decoded greedily against the SSM cache.  ``--engine cuda`` runs the prefill's
SSD intra-chunk term in the ssd_intra kernel (``ssd_fused=True``);
``plan`` runs the plain ``ssd_chunked``.

``--stream A`` absorbs A arrivals after training, as the reference does:
the topology gets ``ceil(A / n) + 4`` lanes of headroom, the arrivals are
drawn from the generator that drew the fields (an odd remainder of one,
then a warm window and a timed window of A // 2 through
``streaming.absorb_many`` under ``--on_full``), ``--refresh_sweeps``
colored sweeps with the train engine follow, and the queries run on the
streamed problem.

``--churn N`` then replays N rounds of network churn, as the reference
does: the problem is built with ``--spares`` spare rows (``n_max = n +
spares``) and 2 more lanes of headroom, and each round joins a sensor at a
random position (``streaming.add_sensor`` and ``serving.plan_add_sensor``
on a query plan with ``spares + 4`` spare columns and ``N`` slack),
absorbs 8 arrivals, refreshes, makes a sensor leave every other round
(``remove_sensor``, ``plan_remove_sensor``, another refresh) and serves a
kNN request on the repaired plan.  Two rounds warm up; the rest are timed.
The final kNN request runs on the repaired plan.

``--faults SPEC`` trains under the seeded fault process
(``core.faults``: i.i.d. drops, Gilbert-Elliott bursts, sensor crashes)
with the convergence watchdog (``core.monitor``) supervising every round
of ``--refresh_sweeps`` sweeps, up to ``--sweeps`` in all: a diverging
round is retried with fresh draws, then the factors are rebuilt, then the
entry state is restored.  The supervised run takes the place of the timed
train call, as in the reference; it prints the watchdog receipt and its
``watchdog.json:`` twin, and ``--stream``, ``--churn`` and the requests
follow on the supervised state.

``--energy_tau TAU`` compacts the kNN query plan offline, as the reference
does: ``pruning.prune_plan`` drops the sensors whose coefficient energy is
at most TAU (on the churn trace's repaired plan under ``--churn``) and the
kNN request is served through the compacted plan, at its smaller
``K_max``; the ``query[...]`` line reports ``tau=TAU pruned n/m``.  The conn
route and ``--engine dense`` are not pruned, as in the reference.

Examples (on the GPU):
  PYTHONPATH=src python -m repro_torch.launch.serve --mode field \\
    --fields 16 --sensors 1000 --dim 2 --radius 0.0949 --sweeps 30 \\
    --queries 4096 --fusion knn conn --k 3
  PYTHONPATH=src python -m repro_torch.launch.serve --mode field \\
    --fields 16 --sensors 1000 --dim 2 --radius 0.0949 --sweeps 30 \\
    --queries 4096 --fusion knn conn --k 3 --stream 2048 --on_full evict
  PYTHONPATH=src python -m repro_torch.launch.serve --mode field \\
    --fields 16 --sensors 1000 --dim 2 --radius 0.0949 --sweeps 30 \\
    --queries 4096 --fusion knn conn --k 3 --stream 2048 --on_full evict \\
    --churn 16 --spares 8
  PYTHONPATH=src python -m repro_torch.launch.serve --mode field \\
    --fields 16 --sensors 1000 --dim 2 --radius 0.0949 --sweeps 30 \\
    --queries 4096 --fusion knn conn --k 3 --faults drop=0.1,burst=0.05:0.4:0.5
  PYTHONPATH=src python -m repro_torch.launch.serve --mode field \\
    --fields 16 --sensors 1000 --dim 2 --radius 0.0949 --sweeps 30 \\
    --queries 4096 --fusion knn conn --k 3 --energy_tau 0.05
  PYTHONPATH=src python -m repro_torch.launch.serve --mode daemon \\
    --sensors 40 --fields 3 --ticks 20 --ckpt-every 1 --snapshot-dir /tmp/snap
  PYTHONPATH=src python -m repro_torch.launch.serve --mode lm \\
    --arch mamba2-370m --variant full --batch 4 --prompt_len 512 --gen 32
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import sys
import time

import numpy as np
import torch

from .. import device as _device
from ..configs import ARCH_NAMES, get_config
from ..core import (
    Kernel,
    build_topology,
    colored_sweep,
    faults,
    fusion,
    init_state,
    make_batch_problem,
    make_serving_plan,
    monitor,
    plan_add_sensor,
    plan_remove_sensor,
    plans,
    pruning,
    streaming,
    uniform_sensors,
)
from ..kernels import _build
from ..kernels.ops import kernel_matvec
from ..models import decode_step, init_cache, init_params, prefill


# Hardened launch environment (the reference's HomebrewNLP run.sh pattern):
# tcmalloc beats glibc malloc under a daemon's sustained small allocations,
# and the TCMALLOC threshold silences its large-allocation reports.
_TCMALLOC_PATHS = (
    "/usr/lib/x86_64-linux-gnu/libtcmalloc.so.4",
    "/usr/lib/x86_64-linux-gnu/libtcmalloc_minimal.so.4",
    "/usr/lib/libtcmalloc.so.4",
    "/usr/local/lib/libtcmalloc.so.4",
)
_HARDENED_GUARD = "_REPRO_HARDENED_ENV"


def hardened_env(base=None) -> tuple[dict, list[str]]:
    """The hardened serving environment; returns ``(env, notes)``.

    Never overrides values the caller already exported, and skips the
    tcmalloc preload with a note, not an error, when no known library path
    exists.  The reference also sets ``XLA_FLAGS`` and
    ``TF_CPP_MIN_LOG_LEVEL``; they configure XLA, which the port does not
    run, so they are left out.
    """
    env = dict(os.environ if base is None else base)
    notes = []
    lib = next((p for p in _TCMALLOC_PATHS if os.path.exists(p)), None)
    if lib is not None:
        pre = env.get("LD_PRELOAD", "")
        if lib not in pre.split(":"):
            env["LD_PRELOAD"] = f"{lib}:{pre}" if pre else lib
        env.setdefault("TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD", "60000000000")
        notes.append(f"tcmalloc={lib}")
    else:
        notes.append("tcmalloc absent (preload skipped)")
    return env, notes


def _reexec_hardened(argv: list[str]) -> None:
    """Replace this process with the launcher on ``argv`` under the hardened env.

    ``LD_PRELOAD`` only takes effect at process start, so the flag re-execs
    the command once; the guard variable stops the loop.
    """
    env, notes = hardened_env()
    env[_HARDENED_GUARD] = "1"
    print("hardened-env: " + "; ".join(notes), flush=True)
    os.execve(sys.executable, [sys.executable, "-m", "repro_torch.launch.serve"] + argv, env)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


TIMED_CALLS = 2  # calls of fn per _timed: the warm-up and the timed one


def _timed(fn, dev: torch.device):
    """Run ``fn`` once to warm up, then once timed; returns (result, seconds)."""
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0


def build_problem(
    args: argparse.Namespace, dtype: torch.dtype = torch.float32, rng=None
):
    """The launcher's seeded batch problem (B sinusoid fields + noise) on ``args.device``.

    The fields are drawn from ``rng`` (default: a fresh
    ``np.random.default_rng(args.seed)``); pass one to go on drawing from it
    afterwards, as the launcher draws its arrival windows.  With
    ``args.stream`` or ``args.churn`` the neighborhoods get ``ceil(stream /
    n) + 4`` lanes of headroom beyond the max degree (2 more with churn, for
    the joins' reciprocal lanes), the reference's capacity; with
    ``args.churn`` the problem also holds ``args.spares`` spare rows.
    """
    dev = _device.resolve(args.device)
    b, n = args.fields, args.sensors
    if rng is None:
        rng = np.random.default_rng(args.seed)
    pos = uniform_sensors(n, d=args.dim, seed=args.seed)
    # Per-field targets: random-frequency/phase sinusoids + noise.
    freq = rng.uniform(0.5, 2.0, size=(b, 1))
    phase = rng.uniform(0, 2 * np.pi, size=(b, 1))
    ys = np.sin(np.pi * freq * pos[None, :, 0] + phase) + 0.3 * rng.normal(size=(b, n))
    topo = build_topology(pos, args.radius, device=dev)
    if args.stream or args.churn:
        per_sensor = -(-max(args.stream, 1) // n) + 4 + (2 if args.churn else 0)
        d_max = int(topo.degrees.max()) + per_sensor
        topo = build_topology(pos, args.radius, d_max=d_max, device=dev)
    return make_batch_problem(
        topo, Kernel("rbf", gamma=args.gamma), ys, np.full((n,), args.lam, np.float32),
        beta=args.beta, dtype=dtype, n_max=n + args.spares if args.churn else None,
        device=dev,
    )


def serve_fields(args: argparse.Namespace) -> dict:
    """Build, train and serve one batch of fields; prints and returns the results.

    Returns ``problem``, the trained ``state``, the query grid ``xq``, the
    (B, Q) answers under each ``--fusion`` rule, the timings and
    ``train_calls`` (``colored_sweep`` calls, the warm-up included; under
    ``--faults`` the supervised rounds, and ``watchdog`` holds the
    receipt).  With ``--stream`` or ``--churn``, ``problem`` and ``state``
    are the streamed, churned and refreshed ones the queries ran on;
    ``stream`` holds what ``stream_fields`` returns and ``churn`` what
    ``churn_fields`` returns.  With ``--energy_tau``, ``prune`` holds the
    ``PruneReport`` and ``pruned_plan`` the compacted plan the kNN request
    ran on.
    """
    dev = _device.resolve(args.device)
    b, n = args.fields, args.sensors
    rng = np.random.default_rng(args.seed)
    prob = build_problem(args, rng=rng)
    state0 = init_state(prob)
    capacity = f" (capacity {prob.n})" if args.churn else ""
    print(
        f"fields={b} sensors={n}{capacity} D={prob.topology.d_max} "
        f"colors={prob.topology.n_colors} stream_capacity={prob.n_stream} device={dev}"
    )

    train_engine = "cuda" if args.engine == "cuda" else "plan"
    if args.faults:
        prob, state, res = train_faulty(args, prob, state0, train_engine)
    else:
        state, train_s = _timed(
            lambda: colored_sweep(prob, state0, n_sweeps=args.sweeps, engine=train_engine), dev
        )
        print(
            f"train[engine={train_engine}]: {args.sweeps} sweeps x {b} fields in "
            f"{train_s:.4f}s -> {b / train_s:.1f} fields/s"
        )
        res = dict(train_s=train_s, train_calls=TIMED_CALLS)
    if args.stream:
        prob, state, res["stream"] = stream_fields(args, prob, state, rng, train_engine)
    plan = None
    if args.churn:
        prob, state, res["churn"] = churn_fields(args, prob, state, rng, train_engine)
        plan = res["churn"]["plan"]
    xq = query_grid(args, dev)
    res.update(problem=prob, state=state, xq=xq)
    report = None
    if args.energy_tau > 0 and "knn" in args.fusion and args.engine != "dense":
        # offline compaction, on the churn trace's repaired plan if there is one
        base = plan if plan is not None else make_serving_plan(prob, k=args.k)
        plan, report = pruning.prune_plan(prob, state, base, energy_tau=args.energy_tau)
        res.update(prune=report, pruned_plan=plan)
    for rule, note, run in field_requests(args, prob, state, xq, plan=plan, prune=report):
        out, dt = _timed(run, dev)
        print(
            f"query[{note}]: {args.queries} points x {b} fields in {dt * 1e3:.3f}ms "
            f"-> {args.queries * b / dt:.0f} field-queries/s"
        )
        print(f"sample field 0 ({rule}):", [round(float(v), 3) for v in out[0, :6]])
        res[rule] = out
        res[f"{rule}_s"] = dt
    return res


def train_faulty(args: argparse.Namespace, prob, state, engine: str):
    """Train under ``--faults`` with the watchdog supervising, as the reference does.

    Rounds of ``--refresh_sweeps`` sweeps, at most ``ceil(sweeps /
    refresh_sweeps)`` of them, converged at ``--watch_tol``; the fault draws
    come from a generator on the problem's device seeded with ``--seed +
    1``.  Prints the ``train[faults ...]`` line, the receipt and its
    ``watchdog.json:`` twin.  Returns ``(problem, state, res)``; ``res``
    has ``train_s``, ``train_calls`` (the rounds run, one ``faulty_sweep``
    call each) and the ``watchdog`` receipt.
    """
    dev = prob.device
    model = faults.parse_fault_spec(args.faults, dtype=state.z.dtype, device=dev)
    cfg = monitor.WatchdogConfig(
        sweeps_per_round=args.refresh_sweeps,
        tol=args.watch_tol,
        max_rounds=max(1, -(-args.sweeps // args.refresh_sweeps)),
    )
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    _sync(dev)
    t0 = time.perf_counter()
    prob, state, receipt = monitor.watch_sweeps(
        prob, state, model=model, generator=gen, engine=engine, config=cfg
    )
    _sync(dev)
    train_s = time.perf_counter() - t0
    print(
        f"train[faults {args.faults}, engine={engine}]: {receipt.sweeps} supervised "
        f"sweeps x {args.fields} fields in {train_s:.4f}s"
    )
    print(monitor.format_receipt(receipt))
    print("watchdog.json: " + json.dumps(receipt.to_json()))
    return prob, state, dict(train_s=train_s, train_calls=receipt.rounds, watchdog=receipt)


def stream_fields(args: argparse.Namespace, prob, state, rng, engine: str):
    """Absorb ``args.stream`` arrivals into the trained fields, then refresh.

    The reference launcher's order: an odd remainder of one arrival, then a
    warm window and a timed window of ``stream // 2`` arrivals (the timed
    one drawn before the clock starts), each one ``absorb_many`` call under
    ``--on_full`` with ``donate=True``; arrivals are drawn from ``rng``
    (field, sensor, the sensor's position + N(0, 0.05^2), value N(0, 1)).
    Then ``--refresh_sweeps`` colored sweeps with ``engine``.  Returns
    ``(problem, state, info)``: ``info`` has the ``receipt`` of every
    arrival, the ``absorbed``/``evicted``/``dropped`` counts, the timed
    ``window`` and its ``window_s``, and ``refresh_s``.
    """
    dev = prob.device
    b, n = args.fields, args.sensors
    pos = prob.topology.positions[:n].cpu().numpy()
    half = args.stream // 2

    def window(a):
        fs = rng.integers(0, b, size=a)
        ss = rng.integers(0, n, size=a)
        xs = (pos[ss] + 0.05 * rng.normal(size=(a, pos.shape[1]))).astype(np.float32)
        return fs, ss, xs, rng.normal(size=a).astype(np.float32)

    receipts = []

    def absorb(arrivals):
        nonlocal prob, state
        prob, state, rec = streaming.absorb_many(
            prob, state, *arrivals, donate=True, on_full=args.on_full
        )
        receipts.append(rec)

    if args.stream % 2:
        absorb(window(1))
    window_s = None
    if half:
        absorb(window(half))
        timed = window(half)
        _sync(dev)
        t0 = time.perf_counter()
        absorb(timed)
        _sync(dev)
        window_s = time.perf_counter() - t0
    receipt = streaming.AbsorbReceipt(
        absorbed=torch.cat([r.absorbed for r in receipts]),
        evicted=torch.cat([r.evicted for r in receipts]),
    )
    # every arrival is absorbed, absorbed after an eviction, or dropped
    absorbed = int(receipt.absorbed.sum())
    evicted = int(receipt.evicted.sum())
    dropped = args.stream - absorbed
    pressure = (f" (capacity pressure: {dropped} dropped, {evicted} evicted)"
                if dropped or evicted else "")
    timing = (f", timed window of {half} in one absorb_many call: {window_s:.4f}s -> "
              f"{window_s / half * 1e3:.3f} ms/update" if window_s is not None else "")
    print(f"stream: {absorbed} absorbed{timing}{pressure}")

    _sync(dev)
    t0 = time.perf_counter()
    state = colored_sweep(prob, state, n_sweeps=args.refresh_sweeps, engine=engine)
    _sync(dev)
    refresh_s = time.perf_counter() - t0
    print(f"refresh[engine={engine}]: {args.refresh_sweeps} sweeps x {b} fields in "
          f"{refresh_s:.4f}s")
    info = dict(receipt=receipt, absorbed=absorbed, evicted=evicted, dropped=dropped,
                window=half, window_s=window_s, refresh_s=refresh_s)
    return prob, state, info


CHURN_ARRIVALS = 8  # arrivals absorbed per churn round
CHURN_WARM_ROUNDS = 2  # one join-only and one join + leave round, untimed


def churn_fields(args: argparse.Namespace, prob, state, rng, engine: str):
    """Replay ``args.churn`` rounds of joins and leaves, as the reference does.

    Round i draws from ``rng`` a join at a uniform position in [-0.9, 0.9]^d
    with N(0, 1) measurements (``add_sensor``; a joined sensor also enters
    the query plan), then ``CHURN_ARRIVALS`` arrivals absorbed under
    ``--on_full`` and ``--refresh_sweeps`` colored sweeps with ``engine``;
    every odd round the oldest joined sensor (or, with none, a random base
    sensor) leaves, followed by another refresh; then one kNN request of 64
    points on the repaired plan with ``--engine``.  Every event donates.  The
    first ``CHURN_WARM_ROUNDS`` rounds warm up; the others are timed.
    Returns ``(problem, state, info)``: ``info`` has the counts (``joins``,
    ``leaves``, ``join_drops``, ``absorbed``, ``dropped``, ``cell_overflows``,
    ``skipped_couplings``, ``dropped_newest``), ``refresh_calls`` and
    ``knn_calls`` (every round's), the repaired ``plan``, ``round_ms`` per
    timed round, ``builds`` (CUDA library builds during the timed rounds)
    and the live degree headroom.
    """
    dev = prob.device
    b, n = args.fields, args.sensors
    pos = prob.topology.positions[:n].cpu().numpy()
    d = pos.shape[1]
    plan = make_serving_plan(prob, k=args.k, spare=args.spares + 4, slack=args.churn)
    xq = np.linspace(-0.9, 0.9, 64)[:, None].astype(np.float32)
    xq = torch.as_tensor(np.concatenate([xq] + [np.zeros_like(xq)] * (d - 1), axis=1),
                         device=dev)
    stats = dict(joins=0, join_drops=0, leaves=0, cell_overflows=0, absorbed=0, dropped=0,
                 skipped_couplings=0, dropped_newest=0, refresh_calls=0, knn_calls=0)
    joined: list[int] = []
    lifecycle = dict(repair_lambda=args.repair_lambda, donate=True)

    def refresh(prob, state):
        stats["refresh_calls"] += 1
        return colored_sweep(prob, state, n_sweeps=args.refresh_sweeps, engine=engine)

    def churn_round(prob, state, plan, i):
        x = rng.uniform(-0.9, 0.9, size=d).astype(np.float32)
        ys = rng.normal(size=b).astype(np.float32)
        prob, state, rcpt = streaming.add_sensor(prob, state, x, ys, lam=args.lam, **lifecycle)
        stats["skipped_couplings"] += int(rcpt.skipped_mask.sum())
        stats["dropped_newest"] += int(rcpt.dropped_newest.sum())
        if bool(rcpt.joined):  # a dropped join must not touch the query plan
            plan, over = plan_add_sensor(plan, x, rcpt.slot)
            joined.append(int(rcpt.slot))
            stats["joins"] += 1
            stats["cell_overflows"] += int(over)
        else:
            stats["join_drops"] += 1
        a = CHURN_ARRIVALS
        fs = rng.integers(0, b, size=a)
        ss = rng.integers(0, n, size=a)
        xs = (pos[ss] + 0.05 * rng.normal(size=(a, d))).astype(np.float32)
        prob, state, rec = streaming.absorb_many(
            prob, state, fs, ss, xs, rng.normal(size=a).astype(np.float32), donate=True,
            on_full=args.on_full,
        )
        got = int(rec.absorbed.sum())
        stats["absorbed"] += got
        stats["dropped"] += a - got
        state = refresh(prob, state)
        if i % 2 == 1:  # every other round a sensor leaves
            victim = joined.pop(0) if joined else int(rng.integers(0, n))
            prob, state, removed = streaming.remove_sensor(prob, state, victim, **lifecycle)
            plan = plan_remove_sensor(plan, victim)
            stats["leaves"] += int(bool(removed))
            state = refresh(prob, state)
        stats["knn_calls"] += 1
        fusion.fuse(prob, state, xq, "knn", k=args.k, engine=args.engine,
                    plan=None if args.engine == "dense" else plan)
        _sync(dev)
        return prob, state, plan

    warm = min(CHURN_WARM_ROUNDS, args.churn)
    for i in range(warm):
        prob, state, plan = churn_round(prob, state, plan, i)
    builds0 = _build.builds
    t0 = time.perf_counter()
    for i in range(warm, args.churn):
        prob, state, plan = churn_round(prob, state, plan, i)
    round_ms = (time.perf_counter() - t0) / max(args.churn - warm, 1) * 1e3
    builds = _build.builds - builds0
    headroom = plans.degree_headroom(prob.topology.degrees, prob.alive[: prob.n],
                                     prob.topology.d_max)
    live = headroom[prob.alive[: prob.n]].cpu().numpy()
    hr = dict(min=int(live.min()) if live.size else 0,
              p50=int(np.median(live)) if live.size else 0, at_0=int((live == 0).sum()))
    print(
        f"churn: {args.churn} rounds ({stats['joins']} joins, {stats['leaves']} leaves, "
        f"{stats['join_drops']} join-drops, {stats['absorbed']} absorbed / "
        f"{stats['dropped']} dropped arrivals, {stats['cell_overflows']} cell overflows) "
        f"{round_ms:.1f} ms/round warm; CUDA library builds after warmup: {builds} "
        f"(want 0; the reference counts recompiles here)"
    )
    print(
        f"churn receipts: {stats['skipped_couplings']} couplings skipped (lane-exhausted "
        f"neighbors), {stats['dropped_newest']} newest arrivals dropped to anchor lanes; "
        f"live degree headroom min={hr['min']} p50={hr['p50']} rows_at_0={hr['at_0']}"
        + (" -- joins near 0-headroom rows lose couplings" if hr["at_0"] else "")
    )
    info = dict(stats, plan=plan, rounds=args.churn, timed_rounds=args.churn - warm,
                round_ms=round_ms, builds=builds, headroom=hr)
    return prob, state, info


def query_grid(args: argparse.Namespace, dev: torch.device) -> torch.Tensor:
    """The launcher's (Q, dim) request grid: Q points on [-1, 1] along axis 0."""
    xq = np.linspace(-1, 1, args.queries)[:, None].astype(np.float32)
    if args.dim > 1:
        xq = np.concatenate([xq] + [np.zeros_like(xq)] * (args.dim - 1), axis=1)
    return torch.as_tensor(xq, device=dev)


def field_requests(args: argparse.Namespace, prob, state, xq, plan=None, prune=None) -> list:
    """(rule, note, request) per ``--fusion`` rule; a request answers the
    grid ``xq`` for all B fields.  Per-request work (plans, global
    coefficients) that depends only on the trained state is done here.
    ``plan``: the kNN query plan to serve on (default: one built now; a
    churned problem passes its repaired plan, ``--energy_tau`` the
    compacted one); ``prune``: the compaction's ``PruneReport``, named in
    the kNN note."""
    out = []
    for rule in args.fusion:
        if rule == "knn":
            if args.engine == "dense":
                plan = None
            elif plan is None:
                plan = make_serving_plan(prob, k=args.k)
            cdt = None if args.engine == "dense" or args.serve_dtype == "f32" else args.serve_dtype
            run = functools.partial(
                fusion.fuse, prob, state, xq, "knn", k=args.k, engine=args.engine, plan=plan,
                compute_dtype=cdt,
            )
            note = f"knn k={args.k} engine={args.engine}"
            if prune is not None:
                note += f" tau={args.energy_tau:g} pruned {prune.n_pruned}/{prune.n_live}"
            if cdt is not None:
                note += f" dtype={args.serve_dtype}"
            if plan is not None:
                note += f" (plan: {plan.n_cells} cells, K_max={plan.k_max})"
        else:
            anchors, coefs = fusion.global_coefficients(prob, state, rule="conn")
            run = functools.partial(kernel_matvec, xq, anchors, coefs, gamma=args.gamma)
            note = "conn (global coefficients + fused matvec)"
        out.append((rule, note, run))
    return out


@torch.inference_mode()
def serve_lm(args: argparse.Namespace) -> dict:
    """Prefill one random prompt and decode ``--gen`` tokens greedily.

    One prefill and one decode step run first as a warm-up, so the timed
    prefill and decode hold no one-time costs (kernel loading, library
    handles).  Returns ``cfg``, ``params``, ``prompt``, the timed prefill's
    last-position ``logits`` (B, 1, V) and ``prefill_cache``, the generated
    ``tokens`` (B, gen), the final ``cache``, the timings and
    ``prefill_calls`` (prefills run, the warm-up included).
    """
    dev = _device.resolve(args.device)
    if args.engine not in ("cuda", "plan"):
        raise ValueError(f"--mode lm takes --engine cuda or plan, got {args.engine!r}")
    cfg = get_config(args.arch, variant=args.variant)
    cfg = dataclasses.replace(cfg, ssd_fused=args.engine == "cuda")
    params = init_params(cfg, args.seed, device=dev)
    print(f"arch={cfg.name} params={cfg.n_params() / 1e6:.1f}M dtype={cfg.dtype} "
          f"engine={args.engine} device={dev}")

    b, s0 = args.batch, args.prompt_len
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    prompt = torch.randint(0, cfg.vocab_size, (b, s0), generator=gen, device=dev)
    batch = {"tokens": prompt}
    max_seq = s0 + args.gen + 1

    logits, cache = prefill(cfg, params, batch, init_cache(cfg, b, max_seq, device=dev))
    decode_step(cfg, params, torch.argmax(logits[:, -1:], dim=-1), cache, s0)  # warm-up
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(cfg, params, batch, init_cache(cfg, b, max_seq, device=dev))
    tok = torch.argmax(logits[:, -1:], dim=-1)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    print(f"prefill: {prefill_s:.4f}s ({b}x{s0} tokens)")

    res = dict(cfg=cfg, params=params, prompt=prompt, logits=logits, prefill_cache=cache,
               prefill_s=prefill_s, prefill_calls=2)
    out = []
    t0 = time.perf_counter()
    for i in range(args.gen):
        step_logits, cache = decode_step(cfg, params, tok, cache, s0 + i)
        tok = torch.argmax(step_logits[:, -1:], dim=-1)
        out.append(tok)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    tokens = torch.cat(out, dim=1) if out else prompt.new_zeros((b, 0))
    tok_s = b * args.gen / decode_s if decode_s > 0 else float("inf")
    print(f"decode: {args.gen} steps in {decode_s:.4f}s -> {tok_s:.1f} tok/s")
    print("sample row 0:", tokens[0, :24].tolist())
    res.update(tokens=tokens, cache=cache, decode_s=decode_s, tok_s=tok_s)
    return res


def _launch_parser() -> argparse.ArgumentParser:
    """The flags ``main`` reads before any mode's own."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--mode", default="field", choices=["field", "lm", "daemon"])
    ap.add_argument("--hardened-env", action="store_true",
                    help="re-exec under the hardened launch env (tcmalloc LD_PRELOAD), "
                         "skipped with a note when tcmalloc is absent")
    return ap


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                 parents=[_launch_parser()])
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--seed", type=int, default=0)
    # --mode lm
    ap.add_argument("--arch", default="mamba2-370m", choices=ARCH_NAMES)
    ap.add_argument("--variant", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt_len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=64)
    # --mode field
    ap.add_argument("--fields", type=int, default=64, help="B concurrent fields")
    ap.add_argument("--sensors", type=int, default=50)
    ap.add_argument("--dim", type=int, default=1, help="sensor-space dimension")
    ap.add_argument("--radius", type=float, default=0.8)
    ap.add_argument("--gamma", type=float, default=1.0)
    ap.add_argument("--lam", type=float, default=0.1)
    ap.add_argument("--beta", type=float, default=1.0,
                    help="per-field forgetting factor in (0, 1]; beta < 1 decays old "
                         "arrivals one step per absorb, 1.0 is the static path")
    ap.add_argument("--sweeps", type=int, default=30)
    ap.add_argument("--refresh_sweeps", type=int, default=5,
                    help="colored sweeps after --stream's arrivals and per churn "
                         "refresh; the sweeps per --faults watchdog round")
    ap.add_argument("--stream", type=int, default=0, help="streaming arrivals to absorb")
    ap.add_argument("--on_full", default="drop", choices=["drop", "evict"],
                    help="over-capacity arrival policy (evict = sliding window)")
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--fusion", nargs="+", default=["conn"], choices=["conn", "knn"],
                    help="query fusion rules to serve, in order")
    ap.add_argument("--k", type=int, default=3, help="kNN order for --fusion knn")
    ap.add_argument("--engine", default="cuda", choices=["cuda", "plan", "dense"],
                    help="cuda: the CUDA kernels (field: color step and knn_fuse; "
                         "lm: ssd_intra); plan/dense: the plain PyTorch engines "
                         "(lm takes plan)")
    ap.add_argument("--serve_dtype", default="f32", choices=["f32", "bf16"],
                    help="anchor-table storage dtype for the plan/cuda kNN engines")
    ap.add_argument("--repair_lambda", action="store_true",
                    help="re-derive lambda_i = 0.01/|N_i|^2 for rows whose degree changes "
                         "in churn events")
    ap.add_argument("--churn", type=int, default=0,
                    help="membership churn rounds to replay (symmetric joins/leaves with "
                         "O(degree) event repairs)")
    ap.add_argument("--spares", type=int, default=8,
                    help="spare sensor rows reserved for --churn joins (n_max = sensors + "
                         "spares; the recolor pool is 2x this)")
    ap.add_argument("--faults", default="",
                    help="train under unreliable links: drop=P[,burst=to_bad:to_good:"
                         "drop_bad][,crash=p_crash:p_restart], supervised by the "
                         "convergence watchdog in rounds of --refresh_sweeps sweeps")
    ap.add_argument("--watch_tol", type=float, default=1e-3,
                    help="--faults watchdog convergence tolerance (max |dz| / max |z| "
                         "per round)")
    ap.add_argument("--energy_tau", type=float, default=0.0,
                    help="representer-pruning energy threshold: compact the kNN query "
                         "plan to the sensors with coefficient energy above tau before "
                         "serving (plan/cuda engines; 0 = off)")
    return ap


def main(argv: list[str] | None = None):
    """Run the launcher on ``argv`` (default ``sys.argv[1:]``).

    Returns what ``serve_fields``, ``serve_lm`` or the daemon's ``main``
    returns.  ``--mode daemon`` hands every other flag to
    ``repro_torch.launch.daemon.main``.
    """
    argv = sys.argv[1:] if argv is None else list(argv)
    ns, rest = _launch_parser().parse_known_args(argv)
    if ns.hardened_env and os.environ.get(_HARDENED_GUARD) != "1":
        _reexec_hardened(argv)  # never returns
    if ns.mode == "daemon":
        from . import daemon

        return daemon.main(rest)
    args = parser().parse_args(argv)
    if args.mode == "lm":
        return serve_lm(args)
    return serve_fields(args)


if __name__ == "__main__":
    main()
