"""Always-on serving daemon: snapshot-isolated queries under a supervised
trainer.

Port of ``repro.launch.daemon``.  The paper's SOP trainer is an ongoing
message-passing process: sensors keep measuring, links keep dropping and
queries arrive while training is mid-sweep.  This module is the long-lived
process built from the port's earlier pieces:

  queue      arriving queries coalesce into the power-of-two buckets of
             ``kernels.ops.bucket_rows`` behind a bounded queue with
             admission control: when the queue is full, or the estimated
             wait exceeds the deadline budget, the request is shed at
             submit time with a receipt;
  snapshot   every query reads a published snapshot (problem, state, plan,
             effective coefficients, prune mask); training builds the next
             one on other tensors and the publish is one reference flip;
  supervise  every training tick runs through ``monitor.watch_sweeps``; a
             tick that rolls back or diverges is not published, the daemon
             serves the last good snapshot (degraded) and restores its
             working copy from it;
  restart    ``checkpoint.save_train`` saves the published state every
             ``ckpt_every`` ticks; construction restores the latest intact
             step, so a crash-kill resumes bitwise.

The daemon is a cooperative state machine: ``pump()`` drains queries,
``tick()`` advances training.

Where the port differs from the reference, by design:

* Randomness.  The reference splits a ``jax.random`` key each tick; the
  port's ``Daemon`` takes ``generator``, a ``torch.Generator`` on the
  problem's device (default: seeded 0), and hands it to
  ``monitor.watch_sweeps``.  Philox cannot draw Threefry's masks, so the
  two packages agree on fault-free traces (``make_fault_model(0.0)``: every
  lane delivered, a bitwise identity), not on drilled ones.
* Publish.  The reference's ``block_until_ready`` becomes a synchronize of
  the current stream, so a published snapshot is complete; the ``pruned``
  count is the publish's one host read.
* Snapshot isolation by construction.  JAX arrays are immutable; PyTorch
  tensors are not, and the port writes in place in three places on a
  tick's path: the ``color_sweep`` kernel (z and coef), the streaming and
  lifecycle events with ``donate=True``, and ``plans.cells_add``.  So a
  published snapshot's tensors are never written after the flip: every
  event and absorb call here passes ``donate=False`` (it copies the tables
  and state it writes), ``colored_sweep(engine="cuda")`` copies z and coef
  before its launch, ``serving.plan_add_sensor`` copies the plan's tables,
  ``plan_remove_sensor`` makes a new mask, and the watchdog's in-memory
  rollback anchor holds copies of z, coef and chol.  Right after a
  publish, and after a rollback to the last good snapshot, the working
  pair aliases the snapshot; the next tick's first write goes through one
  of those copies.  The daemon itself therefore writes no tensor and needs
  no clone of its own.
* "Zero recompiles".  The reference proves it with jit caches; here it
  is "0 CUDA library builds after the warm-up" (``kernels._build.builds``)
  for every bucket size, fault drill and ``set_energy_tau``: ``knn_fuse``
  takes any Q and ``color_sweep`` any mask.
* No fallback.  ``engine="cuda"`` on CUDA tensors launches the kernel or
  raises; a failed dispatch is never served from the plain engine.

CLI (the kill-and-warm-restart smoke):

  PYTHONPATH=src python -m repro_torch.launch.daemon --sensors 40 --fields 3 \\
      --ticks 20 --ckpt-every 1 --snapshot-dir /tmp/snap
  # SIGKILL it mid-run, then:
  PYTHONPATH=src python -m repro_torch.launch.daemon --sensors 40 --fields 3 \\
      --ticks 0 --snapshot-dir /tmp/snap --verify-restart

``--device cpu`` runs the kernels' plain versions on the CPU.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import deque
from typing import NamedTuple

import numpy as np
import torch

from .. import device as _device
from ..checkpoint import ckpt
from ..core import faults as faults_mod
from ..core import fusion, make_serving_plan, monitor, pruning, streaming
from ..core.serving import plan_add_sensor, plan_remove_sensor
from ..core.sn_train import effective_coef
from ..kernels.ops import bucket_rows


@dataclasses.dataclass(frozen=True)
class DaemonConfig:
    """Host-side knobs of the serving daemon (all static)."""

    k: int = 3  # kNN fusion order served
    engine: str = "cuda"  # serving engine: "plan" | "cuda"
    train_engine: str = "cuda"  # sweep engine for training ticks
    queue_rows: int = 1024  # hard cap on pending query rows
    max_batch_rows: int = 256  # rows coalesced into one dispatch
    deadline_ms: float = float("inf")  # admission budget (est. wait)
    sweeps_per_tick: int = 5  # sweeps per watchdog round
    rounds_per_tick: int = 2  # watchdog rounds per tick
    watch_tol: float = 1e-3  # per-round convergence tolerance
    arrival_rows: int = 32  # max arrivals absorbed per tick window
    on_full: str = "drop"  # over-capacity arrival policy
    ckpt_every: int = 0  # ticks between checkpoints (0 = off)
    snapshot_dir: str | None = None  # warm-restart / checkpoint home
    serve_dtype: str = "f32"  # anchor storage dtype: "f32" | "bf16"
    energy_tau: float = 0.0  # representer-pruning threshold (0 = off)


class Snapshot(NamedTuple):
    """One published serving state, never written after its publish.

    ``ecoef`` is ``effective_coef(problem, state)`` made at publish time,
    in the coefficient dtype whatever ``serve_dtype`` is.  ``keep`` is the
    representer-prune mask of this snapshot's coefficients
    (``pruning.prune_mask``; None when pruning is off) and ``pruned`` the
    live sensors it drops.
    """

    version: int
    problem: object
    state: object
    plan: object
    ecoef: torch.Tensor
    serve_dtype: str = "f32"
    keep: torch.Tensor | None = None
    pruned: int = 0


class QueryTicket(NamedTuple):
    """Admission receipt returned by ``submit``.

    ``admitted`` False means the query was shed at the door; ``shed_reason``
    is "queue_full" (the bounded queue is at capacity) or "deadline" (the
    estimated wait exceeds the deadline budget).
    """

    id: int
    admitted: bool
    shed_reason: str = ""


class QueryAnswer(NamedTuple):
    """One served query: values from the snapshot named by ``version``."""

    id: int
    values: np.ndarray  # (B, q) field estimates at the request's points
    version: int  # snapshot the answer was read from
    degraded: bool  # True: trainer unhealthy, snapshot is last-good
    latency_s: float  # submit -> answer wall time


class TickReceipt(NamedTuple):
    """What one training tick did (the health endpoint's raw material)."""

    tick: int
    published: bool  # a new snapshot went live
    degraded: bool  # trainer unhealthy; serving last good snapshot
    version: int  # currently PUBLISHED snapshot version
    absorbed: int  # arrivals absorbed this tick
    arrival_drops: int  # arrivals dropped by capacity pressure
    arrivals_rolled_back: int  # absorbed arrivals lost to a rollback
    joins: int
    leaves: int
    watchdog: monitor.WatchdogReceipt
    ckpt_step: int | None  # checkpoint written this tick (None: none)

    def to_json(self) -> dict:
        """Plain-JSON receipt (the health payload's per-tick record)."""
        return {
            "schema": "tick_receipt/1",
            "tick": int(self.tick),
            "published": bool(self.published),
            "degraded": bool(self.degraded),
            "version": int(self.version),
            "absorbed": int(self.absorbed),
            "arrival_drops": int(self.arrival_drops),
            "arrivals_rolled_back": int(self.arrivals_rolled_back),
            "joins": int(self.joins),
            "leaves": int(self.leaves),
            "watchdog": self.watchdog.to_json(),
            "ckpt_step": None if self.ckpt_step is None else int(self.ckpt_step),
        }


def _state_digest(problem, state) -> str:
    """Order-stable sha256 over every problem/state leaf (bitwise identity).

    The leaves are taken in the checkpoint's order (the reference's
    ``jax.tree.leaves``), each hashed as its numpy dtype string, shape
    string and bytes, so a checkpoint restored into either package hashes
    equal.
    """
    h = hashlib.sha256()
    for _, leaf in ckpt._items({"problem": problem, "state": state}):
        arr = ckpt._numpy(leaf)
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


class Daemon:
    """Long-lived field-serving process; see the module docstring.

    problem/state: a batched ``SNTrainProblem``/``SNTrainState`` pair, also
    the templates of a warm restart.  plan: a prebuilt ``ServingPlan``
    (default ``make_serving_plan(problem, k=config.k)``; pass one built
    with ``spare=``/``slack=`` when churn events will arrive).
    fault_model: the link-fault process of the training ticks (default
    ``make_fault_model(0.0)``, so fault-free and drilled ticks run the same
    code; ``set_fault_model`` swaps rates).  generator: the fault draws'
    ``torch.Generator`` on the problem's device (default: seeded 0).

    ``last_split`` holds the last tick's host milliseconds per part
    (events, absorb, watchdog, publish, checkpoint); each part ends in a
    host read, so the clock reads include its device work.
    """

    def __init__(
        self,
        problem,
        state,
        *,
        config: DaemonConfig = DaemonConfig(),
        plan=None,
        fault_model: faults_mod.FaultModel | None = None,
        generator: torch.Generator | None = None,
    ):
        if not problem.batched:
            raise ValueError("the daemon serves batched problems (use B=1)")
        if config.on_full not in ("drop", "evict"):
            raise ValueError(f"bad on_full {config.on_full!r}")
        if config.serve_dtype not in ("f32", "bf16"):
            raise ValueError(f"bad serve_dtype {config.serve_dtype!r}")
        for engine in (config.engine, config.train_engine):
            if engine not in ("plan", "cuda"):
                raise ValueError(f"engines are 'plan' or 'cuda', got {engine!r}")
        self.config = config
        self.device = problem.device
        # "f32" means the problem's native dtype (f64 problems serve f64);
        # bf16 rounds the stored anchor tables only (selection-exact).
        self._compute_dtype = None if config.serve_dtype == "f32" else config.serve_dtype
        self._energy_tau = float(config.energy_tau)
        self.restored_step: int | None = None
        if config.snapshot_dir is not None:
            step = ckpt.latest_step(config.snapshot_dir)  # verified intact
            if step is not None:
                problem, state = ckpt.restore_train(config.snapshot_dir, step, problem, state)
                self.restored_step = step
        self._work = (problem, state)
        self._plan = plan if plan is not None else make_serving_plan(problem, k=config.k)
        self._model = (
            fault_model if fault_model is not None
            else faults_mod.make_fault_model(0.0, dtype=state.z.dtype, device=self.device)
        )
        self._gen = (
            generator if generator is not None
            else torch.Generator(device=self.device).manual_seed(0)
        )
        self._watch_cfg = monitor.WatchdogConfig(
            sweeps_per_round=config.sweeps_per_tick,
            tol=config.watch_tol,
            max_rounds=config.rounds_per_tick,
        )
        # queues (host-side; bounded by admission control)
        self._queries: deque = deque()  # (id, xq np, t_submit)
        self._pending_rows = 0
        self._arrivals: deque = deque()  # (field, sensor, x, y)
        self._events: deque = deque()  # ("join", x, ys, lam) | ("leave", s)
        # stats / receipts
        self._next_id = 0
        self.tick_count = 0
        self.served = 0
        self.shed = 0
        self.degraded = False
        self.last_tick: TickReceipt | None = None
        self.last_split: dict | None = None
        self.buckets_hit: set = set()  # padded dispatch sizes
        self._ema_batch_s: float | None = None
        # initial publish: version 0 serves the (possibly restored) state
        self._snap = self._make_snapshot(0, problem, state, self._plan)

    # -- snapshot plumbing -------------------------------------------------

    def _make_snapshot(self, version, problem, state, plan) -> Snapshot:
        ecoef = effective_coef(problem, state)  # a new tensor, never an alias
        keep = None
        pruned = 0
        if self._energy_tau > 0.0:
            # re-pruned on every publish: fresh coefficients move energies
            keep = pruning.prune_mask(problem, ecoef=ecoef, energy_tau=self._energy_tau)
            n = problem.n
            pruned = int((problem.alive[:n] != 0).sum() - keep[:n].sum())  # the host read
        _sync(self.device)  # publish complete tensors only
        return Snapshot(
            version, problem, state, plan, ecoef,
            serve_dtype=self.config.serve_dtype, keep=keep, pruned=pruned,
        )

    def set_energy_tau(self, tau: float) -> None:
        """Change the pruning threshold; takes effect at the next publish."""
        self._energy_tau = float(tau)

    @property
    def snapshot(self) -> Snapshot:
        """The currently published snapshot (never written; safe to hold)."""
        return self._snap

    # -- query path --------------------------------------------------------

    def submit(self, xq, now: float | None = None) -> QueryTicket:
        """Enqueue a query grid (q, d); sheds instead of queueing unbounded.

        A request is rejected when the queue is at ``queue_rows`` capacity,
        or when the estimated wait (pending dispatches times the EMA
        dispatch latency) exceeds ``deadline_ms``.
        """
        now = time.perf_counter() if now is None else now
        xq = np.atleast_2d(np.asarray(xq))
        qid = self._next_id
        self._next_id += 1
        rows = xq.shape[0]
        cfg = self.config
        if self._pending_rows + rows > cfg.queue_rows:
            self.shed += 1
            return QueryTicket(qid, False, "queue_full")
        if self._ema_batch_s is not None and np.isfinite(cfg.deadline_ms):
            batches_ahead = 1 + self._pending_rows // cfg.max_batch_rows
            est_wait_ms = batches_ahead * self._ema_batch_s * 1e3
            if est_wait_ms > cfg.deadline_ms:
                self.shed += 1
                return QueryTicket(qid, False, "deadline")
        self._queries.append((qid, xq, now))
        self._pending_rows += rows
        return QueryTicket(qid, True)

    def dispatch(self, snap: Snapshot, xq) -> torch.Tensor:
        """(B, Q) kNN answers of ``snap`` at ``xq`` with the serving engine."""
        return fusion.fuse(
            snap.problem, snap.state, xq, "knn", k=self.config.k,
            engine=self.config.engine, plan=snap.plan, ecoef=snap.ecoef,
            compute_dtype=self._compute_dtype, prune=snap.keep,
        )

    def pump(self) -> list[QueryAnswer]:
        """Drain the query queue against the published snapshot.

        Requests coalesce front to back into dispatches of at most
        ``max_batch_rows`` rows; each dispatch pads its rows to the
        power-of-two bucket (``bucket_rows``) with copies of its last row,
        sliced off after.  Every dispatch reads one snapshot.
        """
        answers: list[QueryAnswer] = []
        while self._queries:
            snap = self._snap  # one snapshot per dispatch
            batch = [self._queries.popleft()]
            rows = batch[0][1].shape[0]
            while (
                self._queries
                and rows + self._queries[0][1].shape[0] <= self.config.max_batch_rows
            ):
                nxt = self._queries.popleft()
                batch.append(nxt)
                rows += nxt[1].shape[0]
            self._pending_rows -= rows
            xq = np.concatenate([b[1] for b in batch], axis=0)
            q_pad = bucket_rows(rows)
            if q_pad > rows:  # padded rows are sliced off below: exact
                xq = np.concatenate([xq, np.repeat(xq[-1:], q_pad - rows, axis=0)], axis=0)
            self.buckets_hit.add(q_pad)
            t0 = time.perf_counter()
            vals = self.dispatch(snap, xq).cpu().numpy()  # the dispatch's host read
            done = time.perf_counter()
            dt = done - t0
            self._ema_batch_s = dt if self._ema_batch_s is None else (
                0.8 * self._ema_batch_s + 0.2 * dt
            )
            off = 0
            for qid, grid, t_submit in batch:
                q = grid.shape[0]
                answers.append(QueryAnswer(
                    id=qid,
                    values=vals[:, off:off + q],
                    version=snap.version,
                    degraded=self.degraded,
                    latency_s=done - t_submit,
                ))
                off += q
            self.served += len(batch)
        return answers

    # -- trainer-side inputs -----------------------------------------------

    def offer_arrivals(self, fields, sensors, xs, ys) -> None:
        """Queue measurement arrivals for the next training ticks."""
        fields = np.asarray(fields).reshape(-1)
        sensors = np.asarray(sensors).reshape(-1)
        xs = np.atleast_2d(np.asarray(xs))
        ys = np.asarray(ys).reshape(-1)
        for f, s, x, y in zip(fields, sensors, xs, ys):
            self._arrivals.append((int(f), int(s), x, float(y)))

    def offer_join(self, x, ys, lam: float) -> None:
        """Queue a sensor join (position x, per-field targets ys)."""
        self._events.append(("join", np.asarray(x), np.asarray(ys), lam))

    def offer_leave(self, slot: int) -> None:
        """Queue a sensor leave by row slot."""
        self._events.append(("leave", int(slot)))

    def set_fault_model(self, model: faults_mod.FaultModel) -> None:
        """Swap the training fault process (degraded-mode drills).

        Rates are tensor operands, so a drill changes values only.  The
        crash structure is fixed: a crash model runs another sweep path.
        """
        if model.has_crash != self._model.has_crash:
            raise ValueError(
                "crash-model structure is static (it runs another sweep path); "
                "construct the daemon with the crash model"
            )
        self._model = model

    # -- training tick -----------------------------------------------------

    def _apply_events(self, problem, state, plan):
        joins = leaves = 0
        while self._events:
            ev = self._events.popleft()
            if ev[0] == "join":
                _, x, ys, lam = ev
                problem, state, rcpt = streaming.add_sensor(
                    problem, state, x, ys, lam=lam, donate=False,
                )
                if bool(rcpt.joined):
                    plan, _ = plan_add_sensor(plan, x, rcpt.slot)
                    joins += 1
            else:
                _, slot = ev
                problem, state, ok = streaming.remove_sensor(problem, state, slot, donate=False)
                plan = plan_remove_sensor(plan, slot)
                leaves += int(bool(ok))
        return problem, state, plan, joins, leaves

    def _absorb_pending(self, problem, state):
        """Drain queued arrivals in windows of at most ``arrival_rows``.

        Full windows run at exactly ``arrival_rows``; the final partial
        window pads to its power-of-two bucket with sentinel-row no-op
        arrivals (``streaming.pad_arrivals``, a bitwise no-op).
        """
        absorbed = dropped = 0
        w = self.config.arrival_rows
        while self._arrivals:
            take = min(len(self._arrivals), w)
            window = [self._arrivals.popleft() for _ in range(take)]
            fs = np.array([a[0] for a in window], np.int32)
            ss = np.array([a[1] for a in window], np.int32)
            xs = np.stack([a[2] for a in window])
            ys = np.array([a[3] for a in window])
            a_pad = take if take == w else min(bucket_rows(take), w)
            fs, ss, xs, ys, real = streaming.pad_arrivals(problem, fs, ss, xs, ys, a_pad)
            # donate=False always: right after a publish (or a rollback) the
            # working pair aliases the published snapshot's tensors
            problem, state, rec = streaming.absorb_many(
                problem, state, fs, ss, xs, ys, donate=False, on_full=self.config.on_full,
            )
            ok = rec.absorbed[real].cpu().numpy()
            absorbed += int(ok.sum())
            dropped += int((~ok).sum())
        return problem, state, absorbed, dropped

    def tick(self) -> TickReceipt:
        """One supervised training advance; publishes when healthy.

        Order: churn events -> arrival absorbs -> ``watch_sweeps`` under the
        current fault model.  A healthy tick publishes a fresh snapshot and
        checkpoints it every ``ckpt_every`` ticks.  A tick whose watchdog
        rolled back restores the working copy from the published snapshot
        and loses this tick's inputs (counted); a diverged tick keeps its
        working state but does not publish.  Either marks the daemon
        degraded.
        """
        cfg = self.config
        clock = [time.perf_counter()]
        lap = lambda: clock.append(time.perf_counter())  # noqa: E731
        problem, state = self._work
        plan = self._plan
        problem, state, plan, joins, leaves = self._apply_events(problem, state, plan)
        lap()
        problem, state, absorbed, arrival_drops = self._absorb_pending(problem, state)
        lap()
        problem, state, receipt = monitor.watch_sweeps(
            problem, state, model=self._model, generator=self._gen,
            engine=cfg.train_engine, config=self._watch_cfg,
        )
        lap()
        self.tick_count += 1
        arrivals_rolled_back = 0
        ckpt_step = None
        if receipt.rolled_back:
            # watch_sweeps restored its (post-absorb) entry state, which is
            # what diverged: fall back to the last published snapshot
            snap = self._snap
            problem, state, plan = snap.problem, snap.state, snap.plan
            arrivals_rolled_back = absorbed
            absorbed = 0
            joins = leaves = 0
            self.degraded = True
            published = False
            lap()
        elif bool(np.asarray(receipt.diverged).any()):
            self.degraded = True  # keep training state; serve last good
            published = False
            lap()
        else:
            self.degraded = False
            published = True
            self._snap = self._make_snapshot(self._snap.version + 1, problem, state, plan)
            lap()
            if cfg.ckpt_every and cfg.snapshot_dir is not None and (
                self.tick_count % cfg.ckpt_every == 0
            ):
                ckpt.save_train(cfg.snapshot_dir, self.tick_count, problem, state)
                ckpt_step = self.tick_count
        lap()
        self._work = (problem, state)
        self._plan = plan
        parts = ("events", "absorb", "watchdog", "publish", "ckpt")
        self.last_split = {f"{name}_ms": (clock[i + 1] - clock[i]) * 1e3
                           for i, name in enumerate(parts)}
        self.last_tick = TickReceipt(
            tick=self.tick_count,
            published=published,
            degraded=self.degraded,
            version=self._snap.version,
            absorbed=absorbed,
            arrival_drops=arrival_drops,
            arrivals_rolled_back=arrivals_rolled_back,
            joins=joins,
            leaves=leaves,
            watchdog=receipt,
            ckpt_step=ckpt_step,
        )
        return self.last_tick

    # -- health ------------------------------------------------------------

    def health(self) -> dict:
        """Machine-readable health endpoint (plain-JSON types only)."""
        t = self.last_tick
        return {
            "schema": "daemon_health/1",
            "version": int(self._snap.version),
            "degraded": bool(self.degraded),
            "ticks": int(self.tick_count),
            "served": int(self.served),
            "shed": int(self.shed),
            "queue_rows": int(self._pending_rows),
            "queued_arrivals": len(self._arrivals),
            "restored_step": self.restored_step,
            "serve_dtype": self.config.serve_dtype,
            "energy_tau": float(self._energy_tau),
            "pruned": int(self._snap.pruned),
            "last_tick": None if t is None else {
                "tick": t.tick,
                "published": t.published,
                "absorbed": t.absorbed,
                "arrival_drops": t.arrival_drops,
                "arrivals_rolled_back": t.arrivals_rolled_back,
                "joins": t.joins,
                "leaves": t.leaves,
                "ckpt_step": t.ckpt_step,
                "watchdog": t.watchdog.to_json(),
            },
        }

    def state_digest(self) -> str:
        """sha256 of the PUBLISHED snapshot's leaves (bitwise identity)."""
        return _state_digest(self._snap.problem, self._snap.state)


# ---------------------------------------------------------------------------
# CLI: the long-lived process (and the kill / warm-restart smoke)
# ---------------------------------------------------------------------------


def _build_problem(args):
    """Deterministic problem build shared by cold start and warm restart.

    Everything derives from ``--seed``; a restarted process rebuilds the
    same shapes and statics as templates and ``checkpoint.restore_train``
    replaces the tensors bitwise.
    """
    from ..core import Kernel, build_topology, init_state, make_batch_problem, uniform_sensors

    dev = _device.resolve(args.device)
    rng = np.random.default_rng(args.seed)
    pos = uniform_sensors(args.sensors, seed=args.seed)
    freq = rng.uniform(0.5, 2.0, size=(args.fields, 1))
    phase = rng.uniform(0, 2 * np.pi, size=(args.fields, 1))
    ys = (
        np.sin(np.pi * freq * pos[None, :, 0] + phase)
        + 0.1 * rng.normal(size=(args.fields, args.sensors))
    ).astype(np.float32)
    topo = build_topology(pos, args.radius, device=dev)
    per_sensor = -(-max(args.arrivals_per_tick, 1) // args.sensors) + 4
    deg_max = int(topo.degrees.max()) + per_sensor
    topo = build_topology(pos, args.radius, d_max=deg_max, device=dev)
    prob = make_batch_problem(
        topo, Kernel("rbf", gamma=args.gamma), ys,
        np.full((args.sensors,), args.lam, np.float32), device=dev,
    )
    return pos, prob, init_state(prob), rng


def _probe_grid(args):
    return np.linspace(-0.9, 0.9, args.probe_points)[:, None].astype(np.float32)


def parser():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--fields", type=int, default=4)
    ap.add_argument("--sensors", type=int, default=40)
    ap.add_argument("--radius", type=float, default=0.5)
    ap.add_argument("--gamma", type=float, default=1.0)
    ap.add_argument("--lam", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--engine", default="cuda", choices=["plan", "cuda"],
                    help="serving engine: cuda (the knn_fuse kernel) or plan")
    ap.add_argument("--serve-dtype", default="f32", choices=["f32", "bf16"],
                    help="anchor-table storage dtype (bf16 rounds stored anchors only; "
                         "selection and accumulation stay full precision)")
    ap.add_argument("--energy-tau", type=float, default=0.0,
                    help="representer-pruning energy threshold, re-derived per publish "
                         "(0 = off)")
    ap.add_argument("--ticks", type=int, default=10,
                    help="training ticks to run (0: restart-verify only)")
    ap.add_argument("--queries-per-tick", type=int, default=2)
    ap.add_argument("--query-rows", type=int, default=48)
    ap.add_argument("--arrivals-per-tick", type=int, default=8)
    ap.add_argument("--sweeps-per-tick", type=int, default=5)
    ap.add_argument("--snapshot-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--faults", default="",
                    help="fault spec for training ticks (core.faults syntax, e.g. drop=0.1)")
    ap.add_argument("--probe-points", type=int, default=32)
    ap.add_argument("--tick-sleep", type=float, default=0.0,
                    help="seconds to sleep between ticks (makes a mid-run SIGKILL land "
                         "mid-stream)")
    ap.add_argument("--verify-restart", action="store_true",
                    help="after warm restart, assert the restored snapshot matches the "
                         "last checkpoint's probe answers and state digest bitwise, then "
                         "exit")
    return ap


def main(argv=None):
    import json
    import os

    args = parser().parse_args(argv)
    pos, prob, state, rng = _build_problem(args)
    cfg = DaemonConfig(
        k=args.k, engine=args.engine,
        sweeps_per_tick=args.sweeps_per_tick,
        ckpt_every=args.ckpt_every, snapshot_dir=args.snapshot_dir,
        serve_dtype=args.serve_dtype, energy_tau=args.energy_tau,
    )
    model = (
        faults_mod.parse_fault_spec(args.faults, dtype=state.z.dtype, device=prob.device)
        if args.faults else None
    )
    if model is not None and model.has_crash:
        d = Daemon(prob, state, config=cfg, fault_model=model)
    else:
        d = Daemon(prob, state, config=cfg)
        if model is not None:
            d.set_fault_model(model)
    if d.restored_step is not None:
        print(f"warm restart: restored step {d.restored_step} from {args.snapshot_dir}")

    probe = _probe_grid(args)

    def probe_answers():
        return d.dispatch(d.snapshot, probe).cpu().numpy()

    if args.verify_restart:
        if d.restored_step is None:
            raise SystemExit("--verify-restart: no intact checkpoint found")
        path = os.path.join(args.snapshot_dir, f"probe_{d.restored_step:08d}.npz")
        ref = np.load(path)
        assert ref["digest"] == d.state_digest(), "restored state digest mismatch (not bitwise)"
        got = probe_answers()
        assert np.array_equal(got, ref["answers"]), (
            "served probe answers differ from the pre-kill snapshot"
        )
        print(f"warm restart verified: step {d.restored_step} bitwise "
              f"(digest + {probe.shape[0]}-point probe answers)")
        return d

    for _ in range(args.ticks):
        for _ in range(args.queries_per_tick):
            q = int(rng.integers(1, args.query_rows + 1))
            d.submit(rng.uniform(-0.9, 0.9, size=(q, pos.shape[1])).astype(np.float32))
        a = args.arrivals_per_tick
        if a:
            ss = rng.integers(0, args.sensors, size=a)
            d.offer_arrivals(
                rng.integers(0, args.fields, size=a), ss,
                (pos[ss] + 0.05 * rng.normal(size=(a, pos.shape[1]))).astype(np.float32),
                rng.normal(size=a).astype(np.float32),
            )
        d.pump()
        rcpt = d.tick()
        if rcpt.ckpt_step is not None and args.snapshot_dir:
            # the probe file rides next to the checkpoint: the restart smoke
            # compares restored serving output against it bitwise
            np.savez(
                os.path.join(args.snapshot_dir, f"probe_{rcpt.ckpt_step:08d}.npz"),
                answers=probe_answers(),
                digest=np.asarray(d.state_digest()),
            )
        print(json.dumps(d.health()), flush=True)
        if args.tick_sleep:
            time.sleep(args.tick_sleep)
    return d


if __name__ == "__main__":
    main()
