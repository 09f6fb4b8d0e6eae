"""The canonical problem and the one registry of audited entry points.

Every auditor reads its view of :func:`registry`:

  ``ast_lint.SYNC_FREE``   the targets of the entries with a ``card`` call;
  ``sync_audit``           each ``card`` call on the card tensors of
                           :func:`card_inputs`, under the "error" sync mode;
  ``dtype_audit``          each ``call`` with ``"dtype"`` in its checks;
  ``alive_audit``          each ``call`` with ``"alive"`` in its checks;
  ``launch_ledger``        each entry's ``launches`` per ``per`` unit, and
                           its self-check that every ``target`` resolves.

The names are the reference's (``repro.analysis.jaxpr_audit.
default_entries``), so the two packages' finding keys compare one to one;
the port's ``cuda`` engine stands where the reference names ``pallas``.
Where only the reference's compile ledger names an entry, its name is
kept without the donate/copy variants (the port builds no program per
donation).  The reference's ``sweep.sharded.plan`` needs a process group
and is not run here (``tests/test_torch_sharded.py`` holds it against
``colored_sweep``).

An entry's ``call(fx, alive)`` runs it with the (n+1,) row liveness
``alive`` in place of the problem's (None: the problem's own); the
sensor-level robust sweep takes it as its alive trace instead.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import types
from collections.abc import Callable

import numpy as np
import torch

from .. import device as _device

# the runtime checks that apply to an entry's ``call``
SWEEP = ("dtype", "alive", "alive-scatter")
STREAM = ("dtype", "alive")
STATIC = ("dtype",)

# the unit that an entry's ``launches`` count
PER_CALL, PER_SWEEP, PER_LAYER = "call", "sweep", "layer"
UNITS = (PER_CALL, PER_SWEEP, PER_LAYER)


@dataclasses.dataclass(frozen=True)
class Fixture:
    """A trained batched problem and its single-field view, a serving plan
    and queries; arrivals already occupy a few stream lanes."""

    prob: object
    state: object
    sprob: object
    sstate: object
    plan: object
    xq: torch.Tensor
    dtype: torch.dtype
    device: torch.device


def canonical(dtype=torch.float32, device="cuda", *, n: int = 12, b: int = 2,
              spares: int = 2, headroom: int = 3) -> Fixture:
    """The canonical problem: n sensors on [-1, 1] (d = 1) from seed 0, B
    fields, spare rows for joins, ``headroom`` stream lanes, forgetting
    factor 0.9; trained 2 colored sweeps, with arrivals absorbed at every
    third sensor."""
    from ..core import (Kernel, absorb_wave, build_topology, colored_sweep, init_state,
                        make_batch_problem, make_problem, make_serving_plan, uniform_sensors)

    dev = _device.resolve(device)
    pos = uniform_sensors(n, seed=0)
    rng = np.random.default_rng(1)
    ys = (np.sin(np.pi * pos[None, :, 0] * np.linspace(1.0, 1.7, b)[:, None])
          + 0.1 * rng.normal(size=(b, n)))
    topo = build_topology(pos, 0.7, device="cpu")
    d_max = int(topo.degrees.max()) + headroom
    topo = build_topology(pos, 0.7, d_max=d_max, n_max=n + spares, device=dev)
    kern = Kernel("rbf", gamma=1.0)
    lam = np.full((n,), 0.1)
    prob = make_batch_problem(topo, kern, ys, lam, dtype=dtype, beta=0.9, device=dev)
    sprob = make_problem(topo, kern, ys[0], lam, dtype=dtype, device=dev)
    state = colored_sweep(prob, init_state(prob), n_sweeps=2)
    sstate = colored_sweep(sprob, init_state(sprob), n_sweeps=2)
    xs = torch.as_tensor(rng.uniform(-0.9, 0.9, size=(b, prob.n, 1)), dtype=dtype, device=dev)
    ys_new = torch.as_tensor(rng.normal(size=(b, prob.n)), dtype=dtype, device=dev)
    mask = torch.zeros((b, prob.n), dtype=torch.bool, device=dev)
    mask[:, 0:n:3] = True
    prob, state, _ = absorb_wave(prob, state, xs, ys_new, mask=mask, donate=True)
    return Fixture(
        prob=prob, state=state, sprob=sprob, sstate=sstate,
        plan=make_serving_plan(prob, k=2),
        xq=torch.as_tensor(rng.uniform(-0.9, 0.9, size=(8, 1)), dtype=dtype, device=dev),
        dtype=dtype, device=dev,
    )


@dataclasses.dataclass(frozen=True)
class Entry:
    """One audited entry point.

    target:  ``"module:function"`` under ``repro_torch`` (``"core.streaming:
             absorb"``), the function whose contract the entry registers.
    call:    (fixture, alive or None) -> outputs, for the dtype and liveness
             auditors; None: they do not run it.
    checks:  which of those rules apply ("dtype", "alive", "alive-scatter").
    row:     the live row the liveness checks kill.
    single:  whether ``call`` runs on the single-field view.
    allow_dtypes: dtype names exempt from the dtype rules (storage casts).
    card:    (card inputs) -> outputs, every value argument a card tensor
             (:func:`card_inputs`).  An entry with one claims that its
             target makes no host sync: the AST rule reads the target's
             source and the host-sync auditor runs this call.
    launches: ((kernel, n), ...): one ``per`` unit launches n of the kernel
             (none: plain PyTorch, no launch).
    """

    name: str
    target: str
    call: Callable | None = None
    checks: tuple[str, ...] = STATIC
    row: int | Callable = 3
    single: bool = False
    allow_dtypes: frozenset = frozenset()
    card: Callable | None = None
    launches: tuple[tuple[str, int], ...] = ()
    per: str = PER_CALL

    @property
    def path(self) -> str:
        """The target's file under ``src/repro_torch`` (``core/streaming.py``)."""
        return self.target.partition(":")[0].replace(".", "/") + ".py"

    @property
    def function(self) -> str:
        return self.target.partition(":")[2]

    def resolve(self):
        mod, _, attr = self.target.partition(":")
        return getattr(importlib.import_module(f"repro_torch.{mod}"), attr)


def with_alive(problem, alive):
    return problem if alive is None else dataclasses.replace(problem, alive=alive)


@functools.cache
def registry() -> tuple[Entry, ...]:
    """Every registered entry point, once."""
    from ..core import faults, fusion, monitor, pruning, serving, sn_train, streaming
    from ..kernels import color_step, gram, kernel_matvec, knn_fuse, ops, ssd_intra

    E = Entry
    one_step, one_knn = (("color_step", 1),), (("knn_fuse", 1),)

    def gen(fx):
        return torch.Generator(device=fx.device).manual_seed(0)

    def batch(fn):
        return lambda fx, alive: fn(fx, with_alive(fx.prob, alive))

    def single(fn):
        return lambda fx, alive: fn(fx, with_alive(fx.sprob, alive))

    # --- training sweeps: every sweep and color of a call is one launch
    sw = "core.sn_train:"
    entries = [
        E("sweep.serial", sw + "serial_sweep",
          batch(lambda fx, p: sn_train.serial_sweep(p, fx.state, 2)), SWEEP),
    ]
    for engine in ("plan", "onehot"):
        entries.append(E(f"sweep.colored.{engine}", sw + "colored_sweep", batch(
            lambda fx, p, e=engine: sn_train.colored_sweep(p, fx.state, 2, engine=e)), SWEEP))
    entries += [
        E("sweep.colored.cuda", sw + "colored_sweep", batch(
            lambda fx, p: sn_train.colored_sweep(p, fx.state, 2, engine="cuda")), SWEEP,
          card=lambda c: sn_train.colored_sweep(c.p, c.st, 2, engine="cuda"),
          launches=one_step),
        E("sweep.random", sw + "random_sweep", single(
            lambda fx, p: sn_train.random_sweep(p, fx.sstate, gen(fx), 2)), SWEEP, single=True),
        E("sweep.weighted", sw + "weighted_sweep", single(lambda fx, p: sn_train.weighted_sweep(
            p, fx.sstate, torch.full((p.n,), 2.0, dtype=fx.dtype, device=fx.device), 2)),
          SWEEP, single=True),
        E("sweep.robust", sw + "robust_sweep", lambda fx, alive: sn_train.robust_sweep(
            fx.prob, fx.state, _trace(fx.prob, alive, 2), 2, engine="plan"), SWEEP),
        # refactors per sweep, then one launch per sweep
        E("sweep.robust.cuda", sw + "robust_sweep",
          card=lambda c: sn_train.robust_sweep(c.p, c.st, c.trace, 2, engine="cuda"),
          launches=one_step, per=PER_SWEEP),
        E("sweep.robust_links", sw + "robust_sweep_links", single(
            lambda fx, p: sn_train.robust_sweep_links(
                p, fx.sstate, torch.ones((2,) + tuple(p.nbr_idx[:-1].shape), dtype=torch.bool,
                                         device=fx.device), 2)), SWEEP, single=True),
        # batched problems: each rank's fields in one launch; single-field
        # problems (the sensor regime): the plan transport only
        E("sweep.sharded.fields.cuda", sw + "sharded_sweep", launches=one_step),
        E("sweep.sharded.sensors", sw + "sharded_sweep"),
    ]

    # --- fault-injected sweeps: rates are tensors; crash-free models launch
    # once per call, crashing ones run robust_sweep's path, once per sweep
    def faulty(engine, crash):
        def run(fx, p):
            model = faults.make_fault_model(0.1, burst=(0.05, 0.5, 0.3), crash=crash,
                                            dtype=fx.dtype, device=fx.device)
            return faults.faulty_sweep(p, fx.state, model, gen(fx), 2, engine=engine)
        return batch(run)

    fs = "core.faults:faulty_sweep"
    entries += [E(f"faults.{engine}", fs, faulty(engine, None), SWEEP)
                for engine in ("plan", "serial")]
    entries += [
        E("faults.cuda", fs, faulty("cuda", None), SWEEP,
          card=lambda c: faults.faulty_sweep(c.p, c.st, c.drop, c.gen, 2, engine="cuda"),
          launches=one_step),
        E("faults.crash", fs, faulty("plan", (0.1, 0.5)), SWEEP),
        E("faults.crash.cuda", fs,
          card=lambda c: faults.faulty_sweep(c.p, c.st, c.crash, c.gen, 2, engine="cuda"),
          launches=one_step, per=PER_SWEEP),
        E("faults.sample", "core.faults:sample_faults",
          card=lambda c: faults.sample_faults(c.crash, c.gen, 2, c.p)),
    ]

    # --- streaming and the lifecycle: plain PyTorch
    def x1(fx, v):
        return torch.full((1,), v, dtype=fx.dtype, device=fx.device)

    st = "core.streaming:"
    entries += [
        E("stream.absorb", st + "absorb", batch(lambda fx, p: streaming.absorb(
            p, fx.state, 0, 3, fx.xq[0], x1(fx, 0.3)[0])), STREAM,
          card=lambda c: streaming.absorb(c.p, c.st, c.f0, c.s3, c.xs[0], c.ys[0],
                                          on_full="evict")),
        E("stream.absorb_many", st + "absorb_many", batch(lambda fx, p: streaming.absorb_many(
            p, fx.state, torch.zeros(3, dtype=torch.long, device=fx.device),
            torch.arange(3, device=fx.device), fx.xq[:1].expand(3, -1),
            torch.full((3,), 0.2, dtype=fx.dtype, device=fx.device))), STREAM, row=0,
          card=lambda c: streaming.absorb_many(c.p, c.st, c.fields, c.sensors, c.xs,
                                               c.xs[:, 0], on_full="evict")),
        E("stream.wave", st + "absorb_wave", card=lambda c: streaming.absorb_wave(
            c.p, c.st, c.wave_x, c.wave_y, mask=c.wave_m, on_full="evict")),
        E("stream.add_sensor", st + "add_sensor", batch(lambda fx, p: streaming.add_sensor(
            p, fx.state, x1(fx, 0.05), torch.full((p.batch_size,), 0.1, dtype=fx.dtype,
                                                 device=fx.device), lam=0.1)),
          STREAM, row=_nearest_row(0.05),
          card=lambda c: streaming.add_sensor(c.p, c.st, c.x1, c.ys, lam=c.lam)),
        E("stream.remove_sensor", st + "remove_sensor", batch(
            lambda fx, p: streaming.remove_sensor(p, fx.state, 2)), STREAM, row=2,
          card=lambda c: streaming.remove_sensor(c.p, c.st, c.slot2)),
        E("stream.evict_oldest", st + "evict_oldest", batch(
            lambda fx, p: streaming.evict_oldest(p, fx.state, 0, 3)), STREAM,
          card=lambda c: streaming.evict_oldest(c.p, c.st, c.f0, c.s3)),
    ]

    # --- serving
    def fuse(engine, compute_dtype=None):
        def run(fx, p):
            return fusion.fuse(p, fx.state, fx.xq, "knn", k=2, engine=engine,
                               plan=None if engine == "dense" else fx.plan,
                               compute_dtype=compute_dtype)
        return batch(run)

    sv, knn_row = "core.serving:", _nearest_row(None)
    entries += [
        E("serving.knn.plan", sv + "knn_fuse", fuse("plan"), STREAM, row=knn_row),
        E("serving.knn.cuda", sv + "knn_fuse", fuse("cuda"), STREAM, row=knn_row,
          card=lambda c: serving.knn_fuse(c.p, c.st, c.xq, 2, plan=c.plan, engine="cuda"),
          launches=one_knn),
        E("serving.knn.quant", sv + "knn_fuse", fuse("cuda", "bfloat16"), STREAM, row=knn_row,
          allow_dtypes=frozenset({"bfloat16"}), launches=one_knn),
        E("fusion.dense", "core.fusion:fuse", fuse("dense"), STREAM, row=knn_row),
        E("serving.select", sv + "knn_select_valid", card=lambda c: serving.knn_select_valid(
            c.plan, c.positions, c.xq, 2, c.p.alive)),
        E("serving.eval", sv + "_eval_selected", card=lambda c: serving._eval_selected(
            c.p.kernel, c.p.nbr_pos, c.p.nbr_mask, c.ecoef, c.sel, c.valid, c.xq, 2)),
        # sweeping tau launches nothing
        E("pruning.keep", "core.pruning:prune_mask", batch(lambda fx, p: pruning.prune_mask(
            p, fx.state, energy_tau=torch.tensor(0.05, dtype=fx.dtype, device=fx.device))),
          STREAM, card=lambda c: pruning.prune_mask(c.p, c.st, energy_tau=c.tau)),
        E("serving.plan_add", sv + "plan_add_sensor", lambda fx, alive: serving.plan_add_sensor(
            fx.plan, torch.full((1,), 0.05, dtype=fx.plan.centers.dtype, device=fx.device), 5),
          card=lambda c: serving.plan_add_sensor(c.plan, c.xp, c.last)),
        E("serving.plan_remove", sv + "plan_remove_sensor",
          lambda fx, alive: serving.plan_remove_sensor(fx.plan, 5),
          card=lambda c: serving.plan_remove_sensor(c.plan, c.slot2)),
        # the conn route, one launch per request; the kernel matvec computes
        # in float32 by contract, so on an f64 problem its input casts are
        # intentional
        E("kernels.matvec", "kernels.ops:kernel_matvec", lambda fx, alive: ops.kernel_matvec(
            fx.xq, torch.linspace(-1, 1, 10, dtype=fx.dtype, device=fx.device)[:, None],
            torch.full((10,), 0.1, dtype=fx.dtype, device=fx.device), gamma=1.0),
          allow_dtypes=frozenset({"float32"}), launches=(("kernel_matvec", 1),)),
        E("monitor.watchdog_step", "core.monitor:_round_metrics",
          lambda fx, alive: monitor._round_metrics(fx.prob, fx.state, fx.state)),
        # the LM path: one launch per SSM layer of a prefill (ssd_fused=True)
        E("lm.prefill.ssd", "kernels.ops:ssd_chunked_fused", launches=(("ssd_intra", 1),),
          per=PER_LAYER),
    ]

    # --- the kernel wrappers, one launch per call each
    entries += [
        E("kernels.color_sweep", "kernels.color_step:color_sweep",
          card=lambda c: color_step.color_sweep(*c.sweep_tables(), c.p.color_members,
                                                c.p.color_mask, None, 2),
          launches=one_step),
        E("kernels.color_step", "kernels.color_step:color_step",
          card=lambda c: color_step.color_step(*c.sweep_tables(), c.p.color_members[0],
                                               c.p.color_mask[0]),
          launches=one_step),
        E("kernels.knn_fuse_fused", "kernels.knn_fuse:knn_fuse_fused",
          card=lambda c: knn_fuse.knn_fuse_fused(
              c.xq, c.qcell, c.plan.cells, c.plan.cell_mask, c.pos_pad, c.p.nbr_pos,
              c.p.nbr_mask, c.ecoef, alive=c.p.alive, gamma=c.p.kernel.gamma, k=2),
          launches=one_knn),
        E("kernels.kernel_matvec_batched", "kernels.kernel_matvec:kernel_matvec_batched",
          card=lambda c: kernel_matvec.kernel_matvec_batched(
              c.xq, c.positions, c.ecoef[:, :c.n, 0].contiguous(), gamma=1.0),
          launches=(("kernel_matvec", 1),)),
        E("kernels.ssd_intra", "kernels.ssd_intra:ssd_intra",
          card=lambda c: ssd_intra.ssd_intra(*c.ssd, chunk=4), launches=(("ssd_intra", 1),)),
        E("kernels.rbf_gram", "kernels.gram:rbf_gram",
          card=lambda c: gram.rbf_gram(c.xq, c.positions, gamma=1.0),
          launches=(("rbf_gram", 1),)),
    ]
    return tuple(entries)


def by_name() -> dict[str, Entry]:
    return {e.name: e for e in registry()}


def card_inputs(fx) -> types.SimpleNamespace:
    """The ``card`` calls' arguments, every value already a tensor on the
    fixture's device: no host value is copied in the audited call."""
    from ..core import faults, serving
    from ..core.sn_train import effective_coef

    p, st, plan, dev, dt = fx.prob, fx.state, fx.plan, fx.device, fx.dtype
    t = lambda v, dtype=torch.long: torch.tensor(v, dtype=dtype, device=dev)  # noqa: E731
    b, n = p.batch_size, p.n
    c = types.SimpleNamespace(p=p, st=st, plan=plan, xq=fx.xq, n=n)
    c.gen = torch.Generator(device=dev).manual_seed(0)
    c.drop = faults.make_fault_model(0.1, burst=(0.05, 0.5, 0.3), dtype=dt, device=dev)
    c.crash = faults.make_fault_model(0.1, crash=(0.1, 0.5), dtype=dt, device=dev)
    c.x1 = t([0.05], dt)
    c.xp = c.x1.to(plan.centers.dtype)
    c.ys = t([0.1] * b, dt)
    c.f0, c.s3, c.slot2, c.last = t(0), t(3), t(2), t(n - 1)
    c.lam, c.tau = t(0.1, dt), t(0.05, dt)
    c.xs = fx.xq[:4]
    c.fields, c.sensors = t([0, 1, 0, 1]), t([3, 3, 6, 9])
    c.wave_x = fx.xq[:1, None].expand(b, n, 1).contiguous()
    c.wave_y = torch.zeros((b, n), dtype=dt, device=dev)
    c.wave_m = torch.zeros((b, n), dtype=torch.bool, device=dev)
    c.wave_m[:, ::5] = True
    c.trace = torch.ones((2, n), dtype=torch.bool, device=dev)
    c.trace[1, 4] = False
    c.positions = p.topology.positions.to(dt)
    c.sel, c.valid = serving.knn_select_valid(plan, c.positions, fx.xq, 2, p.alive)
    c.ecoef = effective_coef(p, st)
    c.qcell = serving.query_cells(plan, fx.xq)
    c.pos_pad = torch.cat([c.positions, c.positions.new_zeros((1, c.positions.shape[1]))])
    g = torch.Generator(device=dev).manual_seed(1)
    r = lambda *shape: torch.randn(shape, generator=g, device=dev)  # noqa: E731
    c.ssd = (r(1, 8, 2, 4), r(1, 8, 2).abs(), -r(1, 8, 2).abs().cumsum(1), r(1, 8, 3),
             r(1, 8, 3))
    c.sweep_tables = lambda: (st.z.clone(), st.coef.clone(), p.nbr_idx, p.nbr_mask, p.gram,
                              p.chol, p.lam_pad, p.alive, p.alive_z)
    return c


def _trace(problem, alive, n_sweeps):
    """A sensor-level (n_sweeps, n) alive trace from an (n+1,) row mask."""
    if alive is None:
        alive = problem.alive
    return alive[: problem.n][None].expand(n_sweeps, problem.n)


def _nearest_row(x):
    """The liveness checks' row for the serving entries: the live sensor
    nearest the first query (``x`` None) or nearest ``x``."""
    def pick(fx):
        pos = fx.prob.topology.positions[:, 0].to(torch.float64)
        alive = fx.prob.alive[: fx.prob.n]
        at = fx.xq[0, 0].to(torch.float64) if x is None else torch.tensor(x, dtype=torch.float64)
        d = torch.where(alive, (pos - at.to(pos.device)).abs(), float("inf"))
        return int(torch.argmin(d))
    return pick


def row_of(entry: Entry, fx: Fixture) -> int:
    return entry.row(fx) if callable(entry.row) else entry.row
