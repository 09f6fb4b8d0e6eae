"""The port's serving daemon (``repro_torch.launch.daemon``), on the CPU.

The reference's daemon cases (tests/test_daemon.py) inside the port:

  * any interleaving of request sizes drains through power-of-two buckets,
    every answer exact against the dense oracle, with no CUDA library built;
  * ``pad_arrivals`` is a bitwise no-op;
  * snapshot isolation: every tensor of every published snapshot (problem,
    state, plan, ``ecoef``, prune mask) stays bitwise equal (``torch.equal``
    to a copy taken at its publish) through later ticks with arrivals, a
    join, a leave, a fault drill and a forced rollback, and a held snapshot
    keeps serving its own answers bitwise;
  * admission control sheds with receipts;
  * a degraded tick serves last-good, then recovers;
  * churn events apply through ticks;
  * a fault drill and ``set_energy_tau`` change values only;
  * warm restart is bitwise;
  * health is JSON with the watchdog receipt.
"""

import dataclasses
import json
import tempfile

import numpy as np
import pytest
import torch
from _hypothesis_shim import given, settings, strategies as st

import repro_torch.core as tr
from repro_torch.checkpoint import ckpt
from repro_torch.core import faults, fusion, monitor, streaming
from repro_torch.kernels import _build
from repro_torch.kernels.ops import bucket_rows
from repro_torch.launch.daemon import Daemon, DaemonConfig

torch.set_num_threads(1)

CPU = "cpu"
KERN = tr.Kernel("rbf", gamma=1.0)


def _build_problem(n=24, b=3, seed=0, headroom=4, n_max=None):
    pos = tr.uniform_sensors(n, seed=seed)
    rng = np.random.default_rng(seed + 1)
    freq = rng.uniform(0.5, 2.0, size=(b, 1))
    ys = (np.sin(np.pi * freq * pos[None, :, 0]) + 0.2 * rng.normal(size=(b, n))).astype(
        np.float32)
    topo = tr.build_topology(pos, 0.6, device=CPU)
    d_max = int(topo.degrees.max()) + headroom
    topo = tr.build_topology(pos, 0.6, d_max=d_max, n_max=n_max, device=CPU)
    prob = tr.make_batch_problem(topo, KERN, ys, np.full((n,), 0.1, np.float32), device=CPU)
    return prob, tr.init_state(prob), pos, rng


def _offer(d, rng, pos, b, a):
    ss = rng.integers(0, len(pos), size=a)
    d.offer_arrivals(rng.integers(0, b, size=a), ss,
                     (pos[ss] + 0.02 * rng.normal(size=(a, 1))).astype(np.float32),
                     rng.normal(size=a).astype(np.float32))


_FIX = None
_BUCKETS_SEEN: set = set()


def _fix():
    global _FIX
    if _FIX is None:
        _FIX = _build_problem()
    return _FIX


@settings(deadline=None, max_examples=15)
@given(sizes=st.lists(st.integers(1, 60), min_size=1, max_size=12))
def test_any_interleaving_drains_through_buckets(sizes):
    prob, state, pos, _ = _fix()
    builds = _build.builds
    d = Daemon(prob, state, config=DaemonConfig(k=3, max_batch_rows=64))
    rng = np.random.default_rng(sum(sizes))
    grids = [rng.uniform(-0.9, 0.9, size=(q, 1)).astype(np.float32) for q in sizes]
    tickets = [d.submit(g) for g in grids]
    assert all(t.admitted for t in tickets)
    answers = {a.id: a for a in d.pump()}
    assert len(answers) == len(sizes) and d.served == len(sizes)
    _BUCKETS_SEEN.update(d.buckets_hit)
    for t, g in zip(tickets, grids):
        got = answers[t.id].values
        want = fusion.fuse(prob, state, g, "knn", k=3).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert all(b & (b - 1) == 0 and b <= bucket_rows(64) for b in _BUCKETS_SEEN)
    assert len(_BUCKETS_SEEN) <= int(np.log2(bucket_rows(64))) - 2  # 8 .. 64
    assert _build.builds == builds


def test_pad_arrivals_is_bitwise_noop():
    prob, state, pos, rng = _build_problem(seed=3)
    a = 5
    fs = rng.integers(0, 3, size=a).astype(np.int32)
    ss = rng.integers(0, prob.n, size=a).astype(np.int32)
    xs = (pos[ss] + 0.05 * rng.normal(size=(a, 1))).astype(np.float32)
    ys = rng.normal(size=a).astype(np.float32)
    p0, s0, r0 = streaming.absorb_many(prob, state, fs, ss, xs, ys)
    fp, sp, xp, yp, real = streaming.pad_arrivals(prob, fs, ss, xs, ys, 8)
    assert int(real.sum()) == a and real.shape == (8,)
    p1, s1, r1 = streaming.absorb_many(prob, state, fp, sp, xp, yp)
    for (_, l0), (_, l1) in zip(ckpt._items({"p": p0, "s": s0}), ckpt._items({"p": p1, "s": s1})):
        assert torch.equal(l0, l1)
    assert torch.equal(r0.absorbed, r1.absorbed[real])
    assert not bool(r1.absorbed[~real].any())  # padding rows never write
    with pytest.raises(ValueError):
        streaming.pad_arrivals(prob, fs, ss, xs, ys, a - 1)


def _snapshot_tensors(snap) -> dict:
    """Every tensor a published snapshot holds, by name."""
    out = {f"problem.{p}": t for p, t in ckpt._items(snap.problem)}
    out.update({f"state.{p}": t for p, t in ckpt._items(snap.state)})
    for f in dataclasses.fields(snap.plan):
        v = getattr(snap.plan, f.name)
        if isinstance(v, torch.Tensor):
            out[f"plan.{f.name}"] = v
    out["ecoef"] = snap.ecoef
    if snap.keep is not None:
        out["keep"] = snap.keep
    return out


def _assert_unchanged(held):
    for snap, copies in held:
        now = _snapshot_tensors(snap)
        assert now.keys() == copies.keys()
        for name, t in now.items():
            assert torch.equal(t, copies[name]), f"version {snap.version}: {name} was written"


def test_snapshot_isolation_across_ticks():
    """Every published snapshot stays bitwise as published through later
    ticks with arrivals, a join, a leave, a fault drill and a rollback."""
    prob, state, pos, rng = _build_problem(seed=4, n_max=28)
    plan = tr.make_serving_plan(prob, k=3, spare=4, slack=2)
    d = Daemon(prob, state, config=DaemonConfig(k=3, energy_tau=1e-3), plan=plan)
    held = []

    def hold():
        snap = d.snapshot
        if not held or held[-1][0] is not snap:
            held.append((snap, {k: v.clone() for k, v in _snapshot_tensors(snap).items()}))

    xq = rng.uniform(-0.9, 0.9, size=(16, 1)).astype(np.float32)
    hold()
    d.submit(xq)
    (a0,) = d.pump()
    assert a0.version == 0
    events = ["arrivals", "join", "leave", "drill", "rollback", "arrivals"]
    for ev in events:
        _offer(d, rng, pos, 3, 6)
        if ev == "join":
            d.offer_join(np.array([0.15], np.float32), np.zeros(3, np.float32), lam=0.1)
        elif ev == "leave":
            d.offer_leave(2)
        elif ev == "drill":
            d.set_fault_model(faults.make_fault_model(0.25, device=CPU))
        elif ev == "rollback":
            d.set_fault_model(faults.make_fault_model(0.0, device=CPU))
            # room for the whole ladder (retries, refactorization, rollback)
            d._watch_cfg = dataclasses.replace(d._watch_cfg, max_rounds=14)
            wp, ws = d._work
            z = ws.z.clone()
            z[0, 0] = float("nan")  # a poisoned copy; the snapshot's z is untouched
            d._work = (wp, tr.SNTrainState(z=z, coef=ws.coef))
        rcpt = d.tick()
        assert rcpt.published == (ev != "rollback"), (ev, rcpt)
        if ev == "join":
            assert rcpt.joins == 1
        if ev == "leave":
            assert rcpt.leaves == 1
        if ev == "rollback":
            assert rcpt.watchdog.rolled_back and rcpt.arrivals_rolled_back == 6
            # the working pair now aliases the published snapshot
            assert d._work[0] is d.snapshot.problem and d._work[1] is d.snapshot.state
        _assert_unchanged(held)
        hold()
    assert d.snapshot.version == len(events) - 1
    assert [s.version for s, _ in held] == list(range(len(events)))
    d.submit(xq)
    (a_last,) = d.pump()
    assert not np.array_equal(a0.values, a_last.values)  # training moved
    # the first snapshot still serves a0 bitwise (same padded grid)
    snap0 = held[0][0]
    pad = bucket_rows(16) - 16
    xq_pad = np.concatenate([xq, np.repeat(xq[-1:], pad, axis=0)])
    again = d.dispatch(snap0, xq_pad).numpy()
    assert np.array_equal(again[:, :16], a0.values)


def test_admission_control_sheds_with_receipts():
    prob, state, _, rng = _build_problem(seed=5)
    d = Daemon(prob, state, config=DaemonConfig(k=3, queue_rows=16))
    t1 = d.submit(np.zeros((12, 1), np.float32))
    t2 = d.submit(np.zeros((12, 1), np.float32))
    assert t1.admitted and not t2.admitted
    assert t2.shed_reason == "queue_full" and d.shed == 1
    assert len(d.pump()) == 1  # the admitted one still drains

    d2 = Daemon(prob, state, config=DaemonConfig(k=3, deadline_ms=0.0))
    assert d2.submit(np.zeros((4, 1), np.float32)).admitted  # EMA unset yet
    d2.pump()
    t = d2.submit(np.zeros((4, 1), np.float32))
    assert not t.admitted and t.shed_reason == "deadline"
    assert d2.health()["shed"] == 1


def test_degraded_tick_serves_last_good_then_recovers():
    prob, state, pos, rng = _build_problem(seed=6)
    d = Daemon(prob, state, config=DaemonConfig(k=3, rounds_per_tick=14, arrival_rows=8))
    assert d.tick().published  # version 1, known good
    xq = rng.uniform(-0.9, 0.9, size=(9, 1)).astype(np.float32)
    d.submit(xq)
    (good,) = d.pump()
    assert good.version == 1 and not good.degraded

    wp, ws = d._work
    z = ws.z.clone()
    z[0, 0] = float("nan")
    d._work = (wp, tr.SNTrainState(z=z, coef=ws.coef))
    ss = rng.integers(0, prob.n, size=3)
    d.offer_arrivals(rng.integers(0, 3, size=3), ss, pos[ss].astype(np.float32),
                     rng.normal(size=3).astype(np.float32))
    bad = d.tick()
    assert bad.watchdog.rolled_back and not bad.published
    assert bad.degraded and bad.version == 1
    assert bad.arrivals_rolled_back == 3 and bad.absorbed == 0
    assert d.health()["degraded"] is True

    d.submit(xq)
    (during,) = d.pump()
    assert during.degraded and during.version == 1
    assert np.array_equal(during.values, good.values)  # last good, bitwise

    rec = d.tick()  # the working copy was restored from the published snapshot
    assert rec.published and not rec.degraded and rec.version == 2


def test_churn_events_apply_through_ticks():
    prob, state, pos, rng = _build_problem(seed=7, n_max=28)
    plan = tr.make_serving_plan(prob, k=3, spare=4, slack=2)
    d = Daemon(prob, state, config=DaemonConfig(k=3), plan=plan)
    d.offer_join(np.array([0.15], np.float32), np.zeros(3, np.float32), lam=0.1)
    r = d.tick()
    assert r.joins == 1 and r.published
    slot = int(prob.n_base)  # the first spare row took the join
    assert bool(d.snapshot.problem.alive[slot]) and not bool(prob.alive[slot])
    assert bool((d.snapshot.plan.cells == slot).logical_and(d.snapshot.plan.cell_mask).any())
    d.offer_leave(2)
    r = d.tick()
    assert r.leaves == 1 and r.published
    assert not bool(d.snapshot.problem.alive[2])
    assert not bool(((d.snapshot.plan.cells == 2) & d.snapshot.plan.cell_mask).any())
    d.offer_leave(2)  # a leave of a dead row is a counted no-op
    assert d.tick().leaves == 0
    d.submit(rng.uniform(-0.9, 0.9, size=(7, 1)).astype(np.float32))
    (a,) = d.pump()
    assert np.isfinite(a.values).all()


def test_fault_drill_and_energy_tau_change_values_only():
    """Drill rates and the pruning threshold are tensor values: no library
    is built and no shape changes; the crash structure is refused."""
    prob, state, pos, rng = _build_problem(seed=8)
    d = Daemon(prob, state, config=DaemonConfig(k=3))
    d.tick()
    builds = _build.builds
    shapes = {k: tuple(v.shape) for k, v in _snapshot_tensors(d.snapshot).items()}
    d.set_fault_model(faults.make_fault_model(0.25, device=CPU))
    d.tick()
    d.set_fault_model(faults.make_fault_model(0.0, device=CPU))
    d.tick()
    energy = tr.representer_energy(d.snapshot.problem, ecoef=d.snapshot.ecoef)
    live = energy[: prob.n][prob.alive[: prob.n]]
    pruned = []
    for q in (0.1, 0.5):
        d.set_energy_tau(float(torch.quantile(live, q)))
        assert d.snapshot.keep is None or d.snapshot.pruned == pruned[-1]  # at the next publish
        assert d.tick().published
        assert d.snapshot.keep.dtype == torch.bool and d.snapshot.keep.shape == (prob.n + 1,)
        pruned.append(d.snapshot.pruned)
        assert d.health()["pruned"] == d.snapshot.pruned
    assert 0 < pruned[0] < pruned[1] < prob.n
    d.submit(rng.uniform(-0.9, 0.9, size=(5, 1)).astype(np.float32))
    assert np.isfinite(d.pump()[0].values).all()
    shapes_after = {k: tuple(v.shape) for k, v in _snapshot_tensors(d.snapshot).items()}
    shapes_after.pop("keep")
    assert shapes_after == shapes
    assert _build.builds == builds
    with pytest.raises(ValueError, match="crash"):
        d.set_fault_model(faults.make_fault_model(0.1, crash=(0.1, 0.5), device=CPU))


def test_warm_restart_is_bitwise():
    prob, state, _, rng = _build_problem(seed=9)
    with tempfile.TemporaryDirectory() as snap:
        cfg = DaemonConfig(k=3, ckpt_every=1, snapshot_dir=snap)
        d = Daemon(prob, state, config=cfg)
        for i in range(3):
            assert d.tick().ckpt_step == i + 1
        xq = rng.uniform(-0.9, 0.9, size=(11, 1)).astype(np.float32)
        d.submit(xq)
        (before,) = d.pump()
        digest = d.state_digest()

        d2 = Daemon(prob, state, config=cfg)  # same templates, fresh build
        assert d2.restored_step == 3
        assert d2.state_digest() == digest
        d2.submit(xq)
        (after,) = d2.pump()
        assert np.array_equal(before.values, after.values)
        # the restore gives tensors of the templates' dtypes on their device
        for (_, a), (_, b) in zip(ckpt._items(d2.snapshot.problem), ckpt._items(prob)):
            assert a.dtype == b.dtype and a.device == b.device


def test_health_is_json_and_carries_the_watchdog_receipt():
    prob, state, _, _ = _build_problem(seed=10)
    d = Daemon(prob, state, config=DaemonConfig(k=3))
    h0 = json.loads(json.dumps(d.health()))
    assert h0["schema"] == "daemon_health/1" and h0["last_tick"] is None
    rcpt = d.tick()
    h = json.loads(json.dumps(d.health()))
    assert h["version"] == 1 and h["ticks"] == 1
    wd = monitor.receipt_from_json(h["last_tick"]["watchdog"])
    assert wd.rounds >= 1 and not wd.rolled_back
    tj = json.loads(json.dumps(rcpt.to_json()))
    assert tj["schema"] == "tick_receipt/1" and tj["watchdog"]["schema"] == "watchdog_receipt/1"
    assert set(d.last_split) == {"events_ms", "absorb_ms", "watchdog_ms", "publish_ms",
                                 "ckpt_ms"}


def test_defaults_and_bad_config():
    assert DaemonConfig().engine == "cuda" and DaemonConfig().train_engine == "cuda"
    prob, state, _, _ = _build_problem(seed=11)
    with pytest.raises(ValueError, match="engines"):
        Daemon(prob, state, config=DaemonConfig(engine="pallas"))
    with pytest.raises(ValueError, match="batched"):
        Daemon(*tr.field_view(prob, state, 0), config=DaemonConfig())
