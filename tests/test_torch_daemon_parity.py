"""Port parity, the serving daemon: the port's ``Daemon`` against the JAX
package's on the same trace.

Same trace: one seeded fault-free trace (n = 24 sensors with 4 spare rows,
B = 2 fields, arrivals every tick, a join, a leave, an arrival window that
pads to its bucket, ``energy_tau`` > 0) goes through the reference
``Daemon`` (plan engines) and the port's, with plan engines and with cuda
engines (the kernels' plain versions on the CPU).  The default fault model
of both is ``make_fault_model(0.0)``: every lane delivered, a bitwise
identity, so the port's Philox draws and the reference's Threefry draws
deliver the same messages.  The pruning threshold is 6.5 for the first
two ticks and 19.0 after (``set_energy_tau``), so that each publish prunes
a few live sensors.  Per tick: the ``TickReceipt.to_json`` integers and
flags equal, the ``pruned`` counts equal (the threshold is held at least
1e-4 relative away from every live energy of the reference's snapshots),
the answers at the long-chain sweep bound (z 2e-4,
tests/test_scatter_plan.py:200) and the watchdog norms within 2e-4
relative.  The norm ||z||^2 + sum_i lambda_i c_i^T K_i c_i carries the
float32 drift of two summation orders through six ticks of events; it
reaches 1.07e-4 relative at the last tick, so the float32 norms are held
to the z bound taken relatively.  The same trace in float64, in a
subprocess with ``JAX_ENABLE_X64`` started with the file's first test,
holds the norms within 1e-10 relative and the answers within 1e-10, which
shows that the two daemons compute the same thing.

Cross restore: a checkpoint directory written by the reference ``Daemon``
restores into the port's ``Daemon`` (on templates the port built itself):
its ``state_digest`` equals the reference's, and its probe answers agree
with the reference's to the kNN bound (1e-5, tests/test_serving.py:86).
"""

import os
import subprocess
import sys
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jr
import repro_torch.core as tr
from repro.core import pruning as jp
from repro.launch import daemon as jd
from repro_torch.launch import daemon as td

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, B, SPARES, RADIUS, LAM, K = 24, 2, 4, 0.6, 0.1, 3
TAUS = {0: 6.5, 2: 19.0}  # tick -> pruning threshold set before it
TICKS = 6
SWEEP_Z_TOL, NORM_RTOL, KNN_TOL, F64_TOL = 2e-4, 2e-4, 1e-5, 1e-10
RECEIPT_KEYS = ("tick", "published", "degraded", "version", "absorbed", "arrival_drops",
                "arrivals_rolled_back", "joins", "leaves", "ckpt_step")
WATCHDOG_KEYS = ("converged", "rounds", "sweeps", "retries", "refactorized", "rolled_back",
                 "diverged")


def _inputs(seed=0):
    pos = jr.uniform_sensors(N, seed=seed)
    rng = np.random.default_rng(seed + 1)
    freq = rng.uniform(0.5, 2.0, size=(B, 1))
    ys = (np.sin(np.pi * freq * pos[None, :, 0]) + 0.2 * rng.normal(size=(B, N))).astype(
        np.float32)
    return pos, ys


@pytest.fixture(scope="module", autouse=True)
def f64_run():
    """The float64 comparison (F64_CODE), started before this file's first
    test so that it runs beside the float32 ones; read by its own test."""
    env = dict(os.environ, PYTHONPATH="src" + os.pathsep + "tests", JAX_ENABLE_X64="1")
    proc = subprocess.Popen([sys.executable, "-c", F64_CODE], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _reference_problem(seed=0, dtype=jnp.float32):
    pos, ys = _inputs(seed)
    topo = jr.build_topology(pos, RADIUS)
    d_max = int(np.asarray(topo.degrees).max()) + 4
    topo = jr.build_topology(pos, RADIUS, d_max=d_max, n_max=N + SPARES)
    prob = jr.make_batch_problem(topo, jr.Kernel("rbf", gamma=1.0), ys,
                                 jnp.asarray(np.full((N,), LAM, np.float32)), dtype=dtype)
    return prob, jr.init_state(prob)


def _port_problem(seed=0, dtype=torch.float32):
    pos, ys = _inputs(seed)
    topo = tr.build_topology(pos, RADIUS, device="cpu")
    d_max = int(topo.degrees.max()) + 4
    topo = tr.build_topology(pos, RADIUS, d_max=d_max, n_max=N + SPARES, device="cpu")
    prob = tr.make_batch_problem(topo, tr.Kernel("rbf", gamma=1.0), ys,
                                 np.full((N,), LAM, np.float32), dtype=dtype, device="cpu")
    return prob, tr.init_state(prob)


def _trace(seed=2):
    """Per tick: (arrivals, event, query grids), drawn once for every daemon."""
    rng = np.random.default_rng(seed)
    pos, _ = _inputs()
    out = []
    for t in range(TICKS):
        a = 37 if t == 2 else int(rng.integers(1, 12))  # tick 2: a full window + a padded one
        ss = rng.integers(0, N, size=a)
        arrivals = (rng.integers(0, B, size=a), ss,
                    (pos[ss] + 0.05 * rng.normal(size=(a, 1))).astype(np.float32),
                    rng.normal(size=a).astype(np.float32))
        event = None
        if t == 1:
            event = ("join", np.array([0.12], np.float32), rng.normal(size=B).astype(np.float32))
        elif t == 3:
            event = ("leave", 5)
        grids = [rng.uniform(-0.9, 0.9, size=(int(q), 1)).astype(np.float32)
                 for q in rng.integers(1, 40, size=2)]
        out.append((arrivals, event, grids))
    return out


def _run(d, trace, energy_of=None):
    """Drive ``d`` through ``trace``; per tick (receipt JSON, pruned, answers)."""
    rows = []
    for t, (arrivals, event, grids) in enumerate(trace):
        if t in TAUS:
            d.set_energy_tau(TAUS[t])
        d.offer_arrivals(*arrivals)
        if event is not None and event[0] == "join":
            d.offer_join(event[1], event[2], lam=LAM)
        elif event is not None:
            d.offer_leave(event[1])
        rcpt = d.tick()
        tickets = [d.submit(g) for g in grids]
        answers = {a.id: a for a in d.pump()}
        assert all(t.admitted for t in tickets)
        vals = [answers[t.id].values for t in tickets]
        assert all(answers[t.id].version == rcpt.version for t in tickets)
        if energy_of is not None:
            energy_of(d.snapshot)
        rows.append((rcpt.to_json(), d.snapshot.pruned, vals))
    return rows


def _plan(prob, mod):
    return mod.make_serving_plan(prob, k=K, spare=SPARES, slack=2)


@pytest.fixture(scope="module")
def reference_rows():
    prob, state = _reference_problem()
    d = jd.Daemon(prob, state, config=jd.DaemonConfig(k=K, energy_tau=TAUS[0], arrival_rows=32),
                  plan=_plan(prob, jr))
    gaps = []

    def energy_of(snap):
        e = np.asarray(jp.representer_energy(snap.problem, ecoef=snap.ecoef))
        live = e[: snap.problem.n][np.asarray(snap.problem.alive)[: snap.problem.n] != 0]
        tau = d.health()["energy_tau"]
        gaps.append(float(np.abs(live - tau).min() / tau))

    rows = _run(d, _trace(), energy_of)
    return rows, gaps


@pytest.mark.parametrize("engine", ["plan", "cuda"])
def test_same_trace_as_reference(reference_rows, engine):
    ref, gaps = reference_rows
    assert min(gaps) >= 1e-4, gaps  # no live energy sits at the threshold
    prob, state = _port_problem()
    got = _run(_port_daemon(prob, state, engine), _trace())
    compare_rows(got, ref, SWEEP_Z_TOL, NORM_RTOL)
    assert all(r[0]["published"] for r in got)
    assert 0 < min(r[1] for r in got[1:]) and max(r[1] for r in got) < N + 1


def _port_daemon(prob, state, engine):
    cfg = td.DaemonConfig(k=K, engine=engine, train_engine=engine, energy_tau=TAUS[0],
                          arrival_rows=32)
    return td.Daemon(prob, state, config=cfg, plan=_plan(prob, tr))


def compare_rows(got, ref, answer_tol, norm_rtol):
    """Per tick: receipt integers and flags, pruned counts equal; watchdog
    norms and answers within the tolerances."""
    assert len(got) == len(ref) == TICKS
    joins = leaves = 0
    for t, ((pj, pp, pv), (rj, rp, rv)) in enumerate(zip(got, ref)):
        for key in RECEIPT_KEYS:
            assert pj[key] == rj[key], (t, key, pj[key], rj[key])
        for key in WATCHDOG_KEYS:
            assert pj["watchdog"][key] == rj["watchdog"][key], (t, key)
        np.testing.assert_allclose(pj["watchdog"]["norm"], rj["watchdog"]["norm"],
                                   rtol=norm_rtol, err_msg=f"tick {t}")
        assert pp == rp, (t, pp, rp)
        for a, b in zip(pv, rv):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=answer_tol, err_msg=f"tick {t}")
        joins += pj["joins"]
        leaves += pj["leaves"]
    assert joins == 1 and leaves == 1


def test_same_trace_in_float64(f64_run):
    out, err = f64_run.communicate(timeout=300)
    assert f64_run.returncode == 0, err[-3000:]
    assert "OK" in out, out


def test_reference_checkpoint_restores_into_the_port():
    prob, state = _reference_problem(seed=3)
    probe = np.linspace(-0.9, 0.9, 32)[:, None].astype(np.float32)
    with tempfile.TemporaryDirectory() as snap:
        d = jd.Daemon(prob, state, config=jd.DaemonConfig(k=K, ckpt_every=1, snapshot_dir=snap),
                      plan=_plan(prob, jr))
        rng = np.random.default_rng(4)
        for _ in range(2):
            ss = rng.integers(0, N, size=6)
            d.offer_arrivals(rng.integers(0, B, size=6), ss,
                             rng.uniform(-0.9, 0.9, size=(6, 1)).astype(np.float32),
                             rng.normal(size=6).astype(np.float32))
            assert d.tick().published
        d.submit(probe)
        (want,) = d.pump()
        digest = d.state_digest()

        tprob, tstate = _port_problem(seed=3)
        assert td._state_digest(tprob, tstate) != digest
        for engine in ("plan", "cuda"):
            cfg = td.DaemonConfig(k=K, engine=engine, snapshot_dir=snap)
            port = td.Daemon(tprob, tstate, config=cfg, plan=_plan(tprob, tr))
            assert port.restored_step == 2
            assert port.state_digest() == digest
            port.submit(probe)
            (got,) = port.pump()
            np.testing.assert_allclose(got.values, want.values, rtol=0, atol=KNN_TOL)


F64_CODE = r"""
import numpy as np
import jax.numpy as jnp
import torch
import repro.core as jr
from repro.launch import daemon as jd
import test_torch_daemon_parity as T

prob, state = T._reference_problem(dtype=jnp.float64)
assert state.z.dtype == jnp.float64
d = jd.Daemon(prob, state, config=jd.DaemonConfig(k=T.K, energy_tau=T.TAUS[0], arrival_rows=32),
              plan=T._plan(prob, jr))
ref = T._run(d, T._trace())
for engine in ("plan", "cuda"):
    tprob, tstate = T._port_problem(dtype=torch.float64)
    got = T._run(T._port_daemon(tprob, tstate, engine), T._trace())
    assert all(v.dtype == np.float64 for row in got for v in row[2])
    T.compare_rows(got, ref, T.F64_TOL, T.F64_TOL)
print("OK")
"""
