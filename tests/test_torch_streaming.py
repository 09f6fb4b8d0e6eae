"""Port parity, streaming part 1: absorb, absorb_many, absorb_wave,
evict_oldest, forgetting, pad_arrivals, capacity_left and rebuild_chol.

Both packages start from the same tables (the reference's problem and
trained state, carried over with ``repro_torch.convert``) and take the same
numpy arrivals.  Receipt flags, occupancy, positions and coefficients must
be equal; Grams within 2e-5 (the kernel-vs-oracle bound,
tests/test_kernels_pallas.py), factors within 1e-4
(tests/test_multifield.py:189), messages within 1e-6.  Inside the port the
reference's identities hold bitwise: ``absorb_many`` == repeated
``absorb``, a beta = 1 field in a mixed batch == the static problem, a
padded window == the unpadded one, and a wave == sequential absorbs
(except the factors, 1e-5: tests/test_streaming_beta.py:142).  The f64
bound (1e-10) is checked in a subprocess with ``JAX_ENABLE_X64``, started
with the file's first test so that the two runs overlap.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jr
import repro_torch.core as tr
from repro.core import streaming as js
from repro_torch import convert
from repro_torch.core import streaming as ts
from repro_torch.kernels.ops import bucket_rows
from test_torch_build import _leaves, _np

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, B, RADIUS, LAM, HEADROOM = 12, 2, 0.55, 0.3, 3
TABLES = ("nbr_pos", "nbr_mask", "gram", "chol", "stream_pos", "anchor_w")
EXACT = ("nbr_pos", "nbr_mask", "stream_pos")


@pytest.fixture(scope="module", autouse=True)
def f64_run():
    """The f64 comparison (F64_CODE), started before this file's first test
    so that it runs beside the f32 tests; read by the last test."""
    env = dict(os.environ, PYTHONPATH="src")
    proc = subprocess.Popen([sys.executable, "-c", F64_CODE], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _build(betas=1.0):
    """The same streaming problem and 2-sweep state in both packages (one
    geometry throughout, so the reference compiles each program once)."""
    pos = jr.uniform_sensors(N, d=1, seed=0)
    rng = np.random.default_rng(1)
    ys = np.sin(np.pi * pos[None, :, 0]) + 0.2 * rng.normal(size=(B, N))
    d_max = int(np.asarray(jr.build_topology(pos, RADIUS).degrees).max()) + HEADROOM
    jprob = jr.make_batch_problem(
        jr.build_topology(pos, RADIUS, d_max=d_max), jr.Kernel("rbf", gamma=1.0), ys,
        jnp.full((N,), LAM), beta=betas,
    )
    jst = jr.colored_sweep(jprob, jr.init_state(jprob), n_sweeps=2)
    tprob = convert.problem_from_numpy(_leaves(jprob), kernel=tr.Kernel("rbf", gamma=1.0),
                                       device="cpu")
    tst = convert.state_from_numpy({"z": np.asarray(jst.z), "coef": np.asarray(jst.coef)},
                                   device="cpu")
    return pos, jprob, jst, tprob, tst


def _arrivals(pos, count, seed, sensors=None):
    rng = np.random.default_rng(seed)
    fs = rng.integers(0, B, size=count)
    ss = rng.integers(0, len(pos), size=count) if sensors is None else rng.choice(sensors, count)
    xs = (pos[ss] + 0.05 * rng.normal(size=(count, pos.shape[1]))).astype(np.float32)
    return fs, ss, xs, rng.normal(size=count).astype(np.float32)


def _match_reference(tprob, tst, jprob, jst):
    for name in TABLES:
        got, want = _np(getattr(tprob, name)), np.asarray(getattr(jprob, name))
        if name in EXACT:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            tol = {"gram": 2e-5, "chol": 1e-4, "anchor_w": 1e-6}[name]
            np.testing.assert_allclose(got, want, atol=tol, err_msg=name)
    np.testing.assert_allclose(_np(tst.z)[:, :-1], np.asarray(jst.z)[:, :-1], atol=1e-6)
    np.testing.assert_array_equal(_np(tst.coef), np.asarray(jst.coef))


def _bitwise(p1, s1, p2, s2, chol_tol=0.0):
    for name in TABLES:
        a, b = getattr(p1, name), getattr(p2, name)
        if name == "chol" and chol_tol:
            np.testing.assert_allclose(_np(a), _np(b), atol=chol_tol, err_msg=name)
        else:
            assert torch.equal(a, b), name
    assert torch.equal(s1.z[:, :-1], s2.z[:, :-1])  # all but the sentinel scratch slot
    assert torch.equal(s1.coef, s2.coef)


@pytest.mark.parametrize("on_full", ["drop", "evict"])
@pytest.mark.parametrize("beta", [1.0, 0.7])
def test_absorb_matches_reference(beta, on_full):
    """Arrivals crowded onto three sensors, so both policies fire."""
    pos, jprob, jst, tprob, tst = _build(betas=beta)
    flags = []
    for f, s, x, y in zip(*_arrivals(pos, 24, seed=5, sensors=[1, 4, 7])):
        jprob, jst, jok = js.absorb(jprob, jst, int(f), int(s), x, float(y), on_full=on_full)
        tprob, tst, tok = ts.absorb(tprob, tst, int(f), int(s), x, float(y), on_full=on_full)
        assert tok.shape == () and tok.dtype == torch.bool
        assert bool(tok) == bool(jok)
        flags.append(bool(tok))
    assert all(flags) if on_full == "evict" else not all(flags)
    _match_reference(tprob, tst, jprob, jst)
    np.testing.assert_allclose(_np(ts.rebuild_chol(tprob)), _np(tprob.chol), atol=1e-4)
    if beta < 1:
        assert float(tprob.anchor_w.min()) < 0.9  # the tick really decayed lanes


@pytest.mark.parametrize("on_full", ["drop", "evict"])
def test_absorb_many_matches_reference_and_repeated_absorb(on_full):
    pos, jprob, jst, tprob, tst = _build(betas=np.asarray([1.0, 0.7], np.float32))
    fs, ss, xs, ys = _arrivals(pos, 20, seed=17, sensors=[0, 3])
    jp, jstate, jrec = js.absorb_many(jprob, jst, fs, ss, xs, ys, on_full=on_full)
    tp, tstate, trec = ts.absorb_many(tprob, tst, fs, ss, xs, ys, on_full=on_full)
    assert trec.absorbed.shape == trec.evicted.shape == (20,)
    np.testing.assert_array_equal(_np(trec.absorbed), np.asarray(jrec.absorbed))
    np.testing.assert_array_equal(_np(trec.evicted), np.asarray(jrec.evicted))
    assert bool(trec.evicted.any()) == (on_full == "evict")
    assert bool(trec.absorbed.all()) == (on_full == "evict")
    _match_reference(tp, tstate, jp, jstate)
    p1, s1 = tprob, tst
    for i in range(20):
        p1, s1, _ = ts.absorb(p1, s1, fs[i], ss[i], xs[i], ys[i], on_full=on_full)
    _bitwise(p1, s1, tp, tstate)
    assert torch.equal(s1.z, tstate.z)
    doc = trec.to_json()
    assert doc["schema"] == "absorb_receipt/1"
    assert doc["absorbed"] == np.asarray(jrec.absorbed).tolist()


def test_absorb_wave_matches_reference_and_sequential():
    """A partial wave under drop, then dense evicting waves until the windows
    wrap; each against the reference's wave and the port's sequential absorbs."""
    pos, jprob, jst, tprob, tst = _build(betas=np.asarray([1.0, 0.7], np.float32))
    n_cap = tprob.n
    rng = np.random.default_rng(2)

    def seq(prob, state, xs, ys, amask, on_full):
        for b in range(B):
            for s in range(n_cap):
                if amask[b, s]:
                    prob, state, _ = ts.absorb(prob, state, b, s, xs[b, s], ys[b, s],
                                               on_full=on_full)
        return prob, state

    amask = np.zeros((B, n_cap), bool)
    amask[:, :N] = (np.add.outer(np.arange(B), np.arange(N)) % 3) != 0
    rounds = [("drop", amask)] + [("evict", np.ones((B, n_cap), bool))] * 5
    total_evicted = 0
    for on_full, amask in rounds:
        xs = (pos[None] + rng.normal(scale=0.05, size=(B, N, 1))).astype(np.float32)
        ys = rng.normal(size=(B, n_cap)).astype(np.float32)
        jp, jstate, jrec = jr.absorb_wave(jprob, jst, xs, ys, mask=amask, on_full=on_full)
        tp, tstate, trec = tr.absorb_wave(tprob, tst, xs, ys, mask=amask, on_full=on_full)
        np.testing.assert_array_equal(_np(trec.absorbed), np.asarray(jrec.absorbed))
        np.testing.assert_array_equal(_np(trec.evicted), np.asarray(jrec.evicted))
        _match_reference(tp, tstate, jp, jstate)
        ps, ss = seq(tprob, tst, xs, ys, amask, on_full)
        _bitwise(tp, tstate, ps, ss, chol_tol=1e-5)
        total_evicted += int(trec.evicted.sum())
        jprob, jst, tprob, tst = jp, jstate, tp, tstate
    assert total_evicted > 0  # the waves really evicted
    assert float((ts.rebuild_chol(tprob) - tprob.chol).abs().max()) < 5e-5


def test_evict_oldest_round_trip_matches_scratch_and_reference():
    """absorb A, B, C -> evict_oldest -> absorb D equals the window B, C, D
    absorbed from scratch (tests/test_multifield.py:282)."""
    pos, jprob, jst, tprob, tst = _build()
    rng = np.random.default_rng(11)
    s = 4
    events = [((pos[s] + 0.1 * rng.normal(size=1)).astype(np.float32), float(rng.normal()))
              for _ in range(4)]
    p1, s1, j1, js1 = tprob, tst, jprob, jst
    for x, y in events[:3]:
        p1, s1, ok = ts.absorb(p1, s1, 0, s, x, y)
        j1, js1, _ = js.absorb(j1, js1, 0, s, x, y)
        assert bool(ok)
    p1, s1, ev = ts.evict_oldest(p1, s1, 0, s)
    j1, js1, jev = js.evict_oldest(j1, js1, 0, s)
    assert bool(ev) and bool(jev)
    _match_reference(p1, s1, j1, js1)
    p1, s1, ok = ts.absorb(p1, s1, 0, s, *events[3])
    assert bool(ok)
    p2, s2 = tprob, tst
    for x, y in events[1:]:
        p2, s2, _ = ts.absorb(p2, s2, 0, s, x, y)
    for name in ("nbr_pos", "nbr_mask", "gram", "stream_pos"):
        assert torch.equal(getattr(p1, name), getattr(p2, name)), name
    assert torch.equal(s1.z, s2.z)
    np.testing.assert_allclose(_np(p1.chol), _np(p2.chol), atol=1e-5)
    np.testing.assert_allclose(_np(p1.chol), _np(ts.rebuild_chol(p1)), atol=1e-5)


def test_evict_oldest_empty_sensor_is_noop():
    _, _, _, tprob, tst = _build()
    p2, s2, ev = ts.evict_oldest(tprob, tst, 1, 7)
    assert not bool(ev) and ev.shape == ()
    _bitwise(p2, s2, tprob, tst)
    assert torch.equal(s2.z, tst.z)


def test_capacity_left_and_rebuild_chol_match_reference():
    pos, jprob, jst, tprob, tst = _build()
    fs, ss, xs, ys = _arrivals(pos, 9, seed=8)
    jprob, _, _ = js.absorb_many(jprob, jst, fs, ss, xs, ys)
    tprob, _, _ = ts.absorb_many(tprob, tst, fs, ss, xs, ys)
    left = ts.capacity_left(tprob)
    assert left.shape == (B, N)
    np.testing.assert_array_equal(_np(left), np.asarray(js.capacity_left(jprob)))
    np.testing.assert_allclose(_np(ts.rebuild_chol(tprob)),
                               np.asarray(js.rebuild_chol(jprob)), atol=1e-5)
    assert ts.rebuild_chol(tprob).is_contiguous()


def test_pad_arrivals_is_bitwise_noop():
    """A window padded with sentinel-row arrivals equals the unpadded one
    bitwise, under both policies (tests/test_daemon.py:126)."""
    pos, jprob, jst, tprob, tst = _build()
    fs, ss, xs, ys = _arrivals(pos, 5, seed=9)
    a_pad = bucket_rows(5)
    padded = ts.pad_arrivals(tprob, fs, ss, xs, ys, a_pad)
    jpadded = js.pad_arrivals(jprob, fs, ss, xs, ys, a_pad)
    for got, want in zip(padded, jpadded):
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    real = padded[-1]
    assert int(real.sum()) == 5 and real.shape == (8,)
    for on_full in ("drop", "evict"):
        p0, s0, r0 = ts.absorb_many(tprob, tst, fs, ss, xs, ys, on_full=on_full)
        p1, s1, r1 = ts.absorb_many(tprob, tst, *padded[:4], on_full=on_full)
        _bitwise(p0, s0, p1, s1)
        assert torch.equal(s0.z, s1.z)
        assert torch.equal(r0.absorbed, r1.absorbed[real])
        assert not bool(r1.absorbed[~real].any()) and not bool(r1.evicted[~real].any())
    with pytest.raises(ValueError):
        ts.pad_arrivals(tprob, fs, ss, xs, ys, 4)


def test_beta1_field_bitwise_in_mixed_batch():
    """A beta = 1 field sharing a batch with a decaying one is untouched: an
    evicting trace and every sweep engine give the static problem's bits."""
    pos, _, _, prob_s, st_s = _build(betas=1.0)
    _, _, _, prob_m, st_m = _build(betas=np.asarray([1.0, 0.5], np.float32))
    arrivals = _arrivals(pos, 40, seed=7, sensors=[2, 5, 10])
    prob_s, st_s, _ = ts.absorb_many(prob_s, st_s, *arrivals, on_full="evict")
    prob_m, st_m, rec = ts.absorb_many(prob_m, st_m, *arrivals, on_full="evict")
    assert bool(rec.evicted.any())
    for name in TABLES:
        assert torch.equal(getattr(prob_s, name)[0], getattr(prob_m, name)[0]), name
    assert torch.equal(st_s.z[0], st_m.z[0]) and torch.equal(st_s.coef[0], st_m.coef[0])
    runs = {
        "plan": lambda p, s: tr.colored_sweep(p, s, n_sweeps=2),
        "onehot": lambda p, s: tr.colored_sweep(p, s, n_sweeps=2, engine="onehot"),
        "cuda": lambda p, s: tr.colored_sweep(p, s, n_sweeps=2, engine="cuda"),
        "serial": lambda p, s: tr.serial_sweep(p, s, n_sweeps=2),
    }
    for name, run in runs.items():
        assert torch.equal(run(prob_s, st_s).z[0], run(prob_m, st_m).z[0]), name
    assert not torch.equal(prob_s.anchor_w[1], prob_m.anchor_w[1])
    assert float(prob_m.anchor_w.min()) < 0.9


def test_overflow_drops_instead_of_corrupting():
    """An arrival at a FULL sensor is a no-op (tests/test_multifield.py:223)."""
    pos, _, _, prob, state = _build()
    s = 0
    free = int(ts.capacity_left(prob)[0, s])
    for i in range(free):
        prob, state, ok = ts.absorb(prob, state, 0, s, pos[s] + 0.01 * (i + 1), 1.0)
        assert bool(ok)
    assert int(ts.capacity_left(prob)[0, s]) == 0
    over_p, over_s, ok = ts.absorb(prob, state, 0, s, pos[s] + 0.5, 9.9)
    assert not bool(ok)
    _bitwise(over_p, over_s, prob, state)
    # zero-capacity problems are refused before any work
    topo0 = tr.build_topology(tr.uniform_sensors(6, seed=0), 5.0, device="cpu")
    prob0 = tr.make_batch_problem(topo0, tr.Kernel(), np.zeros((1, 6)), np.full(6, 0.1),
                                  device="cpu")
    with pytest.raises(ValueError, match="streaming capacity"):
        ts.absorb(prob0, tr.init_state(prob0), 0, 0, np.zeros(1), 0.0)


def test_absorb_drops_at_dead_sensor():
    pos, _, _, prob, state = _build()
    alive = prob.alive.clone()
    alive[3] = False
    prob = dataclasses.replace(prob, alive=alive)
    for on_full in ("drop", "evict"):
        p2, s2, ok = ts.absorb(prob, state, 0, 3, pos[3] + 0.01, 1.0, on_full=on_full)
        assert not bool(ok)
        _bitwise(p2, s2, prob, state)


def test_local_only_refuses_absorbed_problems():
    pos, _, _, prob, state = _build()
    tr.local_only(prob)  # fine before streaming
    prob, _, _ = ts.absorb(prob, state, 0, 1, pos[1] + 0.1, 1.0)
    with pytest.raises(NotImplementedError, match="pre-streaming"):
        tr.local_only(prob)


def test_donate_contract():
    """donate=False leaves its inputs bitwise untouched; donate=True writes
    the given tensors in place."""
    pos, _, _, prob, state = _build(betas=np.asarray([1.0, 0.7], np.float32))
    prob, state, _ = ts.absorb_many(prob, state, *_arrivals(pos, 12, seed=4, sensors=[2, 6]))
    arrivals = _arrivals(pos, 12, seed=5, sensors=[2, 6])
    keep = {name: getattr(prob, name).clone() for name in TABLES}
    z0, c0 = state.z.clone(), state.coef.clone()
    xs = np.broadcast_to(pos[None], (B, N, 1)) + 0.02
    calls = [
        lambda p, s, d: ts.absorb(p, s, 1, 6, pos[6] + 0.03, 0.5, donate=d, on_full="evict"),
        lambda p, s, d: ts.absorb_many(p, s, *arrivals, donate=d, on_full="evict"),
        lambda p, s, d: ts.absorb_wave(p, s, xs, np.ones((B, N)), donate=d, on_full="evict"),
        lambda p, s, d: ts.evict_oldest(p, s, 1, 6, donate=d),
    ]
    for call in calls:
        p2, s2, _ = call(prob, state, False)
        for name in TABLES:
            assert torch.equal(getattr(prob, name), keep[name]), name
        assert torch.equal(state.z, z0) and torch.equal(state.coef, c0)
        assert not torch.equal(p2.gram, prob.gram)
    for call in calls:
        p_in = dataclasses.replace(prob, **{name: getattr(prob, name).clone() for name in TABLES})
        s_in = tr.SNTrainState(z=state.z.clone(), coef=state.coef.clone())
        want_p, want_s, _ = call(p_in, s_in, False)
        p3, s3, _ = call(p_in, s_in, True)
        assert p3.gram is p_in.gram and s3.z is s_in.z  # rebound to the same tensors
        _bitwise(p3, s3, want_p, want_s)


F64_CODE = r"""
import os
os.environ["JAX_ENABLE_X64"] = "1"
import sys
sys.path.insert(0, "tests")
import numpy as np, jax.numpy as jnp, torch
torch.set_num_threads(1)
import repro.core as jr
import repro_torch.core as tr
from repro.core import streaming as js
from repro_torch import convert
from repro_torch.core import streaming as ts
from test_torch_build import _leaves

n, b = 12, 2
pos = jr.uniform_sensors(n, d=1, seed=0).astype(np.float64)
ys = np.sin(np.pi * pos[None, :, 0]) + 0.2 * np.random.default_rng(1).normal(size=(b, n))
d_max = int(np.asarray(jr.build_topology(pos, 0.55).degrees).max()) + 3
jprob = jr.make_batch_problem(jr.build_topology(pos, 0.55, d_max=d_max),
                              jr.Kernel("rbf", gamma=1.0), ys, jnp.full((n,), 0.3),
                              dtype=jnp.float64, beta=np.asarray([1.0, 0.7]))
jst = jr.colored_sweep(jprob, jr.init_state(jprob), n_sweeps=2)
tprob = convert.problem_from_numpy(_leaves(jprob), kernel=tr.Kernel("rbf", gamma=1.0),
                                   device="cpu")
tst = convert.state_from_numpy({"z": np.asarray(jst.z), "coef": np.asarray(jst.coef)},
                               device="cpu")
assert tprob.gram.dtype == torch.float64

def same(tp, tsx, jp, jsx, what):
    for name in ("nbr_pos", "nbr_mask", "gram", "chol", "stream_pos", "anchor_w"):
        np.testing.assert_allclose(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)),
                                   atol=1e-10, err_msg=f"{what}: {name}")
    np.testing.assert_allclose(tsx.z.numpy()[:, :-1], np.asarray(jsx.z)[:, :-1], atol=1e-10)
    np.testing.assert_allclose(tsx.coef.numpy(), np.asarray(jsx.coef), atol=1e-10)

rng = np.random.default_rng(3)
a = 30
fs, ss = rng.integers(0, b, size=a), rng.choice([1, 5, 8], size=a)
xs, yv = pos[ss] + 0.05 * rng.normal(size=(a, 1)), rng.normal(size=a)
for on_full in ("drop", "evict"):
    jp, jsx, jrec = js.absorb_many(jprob, jst, fs, ss, xs, yv, on_full=on_full)
    tp, tsx, trec = ts.absorb_many(tprob, tst, fs, ss, xs, yv, on_full=on_full)
    assert tsx.z.dtype == torch.float64
    np.testing.assert_array_equal(trec.absorbed.numpy(), np.asarray(jrec.absorbed))
    np.testing.assert_array_equal(trec.evicted.numpy(), np.asarray(jrec.evicted))
    same(tp, tsx, jp, jsx, "absorb_many " + on_full)
    np.testing.assert_allclose(ts.rebuild_chol(tp).numpy(), np.asarray(js.rebuild_chol(jp)),
                               atol=1e-10)
    jp2, jsx2, _ = js.evict_oldest(jp, jsx, 1, 5)
    tp2, tsx2, _ = ts.evict_oldest(tp, tsx, 1, 5)
    same(tp2, tsx2, jp2, jsx2, "evict_oldest " + on_full)
xw = pos[None] + 0.03 * rng.normal(size=(b, n, 1))
yw = rng.normal(size=(b, n))
for on_full in ("drop", "evict"):
    jp, jsx, _ = jr.absorb_wave(jp, jsx, xw, yw, on_full=on_full)
    tp, tsx, _ = tr.absorb_wave(tp, tsx, xw, yw, on_full=on_full)
    same(tp, tsx, jp, jsx, "absorb_wave " + on_full)
print("OK")
"""


def test_f64_streaming_matches_reference_subprocess(f64_run):
    out, err = f64_run.communicate(timeout=300)
    assert f64_run.returncode == 0, err[-3000:]
    assert "OK" in out
