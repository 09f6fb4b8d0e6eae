"""Port parity, the seeded fault process ``core.faults``.

On the reference's test geometry (tests/test_faults.py:46-60: N = 12, B = 2,
d = 1, radius 0.55, lambda 0.3).  Inside the port: an all-delivered mask
and a ``drop=0`` model are bitwise identities engine by engine (serial,
plan, onehot, and the cuda wrapper, which runs its plain version on CPU
tensors), and so is the robust path under all-ones masks; ``drop=1`` holds
every message while the coefficients move; plan == onehot bitwise under one
mask.  The port's generator cannot draw the reference's masks (Philox is
not Threefry), so the parity tests feed the reference's own
``sample_faults`` masks to the port's dispatch ``_faulty``: z within 1e-5,
coef within 1e-3 in f32 (tests/test_scatter_plan.py), 1e-10 in f64 (in a
subprocess with ``JAX_ENABLE_X64``).  The port's sampler is held to the
reference's statistics and thresholds (tests/test_faults.py:140-208), and
``parse_fault_spec`` to the reference's messages and rates.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jr
import repro_torch.core as tr
from repro.core import faults as jf
from repro_torch import convert
from repro_torch.core import faults as tf
from test_torch_build import _leaves, _np

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, B, RADIUS, LAM = 12, 2, 0.55, 0.3
ENGINES = ("serial", "plan", "onehot", "cuda")
COLORED = ("plan", "onehot", "cuda")


@pytest.fixture(scope="module", autouse=True)
def f64_run():
    """The float64 comparison (F64_CODE), started before this file's first
    test so that it runs beside the float32 tests; read by the last test."""
    env = dict(os.environ, PYTHONPATH="src")
    proc = subprocess.Popen([sys.executable, "-c", F64_CODE], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _inputs(seed):
    pos = tr.uniform_sensors(N, d=1, seed=seed)
    ys = np.sin(np.pi * pos[None, :, 0]) + 0.2 * np.random.default_rng(seed + 1).normal(
        size=(B, N))
    return pos, ys


def _port(seed=0):
    """The reference test's problem built by the port, after 2 sweeps."""
    pos, ys = _inputs(seed)
    prob = tr.make_batch_problem(tr.build_topology(pos, RADIUS, device="cpu"),
                                 tr.Kernel("rbf", gamma=1.0), ys,
                                 np.full((N,), LAM, np.float32), device="cpu")
    return prob, tr.colored_sweep(prob, tr.init_state(prob), n_sweeps=2)


def _reference(seed=0, dtype=jnp.float32):
    """The reference's problem and 2-sweep state, and the same carried over."""
    pos, ys = _inputs(seed)
    jprob = jr.make_batch_problem(jr.build_topology(pos, RADIUS), jr.Kernel("rbf", gamma=1.0),
                                  ys, jnp.full((N,), LAM), dtype=dtype)
    jst = jr.colored_sweep(jprob, jr.init_state(jprob), n_sweeps=2)
    tprob = convert.problem_from_numpy(_leaves(jprob), kernel=tr.Kernel("rbf", gamma=1.0),
                                       device="cpu")
    tst = convert.state_from_numpy({"z": np.asarray(jst.z), "coef": np.asarray(jst.coef)},
                                   device="cpu")
    return jprob, jst, tprob, tst


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _model(*a, **k):
    return tf.make_fault_model(*a, device="cpu", **k)


def _sweep(prob, state, engine, n_sweeps, delivered=None):
    if engine == "serial":
        return tr.serial_sweep(prob, state, n_sweeps=n_sweeps, delivered=delivered)
    return tr.colored_sweep(prob, state, n_sweeps=n_sweeps, engine=engine, delivered=delivered)


def _equal(a, b):
    return torch.equal(a.z, b.z) and torch.equal(a.coef, b.coef)


@pytest.mark.parametrize("engine", ENGINES)
def test_all_delivered_is_bitwise_identity(engine):
    prob, state = _port()
    ones = torch.ones((3,) + tuple(prob.nbr_idx.shape), dtype=torch.bool)
    ref = _sweep(prob, state, engine, 3)
    assert _equal(ref, _sweep(prob, state, engine, 3, delivered=ones))
    assert _equal(ref, tf.faulty_sweep(prob, state, _model(0.0), _gen(0), 3, engine=engine))


@pytest.mark.parametrize("engine", COLORED)
def test_robust_under_all_ones_masks_is_colored(engine):
    prob, state = _port()
    ones = torch.ones((3,) + tuple(prob.nbr_idx.shape), dtype=torch.bool)
    alive = torch.ones((3, prob.n), dtype=torch.bool)
    rob = tr.robust_sweep(prob, state, alive, n_sweeps=3, engine=engine, delivered=ones)
    assert _equal(rob, tr.colored_sweep(prob, state, n_sweeps=3, engine=engine))
    # a crash model that never crashes takes the robust path to the same bits
    out = tf.faulty_sweep(prob, state, _model(0.0, crash=(0.0, 1.0)), _gen(1), 3,
                          engine=engine)
    assert _equal(out, rob)


@pytest.mark.parametrize("engine", ENGINES)
def test_drop_all_is_hold_last_value(engine):
    prob, state = _port()
    out = tf.faulty_sweep(prob, state, _model(1.0), _gen(1), 2, engine=engine)
    assert torch.equal(out.z, state.z)
    assert not torch.equal(out.coef, state.coef)


def test_engines_agree_under_one_mask():
    prob, state = _port(3)
    delivered = torch.rand((4,) + tuple(prob.nbr_idx.shape), generator=_gen(7)) >= 0.3
    plan = _sweep(prob, state, "plan", 4, delivered)
    assert _equal(plan, _sweep(prob, state, "onehot", 4, delivered))
    cuda = _sweep(prob, state, "cuda", 4, delivered)
    np.testing.assert_allclose(_np(cuda.z), _np(plan.z), atol=1e-5)
    np.testing.assert_allclose(_np(cuda.coef), _np(plan.coef), atol=1e-3)


@pytest.mark.parametrize("kind,engine", [("free", "serial"), ("free", "plan"),
                                         ("free", "cuda"), ("crash", "plan"),
                                         ("crash", "onehot"), ("crash", "cuda")])
def test_matches_reference_on_its_masks(kind, engine):
    """The reference's sample_faults masks through the port's _faulty against
    the reference's faulty_sweep with the same key."""
    jprob, jst, tprob, tst = _reference(5)
    crash = (0.3, 0.5) if kind == "crash" else None
    jmodel = jf.make_fault_model(0.2, burst=(0.1, 0.4, 0.5), crash=crash)
    key = jax.random.PRNGKey(13)
    deliv, alive_tn = jf.sample_faults(jmodel, key, 4, jprob)
    jengine = "plan" if engine == "cuda" else engine
    want = jf.faulty_sweep(jprob, jst, jmodel, key, n_sweeps=4, engine=jengine)
    tmodel = _model(0.2, burst=(0.1, 0.4, 0.5), crash=crash)
    got = tf._faulty(tprob, tst, tmodel, torch.as_tensor(np.array(deliv)),
                     None if alive_tn is None else torch.as_tensor(np.array(alive_tn)),
                     4, engine)
    if kind == "crash":
        assert not np.asarray(alive_tn).all()  # the trace takes sensors down
    np.testing.assert_allclose(_np(got.z)[:, :-1], np.asarray(want.z)[:, :-1], atol=1e-5)
    np.testing.assert_allclose(_np(got.coef), np.asarray(want.coef), atol=1e-3)


def test_link_masks_statistics_and_coupling():
    """The reference's thresholds (tests/test_faults.py:140-167)."""
    prob, _ = _port()
    lanes = tuple(prob.nbr_idx.shape)
    low = tf.link_masks(_model(0.1), _gen(11), 50, lanes)
    high = tf.link_masks(_model(0.4), _gen(11), 50, lanes)
    assert low.shape == (50,) + lanes and low.dtype == torch.bool
    frac = lambda m: float(m.double().mean())  # noqa: E731
    assert 0.83 < frac(low) < 0.97 and 0.5 < frac(high) < 0.7
    assert not bool((high & ~low).any())  # one seed: a higher rate only shrinks the set
    bursty = tf.link_masks(_model(0.02, burst=(0.05, 0.3, 0.7)), _gen(11), 400, lanes)
    dropped = ~bursty
    marginal = float(dropped.double().mean())
    cond = float(dropped[1:][dropped[:-1]].double().mean())
    assert cond > 1.5 * marginal, (cond, marginal)
    # the chain starts at its stationary distribution: sweep 0 already has
    # the stationary delivered fraction (1 - drop) (1 - pi_bad drop_bad)
    first = tf.link_masks(_model(0.02, burst=(0.05, 0.3, 0.7)), _gen(3), 1, (200, 500))
    want = 0.98 * (1 - 0.05 / 0.35 * 0.7)
    assert abs(frac(first) - want) < 0.01, (frac(first), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_draw_order_and_dtype(dtype):
    """The chain's start is drawn first, then three uniforms per sweep
    (deliver, to-bad, to-good), all in the model's dtype, whatever the
    rates; a lane is delivered when its uniform is >= the drop rate."""
    lanes, t, p = (13, 8), 6, 0.37
    got = tf.link_masks(_model(p, dtype=dtype), _gen(4), t, lanes)
    g = _gen(4)
    torch.rand(lanes, generator=g, dtype=dtype)
    u = torch.rand((t, 3) + lanes, generator=g, dtype=dtype)
    assert torch.equal(got, u[:, 0] >= torch.tensor(p, dtype=dtype))


def test_crash_schedule_and_dispatch():
    prob, state = _port(5)
    null, free = _model(0.2, crash=(0.0, 1.0)), _model(0.2)
    assert null.has_crash and not free.has_crash
    d_null, alive = tf.sample_faults(null, _gen(13), 3, prob)
    d_free, none = tf.sample_faults(free, _gen(13), 3, prob)
    assert none is None and torch.equal(d_null, d_free)  # delivery is drawn first
    assert bool(alive.all()) and alive.shape == (3, prob.n)
    out_r = tf.faulty_sweep(prob, state, null, _gen(13), 3, engine="plan")
    out_c = tf.faulty_sweep(prob, state, free, _gen(13), 3, engine="plan")
    assert _equal(out_r, out_c)
    trace = tf.crash_schedule(_model(0.0, crash=(0.3, 0.5)), _gen(17), 60, N)
    assert bool((~trace).any()) and bool(trace.any())
    assert bool((~trace[:-1] & trace[1:]).any())  # sensors come back
    up = float(trace[10:].double().mean())
    assert abs(up - 0.5 / 0.8) < 0.1
    with pytest.raises(NotImplementedError, match="robust path"):
        tf.faulty_sweep(prob, state, null, _gen(13), 1, engine="serial")


def test_rates_are_tensors_of_the_requested_dtype_and_device():
    m = tf.parse_fault_spec("drop=0.1,burst=0.05:0.4:0.5", dtype=torch.float64, device="cpu")
    for v in (m.drop, m.burst_to_bad, m.burst_to_good, m.drop_bad):
        assert isinstance(v, torch.Tensor) and v.ndim == 0
        assert v.dtype == torch.float64 and v.device.type == "cpu"
    assert m.crash is None and m.restart is None


REJECTED = [
    "",                       # empty
    "drop",                   # missing '='
    "drop=",                  # empty value
    "drop=abc",               # non-numeric
    "drop=-0.1",              # negative rate
    "drop=1.5",               # rate > 1
    "drop=nan",               # NaN
    "drop=0.1,drop=0.2",      # repeated key
    "burst=0.1:0.2",          # wrong arity (wants 3)
    "burst=0.1:0.2:0.3:0.4",  # wrong arity (wants 3)
    "crash=0.1",              # wrong arity (wants 2)
    "crash=0.1:0.2:0.3",      # wrong arity (wants 2)
    "jitter=0.1",             # unknown key
]


@pytest.mark.parametrize("spec", REJECTED)
def test_parse_fault_spec_rejects_as_the_reference(spec):
    with pytest.raises(ValueError) as want:
        jf.parse_fault_spec(spec)
    with pytest.raises(ValueError) as got:
        tf.parse_fault_spec(spec, device="cpu")
    assert str(got.value) == str(want.value)
    assert "usage:" in str(got.value)


@pytest.mark.parametrize("spec", ["drop=0.1,burst=0.05:0.4:0.5,crash=0.01:0.2", "drop=0.3",
                                  "drop=0.1,burst=0.05:0.4:0.5", "drop=0.1,crash=0.01:0.25",
                                  " burst = 0.02:0.3:0.6 , drop=0.05,"])
def test_parse_fault_spec_accepts_as_the_reference(spec):
    want = jf.parse_fault_spec(spec)
    got = tf.parse_fault_spec(spec, device="cpu")
    assert got.has_crash == want.has_crash
    for name in ("drop", "burst_to_bad", "burst_to_good", "drop_bad", "crash", "restart"):
        w, g = getattr(want, name), getattr(got, name)
        assert (w is None) == (g is None), name
        if w is not None:
            assert float(g) == float(w) and g.dtype == torch.float32, name


F64_CODE = r"""
import os
os.environ["JAX_ENABLE_X64"] = "1"
import sys
sys.path.insert(0, "tests")
import numpy as np, jax, jax.numpy as jnp, torch
torch.set_num_threads(1)
import repro.core as jr
import repro_torch.core as tr
from repro.core import faults as jf
from repro_torch import convert
from repro_torch.core import faults as tf
from test_torch_build import _leaves, _np

n, b = 12, 2
pos = jr.uniform_sensors(n, d=1, seed=5)
ys = np.sin(np.pi * pos[None, :, 0]) + 0.2 * np.random.default_rng(6).normal(size=(b, n))
jprob = jr.make_batch_problem(jr.build_topology(pos, 0.55), jr.Kernel("rbf", gamma=1.0), ys,
                              jnp.full((n,), 0.3), dtype=jnp.float64)
jst = jr.colored_sweep(jprob, jr.init_state(jprob), n_sweeps=2)
tprob = convert.problem_from_numpy(_leaves(jprob), kernel=tr.Kernel("rbf", gamma=1.0),
                                   device="cpu")
tst = convert.state_from_numpy({"z": np.asarray(jst.z), "coef": np.asarray(jst.coef)},
                               device="cpu")
key = jax.random.PRNGKey(13)
for crash, engines in ((None, ("serial", "plan", "cuda")), ((0.3, 0.5), ("plan", "cuda"))):
    jmodel = jf.make_fault_model(0.2, burst=(0.1, 0.4, 0.5), crash=crash, dtype=jnp.float64)
    tmodel = tf.make_fault_model(0.2, burst=(0.1, 0.4, 0.5), crash=crash,
                                 dtype=torch.float64, device="cpu")
    deliv, alive_tn = jf.sample_faults(jmodel, key, 4, jprob)
    for engine in engines:
        want = jf.faulty_sweep(jprob, jst, jmodel, key, n_sweeps=4,
                               engine="plan" if engine == "cuda" else engine)
        got = tf._faulty(tprob, tst, tmodel, torch.as_tensor(np.array(deliv)),
                         None if alive_tn is None else torch.as_tensor(np.array(alive_tn)),
                         4, engine)
        assert got.z.dtype == torch.float64
        np.testing.assert_allclose(_np(got.z)[:, :-1], np.asarray(want.z)[:, :-1], atol=1e-10)
        np.testing.assert_allclose(_np(got.coef), np.asarray(want.coef), atol=1e-10)
m = tf.link_masks(tf.make_fault_model(0.3, dtype=torch.float64, device="cpu"),
                  torch.Generator().manual_seed(0), 20, (13, 8))
assert abs(float(m.double().mean()) - 0.7) < 0.05
print("f64 faults ok")
"""


def test_faults_f64_matches_reference(f64_run):
    out, err = f64_run.communicate(timeout=300)
    assert f64_run.returncode == 0, err[-3000:]
    assert "f64 faults ok" in out
