"""Port parity, the sensor-level robust engine ``robust_sweep``.

Per sweep it refactors every masked local system and runs one colored
sweep under the sweep's liveness.  Inside the port, the reference's
identities hold (tests/test_lifecycle.py:437-507): at all-True liveness on
an arrival-free problem built by the port, ``robust_sweep`` equals
``colored_sweep`` bitwise on every engine (the ``cuda`` engine's wrapper
runs its plain version on CPU tensors); a batch equals its fields one by
one within the sweep bound (z 1e-5, coef 1e-3; the reference holds z to
1e-6, but the port's colored engine already rounds a batch differently from
a single field: ``colored_sweep`` differs from its field views by up to
1.6e-6 in z on this problem); plan equals onehot bitwise under a liveness
trace, the cuda wrapper within 1e-5; a dead sensor's messages and coefficients persist
bitwise.  Against the reference's ``robust_sweep`` on the same problem
(carried over with ``repro_torch.convert``) and the same numpy liveness and
delivery masks: z within 1e-5, coef within 1e-3 (tests/test_scatter_plan.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jr
import repro_torch.core as tr
from repro_torch import convert
from repro_torch.core import sn_train
from test_torch_build import _leaves, _np

torch.set_num_threads(1)

N, B, SPARES, RADIUS, LAM = 24, 3, 4, 0.7, 0.1
ENGINES = ("plan", "onehot", "cuda")


def _port_problem(b=B):
    pos = tr.uniform_sensors(N, d=1, seed=0)
    ys = np.sin(np.pi * pos[None, :, 0]) + 0.2 * np.random.default_rng(1).normal(size=(b, N))
    d_max = int(tr.build_topology(pos, RADIUS, device="cpu").degrees.max()) + 4
    topo = tr.build_topology(pos, RADIUS, d_max=d_max, n_max=N + SPARES, device="cpu")
    prob = tr.make_batch_problem(topo, tr.Kernel("rbf", gamma=1.0), ys,
                                 np.full((N,), LAM, np.float32), device="cpu")
    return prob, tr.colored_sweep(prob, tr.init_state(prob), n_sweeps=5)


def _trace(prob, sweeps, seed):
    alive = np.random.default_rng(seed).random((sweeps, prob.n)) > 0.2
    alive[:, prob.n_base:] = False  # the spares stay dead
    return torch.as_tensor(alive)


@pytest.mark.parametrize("engine", ENGINES)
def test_all_alive_equals_colored_bitwise(engine):
    prob, state = _port_problem()
    alive = torch.ones(prob.n, dtype=torch.bool)
    r = tr.robust_sweep(prob, state, alive, n_sweeps=4, engine=engine)
    c = tr.colored_sweep(prob, state, n_sweeps=4, engine=engine)
    assert torch.equal(r.z, c.z) and torch.equal(r.coef, c.coef)
    # the refactored factors are the cached ones, bit for bit
    _, chol = sn_train._masked_factors(prob, prob.nbr_mask, prob.gram, prob.alive)
    assert torch.equal(chol, prob.chol)


def test_batched_equals_per_field():
    prob, state = _port_problem()
    alive = _trace(prob, 4, seed=2)
    out = tr.robust_sweep(prob, state, alive, n_sweeps=4)
    assert out.z.shape == state.z.shape
    for b in range(B):
        pv, sv = tr.field_view(prob, state, b)
        one = tr.robust_sweep(pv, sv, alive, n_sweeps=4)
        np.testing.assert_allclose(_np(out.z[b]), _np(one.z), atol=1e-5)
        np.testing.assert_allclose(_np(out.coef[b]), _np(one.coef), atol=1e-3)


def test_plan_equals_onehot_under_a_churn_trace():
    prob, state = _port_problem(b=2)
    alive = _trace(prob, 5, seed=3)
    a = tr.robust_sweep(prob, state, alive, n_sweeps=5, engine="plan")
    b = tr.robust_sweep(prob, state, alive, n_sweeps=5, engine="onehot")
    assert torch.equal(a.z, b.z) and torch.equal(a.coef, b.coef)
    c = tr.robust_sweep(prob, state, alive, n_sweeps=5, engine="cuda")
    np.testing.assert_allclose(_np(c.z), _np(a.z), atol=1e-5)
    # rows dead in every sweep made no update
    for r in np.nonzero(~_np(alive).any(axis=0)[: prob.n_base])[0]:
        assert torch.equal(a.coef[:, r], state.coef[:, r])


def test_dead_sensor_messages_persist_on_every_engine():
    prob, state = _port_problem(b=2)
    dead = 3
    alive = torch.ones(prob.n, dtype=torch.bool)
    alive[dead] = False
    assert float(state.z[:, dead].abs().max()) > 0
    for engine in ENGINES:
        out = tr.robust_sweep(prob, state, alive, n_sweeps=3, engine=engine)
        assert torch.equal(out.z[:, dead], state.z[:, dead]), engine
        assert torch.equal(out.coef[:, dead], state.coef[:, dead]), engine


@pytest.mark.parametrize("engine", ENGINES)
def test_matches_reference_with_liveness_and_delivery(engine):
    pos = jr.uniform_sensors(N, d=1, seed=0)
    ys = np.sin(np.pi * pos[None, :, 0]) + 0.2 * np.random.default_rng(1).normal(size=(2, N))
    d_max = int(np.asarray(jr.build_topology(pos, RADIUS).degrees).max()) + 4
    topo = jr.build_topology(pos, RADIUS, d_max=d_max, n_max=N + SPARES)
    jprob = jr.make_batch_problem(topo, jr.Kernel("rbf", gamma=1.0), ys, jnp.full((N,), LAM))
    jst = jr.colored_sweep(jprob, jr.init_state(jprob), n_sweeps=3)
    tprob = convert.problem_from_numpy(_leaves(jprob), kernel=tr.Kernel("rbf", gamma=1.0),
                                       device="cpu")
    tst = convert.state_from_numpy({"z": np.asarray(jst.z), "coef": np.asarray(jst.coef)},
                                   device="cpu")
    alive = _np(_trace(tprob, 4, seed=5))
    deliv = np.random.default_rng(6).random((4, tprob.n + 1, d_max)) > 0.3
    want = jr.robust_sweep(jprob, jst, jnp.asarray(alive), n_sweeps=4,
                           delivered=jnp.asarray(deliv))
    got = tr.robust_sweep(tprob, tst, torch.as_tensor(alive), n_sweeps=4, engine=engine,
                          delivered=torch.as_tensor(deliv))
    np.testing.assert_allclose(_np(got.z)[:, :-1], np.asarray(want.z)[:, :-1], atol=1e-5)
    np.testing.assert_allclose(_np(got.coef), np.asarray(want.coef), atol=1e-3)
    # an (n,) trace is the same mask every sweep; all-delivered is no mask
    one = tr.robust_sweep(tprob, tst, torch.as_tensor(alive[0]), n_sweeps=2, engine=engine)
    two = tr.robust_sweep(tprob, tst, torch.as_tensor(np.stack([alive[0]] * 2)), n_sweeps=2,
                          engine=engine, delivered=torch.ones((2, tprob.n + 1, d_max),
                                                              dtype=torch.bool))
    assert torch.equal(one.z, two.z) and torch.equal(one.coef, two.coef)


def test_refusals():
    prob, state = _port_problem(b=1)
    d = prob.nbr_idx.shape[1]
    with pytest.raises(NotImplementedError, match="link-level traces"):
        tr.robust_sweep(prob, state, torch.ones((2, prob.n, d), dtype=torch.bool), n_sweeps=2,
                        delivered=torch.ones((2, prob.n + 1, d), dtype=torch.bool))
    with pytest.raises(ValueError, match="alive must be"):
        tr.robust_sweep(prob, state, torch.ones((3, prob.n), dtype=torch.bool), n_sweeps=2)
    with pytest.raises(ValueError, match="delivered"):
        tr.robust_sweep(prob, state, torch.ones(prob.n, dtype=torch.bool), n_sweeps=2,
                        delivered=torch.ones((3, prob.n + 1, 3), dtype=torch.bool))
