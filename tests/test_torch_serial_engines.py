"""Port parity, the single-field serial engines: ``random_sweep``,
``robust_sweep_links`` and ``weighted_sweep``.

Against the reference on the same problem (carried over with
``repro_torch.convert``): ``random_sweep`` on the reference's own
permutations (the port's private core takes the visiting orders; torch's
generator cannot draw JAX's), ``robust_sweep_links`` on the same link
traces, ``weighted_sweep`` and ``weighted_norm_sq_hetero`` on the same
weights; z within 1e-5 and coef within 1e-3 (tests/test_scatter_plan.py).
Inside the port, the reference's identities (tests/test_sn_train.py:213-395)
at its tolerances: unit weights == serial, all-alive links == serial, Fejer
monotone random and weighted sweeps, the persistent liveness threaded
through both dense engines; and ``robust_sweep`` routes a 3-D trace to
``robust_sweep_links`` and refuses it with ``delivered``.
"""

import jax
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


def _pair(n=20, radius=0.6, seed=3, dead=()):
    """A single-field view of a lifecycle problem (2 spare rows, ``dead``
    sensors removed) in the reference, and the same carried over."""
    pos = jr.uniform_sensors(n, seed=seed)
    y = np.sin(np.pi * pos[:, 0]) + 0.2 * np.random.default_rng(seed + 1).normal(size=n)
    jprob = jr.make_batch_problem(jr.build_topology(pos, radius, n_max=n + 2),
                                  jr.Kernel("rbf", gamma=1.0), y[None, :],
                                  jnp.full((n,), 0.1))
    jst = jr.serial_sweep(jprob, jr.init_state(jprob), n_sweeps=3)
    for s in dead:
        jprob, jst, ok = jr.remove_sensor(jprob, jst, s)
        assert bool(ok)
    jprob, jst = jr.field_view(jprob, jst, 0)
    tprob = convert.problem_from_numpy(_leaves(jprob), kernel=tr.Kernel("rbf", gamma=1.0),
                                       device="cpu")
    tst = convert.state_from_numpy({"z": np.asarray(jst.z), "coef": np.asarray(jst.coef)},
                                   device="cpu")
    return jprob, jst, tprob, tst


def _port(n=30, radius=0.8, seed=0, lam=0.1):
    """The reference test's ``_setup`` problem, built by the port."""
    pos = tr.uniform_sensors(n, seed=seed)
    y = np.sin(np.pi * pos[:, 0]) + 0.5 * np.random.default_rng(seed + 1).normal(size=n)
    prob = tr.make_problem(tr.build_topology(pos, radius, device="cpu"),
                           tr.Kernel("rbf", gamma=1.0), y, np.full((n,), lam, np.float32),
                           device="cpu")
    return prob, tr.init_state(prob)


def _close(got, want, z=1e-5, coef=1e-3):
    np.testing.assert_allclose(_np(got.z)[:-1], np.asarray(want.z)[:-1], atol=z)
    np.testing.assert_allclose(_np(got.coef), np.asarray(want.coef), atol=coef)


@pytest.mark.parametrize("dead", [(), (4, 11)])
def test_random_sweep_matches_reference_on_its_permutations(dead):
    jprob, jst, tprob, tst = _pair(dead=dead)
    key = jax.random.PRNGKey(5)
    want = jr.random_sweep(jprob, jst, key, n_sweeps=3)
    orders = [np.asarray(jax.random.permutation(k, jprob.n)) for k in jax.random.split(key, 3)]
    _close(sn_train._random_core(tprob, tst, orders), want)


@pytest.mark.parametrize("dead", [(), (4, 11)])
def test_robust_sweep_links_matches_reference(dead):
    jprob, jst, tprob, tst = _pair(dead=dead)
    trace = np.random.default_rng(7).random((3, jprob.n, tprob.nbr_idx.shape[1])) > 0.25
    want = jr.robust_sweep_links(jprob, jst, jnp.asarray(trace), n_sweeps=3)
    _close(tr.robust_sweep_links(tprob, tst, torch.as_tensor(trace), n_sweeps=3), want)
    # robust_sweep routes a 3-D trace here
    _close(tr.robust_sweep(tprob, tst, torch.as_tensor(trace), n_sweeps=3), want)


@pytest.mark.parametrize("dead", [(), (4, 11)])
def test_weighted_sweep_matches_reference(dead):
    jprob, jst, tprob, tst = _pair(dead=dead)
    w = np.random.default_rng(0).uniform(0.2, 5.0, jprob.n).astype(np.float32)
    want = jr.weighted_sweep(jprob, jst, jnp.asarray(w), n_sweeps=3)
    got = tr.weighted_sweep(tprob, tst, torch.as_tensor(w), n_sweeps=3)
    _close(got, want)
    np.testing.assert_allclose(
        float(tr.weighted_norm_sq_hetero(tprob, got, torch.as_tensor(w))),
        float(jr.weighted_norm_sq_hetero(jprob, want, jnp.asarray(w))), rtol=1e-5)


def test_random_ordering_reaches_the_serial_fixed_point():
    prob, st0 = _port()
    s = tr.serial_sweep(prob, st0, n_sweeps=400)
    r = tr.random_sweep(prob, st0, torch.Generator().manual_seed(0), n_sweeps=400)
    np.testing.assert_allclose(_np(s.z), _np(r.z), atol=5e-3)


def test_random_and_weighted_sweeps_are_fejer_monotone():
    prob, state = _port(seed=4, lam=1e-2)
    g = torch.Generator().manual_seed(0)
    prev = float(tr.weighted_norm_sq(prob, state))
    for _ in range(5):
        state = tr.random_sweep(prob, state, g, n_sweeps=1)
        cur = float(tr.weighted_norm_sq(prob, state))
        assert cur <= prev * 1.03 + 1e-5
        prev = cur
    prob, state = _port(seed=2, lam=1e-2)
    w = torch.as_tensor(np.random.default_rng(0).uniform(0.2, 5.0, prob.n).astype(np.float32))
    prev = float(tr.weighted_norm_sq_hetero(prob, state, w))
    for _ in range(6):
        state = tr.weighted_sweep(prob, state, w, n_sweeps=1)
        cur = float(tr.weighted_norm_sq_hetero(prob, state, w))
        assert cur <= prev * 1.03 + 1e-5, (cur, prev)
        prev = cur


def test_unit_weights_and_all_alive_links_equal_serial():
    prob, st0 = _port()
    a = tr.serial_sweep(prob, st0, n_sweeps=20)
    b = tr.weighted_sweep(prob, st0, torch.ones(prob.n), n_sweeps=20)
    np.testing.assert_allclose(_np(a.z), _np(b.z), atol=1e-4)
    ones = torch.ones((20, prob.n, prob.topology.d_max), dtype=torch.bool)
    r = tr.robust_sweep(prob, st0, ones, n_sweeps=20)
    np.testing.assert_allclose(_np(a.z), _np(r.z), atol=1e-3)
    np.testing.assert_allclose(_np(a.coef), _np(r.coef), atol=1e-2)


def test_dense_engines_thread_the_alive_mask():
    """On a partially alive problem both dense engines equal the masked
    serial engine; removed sensors stay zero."""
    dead = (4, 11)
    _, _, prob, state = _pair(dead=dead)
    a = tr.serial_sweep(prob, state, n_sweeps=3)
    b = tr.weighted_sweep(prob, state, torch.ones(prob.n), n_sweeps=3)
    c = tr.robust_sweep_links(prob, state, torch.ones((3, prob.n, prob.nbr_idx.shape[1]),
                                                      dtype=torch.bool), n_sweeps=3)
    for out in (b, c):
        np.testing.assert_allclose(_np(a.z), _np(out.z), atol=1e-5)
        np.testing.assert_allclose(_np(a.coef), _np(out.coef), atol=1e-4)
        for s in dead:
            assert float(out.z[s].abs()) == 0.0 and float(out.coef[s].abs().max()) == 0.0


def test_single_field_only_and_refusals():
    _, _, prob, state = _pair()
    pos = tr.uniform_sensors(10, seed=1)
    batch = tr.make_batch_problem(tr.build_topology(pos, 0.8, device="cpu"),
                                  tr.Kernel("rbf", gamma=1.0), np.zeros((2, 10)),
                                  np.full((10,), 0.1, np.float32), device="cpu")
    bst = tr.init_state(batch)
    for fn in (lambda: tr.random_sweep(batch, bst, torch.Generator()),
               lambda: tr.weighted_sweep(batch, bst, torch.ones(10)),
               lambda: tr.robust_sweep_links(batch, bst, torch.ones((1, 10, 5), dtype=bool))):
        with pytest.raises(NotImplementedError, match="single-field"):
            fn()
    d = prob.nbr_idx.shape[1]
    with pytest.raises(NotImplementedError, match="delivered"):
        tr.robust_sweep(prob, state, torch.ones((2, prob.n, d), dtype=torch.bool), n_sweeps=2,
                        delivered=torch.ones((2, prob.n + 1, d), dtype=torch.bool))
    with pytest.raises(ValueError, match="sweeps"):
        tr.robust_sweep_links(prob, state, torch.ones((3, prob.n, d), dtype=torch.bool), 2)
