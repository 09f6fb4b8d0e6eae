"""Port parity, the convergence watchdog ``core.monitor``.

On the reference's test geometry (tests/test_faults.py:46-60).  The receipt
has the reference's JSON schema: ``to_json`` gives the reference's payload
for the same fields, and each package's ``receipt_from_json`` reads the
other's.  ``format_receipt`` prints the reference's line.  Inside the port:
``watch_sweeps`` converges fault-free and at 10% drops, and from a
NaN-poisoned state retries, refactorizes once and rolls back to the entry
state bitwise, from memory and from a checkpoint directory.  Against the
reference: with the port's sampler patched to return the reference's masks
in the reference's key order, the receipts agree (integers and flags equal,
norms to 1e-4 relative, residuals, which are differences of iterates over
max |z| ~ 1, to the sweep engines' z bound of 1e-5).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jr
import repro_torch.core as tr
from repro.core import faults as jf
from repro.core import monitor as jm
from repro_torch import convert
from repro_torch.core import faults as tf
from repro_torch.core import monitor as tm
from test_torch_build import _leaves, _np

torch.set_num_threads(1)

N, B, RADIUS, LAM = 12, 2, 0.55, 0.3
INTS = ("rounds", "sweeps", "retries", "refactorized", "rolled_back")


def _inputs(seed):
    pos = tr.uniform_sensors(N, d=1, seed=seed)
    ys = np.sin(np.pi * pos[None, :, 0]) + 0.2 * np.random.default_rng(seed + 1).normal(
        size=(B, N))
    return pos, ys


def _port(seed):
    pos, ys = _inputs(seed)
    prob = tr.make_batch_problem(tr.build_topology(pos, RADIUS, device="cpu"),
                                 tr.Kernel("rbf", gamma=1.0), ys,
                                 np.full((N,), LAM, np.float32), device="cpu")
    return prob, tr.colored_sweep(prob, tr.init_state(prob), n_sweeps=2)


def _reference(seed):
    pos, ys = _inputs(seed)
    jprob = jr.make_batch_problem(jr.build_topology(pos, RADIUS), jr.Kernel("rbf", gamma=1.0),
                                  ys, jnp.full((N,), LAM))
    jst = jr.colored_sweep(jprob, jr.init_state(jprob), n_sweeps=2)
    tprob = convert.problem_from_numpy(_leaves(jprob), kernel=tr.Kernel("rbf", gamma=1.0),
                                       device="cpu")
    tst = convert.state_from_numpy({"z": np.asarray(jst.z), "coef": np.asarray(jst.coef)},
                                   device="cpu")
    return jprob, jst, tprob, tst


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _fields(rolled_back=False, converged=(True, False)):
    return dict(converged=np.array(converged), residual=np.array([2.5e-4, 3.25e-3]),
                norm=np.array([1.5, 7.125]), rounds=7, sweeps=35, retries=1,
                refactorized=int(rolled_back), rolled_back=rolled_back,
                diverged=np.array([False, rolled_back]))


def test_receipt_json_matches_the_reference_both_ways():
    mine, theirs = tm.WatchdogReceipt(**_fields()), jm.WatchdogReceipt(**_fields())
    assert tm.RECEIPT_SCHEMA == jm.RECEIPT_SCHEMA
    assert mine.to_json() == theirs.to_json()
    for payload, reader in ((mine.to_json(), jm.receipt_from_json),
                            (theirs.to_json(), tm.receipt_from_json)):
        back = reader(json.loads(json.dumps(payload)))
        for name, want in _fields().items():
            np.testing.assert_array_equal(np.asarray(getattr(back, name)), np.asarray(want))
    with pytest.raises(ValueError, match="schema"):
        tm.receipt_from_json({**mine.to_json(), "schema": "watchdog_receipt/0"})


@pytest.mark.parametrize("rolled_back,converged", [(False, (True, True)),
                                                    (False, (True, False)),
                                                    (True, (False, False))])
def test_format_receipt_matches_the_reference(rolled_back, converged):
    f = _fields(rolled_back, converged)
    assert tm.format_receipt(tm.WatchdogReceipt(**f)) == jm.format_receipt(
        jm.WatchdogReceipt(**f))


def test_converges_fault_free_and_at_10pct():
    prob, state = _port(8)
    cfg = tm.WatchdogConfig(tol=1e-3, max_rounds=60)
    _, _, r0 = tm.watch_sweeps(prob, state, config=cfg)
    assert r0.converged.all() and not r0.rolled_back
    _, _, r1 = tm.watch_sweeps(prob, state, model=tf.make_fault_model(0.1, device="cpu"),
                               generator=_gen(2), config=cfg, engine="cuda")
    assert r1.converged.all() and not r1.rolled_back
    assert r0.converged.shape == (B,) and r0.residual.shape == (B,)
    assert "converged" in tm.format_receipt(r1)
    with pytest.raises(ValueError, match="Generator"):
        tm.watch_sweeps(prob, state, model=tf.make_fault_model(0.1, device="cpu"))


def _poisoned(state):
    z = state.z.clone()
    z[0, 0] = float("nan")
    return tr.SNTrainState(z=z, coef=state.coef.clone())


@pytest.mark.parametrize("where", ["memory", "disk"])
def test_rollback_ladder_restores_bitwise(where, tmp_path):
    prob, state = _port(9)
    bad = _poisoned(state)
    cfg = tm.WatchdogConfig(max_rounds=14)
    p2, s2, rec = tm.watch_sweeps(
        prob, bad, model=tf.make_fault_model(0.05, device="cpu"), generator=_gen(3),
        engine="cuda", config=cfg, snapshot_dir=None if where == "memory" else str(tmp_path))
    assert rec.retries == cfg.max_retries and rec.refactorized == 1 and rec.rolled_back
    assert rec.rounds == 10 and rec.sweeps == 50
    assert np.array_equal(_np(s2.z), _np(bad.z), equal_nan=True)
    assert torch.equal(s2.coef, bad.coef) and torch.equal(p2.chol, prob.chol)
    assert "ROLLED BACK" in tm.format_receipt(rec)


def test_in_memory_snapshot_owns_its_tensors():
    """The snapshot clones what a later in-place write could change: the
    state and the factors."""
    prob, state = _port(9)
    p0, s0 = tm._snapshot(prob, state, None)
    z, coef, chol = state.z.clone(), state.coef.clone(), prob.chol.clone()
    state.z.add_(1.0)
    state.coef.mul_(2.0)
    prob.chol.zero_()
    assert torch.equal(s0.z, z) and torch.equal(s0.coef, coef) and torch.equal(p0.chol, chol)


def _reference_masks(jmodel, key, spr, jprob, rounds):
    """The masks the reference's watch_sweeps draws in each round."""
    out = []
    sample = jax.jit(jf.sample_faults, static_argnums=2)
    for _ in range(rounds):
        key, sub = jax.random.split(key)
        deliv, alive = sample(jmodel, sub, spr, jprob)
        out.append((torch.as_tensor(np.array(deliv)),
                    None if alive is None else torch.as_tensor(np.array(alive))))
    return out


@pytest.mark.parametrize("case", ["ladder", "drop10", "crash"])
def test_receipt_matches_the_reference_on_its_masks(case, monkeypatch):
    jprob, jst, tprob, tst = _reference(9 if case == "ladder" else 8)
    spec = {"ladder": "drop=0.05", "drop10": "drop=0.1", "crash": "drop=0.1,crash=0.05:0.5"}
    jmodel = jf.parse_fault_spec(spec[case])
    tmodel = tf.parse_fault_spec(spec[case], device="cpu")
    if case == "ladder":
        jst = dataclasses.replace(jst, z=jst.z.at[0, 0].set(jnp.nan))
        tst = _poisoned(tst)
        cfg = dict(max_rounds=14)
    else:
        cfg = dict(tol=1e-3, max_rounds=24 if case == "drop10" else 8)
    key = jax.random.PRNGKey(3)
    masks = iter(_reference_masks(jmodel, key, 5, jprob, cfg["max_rounds"]))
    monkeypatch.setattr(tf, "sample_faults", lambda model, gen, n, problem: next(masks))
    _, _, want = jm.watch_sweeps(jprob, jst, model=jmodel, key=key,
                                 config=jm.WatchdogConfig(**cfg))
    _, _, got = tm.watch_sweeps(tprob, tst, model=tmodel, generator=_gen(0),
                                config=tm.WatchdogConfig(**cfg))
    for name in INTS:
        assert getattr(got, name) == getattr(want, name), name
    np.testing.assert_array_equal(got.converged, want.converged)
    np.testing.assert_array_equal(got.diverged, want.diverged)
    np.testing.assert_allclose(got.norm, want.norm, rtol=1e-4)
    # a residual is a difference of iterates over max |z| ~ 1: the z bound
    np.testing.assert_allclose(got.residual, want.residual, atol=1e-5)
    if case == "ladder":
        assert want.rolled_back and got.rolled_back
    elif case == "drop10":
        assert want.rounds < cfg["max_rounds"]  # the run converged, not ran out
