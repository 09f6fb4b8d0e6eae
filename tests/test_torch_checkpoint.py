"""Port parity, the checkpoint package ``repro_torch.checkpoint``.

``save_train``/``restore_train`` round-trip a problem and state bitwise, on
the template's device in the template's dtypes, with the static fields
carried over.  ``latest_step`` skips truncated, manifest-less and npz-less
steps (tests/test_faults.py:327-371).  The port flattens its trees in the
order of the reference's ``jax.tree.flatten`` and writes the reference's
layout, so a checkpoint of either package restores bitwise into the other,
for a batched problem, a single-field view and a problem with spare rows.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jr
import repro_torch.core as tr
from repro import checkpoint as jc
from repro_torch import checkpoint as tc
from repro_torch import convert
from repro_torch.checkpoint import ckpt
from test_torch_build import _leaves, _np

torch.set_num_threads(1)

N, B, RADIUS, LAM = 12, 2, 0.55, 0.3


def _inputs(seed, b=B):
    pos = tr.uniform_sensors(N, d=1, seed=seed)
    ys = np.sin(np.pi * pos[None, :, 0]) + 0.2 * np.random.default_rng(seed + 1).normal(
        size=(b, N))
    return pos, ys


def _port(seed=10):
    pos, ys = _inputs(seed)
    prob = tr.make_batch_problem(tr.build_topology(pos, RADIUS, device="cpu"),
                                 tr.Kernel("rbf", gamma=1.0), ys,
                                 np.full((N,), LAM, np.float32), device="cpu")
    return prob, tr.colored_sweep(prob, tr.init_state(prob), n_sweeps=2)


def _reference(kind, seed=10):
    """The reference's problem and state of ``kind``, and the port's copy."""
    pos, ys = _inputs(seed)
    n_max = N + 3 if kind == "spares" else None
    jprob = jr.make_batch_problem(jr.build_topology(pos, RADIUS, n_max=n_max),
                                  jr.Kernel("rbf", gamma=1.0), ys, jnp.full((N,), LAM))
    jst = jr.colored_sweep(jprob, jr.init_state(jprob), n_sweeps=2)
    if kind == "single":
        jprob, jst = jr.field_view(jprob, jst, 1)
    tprob = convert.problem_from_numpy(_leaves(jprob), kernel=tr.Kernel("rbf", gamma=1.0),
                                       device="cpu")
    tst = convert.state_from_numpy({"z": np.asarray(jst.z), "coef": np.asarray(jst.coef)},
                                   device="cpu")
    return jprob, jst, tprob, tst


def _port_leaves(prob, state):
    return [leaf for _, leaf in ckpt._items({"problem": prob, "state": state})]


def _assert_pairs_equal(port, ref):
    assert len(port) == len(ref)
    for i, (a, b) in enumerate(zip(port, ref)):
        a, b = _np(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (i, a.dtype, b.dtype)
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), i


def test_round_trip_bitwise(tmp_path):
    prob, state = _port()
    state = tr.SNTrainState(z=state.z.clone(), coef=state.coef.clone())
    state.z[1, 3] = float("nan")  # NaN payloads survive too
    path = tc.save_train(str(tmp_path), 3, prob, state)
    assert os.path.basename(path) == "step_00000003" and tc.latest_step(str(tmp_path)) == 3
    p2, s2 = tc.restore_train(str(tmp_path), 3, prob, state)
    want, got = _port_leaves(prob, state), _port_leaves(p2, s2)
    _assert_pairs_equal(got, want)
    for a, b in zip(want, got):
        assert b.device == a.device and b.dtype == a.dtype
    assert p2.kernel == prob.kernel and p2.n_stream == prob.n_stream
    assert p2.topology.n_colors == prob.topology.n_colors and p2.n_base == prob.n_base


def test_latest_step_skips_crash_corrupted_checkpoints(tmp_path):
    prob, state = _port(13)
    d = str(tmp_path)
    tc.save_train(d, 1, prob, state)
    tc.save_train(d, 2, prob, state)
    assert tc.latest_step(d) == 2
    arrays2 = os.path.join(d, "step_00000002", "arrays.npz")  # truncated npz: CRC fails
    with open(arrays2, "r+b") as f:
        f.truncate(os.path.getsize(arrays2) // 2)
    assert not tc.step_valid(d, 2) and tc.step_valid(d, 1)
    assert tc.latest_step(d) == 1 and tc.latest_step(d, verify=False) == 2
    p2, s2 = tc.restore_train(d, tc.latest_step(d), prob, state)
    _assert_pairs_equal(_port_leaves(p2, s2), _port_leaves(prob, state))
    tc.save_train(d, 3, prob, state)  # a step that never got its manifest
    os.remove(os.path.join(d, "step_00000003", "manifest.json"))
    assert not tc.step_valid(d, 3) and tc.latest_step(d) == 1
    tc.save_train(d, 4, prob, state)  # a missing npz
    os.remove(os.path.join(d, "step_00000004", "arrays.npz"))
    assert tc.latest_step(d) == 1
    with open(os.path.join(d, "step_00000001", "arrays.npz"), "r+b") as f:
        f.truncate(10)
    assert tc.latest_step(d) is None
    assert tc.latest_step(os.path.join(d, "nowhere")) is None


def test_leaf_order_and_dtypes_are_the_references():
    """A problem the port builds flattens to the reference's leaves, in
    order, with the reference's dtypes and shapes."""
    pos, ys = _inputs(10)
    jprob = jr.make_batch_problem(jr.build_topology(pos, RADIUS), jr.Kernel("rbf", gamma=1.0),
                                  ys, jnp.full((N,), LAM))
    prob, _ = _port(10)
    jl = jax.tree.leaves({"problem": jprob, "state": jr.init_state(jprob)})
    tl = _port_leaves(prob, tr.init_state(prob))
    assert [(np.asarray(a).dtype, np.shape(a)) for a in jl] == \
        [(_np(b).dtype, tuple(b.shape)) for b in tl]


@pytest.mark.parametrize("kind", ["batched", "single", "spares"])
def test_reference_checkpoint_restores_into_the_port(kind, tmp_path):
    jprob, jst, tprob, tst = _reference(kind)
    jst = jr.colored_sweep(jprob, jst, n_sweeps=1)  # the template's state differs
    jc.save_train(str(tmp_path), 5, jprob, jst)
    p2, s2 = tc.restore_train(str(tmp_path), 5, tprob, tst)
    _assert_pairs_equal(_port_leaves(p2, s2),
                        jax.tree.leaves({"problem": jprob, "state": jst}))
    assert p2.kernel == tprob.kernel and p2.n_stream == tprob.n_stream


@pytest.mark.parametrize("kind", ["batched", "single", "spares"])
def test_port_checkpoint_restores_into_the_reference(kind, tmp_path):
    jprob, jst, tprob, tst = _reference(kind)
    tst = tr.colored_sweep(tprob, tst, n_sweeps=1)
    tc.save_train(str(tmp_path), 6, tprob, tst)
    assert jc.latest_step(str(tmp_path)) == 6 and jc.step_valid(str(tmp_path), 6)
    p2, s2 = jc.restore_train(str(tmp_path), 6, jprob, jst)
    _assert_pairs_equal(_port_leaves(tprob, tst), jax.tree.leaves({"problem": p2, "state": s2}))


def test_generic_trees_and_shape_checks(tmp_path):
    tree = {"b": [torch.arange(3), np.ones((2, 2), np.float64)], "a": torch.zeros(2, 1),
            "scale": 0.5}
    tc.save(str(tmp_path), 0, tree)
    like = {"b": [torch.zeros(3, dtype=torch.int64), np.zeros((2, 2))], "a": torch.ones(2, 1),
            "scale": 2.0}
    back = tc.restore(str(tmp_path), 0, like)
    assert list(back) == ["b", "a", "scale"] and back["scale"] == 2.0  # static
    assert torch.equal(back["a"], tree["a"]) and torch.equal(back["b"][0], tree["b"][0])
    assert isinstance(back["b"][1], np.ndarray) and np.array_equal(back["b"][1], tree["b"][1])
    with pytest.raises(ValueError, match="shape"):
        tc.restore(str(tmp_path), 0, {**like, "a": torch.ones(3, 1)})
    with pytest.raises(ValueError, match="leaves"):
        tc.restore(str(tmp_path), 0, {"a": like["a"]})
