"""Port parity, train stage: the colored SN-Train sweep and its engines.

Tolerances are the reference's own (tests/test_scatter_plan.py): messages z
within 1e-5, coefficients within 1e-3 (a non-unique parameterization).
Port vs JAX excludes the sentinel slot z[:, -1] and the sentinel row
coef[:, -1]: the Pallas kernel redirects gated lanes' writes there, while
the port's kernel never stores a gated lane (its sentinel stays 0, as the
plan engine's).  Inside the port the reference's bitwise identities hold
bitwise: plan == onehot, all-True delivery is an identity, and the CUDA
engine's plain version equals the plan engine on every slot.  The serial
sweep (the paper's Table-1 order) and ``field_view`` close the file.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jr
import repro_torch.core as tr
from repro_torch import convert
from test_torch_build import _leaves, _np, _pair

torch.set_num_threads(1)

SWEEPS = 8


def _faults(jprob, tprob, seed=0, drop=0.3, dead=(5,)):
    """A dead row and a delivery mask with drops, identical in both packages."""
    rng = np.random.default_rng(seed)
    deliv = rng.uniform(size=(SWEEPS,) + tuple(jprob.nbr_idx.shape)) >= drop
    alive = np.asarray(jprob.alive).copy()
    alive[list(dead)] = False
    jprob = dataclasses.replace(jprob, alive=jnp.asarray(alive))
    tprob = dataclasses.replace(tprob, alive=torch.as_tensor(alive))
    return jprob, tprob, deliv


def _compare(t_state, j_state, z_tol=1e-5, c_tol=1e-3):
    np.testing.assert_allclose(_np(t_state.z)[..., :-1], np.asarray(j_state.z)[..., :-1],
                               atol=z_tol)
    np.testing.assert_allclose(_np(t_state.coef)[..., :-1, :],
                               np.asarray(j_state.coef)[..., :-1, :], atol=c_tol)


@pytest.mark.parametrize("faulty", [False, True])
@pytest.mark.parametrize("port_engine", ["plan", "onehot", "cuda"])
def test_colored_sweep_matches_jax(port_engine, faulty):
    """Every port engine against JAX plan AND pallas after SWEEPS sweeps."""
    jprob, tprob = _pair(n=40, b=2, d=2, radius=0.55, seed=1)
    deliv = None
    if faulty:
        jprob, tprob, deliv = _faults(jprob, tprob)
    jst, tst = jr.init_state(jprob), tr.init_state(tprob)
    jd = None if deliv is None else jnp.asarray(deliv)
    td = None if deliv is None else torch.as_tensor(deliv)
    out = tr.colored_sweep(tprob, tst, n_sweeps=SWEEPS, engine=port_engine, delivered=td)
    for j_engine in ("plan", "pallas"):
        ref = jr.colored_sweep(jprob, jst, n_sweeps=SWEEPS, engine=j_engine, delivered=jd)
        _compare(out, ref)
    assert float(out.z[:, -1].abs().max()) == 0.0  # the port never writes the sentinel


@pytest.mark.parametrize("faulty", [False, True])
def test_engines_bitwise_inside_port(faulty):
    """plan == onehot == cuda-on-CPU (the kernel's plain version), bit for bit."""
    _, tprob = _pair(n=30, b=3, d=2, radius=0.6, seed=4, headroom=2)
    td = None
    if faulty:
        _, tprob, deliv = _faults(tprob, tprob, seed=3, dead=(2, 17))
        td = torch.as_tensor(deliv)
    st0 = tr.colored_sweep(tprob, tr.init_state(tprob), n_sweeps=1)  # non-trivial z
    a = tr.colored_sweep(tprob, st0, n_sweeps=SWEEPS, engine="plan", delivered=td)
    for engine in ("onehot", "cuda"):
        b = tr.colored_sweep(tprob, st0, n_sweeps=SWEEPS, engine=engine, delivered=td)
        assert torch.equal(a.z, b.z), engine
        assert torch.equal(a.coef, b.coef), engine


@pytest.mark.parametrize("engine", ["plan", "onehot", "cuda"])
def test_all_delivered_and_alive_override_are_identities(engine):
    _, tprob = _pair(n=30, b=2, d=2, radius=0.6, seed=6)
    st0 = tr.init_state(tprob)
    ref = tr.colored_sweep(tprob, st0, n_sweeps=3, engine=engine)
    ones = torch.ones((3,) + tuple(tprob.nbr_idx.shape), dtype=torch.bool)
    via_mask = tr.colored_sweep(tprob, st0, n_sweeps=3, engine=engine, delivered=ones)
    via_alive = tr.colored_sweep(tprob, st0, n_sweeps=3, engine=engine, alive=tprob.alive)
    for other in (via_mask, via_alive):
        assert torch.equal(ref.z, other.z) and torch.equal(ref.coef, other.coef)
    # drop everything: messages frozen, coefficients still move (local compute)
    zeros = torch.zeros_like(ones)
    frozen = tr.colored_sweep(tprob, st0, n_sweeps=3, engine=engine, delivered=zeros)
    assert torch.equal(frozen.z, st0.z)
    assert not torch.equal(frozen.coef, st0.coef)
    assert torch.equal(st0.z, tr.init_state(tprob).z)  # the caller's state is untouched


def test_single_field_and_norm_and_local_only():
    """B = 1 problems, the weighted SOP norm and the local-only ablation."""
    jb, tb = _pair(n=30, b=2, d=2, radius=0.6, seed=8)
    jtopo, ttopo = jb.topology, tb.topology
    y = np.array(jb.y[0])
    jp = jr.make_problem(jtopo, jr.Kernel("rbf", gamma=1.0), y, jnp.full((30,), 0.1))
    tp = tr.make_problem(ttopo, tr.Kernel("rbf", gamma=1.0), y, np.full(30, 0.1, np.float32),
                         device="cpu")
    jst = jr.colored_sweep(jp, jr.init_state(jp), n_sweeps=SWEEPS)
    tst = tr.colored_sweep(tp, tr.init_state(tp), n_sweeps=SWEEPS, engine="cuda")
    _compare(tst, jst)
    np.testing.assert_allclose(_np(tr.weighted_norm_sq(tp, tst)),
                               np.asarray(jr.weighted_norm_sq(jp, jst)), rtol=1e-5)
    # Lemma 2.1: the product-space norm never grows along the sweep
    st = tr.init_state(tb)
    prev = tr.weighted_norm_sq(tb, st)
    for _ in range(4):
        st = tr.colored_sweep(tb, st, n_sweeps=1, engine="cuda")
        cur = tr.weighted_norm_sq(tb, st)
        assert bool(torch.all(cur <= prev * (1 + 1e-6))), (cur, prev)
        prev = cur
    for jprob, tprob in ((jp, tp), (jb, tb)):
        jl, tl = jr.local_only(jprob), tr.local_only(tprob)
        np.testing.assert_array_equal(_np(tl.z), np.asarray(jl.z))
        np.testing.assert_allclose(_np(tl.coef), np.asarray(jl.coef), atol=1e-3)


def test_centralized_krr_matches_jax():
    """Paper Eq. 6 (the independent fusion-center fit) and its kernel-matvec predict."""
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, size=(40, 1)).astype(np.float32)
    y = (np.sin(np.pi * x[:, 0]) + 0.1 * rng.normal(size=40)).astype(np.float32)
    xq = np.linspace(-1, 1, 23)[:, None].astype(np.float32)
    jm = jr.fit_krr(x, y, jr.Kernel("rbf", gamma=1.0), 0.1)
    tm = tr.fit_krr(x, y, tr.Kernel("rbf", gamma=1.0), 0.1, device="cpu")
    np.testing.assert_allclose(_np(tm.coef), np.asarray(jm.coef), atol=1e-4)
    ref = np.asarray(jr.predict(jm, xq))
    for use_kernel in (False, True):
        out = tr.predict(tm, xq, use_kernel=use_kernel)
        assert out.shape == (23,) and out.dtype == torch.float32
        np.testing.assert_allclose(_np(out), ref, atol=2e-5)


def test_serial_sweep_and_field_view_match_reference():
    """The batched serial sweep with a dead row and dropped deliveries, and one
    field's view of it, against the reference's (z 1e-5, coef 1e-3)."""
    jprob, _ = _pair(n=30, b=2, d=2, radius=0.6, seed=4)
    alive = np.asarray(jprob.alive).copy()
    alive[5] = False
    jprob = dataclasses.replace(jprob, alive=jnp.asarray(alive))
    tprob = convert.problem_from_numpy(_leaves(jprob), kernel=tr.Kernel("rbf", gamma=1.0),
                                       device="cpu")
    deliv = np.random.default_rng(3).uniform(size=(3,) + tuple(jprob.nbr_idx.shape)) >= 0.3
    jst = jr.serial_sweep(jprob, jr.init_state(jprob), n_sweeps=3, delivered=jnp.asarray(deliv))
    tst = tr.serial_sweep(tprob, tr.init_state(tprob), n_sweeps=3,
                          delivered=torch.as_tensor(deliv))
    np.testing.assert_allclose(_np(tst.z)[:, :-1], np.asarray(jst.z)[:, :-1], atol=1e-5)
    np.testing.assert_allclose(_np(tst.coef), np.asarray(jst.coef), atol=1e-3)
    assert float(tst.z[:, :-1].abs().max()) > 0
    # all-True delivery is bitwise the fault-free sweep
    st0 = tr.init_state(tprob)
    plain = tr.serial_sweep(tprob, st0, n_sweeps=2)
    assert torch.equal(plain.z, tr.serial_sweep(
        tprob, st0, n_sweeps=2, delivered=torch.ones((2,) + tuple(tprob.nbr_idx.shape),
                                                     dtype=torch.bool)).z)
    # one field's view runs the single-field path to the same bits
    for b in range(2):
        jp1, js1 = jr.field_view(jprob, jst, b)
        tp1, ts1 = tr.field_view(tprob, tst, b)
        assert not tp1.batched and tp1.beta.shape == ()
        for name in ("y", "nbr_pos", "nbr_mask", "gram", "chol", "stream_pos", "anchor_w"):
            np.testing.assert_array_equal(_np(getattr(tp1, name)), np.asarray(getattr(jp1, name)))
        one = tr.serial_sweep(tp1, ts1, n_sweeps=1)
        both = tr.serial_sweep(tprob, tst, n_sweeps=1)
        assert torch.equal(one.z, both.z[b]) and torch.equal(one.coef, both.coef[b])
    assert (tprob.sentinel, tprob.n_base, tprob.recolor_start) == (
        jprob.sentinel, jprob.n_base, jprob.recolor_start)
