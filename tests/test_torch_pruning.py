"""Port parity, representer pruning (``repro_torch.core.pruning``).

Against the JAX package on the same inputs (the reference's problem and
state, copied into the port): per-sensor and per-lane energies within 1e-5
in float32 and 1e-10 in float64, keep masks equal at thresholds chosen at
least 1e-4 relative away from every energy (the two packages sum the lanes
in different orders), ``prune_plan``'s ``cells``/``cell_mask``/``K_max`` and
the ``PruneReport`` integers bitwise equal, also on a plan repaired through a
churn trace and with ``spare`` columns, and ``answer_bound`` equal on the
same selections.  The float64 comparison runs in a subprocess with
``JAX_ENABLE_X64``, started with the file's first test.

Inside the port, the reference's properties (tests/test_pruning.py): pruned
answers within ``answer_bound`` of the unpruned ones at several liveness
fractions, on the mask path and the compacted plan, with the plan and cuda
engines; tau = 0 compaction exact; no resurrection after a leave; tau
monotone; ``ValueError`` without state or ecoef.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_shim import given, settings, strategies as st

import repro.core as jr
import repro_torch.core as tr
from repro.core import pruning as jp
from repro.core import serving as js
from repro_torch import convert
from repro_torch.core import pruning as tp
from repro_torch.core import serving as ts
from test_torch_build import _leaves, _np

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
N, B, SPARES, RADIUS, LAM = 24, 2, 4, 0.7, 0.1


@pytest.fixture(scope="module", autouse=True)
def f64_run():
    """The float64 comparison (F64_CODE), started before this file's first
    test so that it runs beside the float32 ones; read by its own test."""
    env = dict(os.environ, PYTHONPATH="src" + os.pathsep + "tests")
    proc = subprocess.Popen([sys.executable, "-c", F64_CODE], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _inputs(seed, n=N, b=B):
    pos = jr.uniform_sensors(n, d=1, seed=seed)
    rng = np.random.default_rng(seed + 1)
    ys = np.sin(np.pi * pos[None, :, 0]) + 0.2 * rng.normal(size=(b, n))
    return pos, ys, rng


def _reference(seed=0, spares=SPARES, sweeps=5):
    """The reference pruning tests' problem (tests/test_pruning.py::_problem)."""
    pos, ys, rng = _inputs(seed)
    topo = jr.build_topology(pos, RADIUS)
    d_max = int(np.asarray(topo.degrees).max()) + 2
    topo = jr.build_topology(pos, RADIUS, d_max=d_max, n_max=N + spares)
    prob = jr.make_batch_problem(topo, jr.Kernel("rbf", gamma=1.0), ys, jnp.full((N,), LAM))
    state = jr.colored_sweep(prob, jr.init_state(prob), n_sweeps=sweeps)
    return prob, state, pos, rng


def _to_port(jprob, jstate, jplan=None):
    tprob = convert.problem_from_numpy(_leaves(jprob), kernel=tr.Kernel("rbf", gamma=1.0),
                                       device=CPU)
    tstate = convert.state_from_numpy({"z": np.asarray(jstate.z),
                                       "coef": np.asarray(jstate.coef)}, device=CPU)
    if jplan is None:
        return tprob, tstate
    fields = {f.name: getattr(jplan, f.name) for f in dataclasses.fields(jplan)}
    tplan = convert.serving_plan_from_numpy(fields, device=CPU)
    return tprob, tstate, tplan


def _port(seed=0, spares=SPARES, sweeps=5):
    """The same problem built by the port itself, trained with its plan engine."""
    pos, ys, rng = _inputs(seed)
    topo = tr.build_topology(pos, RADIUS, device=CPU)
    d_max = int(topo.degrees.max()) + 2
    topo = tr.build_topology(pos, RADIUS, d_max=d_max, n_max=N + spares, device=CPU)
    prob = tr.make_batch_problem(topo, tr.Kernel("rbf", gamma=1.0), ys,
                                 np.full((N,), LAM, np.float32), device=CPU)
    state = tr.colored_sweep(prob, tr.init_state(prob), n_sweeps=sweeps)
    return prob, state, pos, rng


def _taus(energy, rel=1e-4):
    """0 and three thresholds between energies, each >= ``rel`` relative
    from every energy."""
    e = np.unique(energy[energy > 0])
    out = [0.0]
    for frac in (0.1, 0.3, 0.6):
        for i in range(int(frac * (e.size - 1)), e.size - 1):
            tau = 0.5 * (e[i] + e[i + 1])
            if np.abs(energy - tau).min() >= rel * tau:
                out.append(float(tau))
                break
    assert len(out) == 4
    return out


def _churned_reference(seed=3):
    """A reference problem, state and capacity plan after a join, a leave,
    a second join and sweeps between them."""
    prob, state, pos, _ = _reference(seed=seed)
    plan = jr.make_serving_plan(prob, k=3, spare=2, slack=2)
    ys_new = np.array([0.4, -0.2], np.float32)
    for x in (0.15, -0.55):
        prob, state, rec = jr.add_sensor(prob, state, np.array([x], np.float32), ys_new,
                                         lam=0.1)
        assert bool(rec.joined)
        plan, _ = js.plan_add_sensor(plan, np.array([x], np.float32), rec.slot)
        state = jr.colored_sweep(prob, state, n_sweeps=3)
        if x > 0:
            prob, state, ok = jr.remove_sensor(prob, state, 7)
            assert bool(ok)
            plan = js.plan_remove_sensor(plan, 7)
            state = jr.colored_sweep(prob, state, n_sweeps=3)
    return prob, state, plan


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_energies_and_keep_masks_match_reference(seed):
    jprob, jstate, _, _ = _reference(seed=seed)
    tprob, tstate = _to_port(jprob, jstate)
    e_ref = np.asarray(jp.representer_energy(jprob, jstate))
    e_port = _np(tp.representer_energy(tprob, tstate))
    lane_ref = np.asarray(jp.representer_energy(jprob, jstate, per_lane=True))
    lane_port = _np(tp.representer_energy(tprob, tstate, per_lane=True))
    assert e_port.dtype == np.float32 and e_port.shape == e_ref.shape == (N + SPARES + 1,)
    np.testing.assert_allclose(e_port, e_ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(lane_port, lane_ref, rtol=0, atol=1e-5)
    ecoef = tr.effective_coef(tprob, tstate)
    np.testing.assert_allclose(_np(tp.representer_energy(tprob, ecoef=ecoef)), e_ref,
                               rtol=0, atol=1e-5)
    for tau in _taus(e_ref):
        want = np.asarray(jp.prune_mask(jprob, jstate, energy_tau=tau))
        got = tp.prune_mask(tprob, tstate, energy_tau=tau)
        assert got.dtype == torch.bool and got.shape == (tprob.n + 1,)
        np.testing.assert_array_equal(_np(got), want, err_msg=f"tau={tau}")
        # a 0-d tensor threshold (the daemon's) gives the same mask
        np.testing.assert_array_equal(
            _np(tp.prune_mask(tprob, ecoef=ecoef, energy_tau=torch.tensor(tau))), want)
        assert not want[tprob.n] and not _np(got)[N:].any()  # spares and the sentinel


def _check_plan_parity(jprob, jstate, jplan, tprob, tstate, tplan, tau, spare):
    jc, jrep = jp.prune_plan(jprob, jstate, jplan, energy_tau=tau, spare=spare)
    tc, trep = tp.prune_plan(tprob, tstate, tplan, energy_tau=tau, spare=spare)
    assert tc.cells.dtype == torch.int32 and tc.cell_mask.dtype == torch.bool
    np.testing.assert_array_equal(_np(tc.cells), np.asarray(jc.cells))
    np.testing.assert_array_equal(_np(tc.cell_mask), np.asarray(jc.cell_mask))
    assert tc.k_max == jc.k_max and tc.k == jc.k and tc.grid_shape == jc.grid_shape
    for name in ("n_live", "n_kept", "n_pruned", "k_max_before", "k_max_after"):
        assert getattr(trep, name) == getattr(jrep, name), name
    assert trep.energy_tau == jrep.energy_tau
    np.testing.assert_array_equal(trep.keep, np.asarray(jrep.keep))
    # the untouched plan fields are the input's
    assert torch.equal(tc.centers, tplan.centers) and torch.equal(tc.radii, tplan.radii)
    return trep


@pytest.mark.parametrize("case", ["fresh", "churned"])
def test_prune_plan_tables_bitwise(case):
    if case == "fresh":
        jprob, jstate, _, _ = _reference(seed=1)
        jplan = jr.make_serving_plan(jprob, k=3, spare=2, slack=1)
    else:
        jprob, jstate, jplan = _churned_reference()
    tprob, tstate, tplan = _to_port(jprob, jstate, jplan)
    energy = np.asarray(jp.representer_energy(jprob, jstate))
    pruned = []
    for tau in _taus(energy):
        for spare in (0, 2):
            rep = _check_plan_parity(jprob, jstate, jplan, tprob, tstate, tplan, tau, spare)
            pruned.append(rep.n_pruned)
    assert pruned[0] == 0 and max(pruned) > 0
    # a threshold above every energy prunes every sensor: K_max falls to k
    top = float(energy.max()) * 2
    rep = _check_plan_parity(jprob, jstate, jplan, tprob, tstate, tplan, top, 0)
    assert rep.n_kept == 0 and rep.k_max_after == tplan.k


def test_answer_bound_equals_reference():
    jprob, jstate, _, rng = _reference(seed=2)
    jplan = jr.make_serving_plan(jprob, k=3, spare=2, slack=1)
    energy = np.asarray(jp.representer_energy(jprob, jstate))
    tau = _taus(energy)[2]
    keep = np.asarray(jp.prune_mask(jprob, jstate, energy_tau=tau))
    xq = rng.uniform(-1, 1, size=(64, 1)).astype(np.float32)
    positions = jprob.topology.positions
    sel_u, val_u = js.knn_select_valid(jplan, positions, xq, 3, jprob.alive)
    alive_p = ((np.asarray(jprob.alive) != 0) & keep).astype(np.int8)
    sel_p, val_p = js.knn_select_valid(jplan, positions, xq, 3, jnp.asarray(alive_p))
    args = [np.asarray(v) for v in (energy, sel_u, val_u, sel_p, val_p)]
    want = jp.answer_bound(*args)
    got = tp.answer_bound(*args)
    assert got.dtype == want.dtype and (want > 0).any()
    np.testing.assert_array_equal(got, want)
    # tensors are accepted too
    np.testing.assert_array_equal(tp.answer_bound(*[torch.tensor(a) for a in args]), want)


def _kill(prob, dead_ids):
    """Serving-level death: flip alive rows (serving reads only alive and
    the tables, so the factors may stay)."""
    alive = prob.alive.clone()
    alive[torch.as_tensor(np.asarray(dead_ids, dtype=np.int64))] = False
    return dataclasses.replace(prob, alive=alive)


@settings(max_examples=12, deadline=None)
@given(
    dead_mode=st.sampled_from(["none", "one", "k", "all"]),
    tau_frac=st.floats(min_value=0.0, max_value=0.6),
    seed=st.integers(min_value=0, max_value=3),
)
def test_pruned_within_answer_bound(dead_mode, tau_frac, seed):
    """|unpruned - pruned| <= answer_bound on the mask path and the compacted
    plan, with both engines, at dead fractions {0, 1/n, k/n, 1}."""
    k = 3
    prob, state, pos, rng = _port(seed=seed)
    plan = ts.make_serving_plan(prob, k=k, spare=2, slack=1)
    live_ids = np.flatnonzero(_np(prob.alive)[:-1])
    count = {"none": 0, "one": 1, "k": k, "all": live_ids.size}[dead_mode]
    dead = np.random.default_rng(seed + 7).choice(live_ids, size=count, replace=False)
    prob = _kill(prob, dead)
    energy = _np(tp.representer_energy(prob, state))
    tau = tau_frac * float(energy.max())
    keep = tp.prune_mask(prob, state, energy_tau=tau)
    xq = rng.uniform(-1, 1, size=(64, 1)).astype(np.float32)
    positions = prob.topology.positions
    xq_t = torch.as_tensor(xq)
    sel_u, val_u = ts.knn_select_valid(plan, positions, xq_t, k, prob.alive)
    sel_p, val_p = ts.knn_select_valid(plan, positions, xq_t, k, prob.alive & keep)
    bound = tp.answer_bound(energy, sel_u, val_u, sel_p, val_p)
    plan_c, rep = tp.prune_plan(prob, state, plan, energy_tau=tau)
    assert rep.k_max_after <= rep.k_max_before
    for engine in ("plan", "cuda"):
        u = _np(ts.knn_fuse(prob, state, xq, k=k, plan=plan, engine=engine))
        p_mask = _np(ts.knn_fuse(prob, state, xq, k=k, plan=plan, engine=engine, prune=keep))
        gap = np.abs(u - p_mask).max(axis=0)  # worst field per query
        assert (gap <= bound + 1e-5).all(), (engine, (gap - bound).max())
        # the compacted plan serves the mask path's answers
        p_comp = _np(ts.knn_fuse(prob, state, xq, k=k, plan=plan_c, engine=engine))
        np.testing.assert_allclose(p_comp, p_mask, rtol=0, atol=1e-6, err_msg=engine)


def test_tau0_compaction_exact_and_reclaims_capacity():
    """tau = 0 drops only dead and spare candidate entries: answers are the
    capacity plan's bitwise, and the gather width shrinks."""
    prob, state, pos, rng = _port(spares=6)
    k = 3
    plan = ts.make_serving_plan(prob, k=k, spare=6, slack=2)
    plan0, rep = tp.prune_plan(prob, state, plan, energy_tau=0.0)
    assert rep.n_pruned == 0
    assert rep.k_max_after < rep.k_max_before
    xq = rng.uniform(-1, 1, size=(128, 1)).astype(np.float32)
    for engine in ("plan", "cuda"):
        a = ts.knn_fuse(prob, state, xq, k=k, plan=plan, engine=engine)
        b = ts.knn_fuse(prob, state, xq, k=k, plan=plan0, engine=engine)
        assert torch.equal(a, b), engine


def test_no_resurrection_after_leave():
    """A removed sensor stays out of the keep mask (even at tau = 0), of every
    compacted candidate list and of every selection; a real re-join with
    trained coefficients re-enters."""
    prob, state, pos, rng = _port()
    k = 2
    victim = 5
    plan = ts.make_serving_plan(prob, k=k, spare=2, slack=1)
    prob2, state2, ok = tr.remove_sensor(prob, state, victim)
    assert bool(ok)
    keep = tp.prune_mask(prob2, state2, energy_tau=0.0)
    assert not bool(keep[victim])
    plan_c, _ = tp.prune_plan(prob2, state2, plan, energy_tau=0.0)
    assert victim not in _np(plan_c.cells)[_np(plan_c.cell_mask)]
    xq = torch.as_tensor(rng.uniform(-1, 1, size=(64, 1)).astype(np.float32))
    sel, valid = ts.knn_select_valid(plan_c, prob2.topology.positions, xq, k, keep)
    assert victim not in _np(sel)[_np(valid)]

    x_new = np.asarray(pos[victim], np.float32)
    prob3, state3, rec = tr.add_sensor(prob2, state2, x_new, np.array([0.4, -0.2], np.float32),
                                       lam=0.1)
    assert bool(rec.joined)
    state3 = tr.colored_sweep(prob3, state3, n_sweeps=3)  # it earns energy by training
    keep3 = tp.prune_mask(prob3, state3, energy_tau=0.0)
    assert bool(keep3[int(rec.slot)])


def test_tau_monotone_and_report():
    prob, state, _, _ = _port()
    plan = ts.make_serving_plan(prob, k=3, spare=2, slack=1)
    energy = _np(tp.representer_energy(prob, state))
    prev_kept = prev_kmax = None
    for tau_frac in (0.0, 0.1, 0.3, 0.6):
        tau = tau_frac * float(energy.max())
        keep = _np(tp.prune_mask(prob, state, energy_tau=tau))
        plan_c, rep = tp.prune_plan(prob, state, plan, energy_tau=tau)
        assert rep.n_live == rep.n_kept + rep.n_pruned
        assert rep.n_kept == int(keep[:-1].sum())
        np.testing.assert_array_equal(rep.keep, keep)
        if prev_kept is not None:
            # a larger tau keeps a subset, and the compacted width shrinks
            assert not np.any(keep & ~prev_kept)
            assert rep.k_max_after <= prev_kmax
        prev_kept, prev_kmax = keep, rep.k_max_after


def test_prune_needs_state_or_ecoef():
    prob, _, _, _ = _port()
    with pytest.raises(ValueError, match="state or ecoef"):
        tp.prune_mask(prob, energy_tau=0.0)
    with pytest.raises(ValueError, match="state or ecoef"):
        tp.representer_energy(prob)
    with pytest.raises(ValueError, match="state or ecoef"):
        tp.prune_plan(prob, None, ts.make_serving_plan(prob, k=3), energy_tau=0.0)


def test_reexports():
    for name in ("PruneReport", "answer_bound", "prune_mask", "prune_plan",
                 "representer_energy"):
        assert getattr(ts, name) is getattr(tp, name) is getattr(tr, name)
    assert tr.pruning is tp


def test_float64_subprocess(f64_run):
    out, err = f64_run.communicate(timeout=300)
    assert f64_run.returncode == 0, err[-3000:]
    assert "OK" in out, out


F64_CODE = r"""
import os
os.environ["JAX_ENABLE_X64"] = "1"
import dataclasses
import numpy as np
import jax.numpy as jnp
import torch
import repro.core as jr
import repro_torch.core as tr
from repro.core import pruning as jp
from repro_torch import convert
from repro_torch.core import pruning as tp
from test_torch_build import _leaves

torch.set_num_threads(1)
n, b = 24, 2
pos = jr.uniform_sensors(n, d=1, seed=4)
ys = np.sin(np.pi * pos[None, :, 0]) + 0.2 * np.random.default_rng(5).normal(size=(b, n))
topo = jr.build_topology(pos, 0.7)
topo = jr.build_topology(pos, 0.7, d_max=int(np.asarray(topo.degrees).max()) + 2, n_max=n + 4)
prob = jr.make_batch_problem(topo, jr.Kernel("rbf", gamma=1.0), ys, jnp.full((n,), 0.1),
                             dtype=jnp.float64)
state = jr.colored_sweep(prob, jr.init_state(prob), n_sweeps=5)
assert state.coef.dtype == jnp.float64
tprob = convert.problem_from_numpy(_leaves(prob), kernel=tr.Kernel("rbf", gamma=1.0),
                                   device="cpu")
tstate = convert.state_from_numpy({"z": np.asarray(state.z), "coef": np.asarray(state.coef)},
                                  device="cpu")
e_ref = np.asarray(jp.representer_energy(prob, state))
e_port = tp.representer_energy(tprob, tstate).numpy()
assert e_port.dtype == np.float64
assert np.abs(e_port - e_ref).max() <= 1e-10
lane_ref = np.asarray(jp.representer_energy(prob, state, per_lane=True))
assert np.abs(tp.representer_energy(tprob, tstate, per_lane=True).numpy() - lane_ref).max() <= 1e-10
plan = jr.make_serving_plan(prob, k=3, spare=2, slack=1)
tplan = convert.serving_plan_from_numpy(
    {f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)}, device="cpu")
e = np.unique(e_ref[e_ref > 0])
for i in (0, len(e) // 4, len(e) // 2):
    tau = 0.5 * (e[i] + e[i + 1])
    assert np.abs(e_ref - tau).min() >= 1e-4 * tau
    want = np.asarray(jp.prune_mask(prob, state, energy_tau=tau))
    assert np.array_equal(tp.prune_mask(tprob, tstate, energy_tau=tau).numpy(), want)
    jc, jrep = jp.prune_plan(prob, state, plan, energy_tau=tau, spare=1)
    tc, trep = tp.prune_plan(tprob, tstate, tplan, energy_tau=tau, spare=1)
    assert np.array_equal(tc.cells.numpy(), np.asarray(jc.cells))
    assert np.array_equal(tc.cell_mask.numpy(), np.asarray(jc.cell_mask))
    assert trep[:5] == tuple(jrep[:5]), (trep[:5], jrep[:5])
print("OK")
"""
