"""Port parity, the network lifecycle: the plan repairs, add_sensor and
remove_sensor, and the serving-plan repairs.

Each device-side repair of ``plans`` runs against the reference's on the
same seeded random tables, with sentinel-padded rows and the sentinel's
out-of-range color, and must give the same tables.  ``add_sensor`` and
``remove_sensor`` run against the reference's on the same problem (carried
over with ``repro_torch.convert``) after absorbed arrivals, so the adopters'
lanes shift and a full row drops its newest arrival: receipts and integer
tables equal, positions equal, Grams within 2e-5 (tests/test_kernels_pallas.py),
factors within 1e-4 (tests/test_multifield.py:189), messages and
coefficients within 1e-6.  ``repair_lambda`` is run at kappa = 1: at the
paper's kappa = 0.01 a row of degree 17 gets lambda ~3.5e-5 and its f32
factor is too ill-conditioned for 1e-4 (the float64 run covers kappa = 0.01
at 1e-10, in a subprocess with ``JAX_ENABLE_X64`` started with the file's
first test).  Inside the port: join -> leave restores every table the
reference restores bitwise (tests/test_lifecycle.py:145), a dropped join is
a bitwise no-op, and ``donate`` has absorb's contract.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jr
import repro_torch.core as tr
from repro.core import plans as jp
from repro.core import serving as jsv
from repro.core import streaming as js
from repro_torch import convert
from repro_torch.core import plans as tp
from repro_torch.core import serving as tsv
from repro_torch.core import streaming as ts
from test_torch_build import _leaves, _np

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, B, SPARES, RADIUS, LAM, HEADROOM, TARGET = 24, 2, 3, 0.7, 0.1, 3, 5
KERNEL = ("rbf", 1.0)
INT_TABLES = ("nbr_idx", "nbr_mask", "plan_z", "plan_coef", "color_members", "color_mask",
              "color_of", "member_pos", "alive", "nbr_pos", "stream_pos", "anchor_w", "y")
# what join -> leave restores; the departed row keeps the newcomer's
# position, neighbor positions, y and lambda, as in the reference
RESTORED = ("nbr_idx", "nbr_mask", "gram", "chol", "stream_pos", "anchor_w", "plan_z",
            "plan_coef", "color_members", "color_mask", "color_of", "member_pos", "alive")
EVERY = RESTORED + ("nbr_pos", "lam_pad", "y")


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


# ---------------------------------------------------------------------------
# plans: the device-side repairs on seeded random tables
# ---------------------------------------------------------------------------

NC, NR, NZ, D, R = 7, 10, 40, 5, 6  # colors, rows (sentinel NR), slots, lanes, repaired rows


def _rows_case(seed):
    """Plan tables and R rows, the gated ones on distinct colors (the
    collision contract), the gated-off ones the sentinel row NR with the
    out-of-range color NC and the sentinel slot on every lane."""
    rng = np.random.default_rng(seed)
    plan_z = rng.integers(0, NZ + NC * D, (NC, NZ)).astype(np.int32)
    plan_z[:, NZ - 1] = NZ - 1
    plan_coef = rng.integers(0, 2 * (NR + 1), (NC, NR + 1)).astype(np.int32)
    plan_coef[:, NR] = NR
    gate = rng.random(R) < 0.6
    gate[0], gate[-1] = True, False
    colors = rng.permutation(NC)[:R].astype(np.int32)
    slots = rng.permutation(NR)[:R].astype(np.int32)
    idx = np.stack([rng.permutation(NZ - 1)[:D] for _ in range(R)]).astype(np.int32)
    idx[1, -1] = NZ - 1  # a retired lane
    m_pos = rng.integers(0, 4, R).astype(np.int32)
    colors[~gate], slots[~gate], idx[~gate], m_pos[~gate] = NC, NR, NZ - 1, 0
    return plan_z, plan_coef, colors, slots, idx, m_pos, gate


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_rows_match_reference(seed):
    plan_z, plan_coef, colors, slots, idx, m_pos, gate = _rows_case(seed)
    want = jp.plan_rows_remove(*_j(plan_z, plan_coef, colors, slots, idx, gate))
    got = tp.plan_rows_remove(*_t(plan_z, plan_coef, colors, slots, idx, gate))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    want = jp.plan_rows_add(*want, *_j(colors, m_pos, slots, idx, gate))
    got = tp.plan_rows_add(*got, *_t(colors, m_pos, slots, idx, gate))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    # the single-row wrappers read the row's color (and position)
    color_of = np.concatenate([np.arange(NR) % NC, [NC]]).astype(np.int32)
    member_pos = (np.arange(NR + 1) % 3).astype(np.int32)
    for s, ok in ((3, True), (NR, False)):
        w = jp.color_plans_add(*_j(plan_z, plan_coef, color_of, member_pos, s, idx[0], ok))
        g = tp.color_plans_add(*_t(plan_z, plan_coef, color_of, member_pos), torch.tensor([s]),
                               torch.tensor(idx[0]), torch.tensor([ok]))
        w = jp.color_plans_remove(*w, *_j(color_of, s, idx[0], ok))
        g = tp.color_plans_remove(*g, torch.tensor(color_of), torch.tensor([s]),
                                  torch.tensor(idx[0]), torch.tensor([ok]))
        for a, b in zip(g, w):
            np.testing.assert_array_equal(_np(a), np.asarray(b))


@pytest.mark.parametrize("seed", [0, 1])
def test_member_tables_and_recoloring_match_reference(seed):
    rng = np.random.default_rng(seed)
    m = 4
    members = rng.integers(0, NR, (NC, m)).astype(np.int32)
    mask = rng.random((NC, m)) < 0.5
    mask[NC - 2:] = False  # two empty recolor classes
    members[~mask] = NR
    colors = np.array([1, 2, 3, NC, NC], np.int32)  # sentinel-padded, out-of-range color
    m_pos = np.array([0, 1, 3, 0, 0], np.int32)
    slots = np.array([4, 5, 6, NR, NR], np.int32)
    gate = np.array([True, True, False, False, False])
    w = jp.members_clear(*_j(members, mask, colors, m_pos, gate), NR)
    g = tp.members_clear(*_t(members, mask, colors, m_pos, gate), NR)
    for a, b in zip(g, w):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    targets = np.array([NC - 2, NC - 1, 0, NC, NC], np.int32)
    w = jp.members_set(*w, *_j(targets, np.zeros(5, np.int32), slots, gate))
    g = tp.members_set(*g, *_t(targets, np.zeros(5, np.int32), slots, gate))
    for a, b in zip(g, w):
        np.testing.assert_array_equal(_np(a), np.asarray(b))

    color_of = np.concatenate([rng.integers(0, NC - 2, NR), [NC]]).astype(np.int32)
    adopters = rng.permutation(NR)[:6].astype(np.int32)
    for valid in (np.array([1, 1, 1, 1, 0, 1], bool), np.ones(6, bool)):
        for pool in (mask, np.zeros_like(mask)):  # a full and an empty pool
            want = jp.resolve_join_conflicts(*_j(color_of, pool, adopters, valid), NC - 2)
            got = tp.resolve_join_conflicts(*_t(color_of, pool, adopters, valid), NC - 2)
            moved = np.asarray(want[1])
            np.testing.assert_array_equal(_np(got[1]), moved)
            assert bool(got[2]) == bool(want[2])
            if bool(want[2]):  # the new colors count where the join goes ahead
                np.testing.assert_array_equal(_np(got[0]), np.asarray(want[0]))
            else:
                np.testing.assert_array_equal(_np(got[0])[~moved], np.asarray(want[0])[~moved])
    assert not bool(tp.resolve_join_conflicts(*_t(color_of, np.zeros((NC, m), bool) | True,
                                                  adopters, np.ones(6, bool)), NC - 2)[2])


def test_cells_and_headroom_match_reference():
    rng = np.random.default_rng(3)
    c, k = 9, 5
    cells = rng.integers(0, NR, (c, k)).astype(np.int32)
    mask = rng.random((c, k)) < 0.6
    mask[0] = True  # a full cell
    centers = rng.uniform(-1, 1, (c, 2)).astype(np.float32)
    radii = rng.uniform(0.3, 1.2, c).astype(np.float32)
    x = centers[0] + 0.01
    for gate in (True, False):
        w = jp.cells_add(*_j(cells, mask, centers, radii, x, np.int32(7), gate))
        g = tp.cells_add(*_t(cells, mask, centers, radii, x), torch.tensor(7, dtype=torch.int32),
                         torch.tensor(gate))
        for a, b in zip(g, w):
            np.testing.assert_array_equal(_np(a), np.asarray(b))
        assert int(g[2]) == (int(w[2]) if gate else 0)
    assert int(g[2]) == 0 and int(w[2]) == 0
    assert int(tp.cells_add(*_t(cells, mask, centers, radii, x), torch.tensor(7),
                            torch.tensor(True))[2]) >= 1  # the full cell overflowed
    for gate in (True, False):
        np.testing.assert_array_equal(
            _np(tp.cells_remove(*_t(cells, mask), torch.tensor(3), torch.tensor(gate))),
            np.asarray(jp.cells_remove(*_j(cells, mask, np.int32(3), gate))))
    degrees = rng.integers(0, 9, NR).astype(np.int32)
    alive = rng.random(NR + 1) < 0.7
    np.testing.assert_array_equal(_np(tp.degree_headroom(*_t(degrees, alive), 7)),
                                  np.asarray(jp.degree_headroom(*_j(degrees, alive), 7)))


# ---------------------------------------------------------------------------
# add_sensor / remove_sensor against the reference
# ---------------------------------------------------------------------------


def _ref_problem(spares=SPARES, n_recolor=None):
    """The reference's lifecycle problem with arrivals absorbed: field 0 of
    TARGET full, field 1 of TARGET one arrival, and a few elsewhere."""
    pos = jr.uniform_sensors(N, d=1, seed=0)
    rng = np.random.default_rng(1)
    ys = np.sin(np.pi * pos[None, :, 0]) + 0.2 * rng.normal(size=(B, N))
    d_max = int(np.asarray(jr.build_topology(pos, RADIUS).degrees).max()) + HEADROOM
    topo = jr.build_topology(pos, RADIUS, d_max=d_max, n_max=N + spares, n_recolor=n_recolor)
    prob = jr.make_batch_problem(topo, jr.Kernel(*KERNEL), ys, np.full((N,), LAM, np.float32))
    state = jr.colored_sweep(prob, jr.init_state(prob), n_sweeps=3)
    deg = int(np.asarray(topo.degrees)[TARGET])
    fs = [0] * (d_max - deg) + [1, 0, 1, 0]
    ss = [TARGET] * (d_max - deg + 1) + [2, 9, 17]
    xs = np.stack([pos[s] + 0.02 * (i + 1) for i, s in enumerate(ss)]).astype(np.float32)
    prob, state, rec = js.absorb_many(prob, state, np.array(fs), np.array(ss), xs,
                                      np.linspace(-0.5, 0.5, len(fs)).astype(np.float32))
    assert bool(np.asarray(rec.absorbed).all())
    return pos, prob, state


def _port(jprob, jstate):
    prob = convert.problem_from_numpy(_leaves(jprob), kernel=tr.Kernel(*KERNEL), device="cpu")
    state = convert.state_from_numpy({"z": np.asarray(jstate.z), "coef": np.asarray(jstate.coef)},
                                     device="cpu")
    return prob, state


def _match(tprob, tst, jprob, jst):
    for name in INT_TABLES:
        np.testing.assert_array_equal(_np(getattr(tprob, name)), np.asarray(getattr(jprob, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(_np(tprob.topology.degrees), np.asarray(jprob.topology.degrees))
    np.testing.assert_array_equal(_np(tprob.topology.positions),
                                  np.asarray(jprob.topology.positions))
    np.testing.assert_allclose(_np(tprob.lam_pad), np.asarray(jprob.lam_pad), rtol=1e-6)
    np.testing.assert_allclose(_np(tprob.gram), np.asarray(jprob.gram), atol=2e-5)
    np.testing.assert_allclose(_np(tprob.chol), np.asarray(jprob.chol), atol=1e-4)
    np.testing.assert_allclose(_np(tst.z)[:, :-1], np.asarray(jst.z)[:, :-1], atol=1e-6)
    np.testing.assert_allclose(_np(tst.coef), np.asarray(jst.coef), atol=1e-6)


def _receipt(rec, n):
    """A receipt as host arrays, the ids of invalid lanes masked to n."""
    out = {}
    for key in ("joined", "slot", "adopted", "adopted_mask", "skipped", "skipped_mask",
               "dropped_newest"):
        out[key] = _np(getattr(rec, key))
    out["adopted"] = np.where(out["adopted_mask"], out["adopted"], n)
    out["skipped"] = np.where(out["skipped_mask"], out["skipped"], n)
    return out


@pytest.mark.parametrize("repair", [False, True])
def test_join_and_leave_match_reference(repair):
    pos, jprob, jst = _ref_problem()
    tprob, tst = _port(jprob, jst)
    kw = dict(repair_lambda=repair, kappa=1.0)
    trace = [("join", np.array([pos[TARGET, 0] + 0.005], np.float32)),
             ("join", np.array([-0.31], np.float32)),
             ("leave", 9),  # a base row with an arrival
             ("leave", "first"),  # the first newcomer
             ("join", np.array([0.42], np.float32))]  # recycles its row
    first = None
    for i, (event, arg) in enumerate(trace):
        if event == "join":
            ys = np.array([0.4 - i, -0.2 + i], np.float32)
            jprob, jst, jrec = js.add_sensor(jprob, jst, arg, ys, lam=LAM, **kw)
            tprob, tst, trec = ts.add_sensor(tprob, tst, arg, ys, lam=LAM, **kw)
            lanes = min(tprob.nbr_idx.shape[1] - 1, tprob.n)  # a join's adopter lanes
            assert trec.slot.shape == () and trec.dropped_newest.shape == (B, lanes)
            want, got = _receipt(jrec, jprob.n), _receipt(trec, tprob.n)
            for key in want:
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
            assert bool(trec.joined)
            first = int(trec.slot) if first is None else first
            if i == 0:  # TARGET adopted the newcomer; its full field 0 lost an arrival
                assert TARGET in got["adopted"].tolist()
                assert got["dropped_newest"][0].any() and not got["dropped_newest"][1].any()
            assert trec.to_json() == jrec.to_json()
        else:
            slot = first if arg == "first" else arg
            jprob, jst, jok = js.remove_sensor(jprob, jst, slot, **kw)
            tprob, tst, tok = ts.remove_sensor(tprob, tst, slot, **kw)
            assert tok.shape == () and bool(tok) and bool(jok)
        _match(tprob, tst, jprob, jst)
    assert int(trec.slot) == first  # the removed newcomer's row was recycled
    np.testing.assert_allclose(_np(ts.rebuild_chol(tprob)), _np(tprob.chol), atol=1e-4)
    # a dead or out-of-range row is a no-op
    for slot in (9, -1, tprob.n):
        p2, s2, ok = ts.remove_sensor(tprob, tst, slot)
        assert not bool(ok)
        _bitwise(p2, s2, tprob, tst)


def _bitwise(p1, s1, p2, s2, names=EVERY):
    for name in names:
        assert torch.equal(getattr(p1, name), getattr(p2, name)), name
    assert torch.equal(p1.topology.degrees, p2.topology.degrees)
    assert torch.equal(s1.z[:, :-1], s2.z[:, :-1])
    assert torch.equal(s1.coef, s2.coef)


def _port_problem(spares=SPARES, n_recolor=None, pos=None, radius=RADIUS):
    """A problem built by the port itself (its own factors), trained 3 sweeps."""
    pos = tr.uniform_sensors(N, d=1, seed=0) if pos is None else pos
    n = len(pos)
    ys = np.sin(np.pi * pos[None, :, 0]) + 0.2 * np.random.default_rng(1).normal(size=(B, n))
    d_max = int(tr.build_topology(pos, radius, device="cpu").degrees.max()) + HEADROOM
    topo = tr.build_topology(pos, radius, d_max=d_max, n_max=n + spares, n_recolor=n_recolor,
                             device="cpu")
    prob = tr.make_batch_problem(topo, tr.Kernel(*KERNEL), ys, np.full((n,), LAM, np.float32),
                                 device="cpu")
    return prob, tr.colored_sweep(prob, tr.init_state(prob), n_sweeps=3)


def test_join_then_leave_restores_every_table_bitwise():
    prob, state = _port_problem()
    for x in (0.15, -0.6):  # a newcomer whose adopters recolor, and another
        p2, s2, rec = ts.add_sensor(prob, state, np.array([x], np.float32),
                                    np.array([0.4, -0.2], np.float32), lam=LAM)
        assert bool(rec.joined) and int(rec.adopted_mask.sum()) > 2
        p3, s3, ok = ts.remove_sensor(p2, s2, rec.slot)
        assert bool(ok)
        _bitwise(p3, s3, prob, state, RESTORED)
        rest = torch.arange(prob.n + 1) != rec.slot
        assert torch.equal(p3.nbr_pos[:, rest], prob.nbr_pos[:, rest])
        assert torch.equal(p3.lam_pad[rest], prob.lam_pad[rest])
    # the reference's own check: the recolored tables rebuild to the same plans
    pz, pc = tp.build_color_plans(_np(p2.color_members), _np(p2.color_mask), _np(p2.nbr_idx),
                                  p2.n_stream, _np(p2.alive))
    np.testing.assert_array_equal(pz, _np(p2.plan_z))
    np.testing.assert_array_equal(pc, _np(p2.plan_coef))


def test_dropped_join_is_a_bitwise_noop():
    # spares exhausted: one spare, two joins
    prob, state = _port_problem(spares=1)
    prob, state, rec = ts.add_sensor(prob, state, np.array([0.1], np.float32),
                                     np.zeros(B, np.float32), lam=LAM)
    assert bool(rec.joined)
    p2, s2, rec = ts.add_sensor(prob, state, np.array([0.2], np.float32),
                                np.ones(B, np.float32), lam=LAM)
    assert not bool(rec.joined) and not bool(rec.adopted_mask.any())
    _bitwise(p2, s2, prob, state)
    assert torch.equal(p2.topology.positions, prob.topology.positions)
    # recolor pool exhausted: two far-apart adjacent pairs share colors, and a
    # newcomer adopting all four needs two recolor classes (none reserved)
    pos = np.array([[-0.45], [-0.35], [0.35], [0.45]], np.float32)
    for n_recolor, joins in ((0, False), (None, True)):
        prob, state = _port_problem(spares=2, n_recolor=n_recolor, pos=pos, radius=0.46)
        p2, s2, rec = ts.add_sensor(prob, state, np.zeros(1, np.float32),
                                    np.array([0.1, -0.1], np.float32), lam=0.2)
        assert bool(rec.joined) == joins
        if not joins:
            _bitwise(p2, s2, prob, state)
        else:  # two adopters moved into recolor classes
            assert int((p2.color_of[:4] >= p2.recolor_start).sum()) == 2


def test_donate_contract():
    prob, state = _port_problem()
    before = {name: getattr(prob, name).clone() for name in EVERY}
    z0, c0 = state.z.clone(), state.coef.clone()
    x, ys = np.array([0.15], np.float32), np.array([0.4, -0.2], np.float32)
    p1, s1, _ = ts.add_sensor(prob, state, x, ys, lam=LAM)
    p1, s1, _ = ts.remove_sensor(p1, s1, 3)
    for name in EVERY:  # donate=False: the inputs are untouched
        assert torch.equal(getattr(prob, name), before[name]), name
    assert torch.equal(state.z, z0) and torch.equal(state.coef, c0)
    p2, s2, _ = ts.add_sensor(prob, state, x, ys, lam=LAM, donate=True)
    p2, s2, _ = ts.remove_sensor(p2, s2, 3, donate=True)
    _bitwise(p1, s1, p2, s2)
    for name in EVERY:  # donate=True: the same tensors, written in place
        assert getattr(p2, name) is getattr(prob, name), name
    assert s2.z is state.z and s2.coef is state.coef


def test_lifecycle_refusals():
    prob, state = _port_problem(spares=0)
    with pytest.raises(ValueError, match="spare"):
        ts.add_sensor(prob, state, np.zeros(1), np.zeros(B))
    ring = tr.ring_topology(8, device="cpu")
    prob_r = tr.make_batch_problem(ring, tr.Kernel(), np.zeros((1, 8)),
                                   np.full((8,), 0.1, np.float32), n_max=10, device="cpu")
    with pytest.raises(ValueError, match="geometric"):
        ts.add_sensor(prob_r, tr.init_state(prob_r), np.zeros(2), np.zeros(1))
    prob, state = _port_problem()
    single, sstate = tr.field_view(prob, state, 0)
    with pytest.raises(ValueError, match="batched"):
        ts.add_sensor(single, sstate, np.zeros(1), np.zeros(1))
    with pytest.raises(ValueError, match="batched"):
        ts.remove_sensor(single, sstate, 3)


def test_serving_plan_repairs_match_reference():
    pos, jprob, jst = _ref_problem()
    tprob, _ = _port(jprob, jst)
    for spare in (3, 0):
        jplan = jr.make_serving_plan(jprob, k=3, spare=spare, slack=2)
        tplan = tsv.make_serving_plan(tprob, k=3, spare=spare, slack=2)
        # at spare = 0 the first full cell's center overflows (at 3 no cell is full)
        full = int(np.argmax(np.asarray(jplan.cell_mask).all(axis=1)))
        overflows = []
        for x, slot in ((np.array(jplan.centers)[full], 24), (np.array([0.3], np.float32), 25)):
            jplan, jover = jsv.plan_add_sensor(jplan, x, slot)
            tplan, tover = tsv.plan_add_sensor(tplan, x, torch.tensor(slot))
            assert tover.shape == () and int(tover) == int(jover)
            overflows.append(int(tover))
            np.testing.assert_array_equal(_np(tplan.cells), np.asarray(jplan.cells))
            np.testing.assert_array_equal(_np(tplan.cell_mask), np.asarray(jplan.cell_mask))
        assert (overflows[0] > 0) == (spare == 0)
        for slot in (24, 3):
            jplan = jsv.plan_remove_sensor(jplan, slot)
            tplan = tsv.plan_remove_sensor(tplan, slot)
            np.testing.assert_array_equal(_np(tplan.cell_mask), np.asarray(jplan.cell_mask))


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
from test_torch_build import _leaves, _np

n, b = 24, 2
pos = jr.uniform_sensors(n, d=1, seed=0)
ys = np.sin(np.pi * pos[None, :, 0]) + 0.2 * np.random.default_rng(1).normal(size=(b, n))
d_max = int(np.asarray(jr.build_topology(pos, 0.7).degrees).max()) + 3
jprob = jr.make_batch_problem(jr.build_topology(pos, 0.7, d_max=d_max, n_max=n + 3),
                              jr.Kernel("rbf", gamma=1.0), ys, jnp.full((n,), 0.1),
                              dtype=jnp.float64)
jst = jr.colored_sweep(jprob, jr.init_state(jprob), n_sweeps=3)
tprob = convert.problem_from_numpy(_leaves(jprob), kernel=tr.Kernel("rbf", gamma=1.0),
                                   device="cpu")
tst = convert.state_from_numpy({"z": np.asarray(jst.z), "coef": np.asarray(jst.coef)},
                               device="cpu")
for repair in (False, True):
    x, y2 = np.array([0.15], np.float32), np.array([0.4, -0.2])
    jp, js2, jrec = js.add_sensor(jprob, jst, x, y2, repair_lambda=repair)
    tp, ts2, trec = ts.add_sensor(tprob, tst, x, y2, repair_lambda=repair)
    assert bool(trec.joined) and int(trec.slot) == int(jrec.slot)
    jp, js2, _ = js.remove_sensor(jp, js2, 5, repair_lambda=repair)
    tp, ts2, _ = ts.remove_sensor(tp, ts2, 5, repair_lambda=repair)
    for name in ("nbr_idx", "plan_z", "plan_coef", "color_of", "alive"):
        np.testing.assert_array_equal(_np(getattr(tp, name)), np.asarray(getattr(jp, name)))
    for name in ("gram", "chol", "lam_pad"):
        np.testing.assert_allclose(_np(getattr(tp, name)), np.asarray(getattr(jp, name)),
                                   atol=1e-10, err_msg=name)
    np.testing.assert_allclose(_np(ts2.z)[:, :-1], np.asarray(js2.z)[:, :-1], atol=1e-10)
    np.testing.assert_allclose(_np(ts2.coef), np.asarray(js2.coef), atol=1e-10)
    assert tp.chol.dtype == torch.float64
print("f64 lifecycle ok")
"""


def test_lifecycle_f64_matches_reference(f64_run):
    out, err = f64_run.communicate(timeout=300)
    assert f64_run.returncode == 0, err[-3000:]
    assert "f64 lifecycle ok" in out
