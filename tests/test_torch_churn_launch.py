"""The lifecycle slice end to end: the launcher's ``--churn`` path.

The port's launcher with ``--stream`` and ``--churn`` against the JAX
package's same pipeline (its ``serve_fields``: train, absorb the arrival
windows, refresh, then the churn rounds of a join, 8 arrivals, a refresh, a
leave and another refresh every other round and a kNN request on the
repaired plan; then kNN on the repaired plan and conn), step for step on the
same seeded draws, at d = 2.  Two spares over six rounds, so joins find no
free spare and are dropped.  The churn counts and receipt sums must be
equal, the integer tables and positions equal after the churn, the Grams
within 2e-5 and the factors within 1e-4 (tests/test_multifield.py:189).
The state has run 55 sweeps through 4 joins, 3 leaves and 57 absorbs, each
event refactoring rows, so it is held to the reference's long-chain sweep
bound (z 2e-4, coef 2e-2, tests/test_scatter_plan.py:200), kNN answers at
that z bound, conn answers within 2e-5 absolute and relative.  The same
churn in float64, through the launcher's ``churn_fields`` on a float64
problem, agrees within 1e-10; it runs in a subprocess with
``JAX_ENABLE_X64``, started with the file's first test so that the two
runs overlap.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jr
from repro.core import streaming as js
from repro.core.serving import plan_add_sensor, plan_remove_sensor
from repro.kernels.ref import kernel_matvec_batched_ref
from repro_torch.launch import serve
from test_torch_build import _np

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fields, sensors, radius, sweeps, stream (odd: the one-arrival remainder),
# churn rounds, spares, seed
GEOMETRY = (2, 40, 0.45, 5, 9, 6, 2, 0)
LAM, K, Q, REFRESH = 0.1, 3, 64, 5
INT_TABLES = ("nbr_idx", "nbr_mask", "plan_z", "plan_coef", "color_members", "color_mask",
              "color_of", "member_pos", "alive", "nbr_pos", "stream_pos", "anchor_w")
COUNTS = ("joins", "leaves", "join_drops", "absorbed", "dropped", "cell_overflows",
          "skipped_couplings", "dropped_newest")


@pytest.fixture(scope="module", autouse=True)
def f64_run():
    """The float64 comparison (F64_CODE), started before this file's first
    test so that it runs beside the float32 one; read by the last test."""
    env = dict(os.environ, PYTHONPATH="src")
    proc = subprocess.Popen([sys.executable, "-c", F64_CODE], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def reference(b, n, radius, sweeps, stream, churn, spares, seed, on_full="evict",
              dtype=jnp.float32):
    """The reference launcher's field mode with --stream and --churn, step for
    step, at d = 2 (its churn refreshes use its default plan engine)."""
    rng = np.random.default_rng(seed)
    pos = jr.uniform_sensors(n, d=2, seed=seed)
    freq = rng.uniform(0.5, 2.0, size=(b, 1))
    phase = rng.uniform(0, 2 * np.pi, size=(b, 1))
    ys = np.sin(np.pi * freq * pos[None, :, 0] + phase) + 0.3 * rng.normal(size=(b, n))
    topo = jr.build_topology(pos, radius)
    per_sensor = -(-max(stream, 1) // n) + 4 + 2
    topo = jr.build_topology(pos, radius, d_max=int(np.asarray(topo.degrees).max()) + per_sensor)
    # float32 lambdas, as both launchers make them (also in the float64 run)
    prob = jr.make_batch_problem(topo, jr.Kernel("rbf", gamma=1.0), ys,
                                 np.full((n,), LAM, np.float32), n_max=n + spares, dtype=dtype)
    state = jr.colored_sweep(prob, jr.init_state(prob), n_sweeps=sweeps)

    def arrivals(a):
        fs = rng.integers(0, b, size=a)
        ss = rng.integers(0, n, size=a)
        xs = (pos[ss] + 0.05 * rng.normal(size=(a, 2))).astype(np.float32)
        return fs, ss, xs, rng.normal(size=a).astype(np.float32)

    for a in ([1] if stream % 2 else []) + [stream // 2] * 2:
        prob, state, _ = js.absorb_many(prob, state, *arrivals(a), on_full=on_full)
    state = jr.colored_sweep(prob, state, n_sweeps=REFRESH)

    plan = jr.make_serving_plan(prob, k=K, spare=spares + 4, slack=churn)
    xq_c = np.linspace(-0.9, 0.9, 64)[:, None].astype(np.float32)
    xq_c = np.concatenate([xq_c, np.zeros_like(xq_c)], axis=1)
    stats = dict.fromkeys(COUNTS, 0)
    joined = []
    for i in range(churn):
        x = rng.uniform(-0.9, 0.9, size=2).astype(np.float32)
        prob, state, rcpt = js.add_sensor(prob, state, x, rng.normal(size=b).astype(np.float32),
                                          lam=LAM)
        stats["skipped_couplings"] += int(np.asarray(rcpt.skipped_mask).sum())
        stats["dropped_newest"] += int(np.asarray(rcpt.dropped_newest).sum())
        if bool(rcpt.joined):
            plan, over = plan_add_sensor(plan, x, rcpt.slot)
            joined.append(int(rcpt.slot))
            stats["joins"] += 1
            stats["cell_overflows"] += int(over)
        else:
            stats["join_drops"] += 1
        prob, state, rec = js.absorb_many(prob, state, *arrivals(8), on_full=on_full)
        stats["absorbed"] += int(np.asarray(rec.absorbed).sum())
        stats["dropped"] += 8 - int(np.asarray(rec.absorbed).sum())
        state = jr.colored_sweep(prob, state, n_sweeps=REFRESH)
        if i % 2 == 1:
            victim = joined.pop(0) if joined else int(rng.integers(0, n))
            prob, state, rok = js.remove_sensor(prob, state, victim)
            plan = plan_remove_sensor(plan, victim)
            stats["leaves"] += int(bool(rok))
            state = jr.colored_sweep(prob, state, n_sweeps=REFRESH)
        jr.fusion.fuse(prob, state, xq_c, "knn", k=K, engine="plan", plan=plan)
    xq = np.linspace(-1, 1, Q)[:, None].astype(np.float32)
    xq = np.concatenate([xq, np.zeros_like(xq)], axis=1)
    knn = jr.fusion.fuse(prob, state, xq, "knn", k=K, engine="plan", plan=plan)
    anchors, coefs = jr.fusion.global_coefficients(prob, state, rule="conn")
    conn = kernel_matvec_batched_ref(xq, anchors, coefs, 1.0)
    return prob, state, knn, conn, stats, plan


def launcher_argv(engine: str) -> list[str]:
    b, n, radius, sweeps, stream, churn, spares, seed = GEOMETRY
    return ["--device", "cpu", "--fields", str(b), "--sensors", str(n), "--dim", "2",
            "--radius", str(radius), "--lam", str(LAM), "--sweeps", str(sweeps),
            "--queries", str(Q), "--fusion", "knn", "conn", "--k", str(K), "--seed", str(seed),
            "--stream", str(stream), "--on_full", "evict", "--refresh_sweeps", str(REFRESH),
            "--churn", str(churn), "--spares", str(spares), "--engine", engine]


def test_churn_launcher_matches_reference_pipeline(capsys):
    """Engine cuda: the color_step and knn_fuse wrappers (their plain
    versions on CPU tensors) run the train, the refreshes and every request."""
    res = serve.main(launcher_argv("cuda"))
    printed = capsys.readouterr().out
    b, n, _, _, _, churn, spares, _ = GEOMETRY
    jprob, jstate, jknn, jconn, jstats, jplan = reference(*GEOMETRY)
    info, prob, state = res["churn"], res["problem"], res["state"]
    for key in COUNTS:
        assert info[key] == jstats[key], key
    assert info["join_drops"] > 0 and info["joins"] > 0 and info["leaves"] > 0
    assert info["builds"] == 0
    assert info["knn_calls"] == churn
    assert info["refresh_calls"] == churn + churn // 2
    assert (f"churn: {churn} rounds ({info['joins']} joins, {info['leaves']} leaves, "
            f"{info['join_drops']} join-drops") in printed
    assert "CUDA library builds after warmup: 0" in printed
    assert f"churn receipts: {info['skipped_couplings']} couplings skipped" in printed
    assert f"sensors={n} (capacity {n + spares})" in printed
    assert prob.topology.d_max == jprob.topology.d_max
    assert prob.topology.n_colors == jprob.topology.n_colors
    for name in INT_TABLES:
        np.testing.assert_array_equal(_np(getattr(prob, name)), np.asarray(getattr(jprob, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(_np(prob.topology.degrees), np.asarray(jprob.topology.degrees))
    np.testing.assert_array_equal(_np(prob.topology.positions),
                                  np.asarray(jprob.topology.positions))
    np.testing.assert_allclose(_np(prob.gram), np.asarray(jprob.gram), atol=2e-5)
    np.testing.assert_allclose(_np(prob.chol), np.asarray(jprob.chol), atol=1e-4)
    np.testing.assert_allclose(_np(state.z)[:, :-1], np.asarray(jstate.z)[:, :-1], atol=2e-4)
    np.testing.assert_allclose(_np(state.coef), np.asarray(jstate.coef), atol=2e-2)
    # the final kNN request was served on the repaired plan, equal to the reference's
    plan = info["plan"]
    np.testing.assert_array_equal(_np(plan.cell_mask), np.asarray(jplan.cell_mask))
    np.testing.assert_array_equal(_np(plan.cells), np.asarray(jplan.cells))
    assert "(plan: " in printed and f"K_max={plan.k_max})" in printed
    assert res["knn"].shape == res["conn"].shape == (b, Q)
    np.testing.assert_allclose(_np(res["knn"]), np.asarray(jknn), atol=2e-4)
    np.testing.assert_allclose(_np(res["conn"]), np.asarray(jconn), atol=2e-5, rtol=2e-5)


F64_CODE = r"""
import os
os.environ["JAX_ENABLE_X64"] = "1"
import sys
sys.path.insert(0, "tests")
import numpy as np, jax.numpy as jnp, torch
torch.set_num_threads(1)
from test_torch_churn_launch import COUNTS, GEOMETRY, INT_TABLES, REFRESH, launcher_argv, reference
from test_torch_build import _np
from repro_torch.core import colored_sweep, init_state
from repro_torch.launch import serve

b, n, radius, sweeps, stream, churn, spares, seed = GEOMETRY
jprob, jstate, _, _, jstats, _ = reference(*GEOMETRY, dtype=jnp.float64)
args = serve.parser().parse_args(launcher_argv("plan"))
rng = np.random.default_rng(seed)
prob = serve.build_problem(args, torch.float64, rng=rng)
state = colored_sweep(prob, init_state(prob), n_sweeps=sweeps)
prob, state, _ = serve.stream_fields(args, prob, state, rng, "plan")
prob, state, info = serve.churn_fields(args, prob, state, rng, "plan")
for key in COUNTS:
    assert info[key] == jstats[key], key
for name in INT_TABLES:
    np.testing.assert_array_equal(_np(getattr(prob, name)), np.asarray(getattr(jprob, name)))
for name in ("gram", "chol"):
    np.testing.assert_allclose(_np(getattr(prob, name)), np.asarray(getattr(jprob, name)),
                               atol=1e-10, err_msg=name)
np.testing.assert_allclose(_np(state.z)[:, :-1], np.asarray(jstate.z)[:, :-1], atol=1e-10)
np.testing.assert_allclose(_np(state.coef), np.asarray(jstate.coef), atol=1e-10)
assert state.z.dtype == torch.float64
print("f64 churn ok", info["joins"], info["join_drops"])
"""


def test_churn_f64_matches_reference(f64_run):
    out, err = f64_run.communicate(timeout=300)
    assert f64_run.returncode == 0, err[-3000:]
    assert "f64 churn ok" in out


if __name__ == "__main__":
    # The reference's churn counts at chip_smoke.py's main-churn flags (n = 1000
    # sensors in d = 2, B = 16, --stream 2048 --on_full evict --churn 16
    # --spares 8, seed 0), which chip_smoke holds the port's launcher to.
    # Run on the CPU: PYTHONPATH=src:tests python tests/test_torch_churn_launch.py
    print(reference(16, 1000, 0.3 * (100.0 / 1000) ** 0.5, 30, 2048, 16, 8, 0)[4])
