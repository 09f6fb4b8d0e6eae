"""The faults slice end to end: the port's launcher with ``--faults``.

Against the JAX package's same pipeline (its ``serve_fields`` under
``--faults``: the watchdog supervising rounds of ``--refresh_sweeps``
sweeps, up to ``ceil(sweeps / refresh_sweeps)`` of them, then the requests)
on the same seeded inputs with ``drop=0``, where every mask delivers, so the
two generators cannot differ: the receipt's integers and flags equal, the
state within the sweep bound (z 1e-5, coef 1e-3, tests/test_scatter_plan.py),
kNN answers within the z bound and conn answers within 2e-5.  With real
drops the launcher prints a ``watchdog.json:`` line that the reference's
``receipt_from_json`` reads, counts its rounds as its train calls, and
``--stream`` and ``--churn`` run on after it.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jr
from repro.core import faults as jf
from repro.core import monitor as jm
from repro.kernels.ref import kernel_matvec_batched_ref
from repro_torch.launch import serve
from test_torch_build import _np

torch.set_num_threads(1)

B, N, RADIUS, SWEEPS, Q, LAM, K, ROUND = 3, 60, 0.5, 10, 64, 0.1, 3, 5
ARGV = ["--device", "cpu", "--fields", str(B), "--sensors", str(N), "--dim", "2",
        "--radius", str(RADIUS), "--sweeps", str(SWEEPS), "--queries", str(Q),
        "--fusion", "knn", "conn", "--k", str(K), "--refresh_sweeps", str(ROUND)]


def _reference(spec, seed=0):
    """The reference launcher's field mode under --faults, step for step, at d = 2."""
    rng = np.random.default_rng(seed)
    pos = jr.uniform_sensors(N, d=2, seed=seed)
    freq = rng.uniform(0.5, 2.0, size=(B, 1))
    phase = rng.uniform(0, 2 * np.pi, size=(B, 1))
    ys = np.sin(np.pi * freq * pos[None, :, 0] + phase) + 0.3 * rng.normal(size=(B, N))
    prob = jr.make_batch_problem(jr.build_topology(pos, RADIUS), jr.Kernel("rbf", gamma=1.0),
                                 ys, jnp.full((N,), LAM))
    state = jr.init_state(prob)
    model = jf.parse_fault_spec(spec, dtype=state.z.dtype)
    cfg = jm.WatchdogConfig(sweeps_per_round=ROUND, tol=1e-3,
                            max_rounds=max(1, -(-SWEEPS // ROUND)))
    prob, state, receipt = jm.watch_sweeps(prob, state, model=model,
                                           key=jax.random.PRNGKey(seed + 1), config=cfg)
    xq = np.linspace(-1, 1, Q)[:, None].astype(np.float32)
    xq = np.concatenate([xq, np.zeros_like(xq)], axis=1)
    knn = jr.fusion.fuse(prob, state, xq, "knn", k=K, engine="plan",
                         plan=jr.make_serving_plan(prob, k=K))
    anchors, coefs = jr.fusion.global_coefficients(prob, state, rule="conn")
    return state, receipt, knn, kernel_matvec_batched_ref(xq, anchors, coefs, 1.0)


@pytest.mark.parametrize("engine", ["plan", "cuda"])
def test_drop0_matches_the_reference_pipeline(engine):
    state, receipt, knn, conn = _reference("drop=0")
    res = serve.main(ARGV + ["--engine", engine, "--faults", "drop=0"])
    got = res["watchdog"]
    for name in ("rounds", "sweeps", "retries", "refactorized", "rolled_back"):
        assert getattr(got, name) == getattr(receipt, name), name
    np.testing.assert_array_equal(got.converged, receipt.converged)
    np.testing.assert_array_equal(got.diverged, receipt.diverged)
    assert res["train_calls"] == got.rounds == SWEEPS // ROUND
    np.testing.assert_allclose(_np(res["state"].z)[:, :-1], np.asarray(state.z)[:, :-1],
                               atol=1e-5)
    np.testing.assert_allclose(_np(res["state"].coef), np.asarray(state.coef), atol=1e-3)
    np.testing.assert_allclose(_np(res["knn"]), np.asarray(knn), atol=1e-5)
    np.testing.assert_allclose(_np(res["conn"]), np.asarray(conn), atol=2e-5, rtol=2e-5)


def _watchdog_line(out: str) -> dict:
    lines = [ln for ln in out.splitlines() if ln.startswith("watchdog.json: ")]
    assert len(lines) == 1
    return json.loads(lines[0][len("watchdog.json: "):])


@pytest.mark.parametrize("spec,extra", [
    ("drop=0.1", []),
    ("drop=0.1,burst=0.05:0.4:0.5,crash=0.01:0.25", ["--stream", "21", "--churn", "2",
                                                      "--spares", "2"]),
])
def test_faults_print_a_receipt_the_reference_reads(spec, extra, capsys):
    res = serve.main(ARGV + ["--faults", spec] + extra)
    out = capsys.readouterr().out
    assert f"train[faults {spec}, engine=cuda]" in out
    payload = _watchdog_line(out)
    back = jm.receipt_from_json(payload)
    rec = res["watchdog"]
    assert payload == rec.to_json()
    assert back.rounds == rec.rounds == res["train_calls"] and back.sweeps == rec.sweeps
    assert any(ln.startswith("watchdog: ") for ln in out.splitlines())
    for key in ("knn", "conn"):
        assert res[key].shape == (B, Q) and bool(torch.isfinite(res[key]).all())
    if extra:
        assert res["stream"]["absorbed"] > 0 and res["churn"]["rounds"] == 2
