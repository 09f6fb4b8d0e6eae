"""The first slice end to end: build -> colored sweep -> kNN and conn serving,
then the same geometry with ``--stream`` (tests/test_torch_stream_launch.py
holds the streaming comparison and its bounds).

The port's entry point (``repro_torch.launch.serve``) against the JAX
package's same pipeline (its ``serve_fields`` field mode: colored sweep
with the Pallas color step, kNN through the Pallas kernel, conn through
the Pallas kernel matvec) on the same seeded inputs, at n=60, B=3, d=2.
"""

import numpy as np
import jax.numpy as jnp
import torch

import repro.core as jr
from repro.kernels import kernel_matvec as j_kernel_matvec
from repro_torch.launch import serve
from test_torch_build import _np
from test_torch_stream_launch import check_stream_launcher

torch.set_num_threads(1)

N, B, SWEEPS, Q, K, RADIUS, LAM, SEED = 60, 3, 10, 64, 3, 0.5, 0.1, 0


def _jax_pipeline():
    """The reference launcher's field mode, step for step, at d = 2."""
    rng = np.random.default_rng(SEED)
    pos = jr.uniform_sensors(N, d=2, seed=SEED)
    freq = rng.uniform(0.5, 2.0, size=(B, 1))
    phase = rng.uniform(0, 2 * np.pi, size=(B, 1))
    ys = np.sin(np.pi * freq * pos[None, :, 0] + phase) + 0.3 * rng.normal(size=(B, N))
    prob = jr.make_batch_problem(
        jr.build_topology(pos, RADIUS), jr.Kernel("rbf", gamma=1.0), ys,
        jnp.full((N,), LAM),
    )
    state = jr.colored_sweep(prob, jr.init_state(prob), n_sweeps=SWEEPS, engine="pallas")
    xq = np.linspace(-1, 1, Q)[:, None].astype(np.float32)
    xq = np.concatenate([xq, np.zeros_like(xq)], axis=1)
    knn = jr.fusion.fuse(prob, state, xq, "knn", k=K, engine="pallas",
                         plan=jr.make_serving_plan(prob, k=K))
    anchors, coefs = jr.fusion.global_coefficients(prob, state, rule="conn")
    conn = j_kernel_matvec(xq, anchors, coefs, gamma=1.0)
    return prob, state, xq, knn, conn


def test_slice_port_launcher_matches_jax_pipeline(capsys):
    res = serve.main([
        "--device", "cpu", "--fields", str(B), "--sensors", str(N), "--dim", "2",
        "--radius", str(RADIUS), "--lam", str(LAM), "--sweeps", str(SWEEPS),
        "--queries", str(Q), "--fusion", "knn", "conn", "--k", str(K), "--seed", str(SEED),
    ])
    printed = capsys.readouterr().out
    assert "train[engine=cuda]" in printed and "query[knn k=3 engine=cuda" in printed
    jprob, jstate, xq, jknn, jconn = _jax_pipeline()
    prob, state = res["problem"], res["state"]
    np.testing.assert_array_equal(_np(prob.plan_z), np.asarray(jprob.plan_z))
    np.testing.assert_array_equal(_np(res["xq"]), xq)
    np.testing.assert_allclose(_np(state.z)[:, :-1], np.asarray(jstate.z)[:, :-1], atol=1e-5)
    assert res["knn"].shape == res["conn"].shape == (B, Q)
    np.testing.assert_allclose(_np(res["knn"]), np.asarray(jknn), atol=1e-5)
    np.testing.assert_allclose(_np(res["conn"]), np.asarray(jconn), atol=2e-5, rtol=2e-5)


def test_slice_with_stream_matches_reference_pipeline(capsys):
    """The same 60 sensors with 61 streamed arrivals (the one-arrival
    remainder, then two windows) under --on_full evict, on the plain engines."""
    check_stream_launcher("n60", "evict", capsys)
