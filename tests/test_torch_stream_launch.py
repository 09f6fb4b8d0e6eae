"""The streaming slice end to end, and the data module it brought.

The port's launcher with ``--stream`` against the JAX package's same
pipeline (its ``serve_fields``: train, absorb the arrival windows drawn from
the field generator, refresh, serve) on the same seeded inputs, under both
``--on_full`` policies (the 60-sensor case runs in tests/test_torch_slice.py
and ``serial_sweep``/``field_view`` in tests/test_torch_train.py, to keep
each file well under a minute): the arrival draws and receipt flags must be
identical, the streamed tables equal (positions, occupancy) or within the
kernel bound (Grams 2e-5), factors within 1e-4, the refreshed state within
the sweep bounds of tests/test_scatter_plan.py (z 1e-5, coef 1e-3; the
long-chain bound where every sensor absorbs ~50 arrivals, see GEOMETRIES),
kNN answers within the z bound and conn answers within 2e-5 absolute and
relative.  Then ``data.fields`` against the reference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jr
import repro.data.fields as jfields
import repro_torch.data.fields as tfields
from repro.core import streaming as js
from repro.kernels.ref import kernel_matvec_batched_ref
from repro_torch.launch import serve
from test_torch_build import _np

torch.set_num_threads(1)

LAM, K, Q, REFRESH = 0.1, 3, 64, 5
# (fields, sensors, radius, sweeps, stream, seed, engine), (z, coef, kNN)
# bounds: a network of 60 sensors with an odd stream (the one-arrival
# remainder) on the plain engines, at the sweep bounds; and 4 sensors in one
# field whose windows overflow them, so drop and evict really differ, on the
# kernels' wrappers (their plain versions here).  There every sensor absorbs
# ~50 arrivals into one D = 59 system: a long chain of f32 updates, held to
# the reference's long-chain bound (z 2e-4, coef 2e-2,
# tests/test_scatter_plan.py:200).
GEOMETRIES = {"n60": ((3, 60, 0.5, 10, 61, 0, "plan"), (1e-5, 1e-3, 1e-5)),
              "pressure": ((1, 4, 3.0, 5, 201, 0, "cuda"), (2e-4, 2e-2, 2e-4))}


def _reference(b, n, radius, sweeps, stream, seed, on_full):
    """The reference launcher's field mode with --stream, step for step, at d = 2."""
    rng = np.random.default_rng(seed)
    pos = jr.uniform_sensors(n, d=2, seed=seed)
    freq = rng.uniform(0.5, 2.0, size=(b, 1))
    phase = rng.uniform(0, 2 * np.pi, size=(b, 1))
    ys = np.sin(np.pi * freq * pos[None, :, 0] + phase) + 0.3 * rng.normal(size=(b, n))
    topo = jr.build_topology(pos, radius)
    per_sensor = -(-max(stream, 1) // n) + 4
    topo = jr.build_topology(pos, radius, d_max=int(np.asarray(topo.degrees).max()) + per_sensor)
    prob = jr.make_batch_problem(topo, jr.Kernel("rbf", gamma=1.0), ys, jnp.full((n,), LAM))
    state = jr.colored_sweep(prob, jr.init_state(prob), n_sweeps=sweeps)

    def window(a):
        fs = rng.integers(0, b, size=a)
        ss = rng.integers(0, n, size=a)
        xs = (pos[ss] + 0.05 * rng.normal(size=(a, pos.shape[1]))).astype(np.float32)
        return fs, ss, xs, rng.normal(size=a).astype(np.float32)

    sizes = ([1] if stream % 2 else []) + [stream // 2] * 2
    receipts = []
    for a in sizes:
        prob, state, rec = js.absorb_many(prob, state, *window(a), on_full=on_full)
        receipts.append(rec)
    state = jr.colored_sweep(prob, state, n_sweeps=REFRESH)
    xq = np.linspace(-1, 1, Q)[:, None].astype(np.float32)
    xq = np.concatenate([xq, np.zeros_like(xq)], axis=1)
    knn = jr.fusion.fuse(prob, state, xq, "knn", k=K, engine="plan",
                         plan=jr.make_serving_plan(prob, k=K))
    anchors, coefs = jr.fusion.global_coefficients(prob, state, rule="conn")
    conn = kernel_matvec_batched_ref(xq, anchors, coefs, 1.0)
    absorbed = np.concatenate([np.asarray(r.absorbed) for r in receipts])
    evicted = np.concatenate([np.asarray(r.evicted) for r in receipts])
    return prob, state, knn, conn, absorbed, evicted


@pytest.mark.parametrize("on_full", ["drop", "evict"])
def test_stream_launcher_matches_reference_pipeline(on_full, capsys):
    check_stream_launcher("pressure", on_full, capsys)


def check_stream_launcher(geometry, on_full, capsys):
    """The port's launcher against ``_reference`` on one of GEOMETRIES (the
    n60 case runs in tests/test_torch_slice.py, beside the static slice)."""
    (b, n, radius, sweeps, stream, seed, engine), (tol_z, tol_c, tol_q) = GEOMETRIES[geometry]
    res = serve.main([
        "--device", "cpu", "--fields", str(b), "--sensors", str(n), "--dim", "2",
        "--radius", str(radius), "--lam", str(LAM), "--sweeps", str(sweeps),
        "--queries", str(Q), "--fusion", "knn", "conn", "--k", str(K), "--seed", str(seed),
        "--stream", str(stream), "--on_full", on_full, "--refresh_sweeps", str(REFRESH),
        "--engine", engine,
    ])
    printed = capsys.readouterr().out
    assert f"refresh[engine={engine}]: {REFRESH} sweeps" in printed
    jprob, jstate, jknn, jconn, jabs, jev = _reference(b, n, radius, sweeps, stream, seed,
                                                       on_full)
    info, prob, state = res["stream"], res["problem"], res["state"]
    np.testing.assert_array_equal(_np(info["receipt"].absorbed), jabs)
    np.testing.assert_array_equal(_np(info["receipt"].evicted), jev)
    assert info["absorbed"] == int(jabs.sum()) and info["evicted"] == int(jev.sum())
    assert info["dropped"] == stream - int(jabs.sum())
    assert f"stream: {info['absorbed']} absorbed, timed window of {stream // 2}" in printed
    if geometry == "pressure":  # the windows overflowed: the policy decided
        assert (info["evicted"] > 0) if on_full == "evict" else (info["dropped"] > 0)
        assert "capacity pressure" in printed
    assert prob.topology.d_max == jprob.topology.d_max
    for name in ("nbr_pos", "nbr_mask", "stream_pos"):
        np.testing.assert_array_equal(_np(getattr(prob, name)), np.asarray(getattr(jprob, name)))
    np.testing.assert_allclose(_np(prob.gram), np.asarray(jprob.gram), atol=2e-5)
    np.testing.assert_allclose(_np(prob.chol), np.asarray(jprob.chol), atol=1e-4)
    np.testing.assert_allclose(_np(state.z)[:, :-1], np.asarray(jstate.z)[:, :-1], atol=tol_z)
    np.testing.assert_allclose(_np(state.coef), np.asarray(jstate.coef), atol=tol_c)
    assert res["knn"].shape == res["conn"].shape == (b, Q)
    np.testing.assert_allclose(_np(res["knn"]), np.asarray(jknn), atol=tol_q)
    np.testing.assert_allclose(_np(res["conn"]), np.asarray(jconn), atol=2e-5, rtol=2e-5)


def test_fields_match_reference():
    assert sorted(tfields.CASES) == sorted(jfields.CASES)
    x = np.linspace(-1, 1, 7)
    for name in tfields.CASES:
        tc, jc = tfields.CASES[name](), jfields.CASES[name]()
        assert (tc.name, tc.noise_sigma, tc.r_grid) == (jc.name, jc.noise_sigma, jc.r_grid)
        assert (tc.kernel.name, tc.kernel.gamma, tc.kernel.bias) == (
            jc.kernel.name, jc.kernel.gamma, jc.kernel.bias)
        np.testing.assert_array_equal(tc.eta(x), jc.eta(x))
        got = tfields.sample_field(tc, 25, seed=3, n_test=40)
        want = jfields.sample_field(jc, 25, seed=3, n_test=40)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype == np.float32
            np.testing.assert_array_equal(got[key], want[key])
