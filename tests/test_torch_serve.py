"""Port parity, serve stage: kNN fusion over the cell plans, conn fusion, kernel matvec.

Both packages serve the SAME trained state (the reference's, carried over
with ``repro_torch.convert``), so these tests isolate serving.  Bounds are
the reference's: kNN engines within 1e-5 of the dense oracle
(tests/test_serving.py) with identical selected sets, kernel matvec within
2e-5 (tests/test_kernels_pallas.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jr
import repro_torch.core as tr
from repro.kernels import kernel_matvec as j_kernel_matvec
from repro.kernels.ref import kernel_matvec_ref as j_kernel_matvec_ref
from repro_torch import convert
from repro_torch.kernels import knn_fuse as t_knn
from repro_torch.kernels.ops import kernel_matvec
from test_torch_build import _np, _pair

torch.set_num_threads(1)


def _trained(n=60, b=3, d=2, radius=0.5, seed=3, sweeps=10, dead=()):
    jprob, tprob = _pair(n=n, b=b, d=d, radius=radius, seed=seed)
    if dead:
        alive = np.asarray(jprob.alive).copy()
        alive[list(dead)] = False
        jprob = dataclasses.replace(jprob, alive=jnp.asarray(alive))
        tprob = dataclasses.replace(tprob, alive=torch.as_tensor(alive))
    jst = jr.colored_sweep(jprob, jr.init_state(jprob), n_sweeps=sweeps)
    tst = convert.state_from_numpy(
        {"z": np.asarray(jst.z), "coef": np.asarray(jst.coef)}, device="cpu"
    )
    return jprob, jst, tprob, tst


def _queries(prob, q=64, seed=0):
    pos = np.asarray(prob.topology.positions)
    rng = np.random.default_rng(seed)
    return rng.uniform(pos.min(0), pos.max(0), size=(q, pos.shape[1])).astype(np.float32)


@pytest.mark.parametrize("dead", [(), (4, 9, 30)])
@pytest.mark.parametrize("k", [1, 3])
def test_knn_engines_match_dense_with_identical_selection(k, dead):
    jprob, jst, tprob, tst = _trained(dead=dead)
    xq = _queries(jprob)
    dense = np.asarray(jr.fusion.fuse(jprob, jst, xq, "knn", k=k))
    jplan, tplan = jr.make_serving_plan(jprob, k=k), tr.make_serving_plan(tprob, k=k)
    for engine in ("plan", "cuda"):
        out = tr.fusion.fuse(tprob, tst, xq, "knn", k=k, engine=engine, plan=tplan)
        assert out.shape == dense.shape and out.dtype == torch.float32
        np.testing.assert_allclose(_np(out), dense, atol=1e-5, err_msg=engine)

    # selected sets: port plan engine, kernel wrapper and JAX plan, exactly
    jsel, jvalid = jr.serving.knn_select_valid(
        jplan, jprob.topology.positions, jnp.asarray(xq), k, jprob.alive
    )
    xt = torch.as_tensor(xq)
    tsel, tvalid = tr.serving.knn_select_valid(tplan, tprob.topology.positions, xt, k,
                                               tprob.alive)
    np.testing.assert_array_equal(_np(tvalid), np.asarray(jvalid))
    np.testing.assert_array_equal(_np(tsel)[_np(tvalid)], np.asarray(jsel)[np.asarray(jvalid)])
    pos_pad = torch.cat([tprob.topology.positions, torch.zeros((1, 2))])
    _, ksel = t_knn.knn_fuse_fused(
        xt, tr.serving.query_cells(tplan, xt), tplan.cells, tplan.cell_mask, pos_pad,
        tprob.nbr_pos, tprob.nbr_mask, tst.coef, alive=tprob.alive, k=k,
        with_selection=True,
    )
    np.testing.assert_array_equal(_np(ksel), np.where(_np(tvalid), _np(tsel), -1))


def test_single_field_and_nn_rule():
    jprob, jst, tprob, tst = _trained(b=2)
    jp1, jst1 = jr.field_view(jprob, jst, 1)
    tp1 = dataclasses.replace(
        tprob, y=tprob.y[1], nbr_pos=tprob.nbr_pos[1], nbr_mask=tprob.nbr_mask[1],
        gram=tprob.gram[1], chol=tprob.chol[1], stream_pos=tprob.stream_pos[1],
        beta=tprob.beta[1], anchor_w=tprob.anchor_w[1],
    )
    tst1 = tr.SNTrainState(z=tst.z[1], coef=tst.coef[1])
    xq = _queries(jprob, q=33, seed=4)
    dense = np.asarray(jr.fusion.fuse(jp1, jst1, xq, "nn"))
    for engine in ("plan", "cuda"):
        out = tr.fusion.fuse(tp1, tst1, xq, "nn", engine=engine)
        assert out.shape == (33,)
        np.testing.assert_allclose(_np(out), dense, atol=1e-5, err_msg=engine)


@pytest.mark.parametrize("rule", ["single", "nn", "knn", "avg", "conn"])
def test_dense_rules_match_jax(rule):
    jprob, jst, tprob, tst = _trained(b=2, dead=(7,))
    xq = _queries(jprob, q=29, seed=1)
    ref = np.asarray(jr.fusion.fuse(jprob, jst, xq, rule, k=3, sensor=2))
    out = tr.fusion.fuse(tprob, tst, xq, rule, k=3, sensor=2)
    np.testing.assert_allclose(_np(out), ref, atol=1e-5)


def test_bf16_anchors_keep_output_dtype_and_match_jax():
    """bf16 anchor storage: f32 output for an f32 problem, same values as the
    reference's bf16 path, same selection as full precision."""
    jprob, jst, tprob, tst = _trained()
    xq = _queries(jprob, q=50, seed=2)
    jplan, tplan = jr.make_serving_plan(jprob, k=3), tr.make_serving_plan(tprob, k=3)
    ref = np.asarray(jr.fusion.fuse(jprob, jst, xq, "knn", k=3, engine="plan", plan=jplan,
                                    compute_dtype="bf16"))
    for engine in ("plan", "cuda"):
        out = tr.fusion.fuse(tprob, tst, xq, "knn", k=3, engine=engine, plan=tplan,
                             compute_dtype="bf16")
        assert out.dtype == torch.float32, engine
        np.testing.assert_allclose(_np(out), ref, atol=1e-5, err_msg=engine)


def test_conn_route_matches_jax():
    """global_coefficients + the fused kernel matvec, against the JAX route."""
    jprob, jst, tprob, tst = _trained()
    xq = np.linspace(-1, 1, 40)[:, None].astype(np.float32)
    xq = np.concatenate([xq, np.zeros_like(xq)], axis=1)
    ja, jc = jr.fusion.global_coefficients(jprob, jst, rule="conn")
    ta, tc = tr.fusion.global_coefficients(tprob, tst, rule="conn")
    np.testing.assert_array_equal(_np(ta), np.asarray(ja))
    np.testing.assert_allclose(_np(tc), np.asarray(jc), atol=1e-7)
    ref = np.asarray(j_kernel_matvec(xq, ja, jc, gamma=1.0))
    out = kernel_matvec(torch.as_tensor(xq), ta, tc, gamma=1.0)
    assert out.shape == ref.shape == (3, 40)
    np.testing.assert_allclose(_np(out), ref, atol=2e-5, rtol=2e-5)
    # the collapsed expansion IS the dense conn fusion
    dense = np.asarray(jr.fusion.fuse(jprob, jst, xq, "conn"))
    np.testing.assert_allclose(_np(out), dense, atol=1e-5)


@pytest.mark.parametrize("q,n,d,b", [(1, 1, 1, 0), (7, 13, 1, 0), (130, 600, 3, 0),
                                     (33, 77, 2, 3), (257, 129, 2, 2)])
def test_kernel_matvec_shapes(q, n, d, b):
    """Single-field (b = 0: (N,) coef) and multi-field, shared and per-field anchors."""
    rng = np.random.default_rng(q * 1000 + n + d)
    xq = rng.normal(size=(q, d)).astype(np.float32)
    an = rng.normal(size=((b, n, d) if b else (n, d))).astype(np.float32)
    c = rng.normal(size=((b, n) if b else (n,))).astype(np.float32)
    out = kernel_matvec(torch.as_tensor(xq), torch.as_tensor(an), torch.as_tensor(c), gamma=0.5)
    if b:
        ref = np.stack([np.asarray(j_kernel_matvec_ref(xq, an[i], c[i], 0.5)) for i in range(b)])
        shared = kernel_matvec(torch.as_tensor(xq), torch.as_tensor(an[0]),
                               torch.as_tensor(c), gamma=0.5)
        ref_shared = np.stack(
            [np.asarray(j_kernel_matvec_ref(xq, an[0], c[i], 0.5)) for i in range(b)]
        )
        np.testing.assert_allclose(_np(shared), ref_shared, atol=2e-5, rtol=2e-5)
    else:
        ref = np.asarray(j_kernel_matvec_ref(xq, an, c, 0.5))
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(_np(out), ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("engine", ["plan", "cuda"])
def test_prune_and_ecoef_match_jax(engine):
    """A prune keep-mask drops sensors from selection exactly like dead rows,
    and a precomputed ``ecoef`` is what the engines evaluate."""
    jprob, jst, tprob, tst = _trained()
    xq = _queries(jprob, q=40, seed=5)
    keep = np.ones(tprob.n + 1, bool)
    keep[[3, 8, 21, 40]] = False
    jplan, tplan = jr.make_serving_plan(jprob, k=3), tr.make_serving_plan(tprob, k=3)
    ref = np.asarray(jr.fusion.fuse(jprob, jst, xq, "knn", k=3, engine="plan", plan=jplan,
                                    prune=jnp.asarray(keep)))
    out = tr.fusion.fuse(tprob, tst, xq, "knn", k=3, engine=engine, plan=tplan,
                         prune=torch.as_tensor(keep))
    np.testing.assert_allclose(_np(out), ref, atol=1e-5)
    dead = dataclasses.replace(tprob, alive=tprob.alive & torch.as_tensor(keep))
    assert torch.equal(out, tr.fusion.fuse(dead, tst, xq, "knn", k=3, engine=engine,
                                           plan=tplan))
    twice = 2.0 * tst.coef  # serving reads ecoef, not the state's coef
    doubled = tr.fusion.fuse(tprob, tst, xq, "knn", k=3, engine=engine, plan=tplan,
                            ecoef=twice)
    base = tr.fusion.fuse(tprob, tst, xq, "knn", k=3, engine=engine, plan=tplan)
    np.testing.assert_allclose(_np(doubled), 2.0 * _np(base), rtol=1e-6, atol=1e-7)


def test_non_rbf_kernel_plan_engine_and_cuda_refusal():
    """The plan engine serves any kernel; the CUDA kernel fuses RBF only."""
    jprob, tprob = _pair(n=40, b=2, d=2, radius=0.6, seed=9, lam=0.5,
                         kernel=("matern32", 1.0))
    jst = jr.colored_sweep(jprob, jr.init_state(jprob), n_sweeps=5)
    tst = convert.state_from_numpy(
        {"z": np.asarray(jst.z), "coef": np.asarray(jst.coef)}, device="cpu"
    )
    xq = _queries(jprob, q=30, seed=6)
    dense = np.asarray(jr.fusion.fuse(jprob, jst, xq, "knn", k=3))
    out = tr.fusion.fuse(tprob, tst, xq, "knn", k=3, engine="plan")
    np.testing.assert_allclose(_np(out), dense, atol=1e-5)
    with pytest.raises(NotImplementedError, match="RBF"):
        tr.fusion.fuse(tprob, tst, xq, "knn", k=3, engine="cuda")
