"""Port parity, build stage: topology, coloring, scatter plans, Grams, serving plans.

The same numpy inputs go through the JAX package (``repro``) and the
PyTorch port (``repro_torch``).  Integer tables and the coloring must be
exactly equal; Grams and factors agree within 2e-5 in f32 (the reference's
kernel-vs-oracle bound, tests/test_kernels_pallas.py).  The f64 bounds
live in tests/test_torch_f64.py.  The helpers here are shared by the other
tests/test_torch_*.py files.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jr
import repro_torch.core as tr
from repro_torch import convert

torch.set_num_threads(1)

CPU = "cpu"
TOPO_ARRAYS = ("positions", "adj", "nbr_idx", "nbr_mask", "degrees", "colors",
               "color_members", "color_mask")
TOPO_STATIC = ("n_colors", "n_base", "radius", "n_recolor")
PROBLEM_INT = ("nbr_idx", "nbr_mask", "plan_z", "plan_coef", "color_members",
               "color_mask", "color_of", "member_pos", "alive")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _inputs(n, b, d, seed):
    pos = np.random.default_rng(seed).uniform(-1, 1, size=(n, d)).astype(np.float32)
    rng = np.random.default_rng(seed + 1)
    freq = rng.uniform(0.5, 2.0, size=(b, 1))
    ys = np.sin(np.pi * freq * pos[None, :, 0]) + 0.3 * rng.normal(size=(b, n))
    return pos, ys.astype(np.float32)


def _pair(n=30, b=2, d=2, radius=0.6, seed=0, lam=0.1, headroom=0, n_max=None,
          kernel=("rbf", 1.0)):
    """The same batched problem built by both packages (f32)."""
    pos, ys = _inputs(n, b, d, seed)
    d_max = None
    if headroom:
        d_max = int(jr.topology.geometric_adjacency(pos, radius).sum(1).max()) + headroom
    name, gamma = kernel
    jtopo = jr.build_topology(pos, radius, d_max=d_max)
    ttopo = tr.build_topology(pos, radius, d_max=d_max, device=CPU)
    lam_v = np.full((n,), lam, np.float32)
    jprob = jr.make_batch_problem(
        jtopo, jr.Kernel(name, gamma=gamma), ys, jnp.asarray(lam_v), n_max=n_max
    )
    tprob = tr.make_batch_problem(
        ttopo, tr.Kernel(name, gamma=gamma), ys, lam_v, n_max=n_max, device=CPU
    )
    return jprob, tprob


def _leaves(jprob) -> dict:
    """The reference problem's leaves as numpy arrays / Python statics."""
    d = {}
    for f in dataclasses.fields(jprob):
        v = getattr(jprob, f.name)
        if f.name == "topology":
            for g in dataclasses.fields(v):
                d[f"topology.{g.name}"] = getattr(v, g.name) if g.name in TOPO_STATIC \
                    else np.asarray(getattr(v, g.name))
        elif f.name == "layout":
            d["layout.slot_owner"] = np.asarray(v.slot_owner)
            d["layout.nbr_idx0"] = np.asarray(v.nbr_idx0)
            d["layout.n_base"] = v.n_base
        elif f.name == "n_stream":
            d[f.name] = v
        elif f.name != "kernel":
            d[f.name] = np.asarray(v)
    return d


def _plan_leaves(jplan) -> dict:
    d = {f.name: np.asarray(getattr(jplan, f.name)) for f in dataclasses.fields(jplan)
         if f.name not in ("grid_shape", "k")}
    d["grid_shape"], d["k"] = jplan.grid_shape, jplan.k
    return d


def _assert_problem_tables_equal(jprob, tprob):
    for name in TOPO_ARRAYS:
        np.testing.assert_array_equal(
            _np(getattr(tprob.topology, name)), _np(getattr(jprob.topology, name)), err_msg=name
        )
    for name in TOPO_STATIC:
        assert getattr(tprob.topology, name) == getattr(jprob.topology, name), name
    for name in PROBLEM_INT:
        np.testing.assert_array_equal(
            _np(getattr(tprob, name)), _np(getattr(jprob, name)), err_msg=name
        )
    np.testing.assert_array_equal(_np(tprob.layout.slot_owner), _np(jprob.layout.slot_owner))
    np.testing.assert_array_equal(_np(tprob.layout.nbr_idx0), _np(jprob.layout.nbr_idx0))
    assert tprob.layout.n_base == jprob.layout.n_base
    assert tprob.n_stream == jprob.n_stream


@pytest.mark.parametrize(
    "n,d,radius,seed,headroom,n_max",
    [
        (30, 2, 0.6, 0, 0, None),
        (40, 1, 0.3, 3, 0, None),
        (25, 2, 0.9, 7, 3, None),
        (20, 2, 0.7, 11, 2, 24),
    ],
)
def test_build_tables_exact(n, d, radius, seed, headroom, n_max):
    """Topology, coloring, slot ids, scatter plans and layout: bit-exact."""
    jprob, tprob = _pair(n=n, d=d, radius=radius, seed=seed, headroom=headroom, n_max=n_max)
    _assert_problem_tables_equal(jprob, tprob)
    np.testing.assert_array_equal(_np(tprob.nbr_pos), np.asarray(jprob.nbr_pos))
    np.testing.assert_allclose(_np(tprob.gram), np.asarray(jprob.gram), atol=2e-5)
    np.testing.assert_allclose(_np(tprob.chol), np.asarray(jprob.chol), atol=2e-5)
    np.testing.assert_array_equal(_np(tprob.lam_pad), np.asarray(jprob.lam_pad))
    assert tprob.gram.dtype == torch.float32 and tprob.nbr_idx.dtype == torch.int32


def test_ring_topology_and_default_lambdas_exact():
    jt, tt = jr.ring_topology(12, hops=2), tr.ring_topology(12, hops=2, device=CPU)
    for name in TOPO_ARRAYS:
        np.testing.assert_array_equal(_np(getattr(tt, name)), np.asarray(getattr(jt, name)))
    np.testing.assert_array_equal(
        _np(tr.default_lambdas(tt)), np.asarray(jr.sn_train.default_lambdas(jt))
    )


@pytest.mark.parametrize("name", ["rbf", "linear", "matern32", "poly"])
def test_kernels_math_parity(name):
    rng = np.random.default_rng(4)
    x1 = rng.normal(size=(9, 2)).astype(np.float32)
    x2 = rng.normal(size=(13, 2)).astype(np.float32)
    jk, tk = jr.Kernel(name, gamma=0.7, length=1.3), tr.Kernel(name, gamma=0.7, length=1.3)
    ref = np.asarray(jr.kernels_math.gram_matrix(jk, x1, x2))
    out = _np(tr.kernels_math.gram_matrix(tk, torch.as_tensor(x1), torch.as_tensor(x2)))
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(
        _np(tr.kernels_math.pairwise_sq_dists(torch.as_tensor(x1), torch.as_tensor(x2))),
        np.asarray(jr.kernels_math.pairwise_sq_dists(x1, x2)), atol=2e-5,
    )


@pytest.mark.parametrize("k,spare,slack", [(3, 0, 0), (1, 0, 0), (3, 2, 1)])
def test_serving_plan_exact(k, spare, slack):
    jprob, tprob = _pair(n=60, d=2, radius=0.5, seed=2)
    jplan = jr.make_serving_plan(jprob, k=k, spare=spare, slack=slack)
    tplan = tr.make_serving_plan(tprob, k=k, spare=spare, slack=slack)
    assert tplan.grid_shape == jplan.grid_shape and tplan.k == jplan.k
    for name in ("cells", "cell_mask", "origin", "inv_cell", "centers", "radii"):
        np.testing.assert_array_equal(_np(getattr(tplan, name)), np.asarray(getattr(jplan, name)))
    rng = np.random.default_rng(0)
    xq = rng.uniform(-1.2, 1.2, size=(40, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        _np(tr.serving.query_cells(tplan, torch.as_tensor(xq))),
        np.asarray(jr.serving.query_cells(jplan, jnp.asarray(xq))),
    )


def test_convert_matches_own_build():
    """The converted reference problem equals the port's own build."""
    jprob, tprob = _pair(n=24, b=2, d=2, radius=0.7, seed=5, headroom=2)
    cprob = convert.problem_from_numpy(_leaves(jprob), kernel=tr.Kernel("rbf", gamma=1.0),
                                       device=CPU)
    _assert_problem_tables_equal(jprob, cprob)
    for f in dataclasses.fields(tprob):
        if f.name in ("topology", "layout", "kernel", "n_stream"):
            continue
        a, b = getattr(cprob, f.name), getattr(tprob, f.name)
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        np.testing.assert_allclose(_np(a).astype(float), _np(b).astype(float), atol=2e-5,
                                   err_msg=f.name)
    jstate = jr.init_state(jprob)
    cstate = convert.state_from_numpy(
        {"z": np.asarray(jstate.z), "coef": np.asarray(jstate.coef)}, device=CPU
    )
    tstate = tr.init_state(tprob)
    assert torch.equal(cstate.z, tstate.z) and torch.equal(cstate.coef, tstate.coef)
    jplan = jr.make_serving_plan(jprob, k=3)
    cplan = convert.serving_plan_from_numpy(_plan_leaves(jplan), device=CPU)
    tplan = tr.make_serving_plan(tprob, k=3)
    assert torch.equal(cplan.cells, tplan.cells) and cplan.grid_shape == tplan.grid_shape
