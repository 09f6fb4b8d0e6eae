"""``core.serving.knn_select`` and ``core.centralized.mse`` against the
reference's (``repro.core.serving.knn_select``, ``repro.core.centralized.mse``).

knn_select: the same problem built by both packages, each package's own
serving plan, the same queries, with and without dead sensors: the selected
ids, exactly (tests/test_serving.py's dense argsort rule holds for both).
mse: the same training data through each package's ``fit_krr``, then the
mean squared error on held-out queries, 1e-5 relative in float32 (the
reference's and the port's Cholesky solves round differently), with the
kernel matvec route too.
"""

import numpy as np
import pytest
import torch

import repro.core as jr
import repro_torch.core as tr
from repro.core.centralized import mse as j_mse
from repro_torch.core.centralized import mse
from test_torch_build import _np, _pair

torch.set_num_threads(1)


@pytest.mark.parametrize("dead", [(), (3, 8, 21)])
@pytest.mark.parametrize("k", [1, 3])
def test_knn_select_matches_reference(k, dead):
    jprob, tprob = _pair(n=50, b=2, radius=0.6, seed=4)
    alive = np.ones(jprob.alive.shape, bool)
    alive[list(dead)] = False
    pos = np.asarray(jprob.topology.positions)
    xq = np.random.default_rng(7).uniform(pos.min(0), pos.max(0), (29, 2)).astype(np.float32)
    jplan, tplan = jr.make_serving_plan(jprob, k=k), tr.make_serving_plan(tprob, k=k)
    want = np.asarray(jr.serving.knn_select(jplan, jprob.topology.positions, xq, k,
                                            alive if dead else None))
    got = tr.serving.knn_select(tplan, tprob.topology.positions, torch.as_tensor(xq), k,
                                torch.as_tensor(alive) if dead else None)
    assert got.shape == (29, k)
    np.testing.assert_array_equal(_np(got), want)
    if not dead:  # tests/test_serving.py's rule: the dense stable argsort
        d2 = ((xq[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
        np.testing.assert_array_equal(_np(got), np.argsort(d2, axis=1, kind="stable")[:, :k])


@pytest.mark.parametrize("use_kernel", [False, True])
def test_mse_matches_reference(use_kernel):
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (40, 2)).astype(np.float32)
    y = np.sin(2 * x[:, 0]).astype(np.float32) + 0.1 * rng.normal(size=40).astype(np.float32)
    xq = rng.uniform(-1, 1, (64, 2)).astype(np.float32)
    yq = np.sin(2 * xq[:, 0]).astype(np.float32)
    jm = jr.fit_krr(x, y, jr.Kernel("rbf", gamma=1.0), 0.1)
    tm = tr.fit_krr(x, y, tr.Kernel("rbf", gamma=1.0), 0.1, device="cpu")
    want = float(j_mse(jm, xq, yq, use_pallas=use_kernel))
    got = mse(tm, xq, yq, use_kernel=use_kernel)
    assert got.shape == () and got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-5 * abs(want), (float(got), want)
