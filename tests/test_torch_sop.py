"""The port's generic SOP machinery (``repro_torch.core.sop``) against the
reference's ``repro.core.sop`` on the same numpy inputs: 1e-5 in float32,
1e-10 in float64 (a subprocess, since JAX's x64 is process-global); then
the reference's own properties (Lemma 2.1) inside the port, at
``tests/test_sop.py``'s bounds."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sop as jsop
from repro_torch.core import sop

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sets(seed, m, k, dim, dtype=np.float32):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(m, k, dim)).astype(dtype)
    xstar = rng.normal(size=(dim,)).astype(dtype)
    b = np.einsum("mkd,d->mk", a, xstar).astype(dtype)
    x0 = rng.normal(size=(dim,)).astype(dtype)
    return a, b, xstar, x0


def _t(*xs):
    return [torch.as_tensor(x) for x in xs]


@pytest.mark.parametrize("seed,m,k,dim", [(0, 3, 2, 6), (1, 5, 1, 4), (2, 2, 3, 10)])
def test_every_function_matches_reference_f32(seed, m, k, dim):
    a, b, xstar, x0 = _sets(seed, m, k, dim)
    ta, tb, tx, t0 = _t(a, b, xstar, x0)
    ja, jb, jx, j0 = (jnp.asarray(v) for v in (a, b, xstar, x0))
    np.testing.assert_allclose(sop.project_affine(t0, ta[0], tb[0]).numpy(),
                               np.asarray(jsop.project_affine(j0, ja[0], jb[0])), atol=1e-5)
    np.testing.assert_allclose(sop.sop_sweep(t0, ta, tb, n_sweeps=3).numpy(),
                               np.asarray(jsop.sop_sweep(j0, ja, jb, n_sweeps=3)), atol=1e-5)
    x, trace = sop.sop_sweep_with_trace(t0, ta, tb, n_sweeps=2)
    jxf, jtrace = jsop.sop_sweep_with_trace(j0, ja, jb, n_sweeps=2)
    assert trace.shape == (2 * m, dim) and trace.dtype == torch.float32
    np.testing.assert_allclose(trace.numpy(), np.asarray(jtrace), atol=1e-5)
    np.testing.assert_allclose(x.numpy(), np.asarray(jxf), atol=1e-5)
    np.testing.assert_allclose(sop.project_intersection(t0, ta, tb).numpy(),
                               np.asarray(jsop.project_intersection(j0, ja, jb)), atol=1e-5)
    np.testing.assert_allclose(sop.fejer_distances(trace, tx).numpy(),
                               np.asarray(jsop.fejer_distances(jtrace, jx)), atol=1e-5)


_F64 = r"""
import os
os.environ["JAX_ENABLE_X64"] = "1"
import numpy as np, jax.numpy as jnp, torch
from repro.core import sop as jsop
from repro_torch.core import sop
worst = 0.0
for seed, m, k, dim in [(0, 3, 2, 6), (3, 4, 2, 8)]:
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(m, k, dim)); xs = rng.normal(size=dim)
    b = np.einsum("mkd,d->mk", a, xs); x0 = rng.normal(size=dim)
    ta, tb, tx, t0 = (torch.as_tensor(v) for v in (a, b, xs, x0))
    ja, jb, jx, j0 = (jnp.asarray(v) for v in (a, b, xs, x0))
    x, tr = sop.sop_sweep_with_trace(t0, ta, tb, n_sweeps=3)
    jxf, jtr = jsop.sop_sweep_with_trace(j0, ja, jb, n_sweeps=3)
    assert x.dtype == torch.float64 and jtr.dtype == jnp.float64
    pairs = [(sop.project_affine(t0, ta[0], tb[0]), jsop.project_affine(j0, ja[0], jb[0])),
             (sop.sop_sweep(t0, ta, tb, n_sweeps=3), jsop.sop_sweep(j0, ja, jb, n_sweeps=3)),
             (tr, jtr), (x, jxf),
             (sop.project_intersection(t0, ta, tb), jsop.project_intersection(j0, ja, jb)),
             (sop.fejer_distances(tr, tx), jsop.fejer_distances(jtr, jx))]
    for p, r in pairs:
        worst = max(worst, float(np.abs(p.numpy() - np.asarray(r)).max()))
assert worst <= 1e-10, worst
print("OK", worst)
"""


def test_every_function_matches_reference_f64_subprocess():
    env = dict(os.environ, PYTHONPATH="src")
    out = subprocess.run([sys.executable, "-c", _F64], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "OK" in out.stdout


def test_projection_is_idempotent_and_feasible():
    a, b, _, x0 = _sets(0, 1, 2, 6)
    ta, tb, t0 = _t(a, b, x0)
    p = sop.project_affine(t0, ta[0], tb[0])
    np.testing.assert_allclose((ta[0] @ p).numpy(), b[0], atol=1e-4)
    np.testing.assert_allclose(sop.project_affine(p, ta[0], tb[0]).numpy(), p.numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("seed", [0, 11, 42, 977])
def test_lemma_2_1_fejer_monotonicity(seed):
    """||x_n - x|| <= ||x_{n-1} - x|| for every feasible x (Lemma 2.1)."""
    rng = np.random.default_rng(seed)
    m, k, dim = int(rng.integers(2, 6)), int(rng.integers(1, 4)), int(rng.integers(4, 11))
    a, b, xstar, x0 = _t(*_sets(seed, m, k, dim))
    _, trace = sop.sop_sweep_with_trace(x0, a, b, n_sweeps=3)
    d = sop.fejer_distances(torch.cat([x0[None], trace]), xstar).numpy()
    assert (np.diff(d) <= 1e-4 + 1e-4 * d[:-1]).all(), d


@pytest.mark.parametrize("seed", [3, 19])
def test_sop_converges_to_projection_for_subspaces(seed):
    """For affine sets, SOP -> P_C(x0) (Lemma 2.1's last claim), at 5e-3."""
    a, b, _, x0 = _t(*_sets(seed, 3, 1, 5))
    x_inf = sop.sop_sweep(x0, a, b, n_sweeps=400)
    for i in range(3):
        np.testing.assert_allclose((a[i] @ x_inf).numpy(), b[i].numpy(), atol=5e-3)
    np.testing.assert_allclose(x_inf.numpy(), sop.project_intersection(x0, a, b).numpy(),
                               atol=5e-3)
