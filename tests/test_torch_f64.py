"""Port parity in float64 (a first-class path of the reference).

x64 is process-global in JAX, so the comparison runs in a subprocess, as
tests/test_scatter_plan.py does.  At the paper's own lambdas
(0.01/|N_i|^2) the sweep engines agree within 1e-10 and the Grams within
1e-12; kNN serving answers in f64, also with bf16 anchor storage.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CODE = r"""
import os
os.environ["JAX_ENABLE_X64"] = "1"
import dataclasses, sys
sys.path.insert(0, "tests")
import numpy as np, jax.numpy as jnp, torch
torch.set_num_threads(1)
import repro.core as jr
import repro_torch.core as tr
from repro_torch import convert
from test_torch_build import _leaves

n, b = 30, 2
pos = np.random.default_rng(0).uniform(-1, 1, size=(n, 2)).astype(np.float32)
rng = np.random.default_rng(1)
ys = np.sin(np.pi * pos[None, :, 0]) + 0.3 * rng.normal(size=(b, n))
jprob = jr.make_batch_problem(jr.build_topology(pos, 0.6), jr.Kernel("rbf", gamma=1.0),
                              ys, dtype=jnp.float64)  # paper lambdas
own = tr.make_batch_problem(tr.build_topology(pos, 0.6, device="cpu"),
                            tr.Kernel("rbf", gamma=1.0), ys, dtype=torch.float64,
                            device="cpu")
assert own.gram.dtype == torch.float64
np.testing.assert_allclose(own.gram.numpy(), np.asarray(jprob.gram), atol=1e-12)
# The factors of these cond ~1e9 systems differ between LAPACK builds by
# ~cond * eps; what must hold is that each factors its own system.
diag = torch.where(own.nbr_mask, own.lam_pad[:, None], 1.0)
np.testing.assert_allclose((own.chol @ own.chol.transpose(-1, -2)).numpy(),
                           (own.gram + torch.diag_embed(diag)).numpy(), atol=1e-12)
# the sweeps run on the reference's own tables, carried over
tprob = convert.problem_from_numpy(_leaves(jprob), kernel=tr.Kernel("rbf", gamma=1.0),
                                   device="cpu")

# a dead row and dropped deliveries, identical in both packages
alive = np.asarray(jprob.alive).copy(); alive[3] = False
jprob = dataclasses.replace(jprob, alive=jnp.asarray(alive))
tprob = dataclasses.replace(tprob, alive=torch.as_tensor(alive))
deliv = np.random.default_rng(2).uniform(size=(6,) + tuple(jprob.nbr_idx.shape)) >= 0.3
ref = jr.colored_sweep(jprob, jr.init_state(jprob), n_sweeps=6, engine="pallas",
                       delivered=jnp.asarray(deliv))
for engine in ("plan", "onehot", "cuda"):
    out = tr.colored_sweep(tprob, tr.init_state(tprob), n_sweeps=6, engine=engine,
                           delivered=torch.as_tensor(deliv))
    assert out.z.dtype == torch.float64, engine
    assert np.isfinite(out.z.numpy()).all(), engine
    np.testing.assert_allclose(out.z.numpy()[:, :-1], np.asarray(ref.z)[:, :-1], atol=1e-10)
    np.testing.assert_allclose(out.coef.numpy()[:, :-1], np.asarray(ref.coef)[:, :-1],
                               atol=1e-10)

jst = jr.colored_sweep(jprob, jr.init_state(jprob), n_sweeps=6)
tst = convert.state_from_numpy({"z": np.asarray(jst.z), "coef": np.asarray(jst.coef)},
                               device="cpu")
xq = np.linspace(-0.9, 0.9, 17)[:, None] * np.ones((1, 2))
dense = np.asarray(jr.fusion.fuse(jprob, jst, xq, "knn", k=3))
jplan, tplan = jr.make_serving_plan(jprob, k=3), tr.make_serving_plan(tprob, k=3)
jq = np.asarray(jr.fusion.fuse(jprob, jst, xq, "knn", k=3, engine="plan", plan=jplan,
                               compute_dtype="bf16"))
for engine in ("plan", "cuda"):
    exact = tr.fusion.fuse(tprob, tst, xq, "knn", k=3, engine=engine, plan=tplan)
    assert exact.dtype == torch.float64, engine
    np.testing.assert_allclose(exact.numpy(), dense, atol=1e-10)
    q = tr.fusion.fuse(tprob, tst, xq, "knn", k=3, engine=engine, plan=tplan,
                       compute_dtype="bf16")
    assert q.dtype == torch.float64, engine
    np.testing.assert_allclose(q.numpy(), jq, atol=1e-10)
    assert np.abs(q.numpy() - dense).max() > 0  # the anchors really were rounded
print("OK")
"""


def test_f64_port_matches_jax_x64_subprocess():
    env = dict(os.environ, PYTHONPATH="src")
    out = subprocess.run(
        [sys.executable, "-c", CODE], capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert "OK" in out.stdout
