"""The launcher's seeded problem at the benched size, through both packages.

n = 1000 sensors in [-1, 1]^2, radius 0.3 sqrt(100 / n), RBF gamma 1,
lambda 0.1, B = 16 fields, 30 colored sweeps on the plan engines: the port's
``launch.serve.build_problem`` against the same draws built by the JAX
package.  At this size the per-step bound does not hold in f32 even inside
the reference (ROADMAP, "Which sweep bound applies"), so f32 is held to the
long-chain bound, z 2e-4 and coef 2e-2 (tests/test_scatter_plan.py:200),
and f64 to 1e-10.  The f64 run is a subprocess with ``JAX_ENABLE_X64``,
started before the f32 test so that the two overlap.
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
from repro_torch.launch import serve

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, SWEEPS = 1000, 30
ARGV = ["--mode", "field", "--device", "cpu", "--fields", "16", "--sensors", str(N),
        "--dim", "2", "--radius", repr(0.3 * (100.0 / N) ** 0.5), "--gamma", "1.0",
        "--lam", "0.1", "--sweeps", str(SWEEPS), "--seed", "0"]

CODE = r"""
import os
os.environ["JAX_ENABLE_X64"] = "1"
import sys
sys.path.insert(0, "tests")
import numpy as np, torch
torch.set_num_threads(1)
import test_torch_field_n1000 as T

jz, jc, tz, tc = T.both(torch.float64)
assert tz.dtype == np.float64 and jz.dtype == np.float64
np.testing.assert_allclose(tz, jz, atol=1e-10)
np.testing.assert_allclose(tc, jc, atol=1e-10)
print("OK", np.abs(tz - jz).max(), np.abs(tc - jc).max())
"""


def both(dtype):
    """(reference z, coef, port z, coef) after SWEEPS plan-engine sweeps, as numpy."""
    args = serve.parser().parse_args(ARGV)
    tprob = serve.build_problem(args, dtype)
    # the launcher's draws: positions from the seed, then the fields' generator
    pos = jr.uniform_sensors(N, d=2, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    b = args.fields
    freq = rng.uniform(0.5, 2.0, size=(b, 1))
    phase = rng.uniform(0, 2 * np.pi, size=(b, 1))
    ys = np.sin(np.pi * freq * pos[None, :, 0] + phase) + 0.3 * rng.normal(size=(b, N))
    jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
    jprob = jr.make_batch_problem(
        jr.build_topology(pos, args.radius), jr.Kernel("rbf", gamma=args.gamma), ys,
        np.full((N,), args.lam, np.float32), dtype=jdtype,
    )
    np.testing.assert_array_equal(tprob.nbr_idx.numpy(), np.asarray(jprob.nbr_idx))
    np.testing.assert_array_equal(tprob.plan_z.numpy(), np.asarray(jprob.plan_z))
    jst = jr.colored_sweep(jprob, jr.init_state(jprob), n_sweeps=SWEEPS)
    tst = tr.colored_sweep(tprob, tr.init_state(tprob), n_sweeps=SWEEPS)
    return (np.asarray(jst.z)[:, :-1], np.asarray(jst.coef), tst.z.numpy()[:, :-1],
            tst.coef.numpy())


@pytest.fixture(scope="module", autouse=True)
def f64_run():
    env = dict(os.environ, PYTHONPATH="src")
    proc = subprocess.Popen([sys.executable, "-c", CODE], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def test_f32_benched_size_matches_reference():
    jz, jc, tz, tc = both(torch.float32)
    assert tz.shape == jz.shape and tz.shape[0] == 16 and np.isfinite(tz).all()
    np.testing.assert_allclose(tz, jz, atol=2e-4)
    np.testing.assert_allclose(tc, jc, atol=2e-2)


def test_f64_benched_size_matches_reference_subprocess(f64_run):
    out, err = f64_run.communicate(timeout=600)
    assert f64_run.returncode == 0, err[-3000:]
    assert "OK" in out
