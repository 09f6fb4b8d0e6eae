"""``repro_torch.core.sharded_sweep`` over a gloo group against the
reference's ``repro.core.sharded_sweep`` over forced host devices.

Both regimes on 4 ranks (one ``distributed.spawn`` for the file, every
check's inputs in it), each against the reference's 4-device run
(subprocesses started beside the spawn) and the port's ``colored_sweep``:

* fields (batched): ``tests/test_multifield.py:379``'s geometry (24
  sensors, B = 8, 7 sweeps), on the plan, onehot and cuda engines (the
  kernel's plain version on the CPU): against ``colored_sweep`` at 1e-5 (a
  batch and its sub-batches differ by up to 1.6e-6, ROADMAP Queue 3 entry
  4, so not bitwise), against the reference at the long-chain bound z 2e-4
  / coef 2e-2: on the same problem the two packages' ``colored_sweep``
  already differ by 2.7e-5 in z after 7 sweeps at lambda = 1e-2 in float32
  (9.5e-14 in float64; Queue 3 entry 7);
* sensors (single field): ``tests/test_scatter_plan.py:178``'s geometry
  (40 sensors in d = 2, r = 0.6, 9 sweeps) at its z 2e-4 / coef 2e-2;
* both regimes in float64 at 1e-10;

both with a 10% drop ``delivered`` mask from a numpy seed.  An all-True
mask equals ``None`` bitwise, and a world of one equals ``colored_sweep``
bitwise, engine by engine.  The port runs on the reference's own problems
(``convert.problem_from_numpy``): built apart, the two packages' float32
Cholesky factors differ by ~2e-6, which 7 sweeps at lambda = 1e-2 carry to
~1e-4 in z with no sharding at all.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro_torch.core as tr
from repro_torch import convert, distributed

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, NF, B, SF, NS, SS = 4, 24, 8, 7, 40, 9
KERN = tr.Kernel("rbf", gamma=1.0)


def _inputs() -> dict:
    pos_f = tr.uniform_sensors(NF, seed=0)
    rng = np.random.default_rng(1)
    ys_f = (np.sin(np.pi * rng.uniform(0.5, 2, (B, 1)) * pos_f[None, :, 0])
            + 0.3 * rng.normal(size=(B, NF)))
    pos_s = tr.uniform_sensors(NS, d=2, seed=0)
    y_s = np.sin(np.pi * pos_s[:, 0]) + 0.5 * np.random.default_rng(1).normal(size=NS)
    out = dict(pos_f=pos_f, ys_f=ys_f, pos_s=pos_s, y_s=y_s)
    f, s = _field_problem(out, torch.float32), _sensor_problem(out, torch.float32)
    drops = np.random.default_rng(2)
    out["deliv_f"] = drops.uniform(size=(SF,) + tuple(f.nbr_idx.shape)) >= 0.1
    out["deliv_s"] = drops.uniform(size=(SS,) + tuple(s.nbr_idx.shape)) >= 0.1
    return out


def _field_problem(inp, dtype, b=B):
    topo = tr.build_topology(inp["pos_f"], 0.8, device="cpu")
    return tr.make_batch_problem(topo, KERN, inp["ys_f"][:b], np.full(NF, 1e-2),
                                 dtype=dtype, device="cpu")


def _sensor_problem(inp, dtype):
    topo = tr.build_topology(inp["pos_s"], 0.6, device="cpu")
    return tr.make_problem(topo, KERN, inp["y_s"], np.full(NS, 1e-2), dtype=dtype,
                           device="cpu")


def _problem(leaves: dict, tag: str):
    """The reference's problem ``tag`` ("field", "sensor", "sensor64") on the CPU."""
    return convert.problem_from_numpy(leaves[tag], kernel=KERN, device="cpu")


def _runs(ctx, inp, leaves) -> dict:
    """Every sharded run of the file on one rank: {key: (z, coef)} as numpy,
    plus the bitwise checks made on the rank."""
    out, flags = {}, {}
    deliv_f = torch.as_tensor(inp["deliv_f"])
    for tag, engines in (("field", tr.sn_train.ENGINES), ("field64", ("plan",))):
        pf = _problem(leaves, tag)
        sf0 = tr.init_state(pf)
        for engine in engines:
            out[f"{tag}/{engine}"] = tr.sharded_sweep(pf, sf0, ctx.group, n_sweeps=SF,
                                                      engine=engine)
            out[f"{tag}/{engine}/drop"] = tr.sharded_sweep(
                pf, sf0, ctx.group, n_sweeps=SF, engine=engine, delivered=deliv_f)
    pf = _problem(leaves, "field")
    sf0 = tr.init_state(pf)
    ones = tr.sharded_sweep(pf, sf0, ctx.group, n_sweeps=SF, delivered=torch.ones_like(deliv_f))
    flags["field all-True == None"] = _equal(ones, out["field/plan"])
    for tag in ("sensor", "sensor64"):
        ps = _problem(leaves, tag)
        ss0 = tr.init_state(ps)
        out[tag] = tr.sharded_sweep(ps, ss0, ctx.group, n_sweeps=SS)
        deliv_s = torch.as_tensor(inp["deliv_s"])
        out[tag + "/drop"] = tr.sharded_sweep(ps, ss0, ctx.group, n_sweeps=SS,
                                              delivered=deliv_s)
        ones = tr.sharded_sweep(ps, ss0, ctx.group, n_sweeps=SS,
                                delivered=torch.ones_like(deliv_s))
        flags[f"{tag} all-True == None"] = _equal(ones, out[tag])
    odd = _field_problem(inp, torch.float32, b=6)
    with pytest.raises(ValueError, match="must divide over 4 devices"):
        tr.sharded_sweep(odd, tr.init_state(odd), ctx.group, n_sweeps=1)
    flags["B = 6 over 4 ranks raises"] = True
    res = {k: (st.z.numpy(), st.coef.numpy()) for k, st in out.items()}
    return {"states": res, "flags": flags}


def _equal(a, b) -> bool:
    return torch.equal(a.z, b.z) and torch.equal(a.coef, b.coef)


_REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
f64 = sys.argv[3] == "f64"
if f64:
    os.environ["JAX_ENABLE_X64"] = "1"
import dataclasses
import numpy as np, jax.numpy as jnp
from repro import compat
from repro.core import *
src = np.load(sys.argv[1])
kern = Kernel("rbf", gamma=1.0)
dt = jnp.float64 if f64 else jnp.float32
tag = "64" if f64 else ""
ps = make_problem(build_topology(src["pos_s"], 0.6), kern, src["y_s"],
                  lambdas=jnp.full((40,), 1e-2, dt), dtype=dt)
pf = make_batch_problem(build_topology(src["pos_f"], 0.8), kern, src["ys_f"],
                        jnp.full((24,), 1e-2, dt), dtype=dt)
leaves = {}
for name, prob in (("sensor" + tag, ps), ("field" + tag, pf)):
    for f in dataclasses.fields(prob):
        v = getattr(prob, f.name)
        if dataclasses.is_dataclass(v) and f.name != "kernel":
            for g in dataclasses.fields(v):
                leaves[f"{name}:{f.name}.{g.name}"] = np.asarray(getattr(v, g.name))
        elif f.name != "kernel":
            leaves[f"{name}:{f.name}"] = np.asarray(v)
np.savez(sys.argv[2] + ".tmp.npz", **leaves)
os.rename(sys.argv[2] + ".tmp.npz", sys.argv[2] + ".leaves.npz")  # the port starts now
out = {}
mesh_s = compat.make_mesh((4,), ("sensors",))
for name, deliv in (("", None), ("/drop", jnp.asarray(src["deliv_s"]))):
    out["sensor" + tag + name] = sharded_sweep(ps, init_state(ps), mesh_s, axis="sensors",
                                               n_sweeps=9, delivered=deliv)
mesh_f = compat.make_mesh((4,), ("fields",))
for engine in ("plan",) if f64 else ("plan", "onehot", "pallas"):
    for name, deliv in (("", None), ("/drop", jnp.asarray(src["deliv_f"]))):
        out[f"field{tag}/{engine}{name}"] = sharded_sweep(
            pf, init_state(pf), mesh_f, axis="fields", n_sweeps=7, engine=engine,
            delivered=deliv)
arrays = {}
for k, st in out.items():
    arrays[k + "|z"] = np.asarray(st.z)
    arrays[k + "|coef"] = np.asarray(st.coef)
np.savez(sys.argv[2], **arrays)
print("OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the reference's problems as leaves, each rank's runs, the
    reference's runs).  The ranks start as soon as the reference has built
    its problems, while its sweeps still run."""
    inp = _inputs()
    tmp = tmp_path_factory.mktemp("sharded")
    np.savez(tmp / "in.npz", **inp)
    env = dict(os.environ, PYTHONPATH="src")
    procs = {mode: subprocess.Popen(
        [sys.executable, "-c", _REF, str(tmp / "in.npz"), str(tmp / f"{mode}.npz"), mode],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for mode in ("f32", "f64")}
    leaves = {}
    for mode, proc in procs.items():
        path = tmp / f"{mode}.npz.leaves.npz"
        deadline = time.monotonic() + 300
        while not path.exists() and proc.poll() is None and time.monotonic() < deadline:
            time.sleep(0.1)
        assert path.exists(), proc.communicate(timeout=60)[1][-2000:]
        with np.load(path) as f:
            for key in f.files:
                tag, leaf = key.split(":")
                leaves.setdefault(tag, {})[leaf] = f[key]
    ranks = distributed.spawn(_runs, W, inp, leaves, device="cpu")
    ref = {}
    for mode, proc in procs.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-2000:]
        with np.load(tmp / f"{mode}.npz") as f:
            for key in f.files:
                name, part = key.split("|")
                ref.setdefault(name.replace("pallas", "cuda"), {})[part] = f[key]
    return inp, leaves, ranks, ref


def _case(inp, leaves, key):
    """(problem, sweeps, engine, delivered) of a run key of ``_runs``."""
    parts = key.split("/")
    field = parts[0].startswith("field")
    deliv = torch.as_tensor(inp["deliv_f" if field else "deliv_s"]) if parts[-1] == "drop" \
        else None
    return (_problem(leaves, parts[0]), SF if field else SS, parts[1] if field else "plan",
            deliv)


def _colored(inp, leaves, key):
    """The port's colored_sweep for a run key of ``_runs``."""
    prob, sweeps, engine, deliv = _case(inp, leaves, key)
    st = tr.colored_sweep(prob, tr.init_state(prob), n_sweeps=sweeps, engine=engine,
                          delivered=deliv)
    return st.z.numpy(), st.coef.numpy()


FIELD_KEYS = [f"field/{e}{d}" for e in ("plan", "onehot", "cuda") for d in ("", "/drop")]
FIELD_KEYS += ["field64/plan", "field64/plan/drop"]
SENSOR_KEYS = ["sensor", "sensor/drop", "sensor64", "sensor64/drop"]


def _tols(key):
    """((z, coef) against colored_sweep, (z, coef) against the reference)."""
    if "64" in key:
        return (1e-10, 1e-10), (1e-10, 1e-10)
    if key.startswith("field"):
        return (1e-5, 1e-5), (2e-4, 2e-2)
    return (2e-4, 2e-2), (2e-4, 2e-2)


@pytest.mark.parametrize("key", FIELD_KEYS + SENSOR_KEYS)
def test_sharded_matches_reference_and_colored_on_4_ranks(runs, key):
    inp, leaves, ranks, ref = runs
    z, coef = ranks[0]["states"][key]
    for r in range(1, W):  # every rank returns the whole replicated state
        rz, rc = ranks[r]["states"][key]
        assert np.array_equal(rz, z) and np.array_equal(rc, coef), r
    (tz, tc), (rz, rc) = _tols(key)
    cz, cc = _colored(inp, leaves, key)
    assert z.shape == cz.shape and coef.shape == cc.shape
    np.testing.assert_allclose(z, cz, atol=tz, err_msg="vs colored_sweep")
    np.testing.assert_allclose(coef, cc, atol=tc, err_msg="vs colored_sweep")
    np.testing.assert_allclose(z, ref[key]["z"], atol=rz, err_msg="vs the reference")
    np.testing.assert_allclose(coef, ref[key]["coef"], atol=rc, err_msg="vs the reference")


def test_drops_change_the_result_and_all_true_is_none(runs):
    _, _, ranks, _ = runs
    for key in ("field/plan", "field64/plan", "sensor", "sensor64"):
        z, _ = ranks[0]["states"][key]
        zd, _ = ranks[0]["states"][key + "/drop"]
        assert not np.array_equal(z, zd), key
    for r in range(W):
        assert all(ranks[r]["flags"].values()) and len(ranks[r]["flags"]) == 4


@pytest.fixture(scope="module")
def world1():
    ctx = distributed.init_group(0, 1, device="cpu")
    yield ctx
    dist.destroy_process_group()


@pytest.mark.parametrize("key", FIELD_KEYS + SENSOR_KEYS)
def test_world_of_one_is_colored_sweep_bitwise(runs, world1, key):
    prob, sweeps, engine, deliv = _case(runs[0], runs[1], key)
    st0 = tr.init_state(prob)
    got = tr.sharded_sweep(prob, st0, world1.group, n_sweeps=sweeps, engine=engine,
                           delivered=deliv)
    want = tr.colored_sweep(prob, st0, n_sweeps=sweeps, engine=engine, delivered=deliv)
    assert _equal(got, want)


def test_engine_validation_matches_reference(world1):
    """tests/test_scatter_plan.py:157-175: an unknown engine is a ValueError;
    the single-field transport IS the plan, other engines refuse."""
    inp = _inputs()
    ps = _sensor_problem(inp, torch.float32)
    pf = _field_problem(inp, torch.float32)
    for prob in (ps, pf):
        with pytest.raises(ValueError, match="engine"):
            tr.sharded_sweep(prob, tr.init_state(prob), world1.group, n_sweeps=1,
                             engine="dense")
    for engine in ("onehot", "cuda"):
        with pytest.raises(NotImplementedError, match="plan transport"):
            tr.sharded_sweep(ps, tr.init_state(ps), world1.group, n_sweeps=1, engine=engine)
    with pytest.raises(ValueError, match="delivered has 2 sweeps"):
        tr.sharded_sweep(ps, tr.init_state(ps), world1.group, n_sweeps=3,
                         delivered=torch.ones((2,) + tuple(ps.nbr_idx.shape), dtype=torch.bool))
