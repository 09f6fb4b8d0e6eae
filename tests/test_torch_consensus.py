"""SOP-consensus gossip in the port (``repro_torch.core.consensus``) against
the reference's ``repro.core.consensus``.

Schedules and sim mode in this process.  Device mode runs on 4 gloo ranks
(one ``distributed.spawn`` for the whole file, every check's inputs in
it) and is held to the reference's 4-device ``shard_map`` run of the same
stacked inputs (a subprocess with forced host devices, as the reference's
own tests run it) at 1e-6, as ``tests/test_consensus.py`` bounds its
device collectives.  A world of one is a bitwise identity.  The
multi-card check (``launch/multi_gpu.py``: the sharded sweep, the gossip
and the train step across ranks) passes its own checks on 2 gloo ranks at
a small size.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import consensus as jc
from repro_torch import distributed, tree
from repro_torch.launch import multi_gpu
from repro_torch.core import consensus as tc

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
ROUNDS = 3


def _stacked(seed, n, shapes=((4, 3), (5,), (2, 2, 2))):
    rng = np.random.default_rng(seed)
    return {f"p{i}": rng.normal(size=(n,) + s).astype(np.float32)
            for i, s in enumerate(shapes)}


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16])
def test_schedules_equal_the_references(n):
    assert tc.hypercube_schedule(n) == jc.hypercube_schedule(n)
    assert tc.schedule("hypercube", n) == jc.schedule("hypercube", n)
    assert tc.one_sided_ring_schedule(n) == jc.one_sided_ring_schedule(n)
    if n % 2 == 0:
        assert tc.ring_schedule(n) == jc.ring_schedule(n)
        assert tc.schedule("ring", n) == jc.schedule("ring", n)


def test_schedule_validation_matches_reference():
    for fn, arg in ((tc.hypercube_schedule, 6), (tc.ring_schedule, 5)):
        with pytest.raises(ValueError):
            fn(arg)
    with pytest.raises(ValueError):
        tc.schedule("bogus", 4)
    for name, n in (("hypercube", 8), ("ring", 6)):
        for partners in tc.schedule(name, n):
            assert [partners[p] for p in partners] == list(range(n))


@pytest.mark.parametrize("seed,n", [(0, 4), (5, 8), (9, 6)])
def test_sim_mode_matches_reference(seed, n):
    tree_np = _stacked(seed, n)
    jt = {k: jnp.asarray(v) for k, v in tree_np.items()}
    tt = {k: torch.as_tensor(v) for k, v in tree_np.items()}
    name = "hypercube" if n & (n - 1) == 0 else "ring"
    sched = tc.schedule(name, n)
    for r, partners in enumerate(sched):
        got = tc.sim_pairwise_project(tt, partners)
        ref = jc.sim_pairwise_project(jt, partners)
        for k in tree_np:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-6)
    got, ref = tc.sim_gossip_sweep(tt, sched), jc.sim_gossip_sweep(jt, sched)
    for k in tree_np:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-6)
    np.testing.assert_allclose(float(tc.sim_consensus_sq_distance(tt)),
                               float(jc.sim_consensus_sq_distance(jt)), rtol=1e-6, atol=1e-6)


def test_sim_hypercube_sweep_equals_global_mean():
    tt = {k: torch.as_tensor(v) for k, v in _stacked(3, 8).items()}
    out = tc.sim_gossip_sweep(tt, tc.hypercube_schedule(8))
    for k, v in out.items():
        mean = tt[k].mean(0, keepdim=True).expand_as(v)
        np.testing.assert_allclose(v.numpy(), mean.numpy(), atol=1e-5)
    assert float(tc.sim_consensus_sq_distance(out)) < 1e-9


# ---------------------------------------------------------------------------
# Device mode: 4 gloo ranks against the reference's 4 forced host devices.
# ---------------------------------------------------------------------------

_REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.core import consensus
n, rounds = 4, 3
src = np.load(sys.argv[1])
stacked = {k: jnp.asarray(src[k]) for k in src.files}
mesh = compat.make_mesh((n,), ("data",))
def sm(f):
    def dev(t):
        return jax.tree.map(lambda a: a[None], f(jax.tree.map(lambda a: a[0], t)))
    return jax.jit(compat.shard_map(dev, mesh=mesh, in_specs=(P("data"),), out_specs=P("data")))
out = {}
hc = consensus.hypercube_schedule(n)
def sweep(t):
    for s in hc:
        t = consensus.pairwise_project(t, "data", s)
    return t
for k, v in sm(sweep)(stacked).items():
    out["hypercube/" + k] = v
ring = consensus.ring_schedule(n)
t = stacked
for r in range(rounds):
    t = sm(lambda p, r=r: consensus.gossip_round(p, "data", ring, jnp.int32(r)))(t)
    for k, v in t.items():
        out[f"gossip{r}/" + k] = v
for k, v in sm(lambda p: consensus.neighborhood_average(p, "data", n))(stacked).items():
    out["neighborhood/" + k] = v
for k, v in sm(lambda p: consensus.allreduce_average(p, "data"))(stacked).items():
    out["allreduce/" + k] = v
d = jax.jit(compat.shard_map(
    lambda t: consensus.consensus_sq_distance(jax.tree.map(lambda a: a[0], t), "data")[None],
    mesh=mesh, in_specs=(P("data"),), out_specs=P("data")))(stacked)
out["consensus_sq"] = d
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
print("OK")
"""


def _port_rank(ctx, stacked: dict) -> dict:
    """One rank's device-mode outputs on its replica of ``stacked``."""
    mine = {k: torch.as_tensor(v[ctx.rank]) for k, v in stacked.items()}
    out = {}
    sweep = mine
    for s in tc.hypercube_schedule(ctx.world):
        sweep = tc.pairwise_project(sweep, ctx.group, s)
    out.update({"hypercube/" + k: v for k, v in sweep.items()})
    ring = tc.ring_schedule(ctx.world)
    t = mine
    for r in range(ROUNDS):
        t = tc.gossip_round(t, ctx.group, ring, r)
        out.update({f"gossip{r}/" + k: v for k, v in t.items()})
    out.update({"neighborhood/" + k: v
                for k, v in tc.neighborhood_average(mine, ctx.group, ctx.world).items()})
    out.update({"allreduce/" + k: v for k, v in tc.allreduce_average(mine, ctx.group).items()})
    out["consensus_sq"] = tc.consensus_sq_distance(mine, ctx.group)
    # the leaves of one model in one flat buffer: a module averages in place
    mod = torch.nn.Linear(3, 2)
    with torch.no_grad():
        mod.weight.fill_(float(ctx.rank))
        mod.bias.fill_(2.0 * ctx.rank)
    same = tc.allreduce_average(mod, ctx.group)
    out["module_is_same"] = torch.tensor(same is mod)
    out["module_weight"] = mod.weight.detach().clone()
    out["module_bias"] = mod.bias.detach().clone()
    out["after_mean_sq"] = tc.consensus_sq_distance(mod, ctx.group)
    return {k: v.numpy() for k, v in out.items()}


@pytest.fixture(scope="module")
def device_runs(tmp_path_factory):
    stacked = _stacked(1, N)
    tmp = tmp_path_factory.mktemp("consensus")
    np.savez(tmp / "in.npz", **stacked)
    env = dict(os.environ, PYTHONPATH="src")
    proc = subprocess.Popen([sys.executable, "-c", _REF, str(tmp / "in.npz"),
                             str(tmp / "ref.npz")], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ranks = distributed.spawn(_port_rank, N, stacked, device="cpu")
    _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-2000:]
    ref = dict(np.load(tmp / "ref.npz"))
    port = {k: np.stack([r[k] for r in ranks]) for k in ranks[0]}
    return stacked, port, ref


@pytest.mark.parametrize("what", ["hypercube", "gossip0", "gossip1", "gossip2",
                                  "neighborhood", "allreduce"])
def test_device_mode_matches_reference_on_4_ranks(device_runs, what):
    stacked, port, ref = device_runs
    for k in stacked:
        key = f"{what}/{k}"
        assert port[key].shape == ref[key].shape == stacked[k].shape
        np.testing.assert_allclose(port[key], ref[key], atol=1e-6, err_msg=key)


def test_device_mode_stencils_and_sim(device_runs):
    """The gossip rounds equal the sim of the same pairing; the neighborhood
    average is the (x_{i-1} + x_i + x_{i+1}) / 3 stencil; the hypercube sweep
    and the all-reduce are the mean (1e-5)."""
    stacked, port, _ = device_runs
    tt = {k: torch.as_tensor(v) for k, v in stacked.items()}
    ring = tc.ring_schedule(N)
    sim = tt
    for r in range(ROUNDS):
        sim = tc.sim_pairwise_project(sim, ring[r % 2])
        for k in stacked:
            np.testing.assert_allclose(port[f"gossip{r}/{k}"], sim[k].numpy(), atol=1e-6)
    for k, w in stacked.items():
        stencil = (w + np.roll(w, 1, axis=0) + np.roll(w, -1, axis=0)) / 3.0
        np.testing.assert_allclose(port[f"neighborhood/{k}"], stencil, atol=1e-6)
        mean = np.broadcast_to(w.mean(0, keepdims=True), w.shape)
        np.testing.assert_allclose(port[f"hypercube/{k}"], mean, atol=1e-5)
        np.testing.assert_allclose(port[f"allreduce/{k}"], mean, atol=1e-6)


def test_device_consensus_sq_matches_reference_and_sim(device_runs):
    stacked, port, ref = device_runs
    d = port["consensus_sq"]
    assert (d == d[0]).all()  # the same value on every rank
    np.testing.assert_allclose(d, ref["consensus_sq"], rtol=1e-6)
    sim = float(tc.sim_consensus_sq_distance({k: torch.as_tensor(v)
                                              for k, v in stacked.items()}))
    np.testing.assert_allclose(d[0], sim, rtol=1e-6)


def test_allreduce_keeps_replicas_bitwise_equal(device_runs):
    stacked, port, _ = device_runs
    for k in stacked:
        a = port[f"allreduce/{k}"]
        assert all(np.array_equal(a[0], a[r]) for r in range(N))
    assert port["module_is_same"].all()
    assert (port["module_weight"] == 1.5).all() and (port["module_bias"] == 3.0).all()
    assert (port["after_mean_sq"] == 0).all()


@pytest.fixture(scope="module")
def world1():
    ctx = distributed.init_group(0, 1, device="cpu")
    yield ctx
    dist.destroy_process_group()


def test_world_of_one_is_a_bitwise_identity(world1):
    g = world1.group
    mine = {k: torch.as_tensor(v[0]) for k, v in _stacked(2, 1).items()}
    outs = [tc.pairwise_project(mine, g, [0]), tc.gossip_round(mine, g, [[0]], 5),
            tc.neighborhood_average(mine, g, 1), tc.allreduce_average(mine, g)]
    for out in outs:
        for k in mine:
            assert torch.equal(out[k], mine[k]), k
    assert float(tc.consensus_sq_distance(mine, g)) == 0.0
    mod = torch.nn.Linear(4, 3).to(torch.float64)
    before = [p.detach().clone() for p in mod.parameters()]
    assert tc.gossip_round(mod, g, [[0]], 0) is mod
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(mod), before))


def test_permutations_are_checked(world1):
    with pytest.raises(ValueError, match="permutation"):
        tc.pairwise_project(torch.zeros(3), world1.group, [0, 1])


def test_multi_gpu_checks_pass_on_two_cpu_ranks():
    res = multi_gpu.main(["--device", "cpu", "--world", "2", "--sensors", "40", "--fields", "2",
                          "--sweeps", "2", "--variant", "smoke", "--seq", "32", "--steps", "10"])
    assert len(res) == 2 and all(r["world"] == 2 for r in res)
    for r in res:
        assert r["fields"]["field"]["err"] <= 1e-5 and r["fields"]["field+drops"]["err"] <= 1e-5
        assert r["gossip"]["hypercube_vs_mean"] <= 1e-5
        assert r["train"]["allreduce"]["consensus_sq"] == 0.0
    assert res[0]["train"]["allreduce"]["losses"] == res[1]["train"]["allreduce"]["losses"]
