"""The training half of the port's model API (``loss_fn``,
``make_train_step``) on ``mamba2-370m --variant smoke`` against the
reference's, with the reference's parameters carried across by
``convert.lm_params_from_numpy``.

Bounds: the loss 1e-6 relative; every gradient leaf 1e-5 absolute + 1e-4
relative against ``jax.grad`` (both float32; the chunked SSD scan sums in
other orders); parameters after three SGD steps 1e-6.  On 2 gloo ranks
(one spawn): ``allreduce`` keeps the replicas bitwise equal, and
``sop_gossip`` matches the reference's 2-device ``shard_map`` train step
after 2 steps at 1e-6 (a subprocess with forced host devices).  The fused
SSD path has no backward and raises under gradients.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as jm
from repro.configs import get_config as j_get_config
from repro.data import synthetic_lm_stream
from repro.optim import constant as j_constant
from repro.optim import sgd as j_sgd
from repro_torch import convert, distributed
from repro_torch import models as tm
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.core import consensus
from repro_torch.kernels import ssd_intra
from repro_torch.optim import constant, sgd

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH, SEQ, BATCH, LR = "mamba2-370m", 32, 4, 1e-2


def _cfgs():
    return j_get_config(ARCH, variant="smoke"), get_config(ARCH, variant="smoke")


def _params_np():
    jcfg, _ = _cfgs()
    return jax.tree.map(np.asarray, jm.init_params(jcfg, jax.random.PRNGKey(0)))


def _batch(i, rows=slice(None)):
    _, tcfg = _cfgs()
    b = synthetic_lm_stream(tcfg.vocab_size, SEQ, BATCH, seed=0).batch_at(i)
    return {k: v[rows] for k, v in b.items()}


def _ref_leaf(jtree, name: str) -> np.ndarray:
    """The reference's array for the port's parameter ``name``."""
    if name == "embed":
        return np.asarray(jtree["embed"])
    if name == "final_norm.scale":
        return np.asarray(jtree["final_norm"]["scale"])
    _, i, rest = name.split(".", 2)
    blk = jtree["blocks"]["layer0"]
    if rest == "norm1.scale":
        return np.asarray(blk["norm1"]["scale"][int(i)])
    key = rest[len("ssm."):]
    v = np.asarray((blk["ssm"][key]["w"] if key in ("in_proj", "out_proj")
                    else blk["ssm"][key])[int(i)])
    return v.T[:, None, :] if key == "conv_w" else v


def _port_params(pnp):
    return convert.lm_params_from_numpy(pnp, _cfgs()[1], device="cpu")


def test_loss_and_every_gradient_match_reference():
    jcfg, tcfg = _cfgs()
    pnp = _params_np()
    b = _batch(0)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (jl, jmet), jg = jax.value_and_grad(lambda p: jm.loss_fn(jcfg, p, jb), has_aux=True)(
        jax.tree.map(jnp.asarray, pnp))
    tp = _port_params(pnp)
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    tl, tmet = tm.loss_fn(tcfg, tp, tb)
    assert sorted(tmet) == sorted(jmet) == ["ce", "loss"]
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    step = tm.make_train_step(tcfg, sgd(constant(0.0), momentum=0.0), dp_mode="none")
    leaves = tree.leaves(tp)
    with torch.enable_grad():
        for p in leaves:
            p.requires_grad_(True)
        grads = torch.autograd.grad(tm.loss_fn(tcfg, tp, tb)[0], leaves)
    names = [n for n, _ in tp.named_parameters()]
    # the reference stacks the layers on a leading axis: 2 + 9 leaves
    assert len(names) == 2 + 9 * tcfg.n_layers and len(jax.tree.leaves(jg)) == 11
    for name, g in zip(names, grads):
        ref = _ref_leaf(jg, name)
        assert g.shape == ref.shape, name
        np.testing.assert_allclose(g.numpy(), ref, atol=1e-5, rtol=1e-4, err_msg=name)
    # a train step with lr 0 leaves the parameters and turns gradients off again
    for p in leaves:
        p.requires_grad_(False)
    before = [p.clone() for p in leaves]
    _, _, m = step(tp, sgd(constant(0.0)).init(tp), tb)
    np.testing.assert_allclose(float(m["loss"]), float(jl), rtol=1e-6)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(tp), before))
    assert not any(p.requires_grad for p in tp.parameters())


def test_three_sgd_steps_match_reference():
    jcfg, tcfg = _cfgs()
    pnp = _params_np()
    jopt, topt = j_sgd(j_constant(LR)), sgd(constant(LR))
    jstep = jax.jit(jm.make_train_step(jcfg, jopt, dp_mode="none"))
    tstep = tm.make_train_step(tcfg, topt, dp_mode="none")
    jp = jax.tree.map(jnp.asarray, pnp)
    tp = _port_params(pnp)
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(3):
        b = _batch(i)
        jp, js, jmet = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tmet = tstep(tp, ts, {k: torch.as_tensor(v) for k, v in b.items()})
        np.testing.assert_allclose(float(tmet["ce"]), float(jmet["ce"]), rtol=1e-6)
    for name, p in tp.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), _ref_leaf(jp, name), atol=1e-6,
                                   err_msg=name)


_REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.configs import get_config
from repro.core import consensus
from repro.data import synthetic_lm_stream
from repro.models import init_params, make_train_step
from repro.optim import sgd, constant
cfg = get_config("mamba2-370m", variant="smoke")
opt = sgd(constant(1e-2))
n = 2
step = make_train_step(cfg, opt, dp_axis="data", dp_mode="sop_gossip",
                       gossip_schedule=consensus.hypercube_schedule(n))
mesh = compat.make_mesh((n,), ("data",))
params = init_params(cfg, jax.random.PRNGKey(0))
opt_state = opt.init(params)
stack = lambda a: jnp.broadcast_to(a[None], (n,) + a.shape)
params = jax.tree.map(stack, params); opt_state = jax.tree.map(stack, opt_state)
def dev(p, o, b, r):
    p1 = jax.tree.map(lambda a: a[0], p); o1 = jax.tree.map(lambda a: a[0], o)
    p1, o1, m = step(p1, o1, b, r[0])
    return jax.tree.map(lambda a: a[None], p1), jax.tree.map(lambda a: a[None], o1), m["consensus_sq"][None]
j = jax.jit(compat.shard_map(dev, mesh=mesh, in_specs=(P("data"),) * 4,
            out_specs=(P("data"), P("data"), P("data"))))
stream = synthetic_lm_stream(cfg.vocab_size, 32, 4, seed=0)
for i in range(2):
    b = {k: jnp.asarray(v) for k, v in stream.batch_at(i).items()}
    params, opt_state, csq = j(params, opt_state, b, jnp.full((n,), i, jnp.int32))
flat = {}
def walk(t, pre):
    for k, v in t.items():
        if isinstance(v, dict):
            walk(v, pre + k + ".")
        else:
            flat[pre + k] = np.asarray(v)
walk(params, "")
flat["consensus_sq"] = np.asarray(csq)
np.savez(sys.argv[1], **flat)
print("OK")
"""


def _rank_train(ctx, pnp, dp_mode, steps):
    """``steps`` SGD steps of the 2-rank data-parallel train step; rank r
    takes rows [r B/W, (r+1) B/W) of global batch i."""
    _, tcfg = _cfgs()
    opt = sgd(constant(LR))
    step = tm.make_train_step(tcfg, opt, group=ctx.group, dp_mode=dp_mode,
                              gossip_schedule=consensus.hypercube_schedule(ctx.world))
    params = _port_params(pnp)
    state = opt.init(params)
    rows = BATCH // ctx.world
    metrics = {}
    for i in range(steps):
        b = _batch(i, slice(ctx.rank * rows, (ctx.rank + 1) * rows))
        params, state, metrics = step(params, state, {k: torch.as_tensor(v)
                                                      for k, v in b.items()}, i)
    return {"params": {n: p.detach().numpy() for n, p in params.named_parameters()},
            "metrics": {k: float(v) for k, v in metrics.items()}}


def _rank_both(ctx, pnp):
    return {"allreduce": _rank_train(ctx, pnp, "allreduce", 3),
            "sop_gossip": _rank_train(ctx, pnp, "sop_gossip", 2)}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("lm_train") / "ref.npz"
    env = dict(os.environ, PYTHONPATH="src")
    proc = subprocess.Popen([sys.executable, "-c", _REF, str(out)], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ranks = distributed.spawn(_rank_both, 2, _params_np(), device="cpu")
    _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-2000:]
    with np.load(out) as f:
        flat = dict(f)
    return ranks, flat


def test_allreduce_keeps_two_replicas_bitwise_equal(two_ranks):
    ranks, _ = two_ranks
    a, b = (r["allreduce"] for r in ranks)
    assert a["metrics"] == b["metrics"] and sorted(a["metrics"]) == ["ce", "loss"]
    for name in a["params"]:
        assert np.array_equal(a["params"][name], b["params"][name]), name
    moved = _port_params(_params_np())
    assert not np.array_equal(a["params"]["embed"], moved.embed.detach().numpy())


def test_sop_gossip_matches_reference_two_device_step(two_ranks):
    ranks, flat = two_ranks
    ref = {"embed": flat["embed"], "final_norm": {"scale": flat["final_norm.scale"]},
           "blocks": {"layer0": {"norm1": {"scale": flat["blocks.layer0.norm1.scale"]},
                                 "ssm": {}}}}
    for key, v in flat.items():
        if key.startswith("blocks.layer0.ssm."):
            parts = key[len("blocks.layer0.ssm."):].split(".")
            ssm = ref["blocks"]["layer0"]["ssm"]
            if len(parts) == 2:
                ssm.setdefault(parts[0], {})[parts[1]] = v
            else:
                ssm[parts[0]] = v
    for r, rank in enumerate(ranks):
        res = rank["sop_gossip"]
        assert res["metrics"]["consensus_sq"] == float(flat["consensus_sq"][r]) == 0.0
        for name, p in res["params"].items():
            replica = jax.tree.map(lambda a: a[r], ref)
            np.testing.assert_allclose(p, _ref_leaf(replica, name), atol=1e-6,
                                       err_msg=f"rank {r} {name}")


def test_fused_ssd_path_raises_under_gradients():
    _, tcfg = _cfgs()
    fused = dataclasses.replace(tcfg, ssd_fused=True)
    tp = _port_params(_params_np())
    b = {k: torch.as_tensor(v) for k, v in _batch(0).items()}
    step = tm.make_train_step(fused, sgd(constant(LR)), dp_mode="none")
    with pytest.raises(RuntimeError, match="ssd_intra has no backward"):
        step(tp, sgd(constant(LR)).init(tp), b)
    # serving (no gradients) still takes the fused path, and it equals the plain one
    with torch.inference_mode():
        lf, _ = tm.loss_fn(fused, tp, b)
        lp, _ = tm.loss_fn(tcfg, tp, b)
    np.testing.assert_allclose(float(lf), float(lp), rtol=1e-5)
    x = torch.zeros((1, 8, 2, 4), requires_grad=True)
    rest = (torch.zeros(1, 8, 2), torch.zeros(1, 8, 2), torch.zeros(1, 8, 3),
            torch.zeros(1, 8, 3))
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_intra.ssd_intra(x, *rest, chunk=4)
    with torch.no_grad():
        assert ssd_intra.ssd_intra(x, *rest, chunk=4).shape == (1, 8, 2, 4)
