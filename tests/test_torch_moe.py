"""The MoE layer of the port against the reference's, as parity tests that
mirror tests/test_moe.py: the same numpy weights (the reference's
``moe_init``, carried across by ``convert.moe_from_numpy``) and the same
numpy inputs through both packages' ``moe_apply``, in float32.

Bounds: the output, ``aux_loss`` and ``z_loss`` 2e-5 abs + 2e-5 rel (the
reference's kernel bound, tests/test_kernels_pallas.py:30); ``expert_load``
exactly, since it counts routing decisions; gradients 1e-5 abs + 1e-4 rel
(tests/test_torch_dense_train.py's).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models.config import ModelConfig as JConfig
from repro_torch import convert
from repro_torch.models import layers as TL
from repro_torch.models.config import ModelConfig as TConfig

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)


def _cfgs(e=4, k=2, group=16, cap=2.0, shared=0, act="silu"):
    kw = dict(name="moe-test", family="moe", n_layers=2, d_model=32, n_heads=2,
              n_kv_heads=2, head_dim=16, d_ff=64, vocab_size=64, n_experts=e, top_k=k,
              moe_d_ff=48, moe_group_size=group, capacity_factor=cap,
              n_shared_experts=shared, act=act)
    return JConfig(**kw), TConfig(**kw)


# one compile per configuration and shape, where eager JAX compiles every op
_J_INIT = jax.jit(JL.moe_init, static_argnums=1)
_J_APPLY = jax.jit(JL.moe_apply, static_argnums=1)


def _params(jcfg, seed=0):
    return jax.tree.map(np.asarray, _J_INIT(jax.random.PRNGKey(seed), jcfg))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _both(jcfg, tcfg, pnp, x):
    jy, jm = _J_APPLY(jax.tree.map(jnp.asarray, pnp), jcfg, jnp.asarray(x))
    ty, tm = TL.moe_apply(convert.moe_from_numpy(pnp, device="cpu"), tcfg, torch.as_tensor(x))
    return (np.asarray(jy), {k: np.asarray(v) for k, v in jm.items()}), \
        (ty.numpy(), {k: v.numpy() for k, v in tm.items()})


def _check(jcfg, tcfg, x, seed=0, pnp=None):
    pnp = _params(jcfg, seed) if pnp is None else pnp
    (jy, jm), (ty, tm) = _both(jcfg, tcfg, pnp, x)
    assert ty.shape == x.shape and np.isfinite(ty).all()
    np.testing.assert_allclose(ty, jy, **TOL)
    for key in ("aux_loss", "z_loss"):
        assert tm[key].shape == () and tm[key].dtype == np.float32
        np.testing.assert_allclose(tm[key], jm[key], **TOL, err_msg=key)
    assert tm["expert_load"].shape == (tcfg.n_experts,)
    np.testing.assert_array_equal(tm["expert_load"], jm["expert_load"])
    return jm, tm


def test_parameters_carry_across_with_the_reference_names():
    jcfg, tcfg = _cfgs(shared=1)
    pnp = _params(jcfg)
    tp = convert.moe_from_numpy(pnp, device="cpu")
    names = {n: p for n, p in tp.named_parameters()}
    assert sorted(names) == ["router", "shared.wd.w", "shared.wg.w", "shared.wu.w", "wd",
                             "wg", "wu"]
    for name, p in names.items():
        node = pnp
        for key in name.split("."):
            node = node[key]
        np.testing.assert_array_equal(p.numpy(), node, err_msg=name)
    assert names["shared.wu.w"].shape == (32, 48)  # f x n_shared_experts
    # the port's own init draws the reference's shapes, router float32 in bf16
    for act, shared in (("silu", 1), ("gelu", 0)):
        over = dict(dtype="bfloat16", act=act, n_shared_experts=shared)
        own = TL.moe_init(torch.Generator().manual_seed(0), dataclasses.replace(tcfg, **over))
        ref = _J_INIT(jax.random.PRNGKey(0), dataclasses.replace(jcfg, **over))
        flat = dict(own.named_parameters())
        assert len(flat) == len(jax.tree.leaves(ref))
        assert flat["router"].dtype == torch.float32 and flat["wd"].dtype == torch.bfloat16
        assert ("wg" in flat) == (act == "silu") and (own.shared is None) == (shared == 0)


def test_tight_capacity_drops_tokens():
    """e = 2, k = 1, cf 0.5: cap = 5 of 16 tokens per expert, so tokens drop;
    the routed mass still counts every token, as in the reference."""
    jcfg, tcfg = _cfgs(e=2, k=1, group=16, cap=0.5)
    assert TL._capacity(tcfg, 16) == JL._capacity(jcfg, 16) == 5
    _, tm = _check(jcfg, tcfg, _x((1, 16, 32), 3))
    assert tm["expert_load"].sum() == 16.0
    assert tm["expert_load"].max() > 5  # some assignments were dropped


def test_generous_capacity_conserves_token_mass():
    jcfg, tcfg = _cfgs(cap=8.0)
    _, tm = _check(jcfg, tcfg, _x((1, 16, 32), 2))
    assert tm["expert_load"].sum() == 16 * tcfg.top_k


@pytest.mark.parametrize("group", [8, 512])
@pytest.mark.parametrize("s", [1, 7, 16, 33])
def test_padded_groups(s, group):
    """Any (B S) % group remainder: the tail group is zero-padded, and the
    padded tokens route and count, as in the reference."""
    jcfg, tcfg = _cfgs(e=4, k=2, group=group)
    _, tm = _check(jcfg, tcfg, _x((2, s, 32), s))
    n = 2 * s
    g = min(group, n)
    assert tm["expert_load"].sum() == (n + (-n) % g) * tcfg.top_k


def test_shared_expert():
    jcfg, tcfg = _cfgs(shared=1)
    pnp = _params(jcfg)
    x = _x((1, 8, 32), 4)
    _check(jcfg, tcfg, x, pnp=pnp)
    zeroed = dict(pnp, shared=jax.tree.map(np.zeros_like, pnp["shared"]))
    (_, _), (y1, _) = _both(jcfg, tcfg, pnp, x)
    (_, _), (y0, _) = _both(jcfg, tcfg, zeroed, x)
    assert float(np.abs(y1 - y0).max()) > 1e-6


def test_top1_routing():
    jcfg, tcfg = _cfgs(e=4, k=1, cap=1.25)
    _check(jcfg, tcfg, _x((2, 24, 32), 7))


@pytest.mark.parametrize("act", ["silu", "squared_relu", "gelu"])
def test_activations(act):
    jcfg, tcfg = _cfgs(act=act)
    pnp = _params(jcfg)
    assert ("wg" in pnp) == (act == "silu")
    _check(jcfg, tcfg, _x((2, 12, 32), 8), pnp=pnp)


def test_decode_single_token():
    """B = 4 tokens of one step: one group of 4, cap = max(int(4 k cf / E) + 1, k)."""
    jcfg, tcfg = _cfgs()
    assert TL._capacity(tcfg, 4) == JL._capacity(jcfg, 4) == 5
    _check(jcfg, tcfg, _x((4, 1, 32), 5))


def _topk_sort(t, dim=-1, descending=False, stable=False):
    """``torch.sort`` as a ``torch.topk`` over the whole axis would give it."""
    return torch.topk(t, t.shape[dim], dim=dim, largest=descending)


def test_ties_follow_the_reference_and_topk_would_not(monkeypatch):
    """Zero rows route on exactly uniform probabilities: the reference's
    top k are experts 0 .. k-1 (the lower expert wins a tie).  The port
    matches it; the same comparison fails when the top k come from
    ``torch.topk``."""
    jcfg, tcfg = _cfgs(e=8, k=3, group=8, cap=8.0)
    x = _x((2, 7, 32), 9)  # 14 tokens: the second group has 2 padded rows
    x[0, :3] = 0.0
    jm, tm = _check(jcfg, tcfg, x)
    assert jm["expert_load"][:3].min() >= 5  # 3 zero + 2 padded rows on experts 0-2
    monkeypatch.setattr(torch, "sort", _topk_sort)
    (_, jm2), (_, tm2) = _both(jcfg, tcfg, _params(jcfg), x)
    assert not np.array_equal(tm2["expert_load"], jm2["expert_load"])


def test_router_and_expert_gradients_match_jax_grad():
    jcfg, tcfg = _cfgs(shared=1)
    pnp = _params(jcfg)
    x = _x((1, 16, 32), 6)

    def jloss(params, xx):
        y, m = JL.moe_apply(params, jcfg, xx)
        return jnp.sum(y**2) + 0.01 * m["aux_loss"] + 1e-3 * m["z_loss"]

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jax.tree.map(jnp.asarray, pnp),
                                                       jnp.asarray(x))
    tp = convert.moe_from_numpy(pnp, device="cpu")
    leaves = dict(tp.named_parameters())
    tx = torch.as_tensor(x).requires_grad_(True)
    with torch.enable_grad():
        for p in leaves.values():
            p.requires_grad_(True)
        y, m = TL.moe_apply(tp, tcfg, tx)
        loss = torch.sum(y**2) + 0.01 * m["aux_loss"] + 1e-3 * m["z_loss"]
        grads = torch.autograd.grad(loss, list(leaves.values()) + [tx])
    for (name, _), g in zip(leaves.items(), grads):
        node = jg
        for key in name.split("."):
            node = node[key]
        np.testing.assert_allclose(g.numpy(), np.asarray(node), **GRAD_TOL, err_msg=name)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jgx), **GRAD_TOL)
    assert float(np.abs(np.asarray(jg["router"])).max()) > 0.0
