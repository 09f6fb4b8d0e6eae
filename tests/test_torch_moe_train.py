"""The training half of the MoE slice: ``loss_fn`` with the router terms
(ce + aux_weight aux_loss + z_weight z_loss), every gradient, and the train
step on the two MoE configs' smoke variants against the reference's, with
the reference's parameters carried across by
``convert.lm_params_from_numpy``, in float32, at the configs' own capacity
(1.25: the batch's groups drop tokens, as training does).

Bounds (tests/test_torch_dense_train.py's): the loss and its terms 1e-6
relative; every gradient leaf 1e-5 absolute + 1e-4 relative against
``jax.value_and_grad``, matched by name; the parameters after three SGD
steps 1e-6.
"""

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
from repro_torch import convert, tree
from repro_torch import models as tm
from repro_torch.configs import get_config
from repro_torch.optim import constant, sgd

torch.set_num_threads(1)

SEQ, BATCH, LR = 32, 4, 1e-2
MOE = ["qwen3-moe-30b-a3b", "llama4-scout-17b-a16e"]


def _cfgs(arch):
    return j_get_config(arch, variant="smoke"), get_config(arch, variant="smoke")


def _params_np(arch):
    jcfg = _cfgs(arch)[0]
    return jax.tree.map(np.asarray, jm.init_params(jcfg, jax.random.PRNGKey(0)))


def _batch(cfg, i):
    return synthetic_lm_stream(cfg.vocab_size, SEQ, BATCH, seed=0).batch_at(i)


def _ref_leaf(jtree, name: str) -> np.ndarray:
    """The reference's array for the port's parameter ``name`` (layer i of a
    stacked ``blocks.layer0`` leaf, or a top-level one)."""
    node, rest = jtree, name
    if name.startswith("layers."):
        _, i, rest = name.split(".", 2)
        node = jtree["blocks"]["layer0"]
    for key in rest.split("."):
        node = node[key]
    return np.asarray(node if rest == name else node[int(i)])


@pytest.mark.parametrize("arch", MOE)
def test_loss_with_router_terms_and_every_gradient_match_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    pnp = _params_np(arch)
    b = _batch(tcfg, 0)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (jl, jmet), jg = jax.jit(jax.value_and_grad(lambda p: jm.loss_fn(jcfg, p, jb),
                                                has_aux=True))(jax.tree.map(jnp.asarray, pnp))
    tp = convert.lm_params_from_numpy(pnp, tcfg, device="cpu")
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    leaves = tree.leaves(tp)
    with torch.enable_grad():
        for p in leaves:
            p.requires_grad_(True)
        tl, tmet = tm.loss_fn(tcfg, tp, tb)
        grads = torch.autograd.grad(tl, leaves)
    tmet = {k: v.detach() for k, v in tmet.items()}
    assert sorted(tmet) == sorted(jmet) == ["aux_loss", "ce", "loss", "z_loss"]
    for key in tmet:
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), rtol=1e-6, err_msg=key)
    want = (float(tmet["ce"]) + tcfg.router_aux_weight * float(tmet["aux_loss"])
            + tcfg.router_z_weight * float(tmet["z_loss"]))
    np.testing.assert_allclose(float(tl.detach()), want, rtol=1e-6)
    assert float(tmet["aux_loss"]) > 0 and float(tmet["z_loss"]) > 0
    names = [n for n, _ in tp.named_parameters()]
    # the reference stacks the layers on a leading axis
    per_layer = len(jax.tree.leaves(jg["blocks"]))
    assert len(names) == len(jax.tree.leaves(jg)) - per_layer + per_layer * tcfg.n_layers
    for name, g in zip(names, grads):
        ref = _ref_leaf(jg, name)
        assert g.shape == ref.shape, name
        np.testing.assert_allclose(g.numpy(), ref, atol=1e-5, rtol=1e-4, err_msg=name)
    for i in range(tcfg.n_layers):  # the router learns from the loss's every term
        assert float(np.abs(_ref_leaf(jg, f"layers.{i}.moe.router")).max()) > 0


def test_three_sgd_steps_match_reference():
    arch = "qwen3-moe-30b-a3b"
    jcfg, tcfg = _cfgs(arch)
    pnp = _params_np(arch)
    jopt, topt = j_sgd(j_constant(LR)), sgd(constant(LR))
    jstep = jax.jit(jm.make_train_step(jcfg, jopt, dp_mode="none"))
    tstep = tm.make_train_step(tcfg, topt, dp_mode="none")
    jp = jax.tree.map(jnp.asarray, pnp)
    tp = convert.lm_params_from_numpy(pnp, tcfg, device="cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(3):
        b = _batch(tcfg, i)
        jp, js, jmet = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tmet = tstep(tp, ts, {k: torch.as_tensor(v) for k, v in b.items()})
        for key in ("loss", "ce", "aux_loss", "z_loss"):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), rtol=1e-6,
                                       err_msg=f"step {i} {key}")
    for name, p in tp.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), _ref_leaf(jp, name), atol=1e-6,
                                   err_msg=name)
    assert not any(p.requires_grad for p in tp.parameters())
