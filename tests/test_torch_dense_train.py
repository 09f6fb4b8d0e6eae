"""The training half of the dense slice: ``loss_fn``, its gradients and the
train step on the dense configs' smoke variants against the reference's,
with the reference's parameters carried across by
``convert.lm_params_from_numpy``, in float32.

Bounds (tests/test_torch_lm_train.py's): the loss 1e-6 relative; every
gradient leaf 1e-5 absolute + 1e-4 relative against ``jax.value_and_grad``,
matched by name; the parameters after three SGD steps 1e-6.  Three configs
cover the dense family's variants: ``smollm-135m`` (tied head, SwiGLU,
rep 2), ``nemotron-4-15b`` (squared ReLU, untied) and ``qwen1.5-32b``
(q/k/v biases, untied).  Then the training launcher on the CPU.
"""

import re

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
from repro_torch.launch import train
from repro_torch.optim import constant, sgd

torch.set_num_threads(1)

SEQ, BATCH, LR = 32, 4, 1e-2


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


@pytest.mark.parametrize("arch", ["smollm-135m", "nemotron-4-15b", "qwen1.5-32b"])
def test_loss_and_every_gradient_match_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    pnp = _params_np(arch)
    if tcfg.qkv_bias:  # the zero-initialised biases, made to count
        rng = np.random.default_rng(1)
        for name in ("wq", "wk", "wv"):
            b = pnp["blocks"]["layer0"]["attn"][name]["b"]
            pnp["blocks"]["layer0"]["attn"][name]["b"] = (
                0.1 * rng.standard_normal(b.shape)).astype(np.float32)
    b = _batch(tcfg, 0)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (jl, jmet), jg = jax.value_and_grad(lambda p: jm.loss_fn(jcfg, p, jb), has_aux=True)(
        jax.tree.map(jnp.asarray, pnp))
    tp = convert.lm_params_from_numpy(pnp, tcfg, device="cpu")
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    leaves = tree.leaves(tp)
    with torch.enable_grad():
        for p in leaves:
            p.requires_grad_(True)
        tl, tmet = tm.loss_fn(tcfg, tp, tb)
        grads = torch.autograd.grad(tl, leaves)
    assert sorted(tmet) == sorted(jmet) == ["ce", "loss"]
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    names = [n for n, _ in tp.named_parameters()]
    # the reference stacks the layers on a leading axis
    per_layer = len(jax.tree.leaves(jg["blocks"]))
    assert len(names) == len(jax.tree.leaves(jg)) - per_layer + per_layer * tcfg.n_layers
    for name, g in zip(names, grads):
        ref = _ref_leaf(jg, name)
        assert g.shape == ref.shape, name
        np.testing.assert_allclose(g.numpy(), ref, atol=1e-5, rtol=1e-4, err_msg=name)
    assert float(np.abs(_ref_leaf(jg, "layers.1.mlp.wd.w")).max()) > 0


def test_three_sgd_steps_match_reference():
    jcfg, tcfg = _cfgs("smollm-135m")
    pnp = _params_np("smollm-135m")
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
        np.testing.assert_allclose(float(tmet["ce"]), float(jmet["ce"]), rtol=1e-6)
    for name, p in tp.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), _ref_leaf(jp, name), atol=1e-6,
                                   err_msg=name)
    assert not any(p.requires_grad for p in tp.parameters())


def test_train_launcher_on_cpu(capfd):
    """``python -m repro_torch.launch.train --arch smollm-135m --variant
    smoke`` at a world of one (gloo): 8 logged steps whose loss falls, then
    ``done``."""
    capfd.readouterr()
    out = train.main(["--arch", "smollm-135m", "--variant", "smoke", "--steps", "8",
                      "--batch", "4", "--seq", "32", "--lr", "3e-3", "--log_every", "1",
                      "--device", "cpu", "--world", "1"])
    lines = capfd.readouterr().out.strip().splitlines()
    assert lines[0] == "arch=smollm-135m-smoke params=0.4M devices=1 dp=allreduce"
    assert lines[-1] == "done"
    losses = [float(re.search(r"loss=(\S+)", ln).group(1)) for ln in lines
              if ln.startswith("step")]
    assert len(losses) == 8 and all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.1, losses
    assert out["loss"] == pytest.approx(losses[-1], abs=1e-4)

