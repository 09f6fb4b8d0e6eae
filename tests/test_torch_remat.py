"""``cfg.remat`` in the port's forward (``models.transformer.decoder_forward``):
each super-block of ``cfg.block_len`` layers under a non-reentrant
``checkpoint``, ``remat_policy`` "full" or "dots" (the reference's
``jax.checkpoint`` and ``dots_saveable``).

(a) At the smoke variants, in float32: ``loss_fn``'s loss, its metrics and
every gradient leaf with remat are those without it, bitwise, for
qwen1.5-32b (block_len 1), jamba-1.5-large-398b (block_len 8, Mamba2 and
MoE layers), qwen3-moe-30b-a3b and qwen2-vl-2b behind its patch prefix
(remat set by ``dataclasses.replace``).  (b) The aten ops that the backward
runs, counted by a ``TorchDispatchMode``: under "full" it re-runs the
blocks' products and their elementwise ops, under "dots" the elementwise
ops and none of the forward's products, without remat neither.  (c) Under
"dots", qwen1.5-32b's loss and every gradient against the reference's
``jax.checkpoint``ed ``loss_fn`` (the bounds of test_torch_dense_train.py:
the loss 1e-6 relative, every gradient 1e-5 absolute + 1e-4 relative);
"full" is held there already, the smoke configs setting ``remat``.  (d) An
unknown policy raises.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.models as jm
from repro.configs import get_config as j_get_config
from repro.data import synthetic_lm_stream
from repro_torch import convert, tree
from repro_torch import models as tm
from repro_torch.configs import get_config
from repro_torch.models import transformer

torch.set_num_threads(1)

BATCH, SEQ = 2, 16
ARCHS = ["qwen1.5-32b", "jamba-1.5-large-398b", "qwen3-moe-30b-a3b", "qwen2-vl-2b"]
POLICIES = ["full", "dots"]


def _cfg(arch, remat, policy="full"):
    return dataclasses.replace(get_config(arch, variant="smoke"), remat=remat,
                               remat_policy=policy)


def _batch(cfg):
    rng = np.random.default_rng(3)
    b = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (BATCH, SEQ))),
         "labels": torch.as_tensor(rng.integers(0, cfg.vocab_size, (BATCH, SEQ))),
         "mask": torch.as_tensor((rng.uniform(size=(BATCH, SEQ)) > 0.2).astype(np.float32))}
    if cfg.n_patches:
        b["patch_embeds"] = torch.as_tensor(
            rng.normal(size=(BATCH, cfg.n_patches, cfg.d_model)), dtype=torch.float32)
    return b


def _loss_and_grads(cfg, batch, during_backward=None):
    """(loss, metrics, gradients) of ``loss_fn`` at ``init_params(cfg, 0)``;
    the backward runs inside ``during_backward`` where one is given."""
    params = tm.init_params(cfg, 0, device="cpu")
    leaves = tree.leaves(params)
    with torch.enable_grad():
        for p in leaves:
            p.requires_grad_(True)
        loss, metrics = tm.loss_fn(cfg, params, batch)
        if during_backward is None:
            grads = torch.autograd.grad(loss, leaves)
        else:
            with during_backward:
                grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bitwise_the_plain_forward(arch, policy):
    cfg = _cfg(arch, True, policy)
    assert cfg.n_layers >= 2 * cfg.block_len  # two checkpointed blocks at least
    batch = _batch(cfg)
    loss, metrics, grads = _loss_and_grads(cfg, batch)
    loss0, metrics0, grads0 = _loss_and_grads(_cfg(arch, False), batch)
    assert torch.equal(loss, loss0)
    assert sorted(metrics) == sorted(metrics0)
    for key in metrics:
        assert torch.equal(metrics[key], metrics0[key]), key
    assert len(grads) == len(grads0)
    for i, (g, g0) in enumerate(zip(grads, grads0)):
        assert torch.equal(g, g0), i
    assert any(float(g.abs().max()) > 0 for g in grads)


class _OpCount(TorchDispatchMode):
    """Counts every aten op that runs, by its packet's name."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


def _products(counts) -> int:
    return sum(counts[op.__name__] for op in transformer.DOTS)


def test_backward_op_counts_show_the_recompute():
    arch = "qwen1.5-32b"
    batch = _batch(_cfg(arch, False))
    forward = _OpCount()
    params = tm.init_params(_cfg(arch, False), 0, device="cpu")
    with torch.no_grad(), forward:
        tm.loss_fn(_cfg(arch, False), params, batch)
    fwd = forward.counts
    head = 1  # the untied head's product, outside the blocks
    assert fwd["silu"] == _cfg(arch, False).n_layers and _products(fwd) > head
    runs = {}
    for name, cfg in (("off", _cfg(arch, False)), ("full", _cfg(arch, True, "full")),
                      ("dots", _cfg(arch, True, "dots"))):
        mode = _OpCount()
        _loss_and_grads(cfg, batch, during_backward=mode)
        runs[name] = mode.counts
    off, full, dots = runs["off"], runs["full"], runs["dots"]
    # without remat the backward runs no forward op: silu only as its
    # derivative, the softmax only through its backward
    assert off["silu"] == 0 and off["_softmax"] == 0 and off["silu_backward"] > 0
    # "full": every block's forward again, its products included but the
    # last (the down projection, whose output no backward reads: the
    # recompute stops once it has every tensor the backward saved)
    blocks = _cfg(arch, True).n_blocks
    assert full["silu"] == fwd["silu"] and full["_softmax"] == fwd["_softmax"]
    assert _products(full) == _products(off) + _products(fwd) - head - blocks
    # "dots": the elementwise ops again, the products taken from the forward
    assert dots["silu"] == fwd["silu"] and dots["_softmax"] == fwd["_softmax"]
    assert _products(dots) == _products(off)


def test_dots_matches_the_reference_checkpoint():
    arch = "qwen1.5-32b"
    jcfg = dataclasses.replace(j_get_config(arch, variant="smoke"), remat=True,
                               remat_policy="dots")
    tcfg = _cfg(arch, True, "dots")
    pnp = jax.tree.map(np.asarray, jm.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    for name in ("wq", "wk", "wv"):  # the zero-initialised biases, made to count
        b = pnp["blocks"]["layer0"]["attn"][name]["b"]
        pnp["blocks"]["layer0"]["attn"][name]["b"] = (
            0.1 * rng.standard_normal(b.shape)).astype(np.float32)
    b = synthetic_lm_stream(tcfg.vocab_size, 32, 4, seed=0).batch_at(0)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (jl, _), jg = jax.value_and_grad(lambda p: jm.loss_fn(jcfg, p, jb), has_aux=True)(
        jax.tree.map(jnp.asarray, pnp))
    tp = convert.lm_params_from_numpy(pnp, tcfg, device="cpu")
    leaves = tree.leaves(tp)
    with torch.enable_grad():
        for p in leaves:
            p.requires_grad_(True)
        tl, _ = tm.loss_fn(tcfg, tp, {k: torch.as_tensor(v) for k, v in b.items()})
        grads = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    names = [n for n, _ in tp.named_parameters()]
    for name, g in zip(names, grads):
        node, rest = jg, name
        if name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            node = jg["blocks"]["layer0"]
        for key in rest.split("."):
            node = node[key]
        ref = np.asarray(node if rest == name else node[int(i)])
        assert g.shape == ref.shape, name
        np.testing.assert_allclose(g.numpy(), ref, atol=1e-5, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("grad", [True, False])
def test_unknown_policy_raises(grad):
    cfg = _cfg("qwen1.5-32b", True, "everything")
    params = tm.init_params(cfg, 0, device="cpu")
    with torch.set_grad_enabled(grad), pytest.raises(ValueError, match="remat_policy"):
        for p in tree.leaves(params):
            p.requires_grad_(grad)
        tm.loss_fn(cfg, params, _batch(cfg))
