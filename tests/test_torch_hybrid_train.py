"""The training half of the hybrid slice: jamba-1.5-large-398b's
``loss_fn`` (ce plus the router terms of all 8 MoE layers, 6 of them after a
Mamba2 mixer), every gradient and three SGD steps against the reference's at
its smoke variant (16 layers), in float32, with the reference's
block-stacked parameters carried across by ``convert.lm_params_from_numpy``
(tests/test_torch_hybrid_lm.py holds the forward, prefill and decode).

Bounds (tests/test_torch_dense_train.py's): the loss 1e-6 relative, every
gradient 1e-5 abs + 1e-4 rel, the parameters after three SGD steps 1e-6.

Sixteen layers in float32 amplify rounding in the backward pass: the
gradients of the embedding and of the first layers differ from the
float64 gradient by ~2e-4 in the reference as in the port (~4e-5 at 8
layers), beyond the gradient bound whichever float32 side is held to the
other.  A gradient or parameter leaf beyond its bound is therefore held
to a float64 witness taken from the reference, not from the port: the
reference's own value_and_grad (and SGD steps) at dtype float64 under
``jax.enable_x64``, on the same weights (the leaves its init keeps in
float32, the router and the SSM's A_log, D and dt_bias, stay so).  The
port's error against it may be at most WITNESS_FACTOR times the
reference's float32 error against it, chip_smoke.py's LM_WITNESS_FACTOR
rule; a fault of the port's shows as an error the size of the fault
against a witness it cannot share.  The leaves so held are named in the
assertion messages and counted, and a planted fault (one gradient zeroed,
or off by 1e-3) is shown to fail the rule.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as jm
from repro.configs import get_config as j_get_config
from repro.data import synthetic_lm_stream
from repro.optim import apply_updates as j_apply_updates
from repro.optim import constant as j_constant
from repro.optim import sgd as j_sgd
from repro_torch import models as tm
from repro_torch import tree
from repro_torch.optim import constant, sgd
from test_torch_hybrid_lm import ARCH, _np, _pair, ref_leaf

torch.set_num_threads(1)

SEQ, BATCH, LR = 16, 2, 1e-2
WITNESS_FACTOR = 4.0


def _batch(cfg, i):
    return synthetic_lm_stream(cfg.vocab_size, SEQ, BATCH, seed=0).batch_at(i)


def _witness_params(pnp):
    """The same weights in the reference's float64 layout: each leaf in the
    dtype the reference's own float64 init gives it (under x64)."""
    jcfg = dataclasses.replace(j_get_config(ARCH, variant="smoke"), dtype="float64")
    like = jax.eval_shape(lambda: jm.init_params(jcfg, jax.random.PRNGKey(0)))
    return jax.tree.map(lambda a, s: jnp.asarray(a, s.dtype), pnp, like)


def _ref_sgd(cfg, params, dtype: str):
    """Three of the reference's SGD steps (its value_and_grad of ``loss_fn``,
    ``sgd.update`` and ``apply_updates``: ``make_train_step`` with
    dp_mode="none") from ``params`` at ``dtype``: the first step's
    gradients, each step's metrics, and the parameters after, as numpy."""
    jcfg = dataclasses.replace(j_get_config(ARCH, variant="smoke"),
                               capacity_factor=cfg.capacity_factor, dtype=dtype)
    value_and_grad = jax.jit(jax.value_and_grad(lambda p, b: jm.loss_fn(jcfg, p, b),
                                                has_aux=True))
    opt = j_sgd(j_constant(LR))

    @jax.jit
    def update(g, s, p):
        updates, s = opt.update(g, s, p)
        return j_apply_updates(p, updates), s

    state, grads0, metrics = opt.init(params), None, []
    for i in range(3):
        (_, met), g = value_and_grad(params, {k: jnp.asarray(v)
                                              for k, v in _batch(cfg, i).items()})
        grads0 = g if grads0 is None else grads0
        params, state = update(g, state, params)
        metrics.append(jax.tree.map(np.asarray, met))
    return jax.tree.map(np.asarray, grads0), metrics, jax.tree.map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def _reference_runs():
    """``_ref_sgd`` at capacity 8.0 on the smoke weights, in float32 (the
    reference) and then in float64 under ``jax.enable_x64`` (the witness).
    The float32 run comes first: leaving x64 drops its compiled program."""
    _, tcfg, pnp, _ = _pair(capacity_factor=8.0)
    ref = _ref_sgd(tcfg, jax.tree.map(jnp.asarray, pnp), "float32")
    with jax.enable_x64(True):
        wit = _ref_sgd(tcfg, _witness_params(pnp), "float64")
    return ref, wit


def _grads(cfg, params, b):
    leaves = tree.leaves(params)
    with torch.enable_grad():
        for p in leaves:
            p.requires_grad_(True)
        loss, metrics = tm.loss_fn(cfg, params, {k: torch.as_tensor(v) for k, v in b.items()})
        grads = torch.autograd.grad(loss, leaves)
        for p in leaves:
            p.requires_grad_(False)
    return {k: v.detach() for k, v in metrics.items()}, grads


def hold(name: str, got, ref, wit, atol: float, rtol: float) -> bool:
    """``got`` (the port) within ``atol + rtol |ref|`` of the reference's
    ``ref``; where not, the port's max error against the reference's float64
    witness ``wit`` at most WITNESS_FACTOR times ``ref``'s.  True where the
    witness decided."""
    got, ref, wit = (np.asarray(_np(a), np.float64) for a in (got, ref, wit))
    assert got.shape == ref.shape == wit.shape, name
    if float((np.abs(got - ref) - rtol * np.abs(ref)).max()) <= atol:
        return False
    e_port, e_ref = float(np.abs(got - wit).max()), float(np.abs(ref - wit).max())
    assert e_port <= WITNESS_FACTOR * e_ref, (
        f"{name}: beyond {atol} + {rtol} |ref| of the reference, and its error against the "
        f"float64 witness {e_port:.3g} exceeds {WITNESS_FACTOR} x the reference's {e_ref:.3g}")
    return True


@functools.lru_cache(maxsize=None)
def _gradient_case():
    """At capacity 8.0 on batch 0: the port's loss metrics and gradients,
    the reference's, and the reference's float64 gradients (the witness)."""
    _, tcfg, _, tp = _pair(capacity_factor=8.0)
    (jg, jmets, _), (wg, _, _) = _reference_runs()
    tmet, grads = _grads(tcfg, tp, _batch(tcfg, 0))
    names = [n for n, _ in tp.named_parameters()]
    return tcfg, names, tmet, grads, jmets[0], jg, wg


def test_loss_and_every_gradient_match_reference():
    """At capacity 8.0, as the SGD steps below (the reference's first step;
    the config's own capacity is held in the forward test above and, with
    its drops, in tests/test_torch_moe_train.py)."""
    tcfg, names, tmet, grads, jmet, jg, wg = _gradient_case()
    assert sorted(tmet) == sorted(jmet) == ["aux_loss", "ce", "loss", "z_loss"]
    for key in tmet:
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), rtol=1e-6, err_msg=key)
    assert len(names) == len(grads)
    by_witness = [name for name, g in zip(names, grads)
                  if hold(name, g, ref_leaf(jg, tcfg, name), ref_leaf(wg, tcfg, name), 1e-5, 1e-4)]
    # the amplified leaves are the embedding's and the first layers'
    assert "lm_head" not in by_witness and len(by_witness) < len(names) // 4, by_witness
    for i in range(tcfg.n_layers):  # every router learns, after a mixer too
        if tcfg.layer_is_moe(i):
            assert float(np.abs(ref_leaf(jg, tcfg, f"layers.{i}.moe.router")).max()) > 0


@pytest.mark.parametrize("fault", ["zeroed", "off_by_1e-3"])
def test_witness_rule_refuses_a_planted_gradient_fault(fault):
    """The embedding's gradient, which the witness decides, zeroed (a leaf
    detached) or scaled by 1 + 1e-3: a fault the port's float32 and float64
    code would share, so only a witness taken from the reference refuses
    it."""
    tcfg, names, _, grads, _, jg, wg = _gradient_case()
    g = grads[names.index("embed")]
    ref, wit = ref_leaf(jg, tcfg, "embed"), ref_leaf(wg, tcfg, "embed")
    assert hold("embed", g, ref, wit, 1e-5, 1e-4)  # the honest leaf: decided by the witness
    bad = torch.zeros_like(g) if fault == "zeroed" else g * (1 + 1e-3)
    with pytest.raises(AssertionError, match="float64 witness"):
        hold("embed", bad, ref, wit, 1e-5, 1e-4)


def test_three_sgd_steps_match_reference():
    """The reference's three SGD steps (``_ref_sgd``) against the port's
    ``make_train_step``, and the same three steps of the reference in
    float64 as the witness for leaves beyond 1e-6.  At capacity 8.0: with
    capacity drops the trajectory is discontinuous in the weights, and two
    float32 trajectories that differ by rounding can drop different tokens
    a step later (the config's own capacity and its drops are held in the
    forward test above)."""
    _, tcfg, _, tp = _pair(capacity_factor=8.0)
    (_, jmets, jp), (_, wmets, wp) = _reference_runs()
    topt = sgd(constant(LR))
    tstep, ts = tm.make_train_step(tcfg, topt, dp_mode="none"), topt.init(tp)
    for i in range(3):
        tp, ts, tmet = tstep(tp, ts, {k: torch.as_tensor(v) for k, v in _batch(tcfg, i).items()})
        for key in ("loss", "ce", "aux_loss", "z_loss"):  # after step 0: moved weights
            held = hold(f"step {i} {key}", tmet[key], jmets[i][key], wmets[i][key], 0.0, 1e-6)
            assert not (held and i == 0), f"step 0 {key}"
    for name, p in tp.named_parameters():
        hold(name, p, ref_leaf(jp, tcfg, name), ref_leaf(wp, tcfg, name), 1e-6, 0.0)
    assert not any(p.requires_grad for p in tp.parameters())
