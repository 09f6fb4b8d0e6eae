"""The port's optimizers, schedules and LM token stream against the
reference's (``repro.optim``, ``repro.data.lm``) on the same numpy inputs.

Schedules over steps 0-200 (float32, rtol 1e-6); AdamW, SGD (plain and
Nesterov) and Lion over three updates of the same parameters and gradients
(updates, moments and parameters at 1e-6 in float32; bfloat16 parameters
take ``(p + u).astype(bf16)`` in both, held to one bfloat16 ulp);
``clip_by_global_norm``; and ``TokenStream`` bitwise.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import optim as jo
from repro.data import synthetic_lm_stream as j_stream
from repro_torch import optim as to
from repro_torch import tree
from repro_torch.data import TokenStream, synthetic_lm_stream

torch.set_num_threads(1)

SHAPES = {"w": (6, 5), "b": (5,), "emb": (7, 3), "scale": ()}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.normal(size=s)).astype(np.float32) for k, s in SHAPES.items()}


SCHEDULES = {
    "constant": lambda m: m.constant(3e-4),
    "linear_warmup": lambda m: m.linear_warmup(3e-4, 10, 150),
    "linear_warmup_short": lambda m: m.linear_warmup(1e-2, 0, 1, final_frac=0.0),
    "cosine_warmup": lambda m: m.cosine_warmup(3e-4, 21, 200),
    "cosine_warmup_launcher": lambda m: m.cosine_warmup(3e-4, min(100, 20 // 10 + 1), 20),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_reference(name):
    jfn, tfn = SCHEDULES[name](jo), SCHEDULES[name](to)
    steps = np.arange(0, 201)
    ref = np.asarray(jax.vmap(jfn)(jnp.asarray(steps, jnp.int32)))
    got = np.array([float(tfn(torch.tensor(int(s), dtype=torch.int32))) for s in steps])
    assert tfn(3).dtype == torch.float32
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-12)


OPTIMIZERS = {
    "adamw": lambda m, s: m.adamw(s),
    "adamw_noclip": lambda m, s: m.adamw(s, clip_norm=None, weight_decay=0.01),
    "sgd": lambda m, s: m.sgd(s),
    "sgd_nesterov": lambda m, s: m.sgd(s, nesterov=True),
    "lion": lambda m, s: m.lion(s),
}


def _to_np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.uint16).numpy().view(ml_dtypes.bfloat16).astype(np.float32)
        return x.numpy()
    return np.asarray(x).astype(np.float32) if np.asarray(x).dtype == jnp.bfloat16 \
        else np.asarray(x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_updates_match_reference(name, dtype):
    sched = "cosine_warmup"
    jopt = OPTIMIZERS[name](jo, SCHEDULES[sched](jo))
    topt = OPTIMIZERS[name](to, SCHEDULES[sched](to))
    p0 = _tree(0)
    jp = {k: jnp.asarray(v, dtype) for k, v in p0.items()}
    tp = {k: torch.as_tensor(v).to(getattr(torch, dtype)) for k, v in p0.items()}
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for i in range(3):
        g = _tree(10 + i, scale=3.0)  # global norm > 1: the clip is active
        jg = {k: jnp.asarray(v, dtype) for k, v in g.items()}
        tg = {k: torch.as_tensor(v).to(getattr(torch, dtype)) for k, v in g.items()}
        ju, jstate = jopt.update(jg, jstate, jp)
        tu, tstate = topt.update(tg, tstate, tp)
        for a, b in zip(jax.tree.leaves(ju), tree.leaves(tu)):
            assert b.dtype == torch.float32
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-10)
        jp = jo.apply_updates(jp, ju)
        tp = to.apply_updates(tp, tu)
        assert int(tstate["step"]) == int(jstate["step"]) == i + 1
        for key in ("mu", "nu", "mom"):
            if key in jstate:
                for a, b in zip(jax.tree.leaves(jstate[key]), tstate[key]):
                    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-6)
        for k in SHAPES:
            assert tp[k].dtype == getattr(torch, dtype)
            if dtype == "float32":
                np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-6)
            else:  # one bfloat16 ulp: a 1e-7 difference in u may round the other way
                np.testing.assert_allclose(_to_np(tp[k]), _to_np(jp[k]), rtol=2**-8, atol=0)


def test_updates_write_a_modules_parameters_in_place():
    mod = torch.nn.Linear(4, 3)
    before = [p.detach().clone() for p in mod.parameters()]
    opt = to.sgd(to.constant(0.1), momentum=0.0)
    state = opt.init(mod)
    grads = [torch.ones_like(p) for p in mod.parameters()]
    upd, state = opt.update(grads, state, mod)
    assert to.apply_updates(mod, upd) is mod
    for p, b in zip(mod.parameters(), before):
        torch.testing.assert_close(p.detach(), b - 0.1, rtol=0, atol=1e-7)
        assert not p.requires_grad or p.grad is None


@pytest.mark.parametrize("scale,max_norm", [(3.0, 1.0), (0.01, 1.0), (1.0, 0.5)])
def test_global_norm_and_clip_match_reference(scale, max_norm):
    g = _tree(4, scale=scale)
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    tg = {k: torch.as_tensor(v) for k, v in g.items()}
    np.testing.assert_allclose(float(to.global_norm(tg)), float(jo.global_norm(jg)), rtol=1e-6)
    jc, jn = jo.clip_by_global_norm(jg, max_norm)
    tc, tn = to.clip_by_global_norm(tg, max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for k in SHAPES:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("seed,vocab,seq,batch", [(0, 512, 32, 4), (3, 50280, 16, 8),
                                                 (7, 100, 9, 2)])
def test_token_stream_is_bitwise_the_reference(seed, vocab, seq, batch):
    ref = j_stream(vocab, seq, batch, seed=seed)
    got = synthetic_lm_stream(vocab, seq, batch, seed=seed)
    assert isinstance(got, TokenStream)
    for step in (0, 1, 17):
        a, b = ref.batch_at(step), got.batch_at(step)
        assert sorted(a) == sorted(b) == ["labels", "mask", "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (step, k)
    assert got.bigram_entropy() == ref.bigram_entropy()
    sharded = TokenStream(vocab, seq, batch, seed=seed, host_id=1, n_hosts=2)
    assert np.array_equal(sharded.batch_at(2)["tokens"],
                          j_stream(vocab, seq, batch, seed=seed, host_id=1,
                                   n_hosts=2).batch_at(2)["tokens"])
