"""The dense slice layer by layer: RoPE, the causal mask, GQA attention with
its ring-buffer KV cache, and the MLPs of ``repro_torch.models.layers``
against the reference's ``repro.models.layers`` on the same numpy inputs,
with the reference's parameters carried across by
``convert.attention_from_numpy`` / ``mlp_from_numpy``.

Bound: 2e-5 absolute + 2e-5 relative in float32 (the reference's kernel
bound); masks and the cache's integer ``pos`` exactly.  The GQA layout is
held at rep = 2 and at rep = 3 (smollm-135m's 9 heads over 3 kv heads),
the -1e30 mask by a fully masked row (which averages v; -inf would give
NaN), and the bf16 rounding of the logits and the probabilities by bf16
inputs, where leaving either out moves a fifth of the outputs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as JL
from repro.configs import get_config as j_get_config
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import layers as TL

torch.set_num_threads(1)

CPU = "cpu"
TOL = dict(atol=2e-5, rtol=2e-5)


def _np(x):
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cfgs(arch="smollm-135m", **over):
    j = dataclasses.replace(j_get_config(arch, variant="smoke"), **over)
    t = dataclasses.replace(get_config(arch, variant="smoke"), **over)
    return j, t


def _x(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _attn_pair(jcfg, tcfg, seed=0, bias=False):
    """The reference's attention parameters and their port; with ``bias`` the
    (zero-initialised) q/k/v biases are made random so that they count."""
    jp = jax.tree.map(np.asarray, JL.attn_init(jax.random.PRNGKey(seed), jcfg))
    if bias:
        rng = np.random.default_rng(seed + 7)
        for name in ("wq", "wk", "wv"):
            jp[name]["b"] = rng.standard_normal(jp[name]["b"].shape).astype(np.float32)
    return jax.tree.map(jnp.asarray, jp), convert.attention_from_numpy(jp, device=CPU)


def test_rope_angles_and_apply_rope():
    jcfg, tcfg = _cfgs("internlm2-1.8b")  # rope_theta 1e6
    pos = np.random.default_rng(0).integers(0, 4096, size=(2, 7)).astype(np.int32)
    ja = JL.rope_angles(jcfg, jnp.asarray(pos))
    ta = TL.rope_angles(tcfg, torch.as_tensor(pos))
    assert ta.dtype == torch.float32 and ta.shape == (2, 7, tcfg.hd // 2)
    np.testing.assert_allclose(_np(ta), np.asarray(ja), **TOL)
    x = _x((2, 7, 3, tcfg.hd))
    np.testing.assert_allclose(_np(TL.apply_rope(torch.as_tensor(x), ta)),
                               np.asarray(JL.apply_rope(jnp.asarray(x), ja)), **TOL)
    # the NeoX half split: rotating by angle 0 is the identity, and a pair is
    # (i, i + hd/2), not (2i, 2i + 1)
    zero = torch.zeros(1, 1, tcfg.hd // 2)
    xt = torch.as_tensor(x[:1, :1])
    assert torch.equal(TL.apply_rope(xt, zero), xt)
    quarter = torch.full((1, 1, tcfg.hd // 2), np.pi / 2)
    rot = TL.apply_rope(xt, quarter)
    half = tcfg.hd // 2
    torch.testing.assert_close(rot[..., :half], -xt[..., half:], atol=1e-6, rtol=0)
    # M-RoPE (the VLM's; its own tests are tests/test_torch_vlm.py) at the same
    # positions on all three streams
    over = dict(rope_mode="mrope", mrope_sections=(4, 6, 6))
    jm_cfg, tm_cfg = dataclasses.replace(jcfg, **over), dataclasses.replace(tcfg, **over)
    pos3 = np.repeat(pos[:, None, :], 3, axis=1)
    np.testing.assert_allclose(_np(TL.rope_angles(tm_cfg, torch.as_tensor(pos3))),
                               np.asarray(JL.rope_angles(jm_cfg, jnp.asarray(pos3))), **TOL)


@pytest.mark.parametrize("sq,sk,window,offset", [(6, 6, 0, 0), (5, 9, 3, 4), (1, 8, 4, 7)])
def test_causal_mask(sq, sk, window, offset):
    want = np.asarray(JL.causal_mask(sq, sk, window=window, offset=offset))
    got = TL.causal_mask(sq, sk, window=window, offset=offset)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("heads,kv_heads", [(4, 2), (9, 3)])
def test_sdpa_gqa_layout(heads, kv_heads):
    """Query head h reads kv head h // rep; a fully masked row averages v."""
    _, tcfg = _cfgs()
    b, sq, sk, hd = 2, 5, 7, 32
    q, k, v = _x((b, sq, heads, hd), 1), _x((b, sk, kv_heads, hd), 2), _x((b, sk, kv_heads, hd), 3)
    mask = np.random.default_rng(4).random((b, sq, sk)) < 0.6
    mask[0, 2] = False  # one fully masked row
    want = np.asarray(JL._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(mask), tcfg))
    tq, tk, tv = (torch.as_tensor(a) for a in (q, k, v))
    got = TL._sdpa(tq, tk, tv, torch.as_tensor(mask), tcfg)
    assert got.shape == (b, sq, heads * hd)
    np.testing.assert_allclose(_np(got), want, **TOL)
    np.testing.assert_allclose(_np(got[0, 2]).reshape(heads, hd),
                               np.repeat(v[0].mean(0), heads // kv_heads, axis=0), **TOL)
    # the other expansion of the kv heads is a different function
    rep = heads // kv_heads
    tiled = TL._sdpa(tq, tk.repeat(1, 1, rep, 1), tv.repeat(1, 1, rep, 1),
                     torch.as_tensor(mask), tcfg)
    assert float((tiled - got).abs().max()) > 1e-2


def _sdpa_variant(q, k, v, mask, *, round_logits: bool, cast_probs: bool):
    """The port's _sdpa with one of the reference's two bf16 roundings left out."""
    b, sq, h, hd = q.shape
    kh = k.shape[2]
    q5 = q.reshape(b, sq, kh, h // kh, hd)
    logits = (torch.einsum("bqkrh,bskh->bkrqs", q5, k).float() if round_logits
              else torch.einsum("bqkrh,bskh->bkrqs", q5.float(), k.float()))
    probs = torch.softmax(torch.where(mask[:, None, None], logits * hd**-0.5, -1e30), -1)
    out = (torch.einsum("bkrqs,bskh->bqkrh", probs.to(v.dtype), v) if cast_probs
           else torch.einsum("bkrqs,bskh->bqkrh", probs, v.float()).to(v.dtype))
    return out.reshape(b, sq, h * hd)


def test_sdpa_bf16_rounds_logits_and_probs_like_the_reference():
    _, tcfg = _cfgs()
    b, s, h, kh, hd = 2, 9, 9, 3, 64
    q, k, v = _x((b, s, h, hd), 5, 2.0), _x((b, s, kh, hd), 6, 2.0), _x((b, s, kh, hd), 7)
    mask = np.tril(np.ones((s, s), bool))[None].repeat(b, 0)
    want = np.asarray(JL._sdpa(*(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
                               jnp.asarray(mask), tcfg).astype(jnp.float32))
    tq, tk, tv = (torch.as_tensor(a).to(torch.bfloat16) for a in (q, k, v))
    tm = torch.as_tensor(mask)
    got = TL._sdpa(tq, tk, tv, tm, tcfg)
    assert got.dtype == torch.bfloat16
    # within one bf16 ulp everywhere and equal almost everywhere (the two
    # libraries' float32 accumulations may round a rare element apart) ...
    np.testing.assert_allclose(_np(got), want, atol=0, rtol=2**-7)
    assert np.mean(_np(got) != want) < 0.02
    # ... where leaving out either rounding moves a fifth of the outputs
    for kw in (dict(round_logits=False, cast_probs=True),
               dict(round_logits=True, cast_probs=False)):
        assert np.mean(_np(_sdpa_variant(tq, tk, tv, tm, **kw)) != want) > 0.1, kw


@pytest.mark.parametrize("bias", [False, True])
def test_attn_forward(bias):
    jcfg, tcfg = _cfgs("qwen1.5-32b" if bias else "smollm-135m")
    assert tcfg.qkv_bias == bias
    jp, tp = _attn_pair(jcfg, tcfg, bias=bias)
    assert (tp.wq.b is not None) == bias and tp.wo.b is None
    b, s = 2, 11
    x = _x((b, s, tcfg.d_model), 8)
    pos = np.arange(s)[None].repeat(b, 0)
    ja = JL.rope_angles(jcfg, jnp.asarray(pos))
    ta = TL.rope_angles(tcfg, torch.as_tensor(pos))
    for window in (0, 4):
        want = JL.attn_forward(jp, jcfg, jnp.asarray(x), ja, window=window)
        got = TL.attn_forward(tp, tcfg, torch.as_tensor(x), ta, window=window)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL, err_msg=f"window {window}")


def _cache_eq(tc, jc, label):
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]), err_msg=label)
    assert tc["pos"].dtype == torch.int32
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tc[key]), np.asarray(jc[key]), **TOL,
                                   err_msg=f"{label} {key}")


def test_prefill_into_cache_wraps_the_ring_then_decodes():
    """A 13-token prompt into a ring of 8 (window 8): the last 8 positions in
    their slots; then 4 decode steps at the reference's slots and mask."""
    jcfg, tcfg = _cfgs("internlm2-1.8b", sliding_window=8)
    jp, tp = _attn_pair(jcfg, tcfg, seed=3)
    b, s, length = 2, 13, 8
    x = _x((b, s + 4, tcfg.d_model), 9)
    pos = np.arange(s)[None].repeat(b, 0)
    jcache = JL.init_kv_cache(jcfg, b, length, jnp.float32)
    tcache = TL.init_kv_cache(tcfg, b, length, torch.float32, CPU)
    _cache_eq(tcache, jcache, "empty")
    jo, jcache = JL.prefill_into_cache(jp, jcfg, jnp.asarray(x[:, :s]),
                                       JL.rope_angles(jcfg, jnp.asarray(pos)), jcache, window=8)
    to, tcache2 = TL.prefill_into_cache(tp, tcfg, torch.as_tensor(x[:, :s]),
                                        TL.rope_angles(tcfg, torch.as_tensor(pos)), tcache,
                                        window=8)
    assert tcache2 is tcache  # written in place
    np.testing.assert_allclose(_np(to), np.asarray(jo), **TOL)
    _cache_eq(tcache, jcache, "prefill")
    assert sorted(tcache["pos"][0].tolist()) == list(range(s - length, s))
    for t in range(4):
        xt = x[:, s + t:s + t + 1]
        jo, jcache = JL.attn_decode(jp, jcfg, jnp.asarray(xt), jcache, jnp.int32(s + t),
                                      window=8)
        to, tcache = TL.attn_decode(tp, tcfg, torch.as_tensor(xt), tcache, s + t, window=8)
        np.testing.assert_allclose(_np(to), np.asarray(jo), **TOL, err_msg=f"step {t}")
        _cache_eq(tcache, jcache, f"step {t}")


def test_attn_decode_against_a_short_prompt():
    """A prompt shorter than the cache (empty slots at pos -1), then decode
    steps without a window, at rep = 3."""
    jcfg, tcfg = _cfgs(n_heads=6, n_kv_heads=2)
    jp, tp = _attn_pair(jcfg, tcfg, seed=4)
    b, s, length = 2, 5, 12
    x = _x((b, s + 3, tcfg.d_model), 10)
    pos = np.arange(s)[None].repeat(b, 0)
    jcache = JL.init_kv_cache(jcfg, b, length, jnp.float32)
    tcache = TL.init_kv_cache(tcfg, b, length, torch.float32, CPU)
    _, jcache = JL.prefill_into_cache(jp, jcfg, jnp.asarray(x[:, :s]),
                                      JL.rope_angles(jcfg, jnp.asarray(pos)), jcache)
    _, tcache = TL.prefill_into_cache(tp, tcfg, torch.as_tensor(x[:, :s]),
                                      TL.rope_angles(tcfg, torch.as_tensor(pos)), tcache)
    _cache_eq(tcache, jcache, "prefill")
    assert int((tcache["pos"] == -1).sum()) == b * (length - s)
    for t in range(3):
        xt = x[:, s + t:s + t + 1]
        jo, jcache = JL.attn_decode(jp, jcfg, jnp.asarray(xt), jcache, jnp.int32(s + t))
        to, tcache = TL.attn_decode(tp, tcfg, torch.as_tensor(xt), tcache, s + t)
        np.testing.assert_allclose(_np(to), np.asarray(jo), **TOL, err_msg=f"step {t}")
        _cache_eq(tcache, jcache, f"step {t}")


@pytest.mark.parametrize("act", ["silu", "squared_relu", "gelu"])
def test_mlp(act):
    jcfg, tcfg = _cfgs(act=act)
    jp = jax.tree.map(np.asarray, JL.mlp_init(jax.random.PRNGKey(5), jcfg, tcfg.d_ff))
    tp = convert.mlp_from_numpy(jp, device=CPU)
    assert (tp.wg is not None) == (act == "silu")
    x = _x((2, 6, tcfg.d_model), 11, 2.0)
    want = JL.mlp(jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(x))
    np.testing.assert_allclose(_np(TL.mlp(tp, tcfg, torch.as_tensor(x))), np.asarray(want),
                               **TOL)
