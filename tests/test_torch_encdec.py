"""The encoder-decoder slice: whisper-tiny (LayerNorm, GELU, stub frames
with a sinusoid, bidirectional encoder, causal decoder with learned
positions clipped to max_target_positions, cross-attention, tied head)
against the reference's ``repro.models.encdec`` at its smoke variant (2
encoder and 2 decoder layers, 32 frames, 64 positions), in float32, with
the reference's parameters carried across by
``convert.lm_params_from_numpy`` and the same numpy inputs.

Bounds: LayerNorm and the encoder states 2e-5 abs + rel (the layers'
bound, tests/test_torch_attention.py), the forward's and decode's logits
and the cross K/V 2e-4 / 3e-4 (tests/test_decode.py), the loss 1e-6
relative and every gradient 1e-5 abs + 1e-4 rel
(tests/test_torch_dense_train.py's), greedy tokens exactly.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as jm
import repro.models.encdec as JED
import repro.models.layers as JL
from repro.configs import concrete_batch
from repro.configs import get_config as j_get_config
from repro_torch import convert, tree
from repro_torch import models as tm
from repro_torch.configs import get_config, long_context_variant
from repro_torch.models import encdec as TED
from repro_torch.models import layers as TL

torch.set_num_threads(1)

CPU = "cpu"
ARCH = "whisper-tiny"
TOL = dict(atol=2e-5, rtol=2e-5)


def _np(x):
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@functools.lru_cache(maxsize=None)
def _ref_params(seed: int):
    """The reference's smoke parameters as numpy, the LayerNorms' (ones,
    zeros) made random so that scale and bias count."""
    jcfg = j_get_config(ARCH, variant="smoke")
    jp = jax.tree.map(np.asarray, jm.init_params(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 7)

    def jitter(path, a):
        if path[-1].key in ("scale", "bias"):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(jitter, jp)


def _pair(seed=1):
    jcfg, tcfg = j_get_config(ARCH, variant="smoke"), get_config(ARCH, variant="smoke")
    jp = _ref_params(seed)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, jp), convert.lm_params_from_numpy(
        jp, tcfg, device=CPU)


def _batch(cfg, s: int = 12, seed: int = 2) -> dict:
    return {k: np.asarray(v) for k, v in concrete_batch(cfg, s, 2, seed=seed).items()}


def test_config_matches_reference_field_for_field():
    for variant in ("full", "smoke"):
        assert dataclasses.asdict(get_config(ARCH, variant=variant)) == \
            dataclasses.asdict(j_get_config(ARCH, variant=variant)), variant
    full = get_config(ARCH)
    assert full.n_params() == j_get_config(ARCH).n_params()
    assert (full.n_layers, full.n_encoder_layers, full.d_model, full.n_heads, full.hd,
            full.d_ff, full.vocab_size, full.encoder_seq, full.max_target_positions) == \
        (4, 4, 384, 6, 64, 1536, 51865, 1500, 448)
    assert full.is_encoder_decoder and full.norm == "layernorm" and full.act == "gelu"
    with pytest.raises(ValueError, match="enc-dec"):
        get_config(ARCH, variant="long")
    with pytest.raises(ValueError, match="enc-dec"):
        long_context_variant(full)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    """The biased variance, eps 1e-5, the math in float32 and the result cast
    back: in bf16 the outputs' bits are the reference's."""
    jcfg = dataclasses.replace(j_get_config(ARCH, variant="smoke"), dtype=dtype)
    tcfg = dataclasses.replace(get_config(ARCH, variant="smoke"), dtype=dtype)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 5, tcfg.d_model)) * 3 + 2).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(tcfg.d_model)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(tcfg.d_model)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = JL.apply_norm({"scale": jnp.asarray(scale, jdt), "bias": jnp.asarray(bias, jdt)},
                         jcfg, jnp.asarray(x, jdt))
    p = TL.norm_init(tcfg, torch.device(CPU))
    assert isinstance(p, TL.LayerNorm) and p.scale.dtype == p.bias.dtype == tdt
    assert torch.equal(p.scale, torch.ones_like(p.scale))
    assert torch.equal(p.bias, torch.zeros_like(p.bias))
    p = TL.LayerNorm(torch.as_tensor(scale).to(tdt), torch.as_tensor(bias).to(tdt))
    got = TL.apply_norm(p, torch.as_tensor(x).to(tdt))
    assert got.dtype == tdt
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_layernorm_zero_mean():
    """tests/test_layers.py's property: at unit scale and zero bias the
    output has zero mean over the features."""
    p = TL.norm_init(get_config(ARCH, variant="smoke"), torch.device(CPU))
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((2, 5, 128)) + 3,
                        dtype=torch.float32)
    y = TL.apply_norm(p, x)
    torch.testing.assert_close(y.mean(-1), torch.zeros(2, 5), atol=1e-4, rtol=0)
    torch.testing.assert_close(y.var(-1, unbiased=False), torch.ones(2, 5), atol=1e-3, rtol=0)


def test_encoder_and_forward_match_reference():
    jcfg, tcfg, jp, tp = _pair()
    b = _batch(tcfg)
    assert [n for n, _ in tp.named_children()] == ["enc_layers", "dec_layers", "enc_norm",
                                                   "dec_norm"]
    frames = b["frames"]
    assert frames.shape == (2, tcfg.encoder_seq, tcfg.d_model)
    np.testing.assert_allclose(TED._sinusoid(32, tcfg.d_model, CPU).numpy(),
                               np.asarray(JED._sinusoid(32, tcfg.d_model)), atol=1e-6)
    je = JED.encode(jp, jcfg, jnp.asarray(frames))
    te = TED.encode(tp, tcfg, torch.as_tensor(frames))
    np.testing.assert_allclose(_np(te), np.asarray(je), **TOL)
    jf, jmet = jm.forward_logits(jcfg, jp, {k: jnp.asarray(v) for k, v in b.items()})
    tf, tmet = tm.forward_logits(tcfg, tp, {k: torch.as_tensor(v) for k, v in b.items()})
    assert tf.shape == (2, 12, tcfg.vocab_size)
    np.testing.assert_allclose(_np(tf), np.asarray(jf), atol=2e-4, rtol=2e-4)
    assert sorted(tmet) == sorted(jmet) == ["aux_loss", "z_loss"]
    assert float(tmet["aux_loss"]) == float(tmet["z_loss"]) == 0.0


def test_prefill_cross_kv_and_decode_match_reference_and_the_forward():
    """The prefill's per-layer cross K/V, 3 decode steps from BOS at
    positions 0.. against the reference's, and the decode against the
    teacher-forced forward over the same tokens."""
    jcfg, tcfg, jp, tp = _pair()
    b = _batch(tcfg)
    frames = b["frames"]
    jcache = jm.init_cache(jcfg, 2, 16)
    jl, jcache = jm.prefill(jcfg, jp, {"frames": jnp.asarray(frames)}, jcache)
    tcache = tm.init_cache(tcfg, 2, 16, device=CPU)
    tl, tcache = tm.prefill(tcfg, tp, {"frames": torch.as_tensor(frames)}, tcache)
    assert jl is None and tl is None
    assert sorted(tcache) == ["cross_k", "cross_v", "self"]
    assert len(tcache["self"]) == tcfg.n_layers == 2
    for key in ("cross_k", "cross_v"):
        assert tcache[key].shape == (2, 2, tcfg.encoder_seq, tcfg.n_kv_heads, tcfg.hd)
        np.testing.assert_allclose(_np(tcache[key]), np.asarray(jcache[key]), atol=2e-4,
                                   rtol=2e-4, err_msg=key)
    toks = np.concatenate([np.zeros((2, 1), np.int32), b["tokens"][:, :3]], axis=1)
    tf, _ = tm.forward_logits(tcfg, tp, {"tokens": torch.as_tensor(toks),
                                         "frames": torch.as_tensor(frames)})
    for t in range(4):
        tok = toks[:, t:t + 1]
        jl, jcache = jm.decode_step(jcfg, jp, jnp.asarray(tok), jcache, t)
        tl, tcache = tm.decode_step(tcfg, tp, torch.as_tensor(tok), tcache, t)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=3e-4, rtol=3e-4,
                                   err_msg=f"step {t}")
        np.testing.assert_allclose(_np(tl[:, 0]), _np(tf[:, t]), atol=3e-4, rtol=3e-4,
                                   err_msg=f"step {t} vs the forward")
        for i, c in enumerate(tcache["self"]):
            np.testing.assert_array_equal(c["pos"].numpy(),
                                          np.asarray(jcache["self"]["pos"][i]))


def test_positions_clip_at_max_target_positions():
    """Smoke: 64 learned positions.  A 70-token forward reads row 63 for
    positions 63..69, as the reference clips; a decode step at position 66
    reads row 63 too."""
    jcfg, tcfg, jp, tp = _pair()
    assert tcfg.max_target_positions == 64
    rows = TED._dec_positions(tp, tcfg, 60, 10)
    assert torch.equal(rows[3:], tp.dec_pos[63].expand(7, -1))
    np.testing.assert_array_equal(_np(rows), np.asarray(JED._dec_positions(jp, jcfg, 60, 10)))
    b = _batch(tcfg, s=70)
    jf, _ = jm.forward_logits(jcfg, jp, {k: jnp.asarray(v) for k, v in b.items()})
    tf, _ = tm.forward_logits(tcfg, tp, {k: torch.as_tensor(v) for k, v in b.items()})
    np.testing.assert_allclose(_np(tf), np.asarray(jf), atol=2e-4, rtol=2e-4)
    cache = tm.prefill(tcfg, tp, {"frames": torch.as_tensor(b["frames"])},
                       tm.init_cache(tcfg, 2, 72, device=CPU))[1]
    for t in range(66):
        _, cache = tm.decode_step(tcfg, tp, torch.as_tensor(b["tokens"][:, t:t + 1]), cache, t)
    tl, _ = tm.decode_step(tcfg, tp, torch.as_tensor(b["tokens"][:, 66:67]), cache, 66)
    np.testing.assert_allclose(_np(tl[:, 0]), _np(tf[:, 66]), atol=3e-4, rtol=3e-4)


def test_loss_and_every_gradient_with_frames_match_reference():
    jcfg, tcfg, jp, tp = _pair()
    b = _batch(tcfg)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(lambda p: jm.loss_fn(jcfg, p, b),
                                                has_aux=True))(jp)
    leaves = tree.leaves(tp)
    with torch.enable_grad():
        for p in leaves:
            p.requires_grad_(True)
        tl, tmet = tm.loss_fn(tcfg, tp, {k: torch.as_tensor(v) for k, v in b.items()})
        grads = torch.autograd.grad(tl, leaves)
    assert sorted(tmet) == sorted(jmet) == ["ce", "loss"]
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    names = [n for n, _ in tp.named_parameters()]
    stacked = {"enc_layers": tcfg.n_encoder_layers, "dec_layers": tcfg.n_layers}
    per = {k: len(jax.tree.leaves(jg[k])) for k in stacked}
    assert len(names) == len(jax.tree.leaves(jg)) + sum(
        per[k] * (n - 1) for k, n in stacked.items())
    for name, g in zip(names, grads):
        path = name.split(".")
        i = int(path.pop(1)) if path[0] in stacked else None  # the layer of a stacked leaf
        node = jg
        for key in path:
            node = node[key]
        ref = np.asarray(node if i is None else node[i])
        assert g.shape == ref.shape, name
        np.testing.assert_allclose(g.numpy(), ref, atol=1e-5, rtol=1e-4, err_msg=name)
    assert float(np.abs(np.asarray(jg["dec_layers"]["cross_attn"]["wk"]["w"])).max()) > 0
    assert float(np.abs(np.asarray(jg["enc_layers"]["norm1"]["bias"])).max()) > 0


def test_greedy_decode_from_bos_matches_reference():
    jcfg, tcfg, jp, tp = _pair()
    frames = _batch(tcfg)["frames"]
    prompt = np.zeros((2, 3), np.int32)  # read by neither: the decode starts from BOS
    jt, _ = jm.greedy_decode(jcfg, jp, jnp.asarray(prompt), 6, 16,
                             batch_extra={"frames": jnp.asarray(frames)})
    tt, cache = tm.greedy_decode(tcfg, tp, torch.as_tensor(prompt), 6, 16,
                                 batch_extra={"frames": torch.as_tensor(frames)})
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert cache["self"][0]["pos"][0, :7].tolist() == [0, 1, 2, 3, 4, 5, -1]
    assert tm.decode_start(tcfg, 3, {"frames": frames}) == 0
