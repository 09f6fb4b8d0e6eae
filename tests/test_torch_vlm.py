"""The VLM slice: qwen2-vl-2b (M-RoPE over temporal / height / width
streams, q/k/v biases, a tied head, a stub prefix of patch embeddings)
against the reference at its smoke variant (2 layers, 16 patches, sections
(4, 6, 6)), in float32, with the reference's parameters carried across by
``convert.lm_params_from_numpy`` and the same numpy inputs.

Bounds are the reference's own: M-RoPE angles 2e-5 abs + rel
(tests/test_torch_attention.py's), positions exactly, the forward's and
the prefill's logits 2e-4 and the teacher-forced decode 3e-4
(tests/test_decode.py), the loss 1e-6 relative and every gradient 1e-5 abs
+ 1e-4 rel (tests/test_torch_dense_train.py's).

The port's launcher sizes the cache for the patch prefix too and decodes
from ``n_patches + S0``; its decode is held to the forward at 3e-4.  The
reference's launcher sizes it ``S0 + gen + 1`` and decodes from ``S0``:
beside the check, its own model API at that sizing is shown to miss the
forward by more than 0.5 (ROADMAP Queue 3).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as jm
import repro.models.layers as JL
import repro.models.transformer as JT
from repro.configs import concrete_batch
from repro.configs import get_config as j_get_config
from repro_torch import convert, tree
from repro_torch import models as tm
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

torch.set_num_threads(1)

CPU = "cpu"
ARCH = "qwen2-vl-2b"
TOL = dict(atol=2e-5, rtol=2e-5)


def _np(x):
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@functools.lru_cache(maxsize=None)
def _ref_params(seed: int):
    jcfg = j_get_config(ARCH, variant="smoke")
    jp = jax.tree.map(np.asarray, jm.init_params(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 7)  # the zero-initialised q/k/v biases made to count
    for name in ("wq", "wk", "wv"):
        b = jp["blocks"]["layer0"]["attn"][name]["b"]
        jp["blocks"]["layer0"]["attn"][name]["b"] = (
            0.1 * rng.standard_normal(b.shape)).astype(np.float32)
    return jp


def _pair(seed=1):
    jcfg, tcfg = j_get_config(ARCH, variant="smoke"), get_config(ARCH, variant="smoke")
    jp = _ref_params(seed)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, jp), convert.lm_params_from_numpy(
        jp, tcfg, device=CPU)


def _batch(cfg, s_text: int, b: int = 2, seed: int = 2) -> dict:
    """The reference's ``concrete_batch`` (tokens, labels, mask and the patch
    embeddings) as numpy, ``s_text`` text tokens behind the prefix."""
    return {k: np.asarray(v) for k, v in
            concrete_batch(cfg, s_text + cfg.n_patches, b, seed=seed).items()}


def _torch(b: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in b.items()}


def test_config_matches_reference_field_for_field():
    for variant in ("full", "smoke", "long"):
        assert dataclasses.asdict(get_config(ARCH, variant=variant)) == \
            dataclasses.asdict(j_get_config(ARCH, variant=variant)), variant
    full = get_config(ARCH)
    assert full.n_params() == j_get_config(ARCH).n_params()
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads, full.hd, full.d_ff,
            full.vocab_size, full.n_patches) == (28, 1536, 12, 2, 128, 8960, 151936, 1024)
    assert full.rope_mode == "mrope" and full.mrope_sections == (16, 24, 24)
    assert full.qkv_bias and full.tie_embeddings and full.family == "vlm"
    assert round(full.n_params() / 1e9, 2) == 1.54


@pytest.mark.parametrize("variant", ["smoke", "full"])
def test_mrope_angles_match_reference(variant):
    """Random positions on three independent streams, at the smoke sections
    (4, 6, 6) of hd/2 = 16 and the full (16, 24, 24) of 64."""
    jcfg, tcfg = j_get_config(ARCH, variant=variant), get_config(ARCH, variant=variant)
    pos = np.random.default_rng(0).integers(0, 4096, size=(2, 3, 7)).astype(np.int32)
    ja = JL.rope_angles(jcfg, jnp.asarray(pos))
    ta = TL.rope_angles(tcfg, torch.as_tensor(pos))
    assert ta.dtype == torch.float32 and ta.shape == (2, 7, tcfg.hd // 2)
    np.testing.assert_allclose(_np(ta), np.asarray(ja), **TOL)
    # each section reads its own stream
    sec = np.repeat(np.arange(3), tcfg.mrope_sections)
    inv = 1.0 / (tcfg.rope_theta ** (np.arange(0, tcfg.hd, 2) / tcfg.hd))
    want = pos[:, sec, :].transpose(0, 2, 1) * inv
    np.testing.assert_allclose(_np(ta), want, rtol=1e-6)
    # float64 for a float64 model
    wide = TL.rope_angles(dataclasses.replace(tcfg, dtype="float64"), torch.as_tensor(pos))
    assert wide.dtype == torch.float64
    np.testing.assert_allclose(wide.numpy(), want, rtol=1e-12)
    with pytest.raises(ValueError, match="mrope_sections"):
        TL.rope_angles(dataclasses.replace(tcfg, mrope_sections=(4, 6, 5)),
                       torch.as_tensor(pos))


def test_mrope_matches_standard_when_streams_equal():
    """tests/test_layers.py's property: if the t/h/w streams coincide, M-RoPE
    is standard RoPE."""
    tcfg = get_config(ARCH, variant="smoke")
    std = dataclasses.replace(tcfg, rope_mode="standard", mrope_sections=())
    pos = torch.arange(5)[None, :]
    a_m = TL.rope_angles(tcfg, pos[:, None, :].expand(1, 3, 5))
    a_s = TL.rope_angles(std, pos)
    torch.testing.assert_close(a_m, a_s, rtol=1e-6, atol=0)


@pytest.mark.parametrize("seq", [24, 16, 10, 17, 40])
def test_build_positions_with_a_patch_prefix(seq):
    """Exactly the reference's ids: the first min(n_patches, seq) positions on
    a grid of side max(int(sqrt(npatch)), 1) (temporal 0, row, column), the
    text from side on every stream; and the standard (B, S) ids."""
    jcfg, tcfg = j_get_config(ARCH, variant="smoke"), get_config(ARCH, variant="smoke")
    want = np.asarray(JT.build_positions(jcfg, 2, seq))
    got = TT.build_positions(tcfg, 2, seq)
    assert got.shape == (2, 3, seq)
    np.testing.assert_array_equal(got.numpy(), want)
    if seq > tcfg.n_patches:  # the decoded tokens continue the text streams
        side = int(tcfg.n_patches**0.5)
        assert TT.mrope_decode_position(tcfg, seq) == seq - tcfg.n_patches + side
        assert int(got[0, 0, -1]) == TT.mrope_decode_position(tcfg, seq - 1)
    std = dataclasses.replace(tcfg, rope_mode="standard")
    np.testing.assert_array_equal(
        TT.build_positions(std, 2, seq).numpy(),
        np.asarray(JT.build_positions(dataclasses.replace(jcfg, rope_mode="standard"), 2, seq)))


def test_forward_with_patches_matches_reference():
    """The text-aligned logits (the prefix's sliced off) with the patches, and
    the forward without them (the first 16 text tokens then take the grid's
    positions, as in the reference)."""
    jcfg, tcfg, jp, tp = _pair()
    b = _batch(tcfg, 12)
    jf, _ = jm.forward_logits(jcfg, jp, {k: jnp.asarray(v) for k, v in b.items()})
    tf, _ = tm.forward_logits(tcfg, tp, _torch(b))
    assert tf.shape == (2, 12, tcfg.vocab_size)
    np.testing.assert_allclose(_np(tf), np.asarray(jf), atol=2e-4, rtol=2e-4)
    full, _ = TT.decoder_forward(tp, tcfg, torch.as_tensor(b["tokens"]),
                                 patch_embeds=torch.as_tensor(b["patch_embeds"]))
    assert full.shape == (2, tcfg.n_patches + 12, tcfg.vocab_size)
    assert torch.equal(full[:, tcfg.n_patches:], tf)
    jt, _ = jm.forward_logits(jcfg, jp, {"tokens": jnp.asarray(b["tokens"])})
    tt, _ = tm.forward_logits(tcfg, tp, {"tokens": torch.as_tensor(b["tokens"])})
    np.testing.assert_allclose(_np(tt), np.asarray(jt), atol=2e-4, rtol=2e-4)


def test_prefill_and_decode_match_reference():
    """tests/test_decode.py's geometry: 12 text tokens behind the prefix, the
    first 9 prefilled into a cache of 64, then 3 teacher-forced steps from
    n_patches + 9; the KV cache (its positions exactly) and the logits
    against the reference's, and the decode against the forward."""
    jcfg, tcfg, jp, tp = _pair()
    b = _batch(tcfg, 12)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    toks = b["tokens"]
    jl, jcache = jm.prefill(jcfg, jp, dict(jb, tokens=jb["tokens"][:, :9]),
                            jm.init_cache(jcfg, 2, 64))
    tb = _torch(b)
    tl, tcache = tm.prefill(tcfg, tp, dict(tb, tokens=tb["tokens"][:, :9]),
                            tm.init_cache(tcfg, 2, 64, device=CPU))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=2e-4, rtol=2e-4)
    for i, c in enumerate(tcache):
        np.testing.assert_array_equal(c["pos"].numpy(), np.asarray(jcache["layer0"]["pos"][i]))
        assert c["pos"][0, :tcfg.n_patches + 9].tolist() == list(range(tcfg.n_patches + 9))
        for key in ("k", "v"):
            np.testing.assert_allclose(_np(c[key]), np.asarray(jcache["layer0"][key][i]),
                                       atol=2e-4, rtol=2e-4, err_msg=f"layer {i} {key}")
    tf, _ = tm.forward_logits(tcfg, tp, tb)
    np.testing.assert_allclose(_np(tl[:, 0]), _np(tf[:, 8]), atol=2e-4, rtol=2e-4)
    pos0 = tcfg.n_patches + 9
    for t in range(3):
        tok = toks[:, 9 + t:10 + t]
        jl, jcache = jm.decode_step(jcfg, jp, jnp.asarray(tok), jcache, pos0 + t)
        tl, tcache = tm.decode_step(tcfg, tp, torch.as_tensor(tok), tcache, pos0 + t)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=3e-4, rtol=3e-4,
                                   err_msg=f"step {t}")
        np.testing.assert_allclose(_np(tl[:, 0]), _np(tf[:, 9 + t]), atol=3e-4, rtol=3e-4,
                                   err_msg=f"step {t} vs the forward")


def test_launcher_decode_matches_forward_and_the_reference_sizing_does_not(capsys):
    """The port's launcher (B = 2, S0 = 8, 4 tokens, 16 patches): a cache of
    n_patches + S0 + gen + 1 = 29 slots, decode from n_patches + S0 = 24;
    each step's logits against ``forward_logits`` over the prompt and the
    tokens decoded so far, at n_patches + S0 + t, within 3e-4.  Witness: the
    reference's model API at its launcher's sizing (a cache of S0 + gen + 1
    = 13 slots, decode from S0) misses its own forward by more than 0.5."""
    s0, gen = 8, 4
    res = serve.main(["--mode", "lm", "--device", "cpu", "--arch", ARCH, "--variant", "smoke",
                      "--batch", "2", "--prompt_len", str(s0), "--gen", str(gen)])
    assert "behind 16 patches" in capsys.readouterr().out
    cfg, params, prompt, extras = res["cfg"], res["params"], res["prompt"], res["extras"]
    assert res["start"] == cfg.n_patches + s0 == 24
    assert res["prefill_cache"][0]["k"].shape[1] == serve.lm_cache_len(cfg, s0, gen) == 29
    seq = torch.cat([prompt, res["tokens"]], dim=1)
    full, _ = tm.forward_logits(cfg, params, {"tokens": seq, **extras})
    cache = tm.init_cache(cfg, 2, serve.lm_cache_len(cfg, s0, gen), device=CPU)
    logits, cache = tm.prefill(cfg, params, {"tokens": prompt, **extras}, cache)
    np.testing.assert_allclose(_np(logits[:, 0]), _np(full[:, s0 - 1]), atol=2e-4, rtol=2e-4)
    for t in range(gen):
        logits, cache = tm.decode_step(cfg, params, seq[:, s0 + t:s0 + t + 1], cache,
                                       res["start"] + t)
        np.testing.assert_allclose(_np(logits[:, 0]), _np(full[:, s0 + t]), atol=3e-4,
                                   rtol=3e-4, err_msg=f"step {t}")
    # the reference's launcher sizing, through the reference's own model API
    jcfg = j_get_config(ARCH, variant="smoke")
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
    jb = {"tokens": jnp.asarray(seq.numpy()),
          "patch_embeds": jnp.asarray(extras["patch_embeds"].numpy())}
    jfull, _ = jm.forward_logits(jcfg, jp, jb)
    jl, jcache = jm.prefill(jcfg, jp, dict(jb, tokens=jb["tokens"][:, :s0]),
                            jm.init_cache(jcfg, 2, s0 + gen + 1))
    worst = []
    for t in range(gen):
        jl, jcache = jm.decode_step(jcfg, jp, jb["tokens"][:, s0 + t:s0 + t + 1], jcache,
                                    s0 + t)
        worst.append(float(np.abs(np.asarray(jl[:, 0]) - np.asarray(jfull[:, s0 + t])).max()))
    assert max(worst) > 0.5, worst


def test_loss_and_every_gradient_with_patches_match_reference():
    jcfg, tcfg, jp, tp = _pair()
    b = _batch(tcfg, 12)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(lambda p: jm.loss_fn(jcfg, p, b),
                                                has_aux=True))(jp)
    leaves = tree.leaves(tp)
    with torch.enable_grad():
        for p in leaves:
            p.requires_grad_(True)
        tl, tmet = tm.loss_fn(tcfg, tp, _torch(b))
        grads = torch.autograd.grad(tl, leaves)
    assert sorted(tmet) == sorted(jmet) == ["ce", "loss"]
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    names = [n for n, _ in tp.named_parameters()]
    per_layer = len(jax.tree.leaves(jg["blocks"]))
    assert len(names) == len(jax.tree.leaves(jg)) - per_layer + per_layer * tcfg.n_layers
    assert "lm_head" not in names  # tied
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
    assert float(np.abs(np.asarray(jg["blocks"]["layer0"]["attn"]["wq"]["b"])).max()) > 0
