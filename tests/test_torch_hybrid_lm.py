"""The hybrid slice: jamba-1.5-large-398b (Mamba2 and attention layers in a
period of 8, ``m m m a m m m m``, MoE on the odd layers after either kind)
against the reference at its smoke variant (16 layers, two super-blocks of
8), in float32, with the reference's block-stacked parameters carried
across by ``convert.lm_params_from_numpy``.  The training half (loss,
every gradient, three SGD steps) is tests/test_torch_hybrid_train.py.

Bounds are the reference's own: the forward's and the prefill's logits
2e-4 and the teacher-forced decode 3e-4 (tests/test_decode.py, at its
capacity 8.0, where no group drops a token); the summed router metrics
2e-5 abs + rel and ``expert_load`` exactly (tests/test_torch_moe.py's).
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
from repro_torch import convert
from repro_torch import models as tm
from repro_torch.configs import get_config
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T

torch.set_num_threads(1)

CPU = "cpu"
ARCH = "jamba-1.5-large-398b"
PROMPT, STEPS = 9, 3


def _np(x):
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@functools.lru_cache(maxsize=None)
def _ref_params(arch: str, seed: int):
    """The reference's smoke parameters, as numpy (drawn once per module)."""
    jcfg = j_get_config(arch, variant="smoke")
    return jax.tree.map(np.asarray, jm.init_params(jcfg, jax.random.PRNGKey(seed)))


def _pair(arch=ARCH, seed=1, **over):
    jcfg = dataclasses.replace(j_get_config(arch, variant="smoke"), **over)
    tcfg = dataclasses.replace(get_config(arch, variant="smoke"), **over)
    jparams = _ref_params(arch, seed)
    tparams = convert.lm_params_from_numpy(jparams, tcfg, device=CPU)
    return jcfg, tcfg, jparams, tparams


def _tokens(cfg, b=2, s=PROMPT + STEPS, seed=2):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def ref_leaf(jtree, cfg, name: str) -> np.ndarray:
    """The reference's array for the port's parameter ``name``, in the port's
    layout: layer i is slot ``i % block_len`` of block ``i // block_len``; a
    mixer's bare ``in_proj`` / ``out_proj`` are the reference's ``.w``, its
    ``conv_w`` (K, C) is ``F.conv1d``'s (C, 1, K)."""
    node, rest = jtree, name
    if name.startswith("layers."):
        _, i, rest = name.split(".", 2)
        i = int(i)
        node = jtree["blocks"][f"layer{i % cfg.block_len}"]
    if rest in ("ssm.in_proj", "ssm.out_proj"):
        rest += ".w"
    for key in rest.split("."):
        node = node[key]
    out = np.asarray(node if rest == name else node[i // cfg.block_len])
    return out.T[:, None, :] if rest == "ssm.conv_w" else out


def test_config_matches_reference_field_for_field():
    for variant in ("full", "smoke", "long"):
        assert dataclasses.asdict(get_config(ARCH, variant=variant)) == \
            dataclasses.asdict(j_get_config(ARCH, variant=variant)), variant
    full = get_config(ARCH)
    assert full.n_params() == j_get_config(ARCH).n_params()
    assert full.n_active_params() == j_get_config(ARCH).n_active_params()
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads, full.hd, full.d_ff,
            full.n_experts, full.top_k, full.vocab_size) == \
        (72, 8192, 64, 8, 128, 24576, 16, 2, 65536)
    assert full.pattern == ("m", "m", "m", "a", "m", "m", "m", "m") and full.block_len == 8
    assert (full.d_inner, full.ssm_heads, full.ssm_head_dim, full.ssm_state,
            full.ssm_chunk) == (16384, 256, 64, 128, 256)
    assert [full.layer_is_moe(i) for i in range(8)] == [False, True] * 4
    assert full.family == "hybrid" and full.has_ffn and full.dtype == "bfloat16"
    smoke = get_config(ARCH, variant="smoke")
    assert (smoke.n_layers, smoke.n_blocks, smoke.ssm_heads) == (16, 2, 16)


def test_block_stacked_parameters_carry_across_by_slot():
    """n_blocks = 2: the port's layer i holds slot i % 8 of block i // 8,
    every leaf by name (mixer or attention, MLP or MoE under the reference's
    keys), bitwise."""
    _, tcfg, jparams, tparams = _pair()
    kinds = [type(layer).__name__ for layer in tparams.layers]
    assert kinds == ["MixerLayer" if k == "m" else "AttnLayer"
                     for k in tcfg.pattern] * 2
    for i, layer in enumerate(tparams.layers):
        assert hasattr(layer, "moe") == tcfg.layer_is_moe(i)
        assert hasattr(layer, "mlp") != tcfg.layer_is_moe(i)
    names = [n for n, _ in tparams.named_parameters()]
    per_block = len(jax.tree.leaves(jparams["blocks"]))
    assert len(names) == len(jax.tree.leaves(jparams)) - per_block + per_block * tcfg.n_blocks
    for name, p in tparams.named_parameters():
        np.testing.assert_array_equal(_np(p), ref_leaf(jparams, tcfg, name), err_msg=name)
    with pytest.raises(ValueError, match="leading axis"):
        bad = jax.tree.map(lambda a: a, jparams)
        bad["blocks"]["layer3"] = jax.tree.map(lambda a: a[:1], bad["blocks"]["layer3"])
        convert.lm_params_from_numpy(bad, tcfg, device=CPU)


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-370m", "qwen3-moe-30b-a3b"])
def test_block_len_one_configs_convert_as_before(arch):
    """block_len = 1: layer i is ``blocks.layer0[i]``, as before the hybrid."""
    _, tcfg, jparams, tparams = _pair(arch)
    assert tcfg.block_len == 1 and tcfg.n_blocks == tcfg.n_layers
    for name, p in tparams.named_parameters():
        np.testing.assert_array_equal(_np(p), ref_leaf(jparams, tcfg, name), err_msg=name)


def test_forward_logits_and_router_metrics_match_reference():
    """At the config's own capacity (1.25): the logits, and the router
    metrics summed over all 8 MoE layers, 6 of them after a Mamba2 mixer."""
    jcfg, tcfg, jparams, tparams = _pair()
    moe_after = [tcfg.layer_kind(i) for i in range(tcfg.n_layers) if tcfg.layer_is_moe(i)]
    assert moe_after.count("m") == 6 and moe_after.count("a") == 2
    toks = _tokens(tcfg)
    jf, jmet = jm.forward_logits(jcfg, jax.tree.map(jnp.asarray, jparams),
                                 {"tokens": jnp.asarray(toks)})
    tf, tmet = tm.forward_logits(tcfg, tparams, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(_np(tf), np.asarray(jf), atol=2e-4, rtol=2e-4)
    for key in ("aux_loss", "z_loss"):
        np.testing.assert_allclose(_np(tmet[key]), np.asarray(jmet[key]), atol=2e-5, rtol=2e-5,
                                   err_msg=key)
    np.testing.assert_array_equal(_np(tmet["expert_load"]), np.asarray(jmet["expert_load"]))
    n_moe = len(moe_after)
    assert float(tmet["expert_load"].sum()) == n_moe * toks.size * tcfg.top_k
    assert float(tmet["aux_loss"]) >= n_moe * (1.0 - 1e-3)  # >= 1 per MoE layer


def test_prefill_decode_match_reference_at_drop_free_capacity():
    jcfg, tcfg, jparams, tparams = _pair(capacity_factor=8.0)
    jparams = jax.tree.map(jnp.asarray, jparams)
    toks = _tokens(tcfg)
    # the reference's prefill and decode step, compiled (one program each)
    jprefill = jax.jit(lambda p, t, c: jm.prefill(jcfg, p, {"tokens": t}, c))
    jdecode = jax.jit(lambda p, t, c, pos: jm.decode_step(jcfg, p, t, c, pos))
    jcache = jm.init_cache(jcfg, 2, 32)
    jl, jcache = jprefill(jparams, jnp.asarray(toks[:, :PROMPT]), jcache)
    tcache = tm.init_cache(tcfg, 2, 32, device=CPU)
    tl, tcache = tm.prefill(tcfg, tparams, {"tokens": torch.as_tensor(toks[:, :PROMPT])},
                            tcache)
    assert tl.shape == (2, 1, tcfg.vocab_size) and len(tcache) == tcfg.n_layers
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=2e-4, rtol=2e-4)
    for i, c in enumerate(tcache):  # slot i % 8 of block i // 8
        ref = jcache[f"layer{i % tcfg.block_len}"]
        keys = ("state", "conv") if tcfg.layer_kind(i) == "m" else ("k", "v")
        assert sorted(c) == sorted(ref)
        for key in keys:
            np.testing.assert_allclose(_np(c[key]), np.asarray(ref[key][i // tcfg.block_len]),
                                       atol=2e-4, rtol=2e-4, err_msg=f"layer {i} {key}")
    tf, _ = tm.forward_logits(tcfg, tparams, {"tokens": torch.as_tensor(toks)})
    for t in range(STEPS):
        tok = toks[:, PROMPT + t:PROMPT + t + 1]
        jl, jcache = jdecode(jparams, jnp.asarray(tok), jcache, PROMPT + t)
        tl, tcache = tm.decode_step(tcfg, tparams, torch.as_tensor(tok), tcache, PROMPT + t)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=3e-4, rtol=3e-4,
                                   err_msg=f"step {t}")
        np.testing.assert_allclose(_np(tl[:, 0]), _np(tf[:, PROMPT + t]), atol=3e-4,
                                   rtol=3e-4, err_msg=f"step {t} vs the forward")


def test_fused_prefill_routes_every_mixer_through_ssd_chunked_fused(monkeypatch):
    """ssd_fused=True: the prefill calls ``ops.ssd_chunked_fused`` once per
    Mamba2 layer (14 of 16; on the CPU its plain version) and gives the
    plain route's logits."""
    from repro_torch.kernels import ops

    _, tcfg, _, tparams = _pair(capacity_factor=8.0)
    toks = torch.as_tensor(_tokens(tcfg)[:, :PROMPT])
    calls = []
    inner = ops.ssd_chunked_fused
    monkeypatch.setattr(S, "ssd_chunked_fused", lambda *a, **k: calls.append(1) or inner(*a, **k))
    fused = dataclasses.replace(tcfg, ssd_fused=True)
    got, _ = tm.prefill(fused, tparams, {"tokens": toks}, tm.init_cache(fused, 2, 16, device=CPU))
    assert len(calls) == sum(k == "m" for k in (tcfg.layer_kind(i) for i in range(16))) == 14
    want, _ = tm.prefill(tcfg, tparams, {"tokens": toks}, tm.init_cache(tcfg, 2, 16, device=CPU))
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)


def test_mixer_layers_hold_an_ffn_only_where_the_config_has_one():
    """mamba2-370m's mixers hold no FFN (d_ff = 0); jamba's hold norm2 and an
    MLP or MoE under the reference's keys."""
    pure = tm.init_params(get_config("mamba2-370m", variant="smoke"), device=CPU)
    assert all(not hasattr(layer, "norm2") for layer in pure.layers)
    hyb = tm.init_params(get_config(ARCH, variant="smoke"), device=CPU)
    assert all(isinstance(layer, T.MixerLayer) == (k == "m")
               for layer, k in zip(hyb.layers, get_config(ARCH).pattern * 2))
    assert [n for n, _ in hyb.layers[1].named_children()] == ["norm1", "ssm", "norm2", "moe"]
    assert [n for n, _ in hyb.layers[3].named_children()] == ["norm1", "attn", "norm2", "moe"]
    assert [n for n, _ in hyb.layers[0].named_children()] == ["norm1", "ssm", "norm2", "mlp"]
