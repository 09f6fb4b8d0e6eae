"""The second slice end to end: mamba2-370m serving (prefill + greedy decode).

The JAX package's smoke ``mamba2-370m`` (2 layers, d_model 128, 16 SSD
heads of 16, state 16, chunk 8) is initialised from a seed, its parameters
are carried across by ``convert.lm_params_from_numpy``, and the same numpy
tokens go through both packages: the prefill's logits and cache, then four
teacher-forced decode steps, at the reference's own bounds (prefill 2e-4,
decode 3e-4: tests/test_decode.py), with ``ssd_fused`` off and on (on, the
JAX side runs the Pallas kernel in interpret mode and the port its plain
version).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as jm
from repro.configs import get_config as j_get_config
from repro_torch import convert
from repro_torch import models as tm
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.launch import serve

torch.set_num_threads(1)

CPU = "cpu"
PROMPT, STEPS = 9, 4


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pair(fused: bool):
    jcfg = dataclasses.replace(j_get_config("mamba2-370m", variant="smoke"), ssd_fused=fused)
    tcfg = dataclasses.replace(get_config("mamba2-370m", variant="smoke"), ssd_fused=fused)
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                           device=CPU)
    return jcfg, tcfg, jparams, tparams


def _tokens(cfg, b=2, s=PROMPT + STEPS, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def test_smoke_config_matches_reference_field_for_field():
    for variant in ("full", "smoke"):
        assert dataclasses.asdict(get_config("mamba2-370m", variant=variant)) == \
            dataclasses.asdict(j_get_config("mamba2-370m", variant=variant))
    full = get_config("mamba2-370m")
    assert (full.n_layers, full.d_model, full.ssm_heads, full.ssm_state) == (48, 1024, 32, 128)
    assert round(full.n_params() / 1e6, 1) == 368.2


DENSE = ["smollm-135m", "internlm2-1.8b", "nemotron-4-15b", "qwen1.5-32b"]
MOE = ["qwen3-moe-30b-a3b", "llama4-scout-17b-a16e"]
LATER = ["jamba-1.5-large-398b", "qwen2-vl-2b", "whisper-tiny"]  # hybrid, VLM, enc-dec


def test_every_architecture_is_ported():
    assert sorted(DENSE + MOE + LATER + ["mamba2-370m"]) == sorted(ARCH_NAMES)
    for name in ARCH_NAMES:
        assert get_config(name).name == name


@pytest.mark.parametrize("name", DENSE + MOE + LATER)
def test_dense_archs_serve_through_the_launcher(name, capsys):
    """Each config's smoke variant (but mamba2-370m's) through ``--mode lm``
    on the CPU: the launcher's tokens are the model API's greedy decode (with
    the VLM's patch prefix, or the encoder-decoder's frames, that the
    launcher drew), its ``prefill_cache`` is a fresh prefill's (the decode
    steps wrote their slots into the live cache only: from ``n_patches + 11``
    behind the VLM's prefix, from 0 for the encoder-decoder), and ``--engine
    plan`` gives the same logits (bitwise where no Mamba2 layer runs)."""
    argv = ["--mode", "lm", "--device", "cpu", "--arch", name, "--variant", "smoke",
            "--batch", "2", "--prompt_len", "11", "--gen", "3", "--seed", "5"]
    res = serve.main(argv)
    assert f"arch={name}-smoke params=" in capsys.readouterr().out
    cfg, params, prompt, extras = res["cfg"], res["params"], res["prompt"], res["extras"]
    max_seq = serve.lm_cache_len(cfg, 11, 3)
    start = res["start"]
    assert start == (0 if cfg.is_encoder_decoder else cfg.n_patches + 11)
    assert sorted(extras) == (["frames"] if cfg.is_encoder_decoder else
                              ["patch_embeds"] if cfg.n_patches else [])
    want, _ = tm.greedy_decode(cfg, params, prompt, 3, max_seq, batch_extra=extras)
    assert torch.equal(res["tokens"], want)
    _, fresh = tm.prefill(cfg, params, {"tokens": prompt, **extras},
                          tm.init_cache(cfg, 2, max_seq, device=CPU))
    kept_all, live_all = res["prefill_cache"], res["cache"]
    if cfg.is_encoder_decoder:
        for key in ("cross_k", "cross_v"):
            assert torch.equal(kept_all[key], fresh[key])
        kept_all, fresh, live_all = kept_all["self"], fresh["self"], live_all["self"]
    for kept, new, live in zip(kept_all, fresh, live_all):
        if "state" in kept:  # a Mamba2 layer
            assert all(torch.equal(kept[key], new[key]) for key in ("state", "conv"))
            continue
        assert all(torch.equal(kept[key], new[key]) for key in ("k", "v", "pos"))
        assert live["pos"][0, start:start + 3].tolist() == [start, start + 1, start + 2]
        assert kept["pos"][0, start:].tolist() == [-1] * (max_seq - start)
    plain = serve.main(argv + ["--engine", "plan"])
    if cfg.is_encoder_decoder:
        assert res["logits"] is None and torch.equal(plain["tokens"], res["tokens"])
    elif "m" in cfg.pattern:
        torch.testing.assert_close(plain["logits"], res["logits"], atol=1e-5, rtol=1e-5)
    else:
        assert torch.equal(plain["logits"], res["logits"])


@pytest.mark.parametrize("fused", [False, True])
def test_prefill_and_decode_match_reference(fused):
    jcfg, tcfg, jparams, tparams = _pair(fused)
    toks = _tokens(tcfg)
    jcache = jm.init_cache(jcfg, 2, 32)
    jl, jcache = jm.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks[:, :PROMPT])}, jcache)
    tcache = tm.init_cache(tcfg, 2, 32, device=CPU)
    tl, tcache = tm.prefill(tcfg, tparams, {"tokens": torch.as_tensor(toks[:, :PROMPT])},
                            tcache)
    assert tl.shape == (2, 1, tcfg.vocab_size) and len(tcache) == tcfg.n_layers
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=2e-4, rtol=2e-4)
    for i, c in enumerate(tcache):  # the reference stacks layers on a leading axis
        for key in ("state", "conv"):
            np.testing.assert_allclose(_np(c[key]), np.asarray(jcache["layer0"][key][i]),
                                       atol=2e-4, rtol=2e-4, err_msg=f"layer {i} {key}")
    for t in range(STEPS):
        tok = toks[:, PROMPT + t:PROMPT + t + 1]
        jl, jcache = jm.decode_step(jcfg, jparams, jnp.asarray(tok), jcache, PROMPT + t)
        tl, tcache = tm.decode_step(tcfg, tparams, torch.as_tensor(tok), tcache, PROMPT + t)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=3e-4, rtol=3e-4,
                                   err_msg=f"step {t}")


def test_bf16_parameters_carry_across_bitwise():
    """The config's own bf16: JAX's bfloat16 leaves become torch.bfloat16
    tensors with the same bits; the conv weight is (C, 1, K)."""
    jcfg = dataclasses.replace(j_get_config("mamba2-370m", variant="smoke"), dtype="bfloat16")
    tcfg = dataclasses.replace(get_config("mamba2-370m", variant="smoke"), dtype="bfloat16")
    jparams = jax.tree.map(np.asarray, jm.init_params(jcfg, jax.random.PRNGKey(0)))
    tparams = convert.lm_params_from_numpy(jparams, tcfg, device=CPU)
    assert tparams.embed.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(tparams.embed.float()),
                                  np.asarray(jparams["embed"], np.float32))
    ssm1 = jparams["blocks"]["layer0"]["ssm"]
    conv = tparams.layers[1].ssm.conv_w
    assert conv.dtype == torch.bfloat16 and conv.shape == (ssm1["conv_w"].shape[2], 1, 4)
    np.testing.assert_array_equal(_np(conv[:, 0, :].float()).T,
                                  np.asarray(ssm1["conv_w"][1], np.float32))
    assert tparams.layers[0].ssm.A_log.dtype == torch.float32


def test_forward_logits_match_reference():
    jcfg, tcfg, jparams, tparams = _pair(False)
    toks = _tokens(tcfg, s=20)
    jl, _ = jm.forward_logits(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    tl, metrics = tm.forward_logits(tcfg, tparams, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=2e-4, rtol=2e-4)
    assert float(metrics["aux_loss"]) == 0.0


def test_greedy_decode_matches_reference_where_decided():
    """Greedy tokens are compared only where the top-2 logit gap exceeds the
    decode tolerance: the port, teacher-forced with the reference's greedy
    tokens, picks the reference's token at every such step, and the port's own
    greedy run agrees up to the first step that is not so decided."""
    jcfg, tcfg, jparams, tparams = _pair(False)
    prompt = _tokens(tcfg, s=PROMPT)
    n = 6
    jout, _ = jm.greedy_decode(jcfg, jparams, jnp.asarray(prompt), n, 32)
    jout = np.array(jout)
    tcache = tm.init_cache(tcfg, 2, 32, device=CPU)
    tl, tcache = tm.prefill(tcfg, tparams, {"tokens": torch.as_tensor(prompt)}, tcache)
    tok = torch.argmax(tl[:, -1:], dim=-1)
    decided = np.ones(2, bool)  # per row: every step so far was decided
    tout, _ = tm.greedy_decode(tcfg, tparams, torch.as_tensor(prompt), n, 32)
    checked = 0
    for t in range(n):
        tl, tcache = tm.decode_step(tcfg, tparams, tok, tcache, PROMPT + t)
        top2 = torch.topk(tl[:, -1], 2, dim=-1).values
        gap = _np(top2[:, 0] - top2[:, 1])
        pick = _np(torch.argmax(tl[:, -1], dim=-1))
        for r in range(2):
            if gap[r] > 3e-4:
                assert pick[r] == jout[r, t], f"row {r} step {t}"
                checked += 1
            else:
                decided[r] = False
            if decided[r]:
                assert int(tout[r, t]) == jout[r, t], f"row {r} step {t}"
        tok = torch.as_tensor(jout[:, t:t + 1]).long()
    assert checked >= n  # the comparison is not vacuous


def test_lm_launcher_on_cpu(capsys):
    argv = ["--mode", "lm", "--device", "cpu", "--arch", "mamba2-370m", "--variant", "smoke",
            "--batch", "2", "--prompt_len", "11", "--gen", "3", "--seed", "4"]
    res = serve.main(argv)
    printed = capsys.readouterr().out
    for line in ("arch=mamba2-370m-smoke params=0.3M", "prefill: ", "decode: 3 steps",
                 "tok/s", "sample row 0: "):
        assert line in printed
    cfg = res["cfg"]
    assert cfg.ssd_fused and res["prefill_calls"] == 2
    assert res["logits"].shape == (2, 1, cfg.vocab_size)
    assert bool(torch.isfinite(res["logits"]).all())
    assert res["tokens"].shape == (2, 3) and len(res["cache"]) == cfg.n_layers
    # the launcher's answers are the model API's on the same weights and prompt
    want, _ = tm.greedy_decode(cfg, res["params"], res["prompt"], 3, 15)
    assert torch.equal(res["tokens"], want)
    # --engine plan (plain ssd_chunked) on the CPU: the same numbers
    plain = serve.main(argv + ["--engine", "plan"])
    assert not plain["cfg"].ssd_fused
    torch.testing.assert_close(plain["logits"], res["logits"], atol=2e-4, rtol=2e-4)
    with pytest.raises(ValueError, match="--engine cuda or plan"):
        serve.main(argv + ["--engine", "dense"])
