"""The dense slice end to end: the four dense configs served by both
packages (prefill + decode against the KV cache, the forward, greedy
decode), at the smoke variant in float32, with the reference's parameters
carried across by ``convert.lm_params_from_numpy``.

Bounds are the reference's own (tests/test_decode.py): the prefill's
logits and every layer's k/v 2e-4 (the cache's integer ``pos`` exactly),
teacher-forced decode 3e-4, the forward 2e-4; the ring cache (window 8, a
16-token prompt) 3e-4 for the prefill and 4e-4 for the decode steps.
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
from repro_torch.configs import get_config

torch.set_num_threads(1)

CPU = "cpu"
DENSE = ["smollm-135m", "internlm2-1.8b", "nemotron-4-15b", "qwen1.5-32b"]
PROMPT, STEPS = 9, 3


def _np(x):
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pair(arch, seed=1, **over):
    jcfg = dataclasses.replace(j_get_config(arch, variant="smoke"), **over)
    tcfg = dataclasses.replace(get_config(arch, variant="smoke"), **over)
    jparams = jax.tree.map(np.asarray, jm.init_params(jcfg, jax.random.PRNGKey(seed)))
    tparams = convert.lm_params_from_numpy(jparams, tcfg, device=CPU)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, jparams), tparams


def _tokens(cfg, b=2, s=PROMPT + STEPS, seed=2):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def ref_leaf(jtree, name: str) -> np.ndarray:
    """The reference's array for the port's parameter ``name``: layer i of a
    stacked ``blocks.layer0`` leaf, or a top-level one."""
    if not name.startswith("layers."):
        node = jtree
        for key in name.split("."):
            node = node[key]
        return np.asarray(node)
    _, i, rest = name.split(".", 2)
    node = jtree["blocks"]["layer0"]
    for key in rest.split("."):
        node = node[key]
    return np.asarray(node[int(i)])


@pytest.mark.parametrize("arch", DENSE)
def test_configs_match_reference_field_for_field(arch):
    for variant in ("full", "smoke", "long"):
        assert dataclasses.asdict(get_config(arch, variant=variant)) == \
            dataclasses.asdict(j_get_config(arch, variant=variant)), variant
    assert get_config(arch, variant="long").sliding_window == 8192
    full = get_config(arch)
    assert full.n_params() == j_get_config(arch).n_params()
    if arch == "smollm-135m":
        assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads, full.hd,
                full.d_ff, full.vocab_size) == (30, 576, 9, 3, 64, 1536, 49152)
        assert full.tie_embeddings and full.dtype == "bfloat16"
        assert round(full.n_params() / 1e6, 1) == 134.5


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_and_forward_match_reference(arch):
    jcfg, tcfg, jparams, tparams = _pair(arch)
    assert (tparams.lm_head is None) == tcfg.tie_embeddings
    toks = _tokens(tcfg)
    jcache = jm.init_cache(jcfg, 2, 32)
    jl, jcache = jm.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks[:, :PROMPT])}, jcache)
    tcache = tm.init_cache(tcfg, 2, 32, device=CPU)
    tl, tcache = tm.prefill(tcfg, tparams, {"tokens": torch.as_tensor(toks[:, :PROMPT])},
                            tcache)
    assert tl.shape == (2, 1, tcfg.vocab_size) and len(tcache) == tcfg.n_layers
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=2e-4, rtol=2e-4)
    for i, c in enumerate(tcache):  # the reference stacks layers on a leading axis
        np.testing.assert_array_equal(c["pos"].numpy(), np.asarray(jcache["layer0"]["pos"][i]))
        for key in ("k", "v"):
            np.testing.assert_allclose(_np(c[key]), np.asarray(jcache["layer0"][key][i]),
                                       atol=2e-4, rtol=2e-4, err_msg=f"layer {i} {key}")
    for t in range(STEPS):
        tok = toks[:, PROMPT + t:PROMPT + t + 1]
        jl, jcache = jm.decode_step(jcfg, jparams, jnp.asarray(tok), jcache, PROMPT + t)
        tl, tcache = tm.decode_step(tcfg, tparams, torch.as_tensor(tok), tcache, PROMPT + t)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=3e-4, rtol=3e-4,
                                   err_msg=f"step {t}")
    jf, _ = jm.forward_logits(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    tf, metrics = tm.forward_logits(tcfg, tparams, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(_np(tf), np.asarray(jf), atol=2e-4, rtol=2e-4)
    assert float(metrics["aux_loss"]) == 0.0
    # and the port's own decode reproduces its forward (tests/test_decode.py)
    np.testing.assert_allclose(_np(tl[:, 0]), _np(tf[:, -1]), atol=3e-4, rtol=3e-4)


def test_ring_cache_matches_reference():
    """internlm2 smoke with a window of 8: the 16-token prompt wraps the ring
    of 8 slots, then 4 decode steps, against the reference's ring cache and
    its windowed forward."""
    jcfg, tcfg, jparams, tparams = _pair("internlm2-1.8b", seed=3, sliding_window=8)
    toks = _tokens(tcfg, s=20, seed=4)
    jf, _ = jm.forward_logits(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    tf, _ = tm.forward_logits(tcfg, tparams, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(_np(tf), np.asarray(jf), atol=3e-4, rtol=3e-4)
    jcache = jm.init_cache(jcfg, 2, 20)
    tcache = tm.init_cache(tcfg, 2, 20, device=CPU)
    assert tcache[0]["k"].shape[1] == 8  # ring length = window
    jl, jcache = jm.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks[:, :16])}, jcache)
    tl, tcache = tm.prefill(tcfg, tparams, {"tokens": torch.as_tensor(toks[:, :16])}, tcache)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=3e-4, rtol=3e-4)
    np.testing.assert_allclose(_np(tl[:, 0]), _np(tf[:, 15]), atol=3e-4, rtol=3e-4)
    for t in range(4):
        tok = toks[:, 16 + t:17 + t]
        jl, jcache = jm.decode_step(jcfg, jparams, jnp.asarray(tok), jcache, 16 + t)
        tl, tcache = tm.decode_step(tcfg, tparams, torch.as_tensor(tok), tcache, 16 + t)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=4e-4, rtol=4e-4,
                                   err_msg=f"step {t}")
        np.testing.assert_allclose(_np(tl[:, 0]), _np(tf[:, 16 + t]), atol=4e-4, rtol=4e-4,
                                   err_msg=f"step {t} vs the windowed forward")
        for i, c in enumerate(tcache):
            np.testing.assert_array_equal(c["pos"].numpy(),
                                          np.asarray(jcache["layer0"]["pos"][i]))


def test_bf16_leaves_carry_across_bitwise():
    """qwen1.5's smoke in bf16 (q/k/v biases, an untied head): every leaf
    becomes a torch.bfloat16 tensor with the reference's bits, by name."""
    jcfg = dataclasses.replace(j_get_config("qwen1.5-32b", variant="smoke"), dtype="bfloat16")
    tcfg = dataclasses.replace(get_config("qwen1.5-32b", variant="smoke"), dtype="bfloat16")
    jparams = jax.tree.map(np.asarray, jm.init_params(jcfg, jax.random.PRNGKey(0)))
    tparams = convert.lm_params_from_numpy(jparams, tcfg, device=CPU)
    names = [n for n, _ in tparams.named_parameters()]
    # 3 top-level leaves (embed, final_norm, lm_head) + 12 per layer
    assert len(names) == 3 + 12 * tcfg.n_layers
    assert len(jax.tree.leaves(jparams)) == 3 + 12
    for name, p in tparams.named_parameters():
        ref = ref_leaf(jparams, name)
        assert p.dtype == torch.bfloat16 and tuple(p.shape) == ref.shape, name
        np.testing.assert_array_equal(p.view(torch.int16).numpy(), ref.view(np.int16),
                                      err_msg=name)


def test_greedy_decode_matches_reference_where_decided():
    """Greedy tokens are compared only where the top-2 logit gap exceeds the
    decode tolerance (tests/test_torch_lm.py's rule): the port, teacher-forced
    with the reference's greedy tokens, picks the reference's token at every
    such step, and its own greedy run agrees up to the first step that is not
    so decided."""
    jcfg, tcfg, jparams, tparams = _pair("smollm-135m")
    prompt = _tokens(tcfg, s=PROMPT)
    n = 6
    jout = np.array(jm.greedy_decode(jcfg, jparams, jnp.asarray(prompt), n, 32)[0])
    tout, _ = tm.greedy_decode(tcfg, tparams, torch.as_tensor(prompt), n, 32)
    tcache = tm.init_cache(tcfg, 2, 32, device=CPU)
    tl, tcache = tm.prefill(tcfg, tparams, {"tokens": torch.as_tensor(prompt)}, tcache)
    tok = torch.argmax(tl[:, -1:], dim=-1)
    decided = np.ones(2, bool)
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
