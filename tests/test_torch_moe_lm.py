"""The MoE slice end to end: the two MoE configs field for field, and their
smoke variants served by both packages (the forward with its router
metrics summed over layers, prefill + decode against the KV cache), in
float32, with the reference's parameters carried across by
``convert.lm_params_from_numpy``.

Bounds are the reference's own (tests/test_decode.py): the forward's and
the prefill's logits and every layer's k/v 2e-4 (the cache's integer
``pos`` exactly), teacher-forced decode 3e-4; ``aux_loss`` and ``z_loss``
2e-5 abs + rel and ``expert_load`` exactly (tests/test_torch_moe.py's).
Prefill and decode run at ``capacity_factor = 8.0``, as the reference's
decode test does: no group drops a token, so the decode steps may be held
to the forward.
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
MOE = ["qwen3-moe-30b-a3b", "llama4-scout-17b-a16e"]
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


@pytest.mark.parametrize("arch", MOE)
def test_configs_match_reference_field_for_field(arch):
    for variant in ("full", "smoke", "long"):
        assert dataclasses.asdict(get_config(arch, variant=variant)) == \
            dataclasses.asdict(j_get_config(arch, variant=variant)), variant
    full = get_config(arch)
    assert full.n_params() == j_get_config(arch).n_params()
    assert full.n_active_params() == j_get_config(arch).n_active_params()
    assert full.family == "moe" and full.dtype == "bfloat16" and not full.tie_embeddings
    assert all(full.layer_is_moe(i) for i in range(full.n_layers))
    if arch == "qwen3-moe-30b-a3b":
        assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads, full.hd,
                full.n_experts, full.top_k, full.moe_d_ff, full.n_shared_experts,
                full.vocab_size) == (48, 2048, 32, 4, 128, 128, 8, 768, 0, 151936)
        assert full.n_params() == 30_532_110_336
    else:
        assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads, full.hd,
                full.n_experts, full.top_k, full.moe_d_ff, full.n_shared_experts,
                full.vocab_size) == (48, 5120, 40, 8, 128, 16, 1, 8192, 1, 202048)
        assert full.n_params() == 107_769_861_120


@pytest.mark.parametrize("arch", MOE)
def test_forward_logits_and_summed_metrics_match_reference(arch):
    """At the config's own capacity (1.25): the forward over 2 x 12 tokens
    (one group of 24), its logits and the router metrics summed over both
    MoE layers."""
    jcfg, tcfg, jparams, tparams = _pair(arch)
    assert [n for n, _ in tparams.named_parameters() if ".moe.router" in n] == \
        [f"layers.{i}.moe.router" for i in range(tcfg.n_layers)]
    toks = _tokens(tcfg)
    jf, jmet = jm.forward_logits(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    tf, tmet = tm.forward_logits(tcfg, tparams, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(_np(tf), np.asarray(jf), atol=2e-4, rtol=2e-4)
    for key in ("aux_loss", "z_loss"):
        np.testing.assert_allclose(_np(tmet[key]), np.asarray(jmet[key]), atol=2e-5, rtol=2e-5,
                                   err_msg=key)
    np.testing.assert_array_equal(_np(tmet["expert_load"]), np.asarray(jmet["expert_load"]))
    # summed over the layers: every token's k assignments, in each layer
    assert float(tmet["expert_load"].sum()) == tcfg.n_layers * toks.size * tcfg.top_k
    assert float(tmet["aux_loss"]) >= tcfg.n_layers * (1.0 - 1e-3)  # >= 1 per layer


@pytest.mark.parametrize("arch", MOE)
def test_prefill_decode_match_reference_at_drop_free_capacity(arch):
    jcfg, tcfg, jparams, tparams = _pair(arch, capacity_factor=8.0)
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
    tf, _ = tm.forward_logits(tcfg, tparams, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(_np(tl[:, 0]), _np(tf[:, PROMPT - 1]), atol=2e-4, rtol=2e-4)
    for t in range(STEPS):
        tok = toks[:, PROMPT + t:PROMPT + t + 1]
        jl, jcache = jm.decode_step(jcfg, jparams, jnp.asarray(tok), jcache, PROMPT + t)
        tl, tcache = tm.decode_step(tcfg, tparams, torch.as_tensor(tok), tcache, PROMPT + t)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=3e-4, rtol=3e-4,
                                   err_msg=f"step {t}")
        # and the port's own decode reproduces its forward (tests/test_decode.py)
        np.testing.assert_allclose(_np(tl[:, 0]), _np(tf[:, PROMPT + t]), atol=3e-4,
                                   rtol=3e-4, err_msg=f"step {t} vs the forward")


def test_bf16_leaves_carry_across_bitwise_with_a_float32_router():
    """llama4-scout's smoke in bf16 (top-1, a shared expert, an untied head):
    every leaf becomes a tensor with the reference's bits, by name; the
    router stays float32."""
    jcfg = dataclasses.replace(j_get_config("llama4-scout-17b-a16e", variant="smoke"),
                               dtype="bfloat16")
    tcfg = dataclasses.replace(get_config("llama4-scout-17b-a16e", variant="smoke"),
                               dtype="bfloat16")
    jparams = jax.tree.map(np.asarray, jm.init_params(jcfg, jax.random.PRNGKey(0)))
    tparams = convert.lm_params_from_numpy(jparams, tcfg, device=CPU)
    # 3 top-level leaves (embed, final_norm, lm_head) + 4 attention + 2 norms
    # + router, wg, wu, wd + 3 shared-expert leaves per layer
    assert len(list(tparams.parameters())) == 3 + 13 * tcfg.n_layers
    assert len(jax.tree.leaves(jparams)) == 3 + 13
    for name, p in tparams.named_parameters():
        node = jparams
        rest = name
        if name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            node = jparams["blocks"]["layer0"]
        for key in rest.split("."):
            node = node[key]
        ref = np.asarray(node if rest == name else node[int(i)])
        assert tuple(p.shape) == ref.shape, name
        if name.endswith("moe.router"):
            assert p.dtype == torch.float32 and ref.dtype == np.float32
            np.testing.assert_array_equal(p.numpy(), ref, err_msg=name)
        else:
            assert p.dtype == torch.bfloat16, name
            np.testing.assert_array_equal(p.view(torch.int16).numpy(), ref.view(np.int16),
                                          err_msg=name)
