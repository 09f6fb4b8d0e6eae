"""The port's sharding rules (``repro_torch.sharding.rules``) against the
reference's (``repro.sharding``), leaf by leaf, with no device and no
process group: the rules read only ``grid.shape``, so one ``FakeMesh`` stub
serves both packages (tests/test_sharding.py's).

  * every port leaf's ``param_pspecs`` is the reference's spec of the same
    leaf on ``jax.eval_shape(init_params)`` at full width, for all ten
    configs on six meshes (the reference's two, and 2 x 2, 1 x 4, 4 x 1
    and 2 x 3, where 3 divides few dims and the rules fall back), without
    the stacked leading ``None`` and in the port's layout; likewise the
    AdamW state's specs, and ``batch_pspecs`` / ``token_pspec`` on the
    reference's train, decode and long-context inputs;
  * ``cache_pspecs`` over the port's ``init_cache`` (on the meta device, at
    the reference's decode_32k shape) for an attention config whose kv
    heads do not divide 16 (qwen1.5-32b), the SSM (mamba2-370m), the
    hybrid (jamba) and the encoder-decoder (whisper-tiny);
  * the reference's own eight cases, asserted on the port;
  * ``param_shapes`` is ``init_params``' names and shapes at every smoke
    variant, and ``convert.reference_leaf`` names, for every port leaf,
    the reference leaf that ``convert.lm_params_from_numpy`` carries into
    it.
No full-width weight is made: the reference's are abstract, the port's are
``param_shapes``.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import input_specs
from repro.models import init_params as j_init_params
from repro.optim import adamw as j_adamw
from repro.optim import cosine_warmup as j_cosine_warmup
from repro.sharding import batch_pspecs as j_batch_pspecs
from repro.sharding import cache_pspecs as j_cache_pspecs
from repro.sharding import opt_state_pspecs as j_opt_state_pspecs
from repro.sharding import param_pspecs as j_param_pspecs
from repro_torch import convert, models
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.sharding import (P, batch_pspecs, cache_pspecs, opt_state_pspecs,
                                  param_pspecs, param_shapes, token_pspec)

torch.set_num_threads(1)


class FakeMesh:
    """Just enough of a Mesh (or a grid) for the divisibility logic."""

    def __init__(self, shape):
        self.shape = shape


MESHES = {"16x16": {"data": 16, "model": 16}, "pod2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2": {"data": 2, "model": 2}, "1x4": {"data": 1, "model": 4},
          "4x1": {"data": 4, "model": 1}, "2x3": {"data": 2, "model": 3}}
MESH = FakeMesh(MESHES["16x16"])
CACHE_ARCHS = ["qwen1.5-32b", "mamba2-370m", "jamba-1.5-large-398b", "whisper-tiny"]


@functools.lru_cache(maxsize=None)
def _abstract(arch):
    cfg = j_get_config(arch)
    return jax.eval_shape(lambda: j_init_params(cfg, jax.random.PRNGKey(0)))


def _node(tree, key):
    for part in key.split("."):
        tree = tree[part]
    return tree


def _ref_param_spec(ref_specs, name, cfg):
    """The reference's spec of the port's leaf ``name``, without the stacked
    axis, in the port's layout."""
    key, index, layout = convert.reference_leaf(name, cfg)
    spec = tuple(_node(ref_specs, key))
    if index is not None:
        assert spec[0] is None, (name, spec)
        spec = spec[1:]
    if layout is not None:
        spec = tuple(None if a is None else spec[a] for a in layout)
    return spec


def _meta(shapes):
    return [torch.empty(s, device="meta") for s in shapes.values()]


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_param_opt_and_batch_specs_are_the_references(arch, mesh):
    grid = FakeMesh(MESHES[mesh])
    jcfg, cfg = j_get_config(arch), get_config(arch)
    ref = j_param_pspecs(jcfg, _abstract(arch), grid)
    shapes = param_shapes(cfg)
    specs = param_pspecs(cfg, shapes, grid)
    assert list(specs) == list(shapes)
    for name, spec in specs.items():
        assert isinstance(spec, P) and len(spec) == len(shapes[name]), name
        assert spec == _ref_param_spec(ref, name, cfg), name
    # a leaf under an axis is divisible by it
    for name, spec in specs.items():
        for dim, axes in zip(shapes[name], spec):
            if axes is not None:
                names = (axes,) if isinstance(axes, str) else axes
                assert dim % np.prod([grid.shape[a] for a in names]) == 0, (name, spec)

    # the optimizer's state: moments take the parameter specs, step replicated
    sched = cosine_warmup(3e-4, 1, 10)
    state = adamw(sched).init(_meta(shapes))
    ospecs = opt_state_pspecs(cfg, state, specs)
    jopt = jax.eval_shape(j_adamw(j_cosine_warmup(3e-4, 1, 10)).init, _abstract(arch))
    jospecs = j_opt_state_pspecs(jcfg, jopt, ref)
    assert sorted(ospecs) == sorted(jospecs) == ["mu", "nu", "step"]
    assert ospecs["step"] == tuple(jospecs["step"]) == ()
    for key in ("mu", "nu"):
        assert len(ospecs[key]) == len(state[key]) == len(shapes)
        for name, spec in zip(shapes, ospecs[key]):
            assert spec == _ref_param_spec(jospecs[key], name, cfg), (key, name)

    # the batch: the reference's train inputs, a decode token and B = 1
    for shape_name in ("train_4k", "prefill_32k"):
        jbatch = input_specs(jcfg, shape_name)
        want = j_batch_pspecs(jcfg, jbatch, grid)
        got = batch_pspecs(cfg, {k: tuple(v.shape) for k, v in jbatch.items()}, grid)
        assert {k: tuple(v) for k, v in want.items()} == got
    for shape_name in ("decode_32k",) + (("long_500k",) if cfg.family == "ssm" else ()):
        token = input_specs(jcfg, shape_name)["token"]
        want = j_batch_pspecs(jcfg, {"t": token}, grid)["t"]
        assert batch_pspecs(cfg, {"t": torch.empty(token.shape, device="meta")}, grid)["t"] \
            == tuple(want)
    dp = tuple(a for a in ("pod", "data") if a in grid.shape)
    assert token_pspec(grid) == (dp, None) and token_pspec(grid, 3) == (dp, None, None)


def _ref_cache_specs(jcfg, grid):
    return j_cache_pspecs(jcfg, input_specs(jcfg, "decode_32k")["cache"], grid)


@pytest.mark.parametrize("arch", CACHE_ARCHS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_cache_specs_are_the_references(arch, mesh):
    grid = FakeMesh(MESHES[mesh])
    jcfg, cfg = j_get_config(arch), get_config(arch)
    ref = _ref_cache_specs(jcfg, grid)
    cache = models.init_cache(cfg, 128, 32768, device="meta")
    got = cache_pspecs(cfg, cache, grid)
    if cfg.is_encoder_decoder:
        assert sorted(got) == sorted(ref) == ["cross_k", "cross_v", "self"]
        for key in ("cross_k", "cross_v"):
            assert got[key] == tuple(ref[key]) and len(got[key]) == cache[key].ndim, key
        layers, leaves, ref_layer = got["self"], cache["self"], lambda i: ref["self"]
    else:
        layers, leaves, ref_layer = got, cache, lambda i: ref[f"layer{i % cfg.block_len}"]
    assert len(layers) == cfg.n_layers
    for i, specs in enumerate(layers):
        want = ref_layer(i)
        assert sorted(specs) == sorted(want), i
        for key, spec in specs.items():
            full = tuple(want[key])
            assert full[0] is None and spec == full[1:], (i, key, spec, full)
            assert len(spec) == leaves[i][key].ndim, (i, key)


# --- the reference's own cases (tests/test_sharding.py), on the port --------


def _port_specs(arch, mesh=MESH, **overrides):
    cfg = dataclasses.replace(get_config(arch), **overrides)
    return param_pspecs(cfg, param_shapes(cfg), mesh)


def test_dense_param_specs_internlm():
    specs = _port_specs("internlm2-1.8b")
    assert specs["embed"] == P("model", None)
    # attn wq (d, H*hd): heads over model (the reference's stacked None dropped)
    assert specs["layers.0.attn.wq.w"] == P(None, "model")
    assert specs["layers.0.attn.wo.w"] == P("model", None)
    assert specs["layers.0.mlp.wg.w"] == P(None, "model")
    assert specs["layers.0.mlp.wd.w"] == P("model", None)
    assert specs["layers.0.norm1.scale"] == P(None)


def test_divisibility_fallback_smollm():
    specs = _port_specs("smollm-135m")
    assert specs["layers.0.attn.wq.w"] == P(None, "model")  # 576 % 16 == 0
    assert specs["embed"] == P("model", None)


def test_fallback_on_truly_indivisible_dims():
    assert _port_specs("internlm2-1.8b", vocab_size=92545)["embed"] == P(None, None)


def test_expert_parallel_specs():
    specs = _port_specs("qwen3-moe-30b-a3b")
    assert specs["layers.0.moe.wu"] == P("model", "data", None)
    assert specs["layers.0.moe.wd"] == P("model", None, "data")
    assert specs["layers.0.moe.router"] == P(None, None)


def test_fsdp_shards_complementary_dim():
    specs = _port_specs("nemotron-4-15b")
    assert specs["layers.0.mlp.wu.w"] == P("data", "model")
    assert specs["layers.0.attn.wo.w"] == P("model", "data")


def test_batch_specs_multipod():
    cfg = get_config("internlm2-1.8b")
    batch = {"tokens": (256, 4096), "labels": (256, 4096), "mask": (256, 4096)}
    assert batch_pspecs(cfg, batch, FakeMesh(MESHES["pod2x16x16"]))["tokens"] \
        == P(("pod", "data"), None)


def test_batch_fallback_batch1():
    assert batch_pspecs(get_config("mamba2-370m"), {"t": (1, 1)}, MESH)["t"] == P(None, None)


def test_cache_specs_ssm_and_attn():
    cfg = get_config("jamba-1.5-large-398b")
    cspecs = cache_pspecs(cfg, models.init_cache(cfg, 128, 32768, device="meta"), MESH)
    # a mamba layer's state (B, H=256, P, N): heads over model
    assert cspecs[0]["state"] == P("data", "model", None, None)
    # the attention layer at pattern index 3: kv heads 8 do not divide 16,
    # so the cache LENGTH is sharded (32768 % 16 == 0)
    assert cspecs[3]["k"] == P("data", "model", None, None)


def test_ssm_leaves_follow_the_ports_layout():
    """The bare SSM projections take the reference's ``in_proj.w`` /
    ``out_proj.w`` specs, the (C, 1, K) conv weight its (K, C) spec
    transposed."""
    specs = _port_specs("jamba-1.5-large-398b")
    assert specs["layers.0.ssm.in_proj"] == P("data", "model")
    assert specs["layers.0.ssm.out_proj"] == P("model", "data")
    assert specs["layers.0.ssm.conv_w"] == P("model", None, None)
    assert specs["layers.0.ssm.A_log"] == P("model")


# --- the shape walk and the leaf mapping, at every smoke variant -----------


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_shapes_is_init_params(arch):
    cfg = get_config(arch, variant="smoke")
    params = models.init_params(cfg, 0, device="cpu")
    assert param_shapes(cfg) == {n: tuple(p.shape) for n, p in params.named_parameters()}


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_reference_leaf_is_the_leaf_convert_carries(arch):
    jcfg, cfg = j_get_config(arch, variant="smoke"), get_config(arch, variant="smoke")
    tree = jax.tree.map(np.asarray, j_init_params(jcfg, jax.random.PRNGKey(0)))
    port = convert.lm_params_from_numpy(tree, cfg, device="cpu")
    for name, p in port.named_parameters():
        key, index, layout = convert.reference_leaf(name, cfg)
        leaf = np.asarray(_node(tree, key))
        leaf = leaf if index is None else leaf[index]
        want = convert.to_port_layout(torch.as_tensor(np.array(leaf)), layout)
        assert torch.equal(p, want), name
