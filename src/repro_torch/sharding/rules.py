"""Divisibility-aware sharding rules of the port (the reference's
``repro.sharding.rules``, leaf by leaf).

Policy, the reference's:
  * tensor parallelism over the ``model`` axis: attention heads, FFN hidden,
    experts (expert parallelism), vocab;
  * data parallelism over (``pod``, ``data``) for activations / batch dims;
  * optional FSDP (cfg.fsdp): the complementary weight dim additionally
    sharded over ``data``;
  * every proposed axis is dropped if it does not divide the dim (a tuple
    of axes first falls back to a prefix).

Optimizer moments inherit the parameter specs.

A spec is a ``P``: a tuple with one entry per dimension, ``None`` (kept
whole), an axis name, or a tuple of names, as ``PartitionSpec`` holds them.
The rules read nothing of the grid but ``grid.shape``, a dict from axis
name to size, exactly as the reference reads its mesh, so any object with
such a ``.shape`` serves (``steps.Grid``, or a stub in a test).

The port holds one module per layer (``layers.{i}.…``, ``enc_layers.{i}.…``,
``dec_layers.{i}.…``) where the reference stacks them on a leading axis, so
a port leaf's spec is the reference's without that axis's leading
``None``; the names and layouts of the two trees meet in
``convert.reference_leaf`` (the SSM projections are bare weights here, the
conv weight is (C, 1, K)).  Caches likewise: a per-layer cache leaf drops
the leading axis, the encoder-decoder's stacked cross K/V keep it.
``param_shapes`` gives a config's leaf names and shapes without making a
weight, so the rules run at full width on any host.
"""

from __future__ import annotations

import math
from typing import Any

from torch import nn

from .. import convert
from ..models.config import ModelConfig


class P(tuple):
    """A ``PartitionSpec`` stand-in: ``P(None, "model") == (None, "model")``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


def data_axes(grid) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in grid.shape)


def _axis_size(grid, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return grid.shape[axes]
    return math.prod(grid.shape[a] for a in axes)


def _fit(dim: int, grid, axes):
    """Return ``axes`` if it divides dim, else None (replicate fallback).

    Single-element tuples are unwrapped to the bare axis name, as the
    reference does (``("data",)`` and ``"data"`` are distinct entries).
    """
    if axes is None:
        return None

    def norm(a):
        if isinstance(a, tuple) and len(a) == 1:
            return a[0]
        return a

    if dim % _axis_size(grid, axes) == 0:
        return norm(axes)
    if isinstance(axes, tuple) and len(axes) > 1:
        # try a prefix (e.g. drop 'pod' but keep 'data')
        for k in range(len(axes) - 1, 0, -1):
            sub = axes[:k]
            if dim % _axis_size(grid, sub) == 0:
                return norm(sub)
    return None


def _param_spec(keys: list[str], shape: tuple[int, ...], grid, cfg: ModelConfig) -> P:
    """Spec for one parameter leaf under the reference's keys and in its
    layout, EXCLUDING any stacked-layer leading axis (the reference's
    ``_param_spec``, case for case)."""
    name = keys[-1]
    ctx = keys[-2] if len(keys) >= 2 else ""
    ctx2 = keys[-3] if len(keys) >= 3 else ""
    fsdp = "data" if cfg.fsdp else None

    def fit(dim, axes):
        return _fit(dim, grid, axes)

    # --- embeddings / heads ---
    if name == "embed":
        return P(fit(shape[0], "model"), fit(shape[1], fsdp))
    if name == "lm_head":
        return P(fit(shape[0], fsdp), fit(shape[1], "model"))
    if name == "dec_pos":
        return P(None, None)

    # --- MoE expert weights: (E, d, f) / (E, f, d); expert parallel on model
    if ctx == "moe" and name in ("wg", "wu") and len(shape) == 3:
        return P(fit(shape[0], "model"), fit(shape[1], fsdp), None)
    if ctx == "moe" and name == "wd" and len(shape) == 3:
        return P(fit(shape[0], "model"), None, fit(shape[2], fsdp))
    if name == "router":
        return P(None, None)

    # --- attention projections ---
    if ctx in ("wq", "wk", "wv") and ctx2 in ("attn", "self_attn", "cross_attn"):
        if name == "w":
            return P(fit(shape[0], fsdp), fit(shape[1], "model"))
        return P(fit(shape[0], "model"))  # bias
    if ctx == "wo" and ctx2 in ("attn", "self_attn", "cross_attn"):
        if name == "w":
            return P(fit(shape[0], "model"), fit(shape[1], fsdp))
        return P(None)

    # --- dense MLP / shared expert: {wg,wu}: (d,f), wd: (f,d) ---
    if ctx in ("wg", "wu") and name == "w":
        return P(fit(shape[0], fsdp), fit(shape[1], "model"))
    if ctx == "wd" and name == "w":
        return P(fit(shape[0], "model"), fit(shape[1], fsdp))
    if ctx in ("wg", "wu", "wd") and name == "b":
        return P(fit(shape[0], "model") if ctx != "wd" else None)

    # --- SSM mixer ---
    if ctx == "in_proj" and name == "w":
        return P(fit(shape[0], fsdp), fit(shape[1], "model"))
    if ctx == "in_proj" and name == "b":
        return P(fit(shape[0], "model"))
    if ctx == "out_proj" and name == "w":
        return P(fit(shape[0], "model"), fit(shape[1], fsdp))
    if ctx == "out_proj" and name == "b":
        return P(None)
    if name == "conv_w":
        return P(None, fit(shape[1], "model"))
    if name == "conv_b":
        return P(fit(shape[0], "model"))
    if name in ("A_log", "D", "dt_bias"):
        return P(fit(shape[0], "model"))
    if name == "norm_scale":
        return P(fit(shape[0], "model"))

    # --- norms and anything else: replicate ---
    return P(*([None] * len(shape)))


def _shape(leaf) -> tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def param_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """The port's parameter names and shapes for ``cfg``, in
    ``init_params(cfg).named_parameters()`` order, without making a weight."""
    d, hd = cfg.d_model, cfg.hd
    out: dict[str, tuple[int, ...]] = {}

    def norm(prefix):
        out[prefix + ".scale"] = (d,)
        if cfg.norm == "layernorm":
            out[prefix + ".bias"] = (d,)

    def dense(prefix, d_in, d_out, bias=False):
        out[prefix + ".w"] = (d_in, d_out)
        if bias:
            out[prefix + ".b"] = (d_out,)

    def attn(prefix):
        hq, hk = cfg.n_heads * hd, cfg.n_kv_heads * hd
        for key, width in (("wq", hq), ("wk", hk), ("wv", hk)):
            dense(f"{prefix}.{key}", d, width, cfg.qkv_bias)
        dense(prefix + ".wo", hq, d)

    def mlp(prefix, f):
        if cfg.act == "silu":
            dense(prefix + ".wg", d, f)
        dense(prefix + ".wu", d, f)
        dense(prefix + ".wd", f, d)

    def moe(prefix):
        e, f = cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
        out[prefix + ".router"] = (d, e)
        for key in (("wg", "wu") if cfg.act == "silu" else ("wu",)):
            out[f"{prefix}.{key}"] = (e, d, f)
        out[prefix + ".wd"] = (e, f, d)
        if cfg.n_shared_experts:
            mlp(prefix + ".shared", f * cfg.n_shared_experts)

    def ssm(prefix):
        di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        c = di + 2 * n
        shapes = {"in_proj": (d, 2 * di + 2 * n + h), "conv_w": (c, 1, cfg.ssm_conv),
                  "conv_b": (c,), "A_log": (h,), "D": (h,), "dt_bias": (h,),
                  "norm_scale": (di,), "out_proj": (di, d)}
        out.update({f"{prefix}.{k}": v for k, v in shapes.items()})

    out["embed"] = (cfg.vocab_size, d)
    if cfg.is_encoder_decoder:
        out["dec_pos"] = (cfg.max_target_positions, d)
        for i in range(cfg.n_encoder_layers):
            p = f"enc_layers.{i}"
            norm(p + ".norm1"), attn(p + ".attn"), norm(p + ".norm2"), mlp(p + ".mlp", cfg.d_ff)
        for i in range(cfg.n_layers):
            p = f"dec_layers.{i}"
            norm(p + ".norm1"), attn(p + ".self_attn"), norm(p + ".norm_x")
            attn(p + ".cross_attn"), norm(p + ".norm2"), mlp(p + ".mlp", cfg.d_ff)
        norm("enc_norm"), norm("dec_norm")
        return out
    if not cfg.tie_embeddings:
        out["lm_head"] = (d, cfg.vocab_size)
    norm("final_norm")
    for i in range(cfg.n_layers):
        p = f"layers.{i}"
        norm(p + ".norm1")
        if cfg.layer_kind(i) == "m":
            ssm(p + ".ssm")
        else:
            attn(p + ".attn")
        if cfg.has_ffn:
            norm(p + ".norm2")
            if cfg.layer_is_moe(i):
                moe(p + ".moe")
            else:
                mlp(p + ".mlp", cfg.d_ff)
    return out


def param_pspecs(cfg: ModelConfig, params: nn.Module | dict, grid) -> dict[str, P]:
    """``{name: P}`` over the port's parameters: a module, or ``{name: shape
    or tensor}`` such as ``param_shapes(cfg)``; the reference's spec of the
    same leaf, without the stacked axis, in the port's layout."""
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    out = {}
    for name, leaf in params.items():
        shape = _shape(leaf)
        key, _, layout = convert.reference_leaf(name, cfg)
        if layout is None:
            out[name] = _param_spec(key.split("."), shape, grid, cfg)
            continue
        ref_shape = [0] * sum(a is not None for a in layout)
        for dim, a in zip(shape, layout):
            if a is not None:
                ref_shape[a] = dim
        spec = _param_spec(key.split("."), tuple(ref_shape), grid, cfg)
        out[name] = P(*(None if a is None else spec[a] for a in layout))
    return out


def opt_state_pspecs(cfg: ModelConfig, opt_state: dict, param_specs: dict[str, P]) -> dict:
    """Moments (``mu``, ``nu``, ``mom``: lists in leaf order) take the
    parameter specs; ``step`` and any other scalar is replicated."""
    specs = list(param_specs.values())
    return {k: list(specs) if k in ("mu", "nu", "mom") else P() for k in opt_state}


def token_pspec(grid, ndim: int = 2) -> P:
    """Batch-sharded spec for (B, S[, ...]) arrays."""
    return P(data_axes(grid), *([None] * (ndim - 1)))


def batch_pspecs(cfg: ModelConfig, batch: dict, grid) -> dict[str, P]:
    """``{key: P}`` for a batch dict of tensors or shapes: the leading (batch)
    dim over the data axes where they divide it."""
    dp = data_axes(grid)
    out = {}
    for key, leaf in batch.items():
        shape = _shape(leaf)
        out[key] = P(_fit(shape[0], grid, dp), *([None] * (len(shape) - 1)))
    return out


def _cache_spec(name: str, shape: tuple[int, ...], grid) -> P:
    """The reference's spec of one cache leaf, ``shape`` with the stacked
    layer axis first.

    kv k/v:   (nb, B, L, K, hd)  -> (None, dp, None, model?, None)
    kv pos:   (nb, B, L)         -> (None, dp, None)
    ssm state:(nb, B, H, P, N)   -> (None, dp, model?, None, None)
    ssm conv: (nb, B, K-1, C)    -> (None, dp, None, model?)
    cross k/v:(nl, B, T, K, hd)  -> like kv
    """
    dp = data_axes(grid)
    bdim = _fit(shape[1], grid, dp)
    if name in ("k", "v", "cross_k", "cross_v") and len(shape) == 5:
        head_ax = _fit(shape[3], grid, "model")
        if head_ax is not None:
            return P(None, bdim, None, head_ax, None)
        # kv heads that do not divide the model axis: the cache LENGTH is
        # sharded instead, as in the reference
        return P(None, bdim, _fit(shape[2], grid, "model"), None, None)
    if name == "pos":
        return P(None, bdim, _fit(shape[2], grid, "model"))
    if name == "state" and len(shape) == 5:
        return P(None, bdim, _fit(shape[2], grid, "model"), None, None)
    if name == "conv" and len(shape) == 4:
        return P(None, bdim, None, _fit(shape[3], grid, "model"))
    return P(*([None] * len(shape)))


def cache_pspecs(cfg: ModelConfig, cache: Any, grid) -> Any:
    """Specs of ``models.init_cache``'s structure: a decoder's list of
    per-layer dicts, or the encoder-decoder's ``{"self": [...], "cross_k",
    "cross_v"}`` (a cache on ``device="meta"`` serves at full width).  A
    leaf in a per-layer dict has no stacked axis; the stacked cross K/V keep
    it."""

    def walk(node, name: str, stacked: bool):
        if isinstance(node, dict):
            return {k: walk(v, k, stacked) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, name, False) for v in node]
        shape = tuple(node.shape)
        if stacked:
            return _cache_spec(name, shape, grid)
        return P(*_cache_spec(name, (1,) + shape, grid)[1:])

    return walk(cache, "", True)
