"""Carry a problem, state, serving plan or LM parameters across as numpy arrays.

The reference's ``SNTrainProblem``, ``SNTrainState`` and ``ServingPlan``
leaves, read out as numpy arrays, become the port's dataclasses on
``device``.  Keys are the field names; nested dataclasses use a dotted
prefix (``"topology.positions"``, ``"layout.slot_owner"``).  Static fields
(``n_stream``, ``topology.n_colors``, ``grid_shape``, ``k``, ...) are
plain Python values in the same dict.  The reference's LM parameter tree
becomes the port's ``Decoder`` or, for an encoder-decoder, ``EncDec``
(``lm_params_from_numpy``), one attention, MLP or MoE tree an
``Attention``, ``MLP`` or ``MoE``.  Dtypes are kept as given.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import device as _device
from .core.kernels_math import Kernel
from .core.plans import LifecycleLayout
from .core.serving import ServingPlan
from .core.sn_train import SNTrainProblem, SNTrainState
from .core.topology import SensorTopology
from .models import layers as L
from .models import encdec as ED
from .models import ssm as S
from .models import transformer as T
from .models.config import ModelConfig

_STATIC = {"n_colors": int, "n_base": int, "radius": float, "n_recolor": int,
           "n_stream": int, "k": int, "grid_shape": tuple}


def _build(cls, d: dict, prefix: str, dev: torch.device, **given):
    kw = dict(given)
    for f in dataclasses.fields(cls):
        if f.name in kw:
            continue
        key = prefix + f.name
        if key not in d:
            if f.default is dataclasses.MISSING:
                raise KeyError(f"missing {key!r}")
            continue
        v = d[key]
        if f.name in _STATIC:
            kw[f.name] = _STATIC[f.name](np.asarray(v).tolist())
        else:
            kw[f.name] = torch.as_tensor(np.array(v), device=dev)  # a writable copy
    return cls(**kw)


def problem_from_numpy(
    d: dict, *, kernel: Kernel, device: str | torch.device = "cuda"
) -> SNTrainProblem:
    """An ``SNTrainProblem`` on ``device`` from the reference's leaves."""
    dev = _device.resolve(device)
    topo = _build(SensorTopology, d, "topology.", dev)
    layout = _build(LifecycleLayout, d, "layout.", dev)
    return _build(SNTrainProblem, d, "", dev, topology=topo, layout=layout, kernel=kernel)


def state_from_numpy(d: dict, *, device: str | torch.device = "cuda") -> SNTrainState:
    """An ``SNTrainState`` on ``device`` from ``{"z": ..., "coef": ...}``."""
    return _build(SNTrainState, d, "", _device.resolve(device))


def serving_plan_from_numpy(d: dict, *, device: str | torch.device = "cuda") -> ServingPlan:
    """A ``ServingPlan`` on ``device`` from the reference's leaves."""
    return _build(ServingPlan, d, "", _device.resolve(device))


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for key, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{key}."))
        else:
            out[prefix + key] = v
    return out


def _tensor(v, dev: torch.device) -> torch.Tensor:
    a = np.array(v)  # a writable copy
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, as JAX hands it out
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(dev)
    return torch.as_tensor(a, device=dev)


# an SSM mixer's leaves: the port's name -> the reference's key under ``ssm``
SSM_KEYS = {"in_proj": "in_proj.w", "conv_w": "conv_w", "conv_b": "conv_b", "A_log": "A_log",
            "D": "D", "dt_bias": "dt_bias", "norm_scale": "norm_scale",
            "out_proj": "out_proj.w"}

# the leaves whose layout is not the reference's: axis i of the port's leaf
# is the reference's axis ``LAYOUTS[name][i]``, None a new axis of length 1
# (the conv weight: ``F.conv1d``'s (C, 1, K) from the reference's (K, C))
LAYOUTS = {"conv_w": (1, None, 0)}


def to_port_layout(x: torch.Tensor, layout: tuple | None) -> torch.Tensor:
    """``x`` in the reference's layout, laid out as the port holds it."""
    if layout is None:
        return x
    y = x.permute(*(a for a in layout if a is not None))
    for i, a in enumerate(layout):
        if a is None:
            y = y.unsqueeze(i)
    return y.contiguous()


def _slot(cfg: ModelConfig, i: int) -> tuple[int, int]:
    """Decoder layer ``i``'s (slot, block): the reference stacks it as slot
    ``i % block_len`` of block ``i // block_len``."""
    return i % cfg.block_len, i // cfg.block_len


def reference_leaf(name: str, cfg: ModelConfig) -> tuple[str, int | None, tuple | None]:
    """(the reference's dotted key, the index on its stacked layer axis or
    None, the port's layout or None) of the port's parameter ``name``.

    ``layers.{i}.X`` is ``blocks.layer{i % block_len}.X`` at block
    ``i // block_len``, ``enc_layers.{i}.X`` / ``dec_layers.{i}.X`` are
    ``enc_layers.X`` / ``dec_layers.X`` at ``i``, an SSM leaf takes its
    key from ``SSM_KEYS``; every other name is the reference's key.
    """
    root, _, rest = name.partition(".")
    index = None
    if root == "layers":
        i, _, rest = rest.partition(".")
        slot, index = _slot(cfg, int(i))
        root = f"blocks.layer{slot}"
    elif root in ("enc_layers", "dec_layers"):
        i, _, rest = rest.partition(".")
        index = int(i)
    layout = None
    if rest.startswith("ssm."):
        leaf = rest[len("ssm."):]
        rest, layout = "ssm." + SSM_KEYS[leaf], LAYOUTS.get(leaf)
    return (f"{root}.{rest}" if rest else root), index, layout


def ssm_mixer_from_numpy(tree: dict, *, device: str | torch.device = "cuda") -> S.SSMMixer:
    """One mixer's ``SSMMixer`` on ``device`` from the reference's ``ssm_init``
    tree (``in_proj.w``, ``conv_w``, ...) read out as numpy: the leaves of
    ``SSM_KEYS``, in the port's ``LAYOUTS`` (the conv weight turns from the
    reference's (K, C) into ``F.conv1d``'s (C, 1, K); nothing else is
    transposed).
    """
    dev = _device.resolve(device)
    flat = _flatten(tree)
    return S.SSMMixer(**{name: to_port_layout(_tensor(flat[key], dev), LAYOUTS.get(name))
                         for name, key in SSM_KEYS.items()})


def _dense(flat: dict, prefix: str, dev: torch.device) -> L.Dense:
    b = flat.get(prefix + ".b")
    return L.Dense(_tensor(flat[prefix + ".w"], dev), None if b is None else _tensor(b, dev))


def attention_from_numpy(tree: dict, *, device: str | torch.device = "cuda") -> L.Attention:
    """One ``Attention`` on ``device`` from the reference's ``attn_init`` tree
    (``wq.w``, ``wq.b``, ...) read out as numpy; nothing is transposed."""
    dev = _device.resolve(device)
    flat = _flatten(tree)
    return L.Attention(*(_dense(flat, name, dev) for name in ("wq", "wk", "wv", "wo")))


def mlp_from_numpy(tree: dict, *, device: str | torch.device = "cuda") -> L.MLP:
    """One ``MLP`` on ``device`` from the reference's ``mlp_init`` tree."""
    dev = _device.resolve(device)
    flat = _flatten(tree)
    wg = _dense(flat, "wg", dev) if "wg.w" in flat else None
    return L.MLP(_dense(flat, "wu", dev), _dense(flat, "wd", dev), wg)


def _sub(d: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


def moe_from_numpy(tree: dict, *, device: str | torch.device = "cuda") -> L.MoE:
    """One ``MoE`` on ``device`` from the reference's ``moe_init`` tree: the
    bare arrays ``router`` (float32), ``wg`` (SwiGLU only), ``wu`` and
    ``wd``, and ``shared.{wg,wu,wd}.w`` where there is a shared expert."""
    dev = _device.resolve(device)
    flat = _flatten(tree)
    shared = _sub(flat, "shared.")
    return L.MoE(_tensor(flat["router"], dev), _tensor(flat["wu"], dev),
                 _tensor(flat["wd"], dev),
                 _tensor(flat["wg"], dev) if "wg" in flat else None,
                 mlp_from_numpy(shared, device=dev) if shared else None)


def _norm(flat: dict, prefix: str, dev: torch.device) -> L.RMSNorm | L.LayerNorm:
    """``{prefix}.scale``, and ``{prefix}.bias`` where the norm is a LayerNorm."""
    bias = flat.get(prefix + ".bias")
    scale = _tensor(flat[prefix + ".scale"], dev)
    return L.RMSNorm(scale) if bias is None else L.LayerNorm(scale, _tensor(bias, dev))


def _unstack(flat: dict, prefix: str, n: int) -> list[dict]:
    """The ``n`` slices of every leaf under ``prefix`` (a leading axis of n)."""
    stacked = {k: np.asarray(v) for k, v in _sub(flat, prefix).items()}
    for key, v in stacked.items():
        if v.shape[0] != n:
            raise ValueError(f"{prefix}{key}: leading axis {v.shape[0]}, expected {n}")
    return [{k: v[i] for k, v in stacked.items()} for i in range(n)]


def _layer(one: dict, cfg: ModelConfig, i: int, dev: torch.device):
    """Decoder layer ``i`` from its leaves (``norm1.scale``, ``ssm.*`` or
    ``attn.*``, and ``norm2.scale`` with ``mlp.*`` or ``moe.*`` where the
    layer has an FFN)."""
    ffn = None
    if cfg.has_ffn:
        ffn = (moe_from_numpy(_sub(one, "moe."), device=dev) if cfg.layer_is_moe(i)
               else mlp_from_numpy(_sub(one, "mlp."), device=dev))
    norm1 = _norm(one, "norm1", dev)
    norm2 = _norm(one, "norm2", dev) if ffn is not None else None
    if cfg.layer_kind(i) == "m":
        return T.MixerLayer(norm1, ssm_mixer_from_numpy(_sub(one, "ssm."), device=dev),
                            norm2, ffn)
    return T.AttnLayer(norm1, attention_from_numpy(_sub(one, "attn."), device=dev), norm2, ffn)


def lm_params_from_numpy(
    tree: dict, cfg: ModelConfig, *, device: str | torch.device = "cuda"
) -> T.Decoder | ED.EncDec:
    """The port's ``Decoder`` on ``device`` from the reference's parameter
    tree, or its ``EncDec`` for an encoder-decoder config
    (``encdec_params_from_numpy``).

    ``tree`` is the reference's ``init_params`` output read out as numpy
    (nested dicts, or one dict with dotted keys): ``embed``,
    ``final_norm.scale``, ``lm_head`` where the head is untied, and
    ``blocks.layer{j}.*`` for j < ``cfg.block_len``, each with a leading
    ``n_blocks`` axis: layer i is slot ``i % block_len`` of block
    ``i // block_len``.  A layer holds ``norm1.scale`` and ``ssm.*`` (a
    mixer) or ``attn.{wq,wk,wv,wo}.{w,b}``; where the config has an FFN,
    ``norm2.scale`` and ``mlp.{wg,wu,wd}.w`` or, where
    ``cfg.layer_is_moe(i)``, ``moe.{router,wg,wu,wd}`` and
    ``moe.shared.{wg,wu,wd}.w``.
    """
    if cfg.is_encoder_decoder:
        return encdec_params_from_numpy(tree, cfg, device=device)
    dev = _device.resolve(device)
    flat = _flatten(tree)
    slots = [_unstack(flat, f"blocks.layer{j}.", cfg.n_blocks) for j in range(cfg.block_len)]
    layers = []
    for i in range(cfg.n_layers):
        slot, block = _slot(cfg, i)
        layers.append(_layer(slots[slot][block], cfg, i, dev))
    head = flat.get("lm_head")
    return T.Decoder(_tensor(flat["embed"], dev), _norm(flat, "final_norm", dev), layers,
                     None if head is None else _tensor(head, dev))


def encdec_params_from_numpy(
    tree: dict, cfg: ModelConfig, *, device: str | torch.device = "cuda"
) -> ED.EncDec:
    """The port's ``EncDec`` on ``device`` from the reference's
    ``init_encdec_params`` tree: ``embed``, ``dec_pos``, ``enc_norm.*`` and
    ``dec_norm.*``, and ``enc_layers.*`` / ``dec_layers.*`` stacked on a
    leading layer axis (``norm1``, ``attn`` / ``self_attn``, ``norm_x``,
    ``cross_attn``, ``norm2``, ``mlp``); a LayerNorm has ``scale`` and
    ``bias``."""
    dev = _device.resolve(device)
    flat = _flatten(tree)

    def attn(one, key):
        return attention_from_numpy(_sub(one, key + "."), device=dev)

    def mlp(one):
        return mlp_from_numpy(_sub(one, "mlp."), device=dev)

    enc = [ED.EncLayer(_norm(one, "norm1", dev), attn(one, "attn"), _norm(one, "norm2", dev),
                       mlp(one))
           for one in _unstack(flat, "enc_layers.", cfg.n_encoder_layers)]
    dec = [ED.DecLayer(_norm(one, "norm1", dev), attn(one, "self_attn"),
                       _norm(one, "norm_x", dev), attn(one, "cross_attn"),
                       _norm(one, "norm2", dev), mlp(one))
           for one in _unstack(flat, "dec_layers.", cfg.n_layers)]
    return ED.EncDec(_tensor(flat["embed"], dev), _tensor(flat["dec_pos"], dev), enc, dec,
                     _norm(flat, "enc_norm", dev), _norm(flat, "dec_norm", dev))
