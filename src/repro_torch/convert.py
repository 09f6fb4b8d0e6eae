"""Carry a problem, state, serving plan or LM parameters across as numpy arrays.

The reference's ``SNTrainProblem``, ``SNTrainState`` and ``ServingPlan``
leaves, read out as numpy arrays, become the port's dataclasses on
``device``.  Keys are the field names; nested dataclasses use a dotted
prefix (``"topology.positions"``, ``"layout.slot_owner"``).  Static fields
(``n_stream``, ``topology.n_colors``, ``grid_shape``, ``k``, ...) are
plain Python values in the same dict.  The reference's LM parameter tree
becomes the port's ``Decoder`` (``lm_params_from_numpy``), one attention,
MLP or MoE tree an ``Attention``, ``MLP`` or ``MoE``.  Dtypes are kept as
given.
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


def ssm_mixer_from_numpy(tree: dict, *, device: str | torch.device = "cuda") -> S.SSMMixer:
    """One mixer's ``SSMMixer`` on ``device`` from the reference's ``ssm_init``
    tree (``in_proj.w``, ``conv_w``, ...) read out as numpy.

    The conv weight turns from the reference's (K, C) into ``F.conv1d``'s
    (C, 1, K); nothing else is transposed.
    """
    dev = _device.resolve(device)
    flat = _flatten(tree)
    return S.SSMMixer(
        in_proj=_tensor(flat["in_proj.w"], dev),
        conv_w=_tensor(flat["conv_w"], dev).T.contiguous()[:, None, :],
        conv_b=_tensor(flat["conv_b"], dev),
        A_log=_tensor(flat["A_log"], dev),
        D=_tensor(flat["D"], dev),
        dt_bias=_tensor(flat["dt_bias"], dev),
        norm_scale=_tensor(flat["norm_scale"], dev),
        out_proj=_tensor(flat["out_proj.w"], dev),
    )


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


def lm_params_from_numpy(
    tree: dict, cfg: ModelConfig, *, device: str | torch.device = "cuda"
) -> T.Decoder:
    """The port's ``Decoder`` on ``device`` from the reference's parameter tree.

    ``tree`` is the reference's ``init_params`` output read out as numpy
    (nested dicts, or one dict with dotted keys): ``embed``,
    ``final_norm.scale``, ``lm_head`` where the head is untied, and
    ``blocks.layer0.*`` with a leading ``n_blocks`` axis, one block per
    layer: ``norm1.scale`` and ``ssm.*`` for a mixer; ``norm1.scale``,
    ``attn.{wq,wk,wv,wo}.{w,b}``, ``norm2.scale`` and ``mlp.{wg,wu,wd}.w``
    for an attention layer, or, where ``cfg.layer_is_moe(i)``,
    ``moe.{router,wg,wu,wd}`` and ``moe.shared.{wg,wu,wd}.w``.
    """
    dev = _device.resolve(device)
    T.check_supported(cfg)
    flat = _flatten(tree)
    stacked = {k: np.asarray(v) for k, v in _sub(flat, "blocks.layer0.").items()}
    for key, v in stacked.items():
        if v.shape[0] != cfg.n_layers:
            raise ValueError(f"{key}: leading axis {v.shape[0]}, expected {cfg.n_layers}")
    layers = []
    for i in range(cfg.n_layers):
        one = {k: v[i] for k, v in stacked.items()}
        norm1 = L.RMSNorm(_tensor(one["norm1.scale"], dev))
        if cfg.layer_kind(i) == "m":
            layers.append(T.MixerLayer(norm1, ssm_mixer_from_numpy(_sub(one, "ssm."),
                                                                   device=dev)))
        else:
            ffn = (moe_from_numpy(_sub(one, "moe."), device=dev) if cfg.layer_is_moe(i)
                   else mlp_from_numpy(_sub(one, "mlp."), device=dev))
            layers.append(T.AttnLayer(norm1, attention_from_numpy(_sub(one, "attn."), device=dev),
                                      L.RMSNorm(_tensor(one["norm2.scale"], dev)), ffn))
    head = flat.get("lm_head")
    return T.Decoder(_tensor(flat["embed"], dev),
                     L.RMSNorm(_tensor(flat["final_norm.scale"], dev)), layers,
                     None if head is None else _tensor(head, dev))
