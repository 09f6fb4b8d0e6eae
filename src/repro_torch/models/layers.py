"""Shared layers of the port's model stack: init helpers, dense, norms, RoPE,
GQA attention with its ring-buffer KV cache, the MLPs and the MoE layer.

The reference's ``repro.models.layers``, for every family: RMSNorm and
LayerNorm, standard RoPE and M-RoPE, attention with or without RoPE and a
causal mask, the MLPs and the MoE layer.
Conventions:
  * weights keep the reference's layouts (a dense weight is (d_in, d_out),
    applied as ``x @ w``), so the reference's parameters carry across as
    they are (``repro_torch.convert.lm_params_from_numpy``);
  * every init helper draws from an explicit ``torch.Generator``;
  * activations follow ``cfg.dtype``; norm, RoPE-angle, softmax and SSM
    math run in float32, or in float64 for a float64 model (``wide``); the
    MoE router is float32 in every model dtype, as in the reference.

Shapes: B batch, S sequence, d model dim, H query heads, K kv heads, hd
head dim; for MoE, E experts, k of them per token, f expert width, G
groups of g tokens, C slots per expert and group (the capacity).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def wide(dtype: torch.dtype) -> torch.dtype:
    """The compute dtype for activations of ``dtype``: float32, or float64."""
    return torch.promote_types(dtype, torch.float32)


def _normal(gen: torch.Generator, shape, scale: float, dtype: torch.dtype) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn in float32 on the generator's device, then cast."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (scale * w).to(dtype)


def param(t: torch.Tensor) -> nn.Parameter:
    """A serving-only parameter: no gradient is recorded through it."""
    return nn.Parameter(t, requires_grad=False)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype: torch.dtype) -> nn.Parameter:
    """A bare (d_in, d_out) weight, as the SSM mixer holds its projections."""
    return param(_normal(gen, (d_in, d_out), d_in**-0.5, dtype))


class Dense(nn.Module):
    """The reference's ``{"w", "b"}`` dense parameters: ``w`` (d_in, d_out)
    and, where the layer has one, the bias ``b`` (d_out,)."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor | None = None):
        super().__init__()
        self.w = param(w)
        self.register_parameter("b", None if b is None else param(b))


def linear_init(gen: torch.Generator, d_in: int, d_out: int, dtype: torch.dtype, *,
                bias: bool = False) -> Dense:
    """The reference's ``dense_init``: a ``Dense`` with a zero bias if ``bias``."""
    w = _normal(gen, (d_in, d_out), d_in**-0.5, dtype)
    return Dense(w, torch.zeros(d_out, dtype=dtype, device=gen.device) if bias else None)


def dense(p: torch.Tensor | Dense, x: torch.Tensor) -> torch.Tensor:
    """``x @ w``, plus the bias where ``p`` is a ``Dense`` that has one."""
    if isinstance(p, torch.Tensor):
        return x @ p
    y = x @ p.w
    return y if p.b is None else y + p.b


class RMSNorm(nn.Module):
    """The reference's ``norm_init`` / ``apply_norm`` for ``norm="rmsnorm"``."""

    def __init__(self, scale: torch.Tensor):
        super().__init__()
        self.scale = param(scale)


class LayerNorm(nn.Module):
    """The reference's ``norm_init`` / ``apply_norm`` for ``norm="layernorm"``:
    ``scale`` and ``bias`` (d,)."""

    def __init__(self, scale: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.scale, self.bias = param(scale), param(bias)


def norm_init(cfg: ModelConfig, device: torch.device) -> RMSNorm | LayerNorm:
    ones = torch.ones(cfg.d_model, dtype=cdtype(cfg), device=device)
    if cfg.norm == "layernorm":
        return LayerNorm(ones, torch.zeros_like(ones))
    if cfg.norm != "rmsnorm":
        raise ValueError(f"unknown norm {cfg.norm!r}")
    return RMSNorm(ones)


def apply_norm(p: RMSNorm | LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """The norm ``p`` is (the port's ``apply_norm`` takes no ``cfg``): RMS
    with eps 1e-6, or LayerNorm (the biased variance) with eps 1e-5, the
    math in float32 (float64 for a float64 model) and cast back."""
    xf = x.to(wide(x.dtype))
    if isinstance(p, LayerNorm):
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + 1e-5)
        return (y * p.scale.to(xf.dtype) + p.bias.to(xf.dtype)).to(x.dtype)
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + 1e-6)
    return (y * p.scale.to(xf.dtype)).to(x.dtype)


def rms_norm_gated(scale: torch.Tensor, x: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """Mamba2's gated RMSNorm: norm(x * silu(gate)) * scale.

    ``x * silu(gate)`` is formed in the activation dtype and only then cast
    to float32, as the reference does: in bf16 the product is rounded once
    more before the norm.
    """
    xf = (x * F.silu(gate)).to(wide(x.dtype))
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + 1e-6) * scale.to(xf.dtype)).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE / M-RoPE
# ---------------------------------------------------------------------------


def _inv_freq(hd: int, theta: float, dtype: torch.dtype, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=dtype, device=device) / hd))


def rope_angles(cfg: ModelConfig, positions: torch.Tensor) -> torch.Tensor:
    """Angles (B, S, hd // 2), ``position * inv_freq`` in float32 (float64 for
    a float64 model).

    standard: positions (B, S).
    mrope:    positions (B, 3, S), the temporal, height and width streams;
              the hd // 2 frequency slots are cut by ``cfg.mrope_sections``
              and each section reads its own stream (Qwen2-VL Sec. 3).
    """
    wd = wide(cdtype(cfg))
    inv = _inv_freq(cfg.hd, cfg.rope_theta, wd, positions.device)
    if cfg.rope_mode == "mrope":
        sections = cfg.mrope_sections
        if sum(sections) != cfg.hd // 2:
            raise ValueError(f"mrope_sections {sections} do not cut hd // 2 = {cfg.hd // 2}")
        sec_id = torch.cat([torch.full((s,), i, device=positions.device)
                            for i, s in enumerate(sections)])  # (hd/2,)
        pos_sel = positions.index_select(1, sec_id)  # (B, hd/2, S)
        return pos_sel.to(wd).transpose(1, 2) * inv
    return positions.to(wd)[..., None] * inv


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: (B, S, n, hd); angles: (B, S, hd // 2).  The half-rotation (NeoX)
    layout; cos and sin are taken at the angles' width, then cast to
    ``x.dtype`` before they multiply, as the reference does."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------------------
# Attention (GQA, causal, sliding window, KV cache)
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    """The reference's ``attn_init`` tree: ``wq`` (d, H hd), ``wk`` and ``wv``
    (d, K hd), each with a bias under ``qkv_bias``, and ``wo`` (H hd, d)."""

    def __init__(self, wq: Dense, wk: Dense, wv: Dense, wo: Dense):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo


def attn_init(gen: torch.Generator, cfg: ModelConfig) -> Attention:
    d, hd, dt, bias = cfg.d_model, cfg.hd, cdtype(cfg), cfg.qkv_bias
    return Attention(
        linear_init(gen, d, cfg.n_heads * hd, dt, bias=bias),
        linear_init(gen, d, cfg.n_kv_heads * hd, dt, bias=bias),
        linear_init(gen, d, cfg.n_kv_heads * hd, dt, bias=bias),
        linear_init(gen, cfg.n_heads * hd, d, dt),
    )


def _qkv(p: Attention, cfg: ModelConfig, x: torch.Tensor, angles, *, rope: bool = True):
    b, s, _ = x.shape
    hd = cfg.hd
    q = dense(p.wq, x).reshape(b, s, cfg.n_heads, hd)
    k = dense(p.wk, x).reshape(b, s, cfg.n_kv_heads, hd)
    v = dense(p.wv, x).reshape(b, s, cfg.n_kv_heads, hd)
    if rope:
        q, k = apply_rope(q, angles), apply_rope(k, angles)
    return q, k, v


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
          cfg: ModelConfig) -> torch.Tensor:
    """q: (B, Sq, H, hd), k/v: (B, Sk, K, hd), mask: (B, Sq, Sk) bool -> (B, Sq, H hd).

    As in the reference: query head h reads kv head h // (H / K) (q is
    viewed as (B, Sq, K, rep, hd)); q k^T is formed in the activation dtype
    and only then widened, so bf16 logits are rounded once before the
    hd^-1/2 scale; masked logits are -1e30 (a fully masked row averages
    v); the probabilities are cast to v's dtype before the PV product.
    """
    b, sq, h, hd = q.shape
    kheads = k.shape[2]
    q = q.reshape(b, sq, kheads, h // kheads, hd)
    logits = torch.einsum("bqkrh,bskh->bkrqs", q, k).to(wide(q.dtype))
    logits = logits * (hd**-0.5)
    logits = torch.where(mask[:, None, None, :, :], logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkrqs,bskh->bqkrh", probs, v)
    return out.reshape(b, sq, h * hd)


def causal_mask(sq: int, sk: int, *, window: int = 0, offset: int = 0,
                device=None) -> torch.Tensor:
    """(sq, sk) bool; query i (absolute position offset + i) sees key j iff
    j <= offset + i and (window == 0 or offset + i - j < window)."""
    qp = offset + torch.arange(sq, device=device)[:, None]
    kp = torch.arange(sk, device=device)[None, :]
    m = kp <= qp
    if window:
        m &= (qp - kp) < window
    return m


def attn_forward(p: Attention, cfg: ModelConfig, x: torch.Tensor, angles, *,
                 causal: bool = True, window: int = 0, rope: bool = True) -> torch.Tensor:
    """Full-sequence attention (training / prefill): causal, or bidirectional
    (an encoder); ``rope=False`` leaves q and k unrotated (``angles`` unread)."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x, angles, rope=rope)
    if causal:
        mask = causal_mask(s, s, window=window, device=x.device)
    else:
        mask = torch.ones((s, s), dtype=torch.bool, device=x.device)
    return dense(p.wo, _sdpa(q, k, v, mask.expand(b, s, s), cfg))


def init_kv_cache(cfg: ModelConfig, batch: int, length: int, dtype, device) -> dict:
    """Ring-buffer KV cache. ``length`` = the full sequence for dense
    attention, the window for sliding-window attention; ``pos`` holds each
    slot's absolute position, -1 where empty."""
    shape = (batch, length, cfg.n_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((batch, length), -1, dtype=torch.int32, device=device),
    }


def attn_decode(p: Attention, cfg: ModelConfig, x: torch.Tensor, cache: dict, position: int,
                *, window: int = 0, rope: bool = True, rope_position: int | None = None
                ) -> tuple[torch.Tensor, dict]:
    """One decode step, x (B, 1, d), against a ring-buffer cache.

    ``position`` is the new token's absolute position, a host int.  Its key
    and value are written IN PLACE at slot ``position % length`` of
    ``cache`` (the reference returns a new cache); the returned cache is
    the one passed in.  Keys attend where ``0 <= pos <= position`` and,
    with a window, ``position - pos < window``.  q and k are rotated at
    ``rope_position`` where it is given (the M-RoPE streams' value, which
    all three streams share, positions (B, 3, 1)), else at ``position``;
    not at all under ``rope=False``.
    """
    length = cache["k"].shape[1]
    angles = decode_angles(cfg, x.shape[0], position, rope_position, x.device) if rope else None
    q, k, v = _qkv(p, cfg, x, angles, rope=rope)
    slot = position % length
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    cache["pos"][:, slot] = position
    valid = decode_mask(cache["pos"], position, window)
    out = _sdpa(q, cache["k"], cache["v"], valid[:, None, :], cfg)
    return dense(p.wo, out), cache


def decode_angles(cfg: ModelConfig, b: int, position: int, rope_position: int | None,
                  device) -> torch.Tensor:
    """The RoPE angles of one decoded token per row: at ``rope_position``
    where it is given (the M-RoPE streams' shared value), else at
    ``position``."""
    rp = position if rope_position is None else rope_position
    shape = (b, 3, 1) if cfg.rope_mode == "mrope" else (b, 1)
    return rope_angles(cfg, torch.full(shape, rp, dtype=torch.int32, device=device))


def decode_mask(kpos: torch.Tensor, position: int, window: int = 0) -> torch.Tensor:
    """Which ring slots (their positions ``kpos``, -1 where empty) a token
    at ``position`` attends to: ``0 <= pos <= position`` and, with a
    window, ``position - pos < window``."""
    valid = (kpos >= 0) & (kpos <= position)
    if window:
        valid &= (position - kpos) < window
    return valid


def prefill_into_cache(p: Attention, cfg: ModelConfig, x: torch.Tensor, angles, cache: dict,
                       *, window: int = 0) -> tuple[torch.Tensor, dict]:
    """Full-sequence attention that also writes k and v into the cache.

    The prompt starts at position 0; the (at most ``length``) most recent
    positions land in their ring slots ``position % length``.  Written IN
    PLACE into ``cache``, which is returned.
    """
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x, angles)
    out = _sdpa(q, k, v, causal_mask(s, s, window=window, device=x.device).expand(b, s, s), cfg)
    length = cache["k"].shape[1]
    start = max(0, s - length)
    kept_pos = torch.arange(start, s, dtype=torch.int32, device=x.device)
    slots = (kept_pos % length).long()
    cache["k"].index_copy_(1, slots, k[:, start:].to(cache["k"].dtype))
    cache["v"].index_copy_(1, slots, v[:, start:].to(cache["v"].dtype))
    cache["pos"].index_copy_(1, slots, kept_pos.expand(b, -1))
    return dense(p.wo, out), cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    """The reference's ``mlp_init`` tree: ``wg`` (SwiGLU only) and ``wu``
    (d, d_ff), ``wd`` (d_ff, d)."""

    def __init__(self, wu: Dense, wd: Dense, wg: Dense | None = None):
        super().__init__()
        self.wg, self.wu, self.wd = wg, wu, wd


def mlp_init(gen: torch.Generator, cfg: ModelConfig, d_ff: int) -> MLP:
    d, dt = cfg.d_model, cdtype(cfg)
    wg = linear_init(gen, d, d_ff, dt) if cfg.act == "silu" else None
    return MLP(linear_init(gen, d, d_ff, dt), linear_init(gen, d_ff, d, dt), wg)


def mlp(p: MLP, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU for ``act="silu"``, squared ReLU, or GELU (``jax.nn.gelu``'s
    default: the tanh approximation)."""
    if cfg.act == "silu":
        h = F.silu(dense(p.wg, x)) * dense(p.wu, x)
    elif cfg.act == "squared_relu":
        h = torch.square(F.relu(dense(p.wu, x)))
    elif cfg.act == "gelu":
        h = F.gelu(dense(p.wu, x), approximate="tanh")
    else:
        raise ValueError(cfg.act)
    return dense(p.wd, h)


# ---------------------------------------------------------------------------
# MoE: GShard-style grouped top-k dispatch with capacity
# ---------------------------------------------------------------------------


class MoE(nn.Module):
    """The reference's ``moe_init`` tree: ``router`` (d, E), float32 whatever
    the model's dtype; ``wg`` (SwiGLU only) and ``wu`` (E, d, f) and ``wd``
    (E, f, d) in the model's dtype; ``shared``, an ``MLP`` of width f x
    ``n_shared_experts``, where the config has one."""

    def __init__(self, router: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor,
                 wg: torch.Tensor | None = None, shared: MLP | None = None):
        super().__init__()
        self.router = param(router)
        self.register_parameter("wg", None if wg is None else param(wg))
        self.wu, self.wd = param(wu), param(wd)
        self.shared = shared


def moe_init(gen: torch.Generator, cfg: ModelConfig) -> MoE:
    d, e, dt = cfg.d_model, cfg.n_experts, cdtype(cfg)
    f = cfg.moe_d_ff or cfg.d_ff
    router = _normal(gen, (d, e), d**-0.5, torch.float32)
    wg = _normal(gen, (e, d, f), d**-0.5, dt) if cfg.act == "silu" else None
    wu = _normal(gen, (e, d, f), d**-0.5, dt)
    wd = _normal(gen, (e, f, d), f**-0.5, dt)
    shared = mlp_init(gen, cfg, f * cfg.n_shared_experts) if cfg.n_shared_experts else None
    return MoE(router, wu, wd, wg, shared)


def _capacity(cfg: ModelConfig, group: int) -> int:
    c = int(group * cfg.top_k * cfg.capacity_factor / cfg.n_experts) + 1
    return max(c, cfg.top_k)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot of ``idx`` over ``n`` classes, a zero row where ``idx``
    lies outside ``[0, n)`` (``jax.nn.one_hot``'s rule; ``F.one_hot`` raises)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(torch.float32)


def moe_apply(p: MoE, cfg: ModelConfig, x: torch.Tensor, *, reduce=None
              ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """x: (B, S, d) -> (y, {"aux_loss", "z_loss", "expert_load"}), the
    reference's dense one-hot dispatch with static shapes and no host read.

    The B S tokens are cut into groups of ``moe_group_size`` (the tail group
    zero-padded; padded tokens route and count, as in the reference).  Each
    token's k experts come from the float32 router's softmax, highest first
    and ties to the lower expert (``jax.lax.top_k``'s order: a stable
    descending sort, where ``torch.topk`` picks other experts among equal
    probabilities), with weights renormalised to sum to 1.  Slot j of every
    token takes capacity before slot j + 1, in token order; an assignment
    past C is dropped.  ``dispatch`` is one-hot in the model's dtype,
    ``combine`` float32 and cast to it before the last product; the shared
    expert is added after.

    ``reduce`` (None: this call's tokens are the whole batch) maps each of
    the router's token means (the mean probabilities and top-1 shares of the
    aux loss, and the z loss) to the mean over the whole batch, where the
    batch is split over ranks: the aux loss is a product of two means, so
    they are reduced before the product.
    """
    b, s, d = x.shape
    e, k, dt = cfg.n_experts, cfg.top_k, cdtype(cfg)
    tokens = x.reshape(b * s, d)
    n = tokens.shape[0]
    g = min(cfg.moe_group_size, n)
    pad = (-n) % g
    if pad:
        tokens = F.pad(tokens, (0, 0, 0, pad))
    ng = tokens.shape[0] // g
    xt = tokens.reshape(ng, g, d)
    cap = _capacity(cfg, g)

    logits = xt.to(torch.float32) @ p.router  # (G, g, E)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :k], topi[..., :k]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)

    counts = torch.zeros((ng, e), dtype=torch.float32, device=x.device)
    dispatch = torch.zeros((ng, g, e, cap), dtype=dt, device=x.device)
    combine = torch.zeros((ng, g, e, cap), dtype=torch.float32, device=x.device)
    for j in range(k):
        oh = _one_hot(topi[..., j], e)  # (G, g, E)
        pos_in = torch.cumsum(oh, dim=1) - oh + counts[:, None, :]
        pos = torch.einsum("nge,nge->ng", pos_in, oh).to(torch.int32)
        keep = (pos < cap).to(torch.float32)
        slot = _one_hot(pos, cap) * keep[..., None]  # (G, g, C)
        dj = oh[..., None] * slot[:, :, None, :]  # (G, g, E, C)
        dispatch = dispatch + dj.to(dt)
        combine = combine + dj * topv[..., j][..., None, None]
        counts = counts + oh.sum(dim=1)

    expert_in = torch.einsum("ngec,ngd->necd", dispatch, xt)  # (G, E, C, d)
    if cfg.act == "silu":
        h = F.silu(torch.einsum("necd,edf->necf", expert_in, p.wg))
        h = h * torch.einsum("necd,edf->necf", expert_in, p.wu)
    elif cfg.act == "squared_relu":
        h = torch.square(F.relu(torch.einsum("necd,edf->necf", expert_in, p.wu)))
    else:
        h = F.gelu(torch.einsum("necd,edf->necf", expert_in, p.wu), approximate="tanh")
    expert_out = torch.einsum("necf,efd->necd", h, p.wd)
    y = torch.einsum("ngec,necd->ngd", combine.to(dt), expert_out)
    y = y.reshape(-1, d)[:n].reshape(b, s, d)

    if cfg.n_shared_experts:
        y = y + mlp(p.shared, cfg, x)

    # load-balance aux (Switch/GShard): E * sum_e f_e * P_e
    me = probs.mean(dim=(0, 1))  # (E,)
    top1 = _one_hot(topi[..., 0], e).mean(dim=(0, 1))
    if reduce is not None:
        me, top1 = reduce(me), reduce(top1)
    aux = e * torch.sum(top1 * me)
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    if reduce is not None:
        z = reduce(z)
    return y, {"aux_loss": aux, "z_loss": z, "expert_load": counts.sum(0)}


def ffn_apply(p: MLP | MoE, cfg: ModelConfig, x: torch.Tensor, *, is_moe: bool,
              moe_reduce=None) -> tuple[torch.Tensor, dict[str, torch.Tensor] | None]:
    """The MoE layer with its metrics, or the MLP with None: the reference
    gives a dense layer zero metrics, which add nothing to a sum over layers
    (``transformer.decoder_forward`` skips them instead).  ``moe_reduce`` is
    ``moe_apply``'s ``reduce``."""
    if is_moe:
        return moe_apply(p, cfg, x, reduce=moe_reduce)
    return mlp(p, cfg, x), None
