"""Mamba2 / SSD (state-space duality) mixer — arXiv:2405.21060.

Chunked "dual" form for prefill (quadratic attention-like math within
chunks of length ``cs``, a linear recurrence across chunks) and an O(1)
single-step recurrence for decode, as in the reference's
``repro.models.ssm``.

Shapes: B batch, S seq, H ssm heads, P head dim, N state dim, K conv width,
cs chunk, nc chunks.  n_groups = 1 (B/C shared across heads).

With ``cfg.ssd_fused`` the intra-chunk term runs in the hand-written
``ssd_intra`` kernel (``kernels.ops.ssd_chunked_fused``); without it, in
the plain ``ssd_intra_ref``, whose (B, nc, cs, cs, H) decay tensor lives in
device memory.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.ops import ssd_chunked_fused, ssd_chunked_with
from ..kernels.ssd_intra import ssd_intra_ref
from .config import ModelConfig
from .layers import _normal, cdtype, dense, dense_init, param, rms_norm_gated, wide


class SSMMixer(nn.Module):
    """One Mamba2 mixer's parameters, in the reference's layouts except
    ``conv_w``, which is PyTorch's depthwise (C, 1, K) for ``F.conv1d``."""

    def __init__(self, in_proj, conv_w, conv_b, A_log, D, dt_bias, norm_scale, out_proj):
        super().__init__()
        self.in_proj = param(in_proj)  # (d, 2 di + 2 n + h)
        self.conv_w = param(conv_w)  # (C, 1, K), C = di + 2 n
        self.conv_b = param(conv_b)  # (C,)
        self.A_log = param(A_log)  # (h,) float32
        self.D = param(D)  # (h,) float32
        self.dt_bias = param(dt_bias)  # (h,) float32
        self.norm_scale = param(norm_scale)  # (di,)
        self.out_proj = param(out_proj)  # (di, d)


def ssm_init(gen: torch.Generator, cfg: ModelConfig) -> SSMMixer:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * n
    dt, dev = cdtype(cfg), gen.device
    conv_w = _normal(gen, (cfg.ssm_conv, conv_dim), cfg.ssm_conv**-0.5, dt)  # (K, C)
    return SSMMixer(
        in_proj=dense_init(gen, d, 2 * di + 2 * n + h, dt),
        conv_w=conv_w.T.contiguous()[:, None, :],
        conv_b=torch.zeros(conv_dim, dtype=dt, device=dev),
        A_log=torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32, device=dev)),
        D=torch.ones(h, dtype=torch.float32, device=dev),
        dt_bias=torch.zeros(h, dtype=torch.float32, device=dev),
        norm_scale=torch.ones(di, dtype=dt, device=dev),
        out_proj=dense_init(gen, di, d, dt),
    )


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d + silu. xbc: (B, S, C), w: (C, 1, K).

    Like the reference's ``conv_general_dilated``, ``F.conv1d`` computes a
    cross-correlation, so the weight is not flipped; the K - 1 zeros go on
    the left.
    """
    k = w.shape[-1]
    out = F.conv1d(F.pad(xbc.transpose(1, 2), (k - 1, 0)), w, groups=xbc.shape[-1])
    return F.silu(out.transpose(1, 2) + b)


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    di, n = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di : 2 * di + 2 * n]
    dt = zxbcdt[..., 2 * di + 2 * n :]
    return z, xbc, dt


def ssd_chunked(x, dt, a, bmat, cmat, chunk: int, h0=None):
    """Returns (y (B,S,H,P), final_state (B,H,P,N)), the plain version.

    Recurrence being computed:  h_t = exp(dt_t a) h_{t-1} + dt_t B_t x_t,
    y_t = C_t . h_t  (the D-skip and gating live in the caller).
    """
    return ssd_chunked_with(ssd_intra_ref, x, dt, a, bmat, cmat, chunk, h0)


def ssd_recurrent_ref(x, dt, a, bmat, cmat, h0=None):
    """Naive per-step recurrence — the oracle for ssd_chunked."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    wd = wide(x.dtype)
    state = x.new_zeros((b, h, p, n), dtype=wd) if h0 is None else h0.to(wd)
    ys = []
    for t in range(s):
        da = torch.exp(dt[:, t] * a[None, :])  # (b, h)
        upd = (dt[:, t, :, None, None] * x[:, t, :, :, None]) * bmat[:, t, None, None, :]
        state = state * da[:, :, None, None] + upd
        ys.append(torch.einsum("bn,bhpn->bhp", cmat[:, t], state))
    return torch.stack(ys, 1), state


def ssm_forward(p: SSMMixer, cfg: ModelConfig, u: torch.Tensor) -> torch.Tensor:
    """Prefill path without state output (sequences start cold)."""
    y, _, _ = ssm_forward_with_state(p, cfg, u)
    return y


def ssm_forward_with_state(p: SSMMixer, cfg: ModelConfig, u: torch.Tensor):
    """(y (B, S, d_model), final SSM state (B, H, P, N) f32, conv tail (B, K-1, C))."""
    b, s, _ = u.shape
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    z, xbc_raw, dt_raw = _split_proj(cfg, dense(p.in_proj, u))
    xbc = _causal_conv(xbc_raw, p.conv_w, p.conv_b)
    x = xbc[..., :di].reshape(b, s, h, cfg.ssm_head_dim)
    bmat = xbc[..., di : di + n]
    cmat = xbc[..., di + n :]
    wd = wide(u.dtype)
    dt = F.softplus(dt_raw.to(wd) + p.dt_bias)
    a = -torch.exp(p.A_log)
    ssd = ssd_chunked_fused if cfg.ssd_fused else ssd_chunked
    xf = x.to(wd)
    y, h_t = ssd(xf, dt, a, bmat.to(wd), cmat.to(wd), cfg.ssm_chunk)
    y = y + xf * p.D[None, None, :, None]
    y = y.reshape(b, s, di).to(u.dtype)
    y = rms_norm_gated(p.norm_scale, y, z)
    # conv tail state for decode continuation after prefill: the raw xbc
    k = cfg.ssm_conv
    conv_state = xbc_raw[:, s - (k - 1) :, :].contiguous() if s >= k - 1 else F.pad(
        xbc_raw, (0, 0, k - 1 - s, 0)
    )
    return dense(p.out_proj, y), h_t, conv_state


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    return {
        "state": torch.zeros(
            (batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
            dtype=wide(dtype), device=device,
        ),
        "conv": torch.zeros(
            (batch, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state),
            dtype=dtype, device=device,
        ),
    }


def ssm_decode(
    p: SSMMixer, cfg: ModelConfig, u: torch.Tensor, cache: dict, *, comm=None,
    heads: slice | None = None, channels: slice | None = None,
) -> tuple[torch.Tensor, dict]:
    """One-token recurrent step (u (B, 1, d_model)); O(1) in context length.

    On a rank's part of a cache split over a model group
    (``sharding.serve``): ``cache["state"]`` holds the ssm heads ``heads``
    and ``cache["conv"]`` the conv channels ``channels`` (None: all of
    them).  The depthwise conv is per channel, so the rank convolves its
    channels and keeps their new tail, and ``comm.gather`` joins the conv
    outputs (B, C); it updates its state heads, and their y are gathered
    before the gated norm and ``out_proj``.  Returns (the output, the new
    part)."""
    b = u.shape[0]
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    ch = slice(None) if channels is None else channels
    hs = slice(None) if heads is None else heads
    z, xbc_raw, dt_raw = _split_proj(cfg, dense(p.in_proj, u))
    wd = wide(u.dtype)
    # (B, K, C_r): the rank's channels' tail and their new value
    window = torch.cat([cache["conv"], xbc_raw[..., ch].to(cache["conv"].dtype)], dim=1)
    conv_out = torch.einsum("bkc,ck->bc", window.to(wd), p.conv_w[ch, 0, :].to(wd))
    if channels is not None:
        conv_out = comm.gather(conv_out, 1)
    xbc = F.silu(conv_out + p.conv_b.to(wd))  # (B, C)
    x = xbc[:, :di].reshape(b, h, cfg.ssm_head_dim)[:, hs]
    bmat = xbc[:, di : di + n]
    cmat = xbc[:, di + n :]
    dt = F.softplus(dt_raw[:, 0, hs].to(wd) + p.dt_bias[hs])  # (B, h)
    da = torch.exp(dt * -torch.exp(p.A_log[hs])[None, :])
    upd = (dt[:, :, None, None] * x[:, :, :, None]) * bmat[:, None, None, :]
    state = cache["state"] * da[:, :, None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", cmat, state) + p.D[hs][None, :, None] * x
    if heads is not None:
        y = comm.gather(y, 1)
    y = y.reshape(b, 1, di).to(u.dtype)
    y = rms_norm_gated(p.norm_scale, y, z)
    new_cache = {"state": state, "conv": window[:, 1:, :]}
    return dense(p.out_proj, y), new_cache
