"""Port parity, SSD kernels and the Mamba2 mixer.

The same numpy inputs go through the JAX package (``repro``; its Pallas
kernels in interpret mode on the CPU) and the port (``repro_torch``; its
kernels' plain versions, since the tensors lie on the CPU).  Tolerances are
the reference's own: the fused SSD kernel 3e-4 and its state threading
2e-4 (tests/test_kernels_pallas.py), the Gram kernel 2e-5 (same file), the
mixer 2e-4 for prefill and 3e-4 for decode (tests/test_ssm.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import rbf_gram as j_rbf_gram
from repro.kernels.ops import ssd_chunked_fused as j_ssd_chunked_fused
from repro.kernels.ssd_intra import ssd_intra_pallas
from repro.models import ssm as jssm
from repro.models.config import ModelConfig as JModelConfig
from repro_torch import convert
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_intra import ssd_intra_ref
from repro_torch.models import ssm as tssm
from repro_torch.models.config import ModelConfig

torch.set_num_threads(1)

CPU = "cpu"


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _ssd_inputs(seed, b, s, h, p, n):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(np.float32)  # softplus
    a = (-np.exp(0.3 * rng.normal(size=(h,)))).astype(np.float32)
    bm = rng.normal(size=(b, s, n)).astype(np.float32)
    cm = rng.normal(size=(b, s, n)).astype(np.float32)
    return x, dt, a, bm, cm


# (b, s, h, p, n, chunk, block_h): the reference's shapes
# (tests/test_kernels_pallas.py), with h % block_h != 0 and s % chunk != 0
SSD_SHAPES = [
    (1, 16, 4, 8, 8, 8, 4),
    (2, 48, 6, 8, 16, 16, 4),
    (2, 41, 5, 4, 8, 16, 8),
    (1, 64, 8, 16, 32, 32, 8),
]


@pytest.mark.parametrize("b,s,h,p,n,chunk,block_h", SSD_SHAPES)
def test_ssd_intra_ref_matches_pallas_kernel(b, s, h, p, n, chunk, block_h):
    """The raw kernel needs S % chunk == 0 and, in JAX, H % block_h == 0."""
    s -= s % chunk
    x, dt, a, bm, cm = _ssd_inputs(s * 7 + h, b, s, h, p, n)
    da_cum = np.cumsum((dt * a).reshape(b, s // chunk, chunk, h), axis=2).reshape(b, s, h)
    jb = block_h if h % block_h == 0 else h
    want = ssd_intra_pallas(*map(jnp.asarray, (x, dt, da_cum, bm, cm)), chunk=chunk,
                            block_h=jb, interpret=True)
    got = ssd_intra_ref(*map(_t, (x, dt, da_cum, bm, cm)), chunk)
    assert got.dtype == torch.float32 and got.shape == (b, s, h, p)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=3e-4, rtol=3e-4)


def _tf32(a, rounding):
    """float32 -> TF32 (10 mantissa bits) by round-to-nearest-even or truncation."""
    bits = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    if rounding == "rne":
        bits = bits + 0x0FFF + ((bits >> 13) & 1)
    return (bits & 0xFFFFE000).astype(np.uint32).view(np.float32)


def _tc_matmul(a, b, passes, rounding):
    """a @ b on tensor cores as the kernel issues it: one TF32 product
    (passes=1), or 3xTF32 (passes=3): hi = tf32(v), lo = tf32(v - hi), and
    lo_a hi_b + hi_a lo_b + hi_a hi_b with exact products and a float32 result."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ah, bh = _tf32(a, rounding), _tf32(b, rounding)
    wide = lambda u, v: u.astype(np.float64) @ v.astype(np.float64)  # noqa: E731
    out = wide(ah, bh)
    if passes == 3:
        out = wide(_tf32(a - ah, rounding), bh) + wide(ah, _tf32(b - bh, rounding)) + out
    return out.astype(np.float32)


def _ssd_intra_emulated(x, dt, da_cum, bm, cm, chunk, passes, rounding):
    """The kernel's arithmetic in numpy: CB and M (x) through ``_tc_matmul``,
    the masked decay in float32; passes=0 is the float64 answer."""
    b, s, h, _ = x.shape
    y = np.zeros(x.shape, np.float64)
    tril = np.tril(np.ones((chunk, chunk), bool))
    for bi in range(b):
        for z0 in range(0, s, chunk):
            rows = slice(z0, z0 + chunk)
            c64, b64 = cm[bi, rows].astype(np.float64), bm[bi, rows].astype(np.float64)
            cb = c64 @ b64.T if passes == 0 else _tc_matmul(cm[bi, rows], bm[bi, rows].T,
                                                              passes, rounding)
            for hh in range(h):
                d = da_cum[bi, rows, hh]
                wd = np.float64 if passes == 0 else np.float32
                diff = np.where(tril, d[:, None].astype(wd) - d[None, :].astype(wd), -np.inf)
                m = np.where(tril, cb * np.exp(diff) * dt[bi, rows, hh][None, :].astype(wd), 0)
                xs = x[bi, rows, hh]
                y[bi, rows, hh] = (m @ xs.astype(np.float64) if passes == 0 else
                                   _tc_matmul(m.astype(np.float32), xs, passes, rounding))
    return y


@pytest.mark.parametrize("rounding", ["rne", "truncate"])
@pytest.mark.parametrize("b,s,h,p,n,chunk,scale", [
    shape[:6] + (1.0,) for shape in SSD_SHAPES] + [(1, 256, 2, 64, 128, 256, 2.0)])
def test_3xtf32_holds_the_bound_and_one_pass_tf32_does_not(b, s, h, p, n, chunk, scale,
                                                           rounding):
    """Why the kernel runs 3xTF32: against the float64 answer, three TF32
    products per term stay within 3e-4 absolute + relative (the kernel's
    bound), one TF32 product does not.  The last case has |y| near 300, as
    the mamba2-370m prefill's shape does on the card.  The kernel splits by
    truncation (bit masks); round-to-nearest-even is the finer split."""
    s -= s % chunk
    x, dt, a, bm, cm = _ssd_inputs(s * 7 + h, b, s, h, p, n)
    x = (x * scale).astype(np.float32)
    a = -np.linspace(1.0, 16.0, h).astype(np.float32)  # the model's A range
    da_cum = np.cumsum((dt * a).reshape(b, s // chunk, chunk, h), axis=2).reshape(b, s, h)
    ins = (x, dt, da_cum.astype(np.float32), bm, cm, chunk)
    want = _ssd_intra_emulated(*ins, passes=0, rounding=rounding)

    def excess(got):
        return float((np.abs(got - want) - 3e-4 * np.abs(want)).max())

    assert excess(_ssd_intra_emulated(*ins, passes=3, rounding=rounding)) <= 3e-4
    assert excess(_ssd_intra_emulated(*ins, passes=1, rounding=rounding)) > 3e-4
    if scale > 1:
        assert 250 < float(np.abs(want).max()) < 400


@pytest.mark.parametrize("b,s,h,p,n,chunk,block_h", SSD_SHAPES)
def test_ssd_chunked_fused_matches_reference(b, s, h, p, n, chunk, block_h):
    """Both paddings (S to a chunk multiple; H only on the JAX side)."""
    x, dt, a, bm, cm = _ssd_inputs(s * 7 + h, b, s, h, p, n)
    y_j, h_j = j_ssd_chunked_fused(*map(jnp.asarray, (x, dt, a, bm, cm)), chunk,
                                   block_h=block_h)
    y_t, h_t = ops.ssd_chunked_fused(*map(_t, (x, dt, a, bm, cm)), chunk, block_h=block_h)
    assert y_t.shape == (b, s, h, p) and h_t.shape == (b, h, p, n)
    np.testing.assert_allclose(_np(y_t), np.asarray(y_j), atol=3e-4, rtol=3e-4)
    np.testing.assert_allclose(_np(h_t), np.asarray(h_j), atol=3e-4, rtol=3e-4)
    # the plain route of the port computes the same function
    y_p, h_p = tssm.ssd_chunked(*map(_t, (x, dt, a, bm, cm)), chunk)
    np.testing.assert_allclose(_np(y_p), _np(y_t), atol=3e-4, rtol=3e-4)
    np.testing.assert_allclose(_np(h_p), _np(h_t), atol=3e-4, rtol=3e-4)


def test_ssd_chunked_fused_initial_state_threading():
    x, dt, a, bm, cm = _ssd_inputs(3, 1, 32, 4, 8, 8)
    args = list(map(_t, (x, dt, a, bm, cm)))
    jargs = list(map(jnp.asarray, (x, dt, a, bm, cm)))

    def halves(t):
        return (t[:, :16], t[:, 16:]) if t.ndim > 1 else (t, t)

    first = [halves(t)[0] for t in args]
    second = [halves(t)[1] for t in args]
    y_full, h_full = ops.ssd_chunked_fused(*args, 8, block_h=4)
    y1, h1 = ops.ssd_chunked_fused(*first, 8, block_h=4)
    y2, h2 = ops.ssd_chunked_fused(*second, 8, h0=h1, block_h=4)
    np.testing.assert_allclose(_np(y_full[:, 16:]), _np(y2), atol=2e-4)
    np.testing.assert_allclose(_np(h_full), _np(h2), atol=2e-4)
    _, jh1 = j_ssd_chunked_fused(*[halves(t)[0] for t in jargs], 8, block_h=4)
    jy2, jh2 = j_ssd_chunked_fused(*[halves(t)[1] for t in jargs], 8, h0=jh1, block_h=4)
    np.testing.assert_allclose(_np(y2), np.asarray(jy2), atol=2e-4)
    np.testing.assert_allclose(_np(h2), np.asarray(jh2), atol=2e-4)


# (q, n, d): the reference's SHAPES (tests/test_kernels_pallas.py)
GRAM_SHAPES = [(1, 1, 1), (7, 13, 1), (128, 512, 2), (130, 600, 3), (64, 64, 4),
               (257, 129, 2)]


@pytest.mark.parametrize("q,n,d", GRAM_SHAPES)
def test_rbf_gram_matches_reference(q, n, d):
    rng = np.random.default_rng(q + 7 * n + d)
    x1 = rng.normal(size=(q, d)).astype(np.float32)
    x2 = rng.normal(size=(n, d)).astype(np.float32)
    want = j_rbf_gram(x1, x2, gamma=1.1)
    got = ops.rbf_gram(_t(x1), _t(x2), gamma=1.1)
    assert got.dtype == torch.float32 and got.shape == (q, n)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# The mixer
# ---------------------------------------------------------------------------

_CFG = dict(name="ssm-test", family="ssm", n_layers=1, d_model=32, d_ff=0,
            vocab_size=64, ssm_state=8, ssm_head_dim=16, ssm_chunk=8)


def _mixer_pair(seed=0, fused=False):
    jcfg = JModelConfig(**_CFG, ssd_fused=fused)
    tcfg = ModelConfig(**_CFG, ssd_fused=fused)
    jp = jssm.ssm_init(jax.random.PRNGKey(seed), jcfg)
    tp = convert.ssm_mixer_from_numpy(jax.tree.map(np.asarray, jp), device=CPU)
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("s,fused", [(20, False), (20, True), (2, False)])
def test_mixer_prefill_matches_reference(s, fused):
    """y, final state and conv tail; s=20 pads the last chunk, s=2 < K-1
    left-pads the conv tail."""
    jcfg, tcfg, jp, tp = _mixer_pair(fused=fused)
    u = np.random.default_rng(1).normal(size=(2, s, 32)).astype(np.float32)
    jy, jst, jconv = jssm.ssm_forward_with_state(jp, jcfg, jnp.asarray(u))
    ty, tst, tconv = tssm.ssm_forward_with_state(tp, tcfg, _t(u))
    assert tconv.shape == (2, tcfg.ssm_conv - 1, tcfg.d_inner + 2 * tcfg.ssm_state)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(_np(tst), np.asarray(jst), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(_np(tconv), np.asarray(jconv), atol=2e-4, rtol=2e-4)


def test_mixer_decode_matches_reference():
    """Four decode steps after a 16-token prefill, each against the
    reference's step on the reference's cache."""
    jcfg, tcfg, jp, tp = _mixer_pair(seed=2)
    u = np.random.default_rng(3).normal(size=(2, 20, 32)).astype(np.float32)
    _, jst, jconv = jssm.ssm_forward_with_state(jp, jcfg, jnp.asarray(u[:, :16]))
    _, tst, tconv = tssm.ssm_forward_with_state(tp, tcfg, _t(u[:, :16]))
    jc, tc = {"state": jst, "conv": jconv}, {"state": tst, "conv": tconv}
    for t in range(16, 20):
        jy, jc = jssm.ssm_decode(jp, jcfg, jnp.asarray(u[:, t:t + 1]), jc)
        ty, tc = tssm.ssm_decode(tp, tcfg, _t(u[:, t:t + 1]), tc)
        np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=3e-4, rtol=3e-4,
                                   err_msg=f"t={t}")
        for key in ("state", "conv"):
            np.testing.assert_allclose(_np(tc[key]), np.asarray(jc[key]), atol=3e-4,
                                       rtol=3e-4, err_msg=f"t={t} {key}")


def test_ssd_recurrent_ref_matches_reference():
    x, dt, a, bm, cm = _ssd_inputs(5, 2, 11, 3, 4, 8)
    jy, jh = jssm.ssd_recurrent_ref(*map(jnp.asarray, (x, dt, a, bm, cm)))
    ty, th = tssm.ssd_recurrent_ref(*map(_t, (x, dt, a, bm, cm)))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(_np(th), np.asarray(jh), atol=2e-4, rtol=2e-4)
