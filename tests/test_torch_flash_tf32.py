"""The float32 flash kernel's arithmetic, emulated on the CPU.

The kernel (``csrc/flash_attention.cu``, ``flash_fwd_kernel_tf32``) runs
both products on the tensor cores in split precision: each operand a
becomes hi = cvt.rna.tf32(a) and lo = cvt.rna.tf32(a - hi), and a.b is
taken as hi.lo + lo.hi + hi.hi with float32 accumulation, over an online
softmax of 64-key tiles whose exp is float32 ``expf``.  The emulation
below repeats that arithmetic in torch (TF32 rounding on the int32 view,
as ``cvt.rna`` rounds; float32 ``torch.exp`` for ``expf``) and is
held to ``flash_attention_plain`` and to the JAX reference at the
``FLASH_CASES`` shapes of the ``gpu`` tests, at the float32 bar (atol
3e-5, rtol 1e-4).  One TF32 product alone keeps about three digits: at
D = 128 it misses that bar, which is why the kernel pays for three.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import flash_attention_jnp
from repro_torch.kernels import flash_attention as fa
from test_torch_kernels_gpu import (FLASH_CASES, WIDE_FLASH_CASES,
                                    _flash_inputs)

F32_TOL = dict(atol=3e-5, rtol=1e-4)
NEG_INF = -1e30
TILE = 64  # keys per tile, as the kernel at D <= 128
WIDE_TILE = 32  # and at D in (128, 192]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits) to nearest, ties away
    from zero: cvt.rna.tf32.f32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm_3xtf32(a, b):
    (ah, al), (bh, bl) = split(a), split(b)
    return ah @ bl + al @ bh + ah @ bh


def mm_1xtf32(a, b):
    return tf32(a) @ tf32(b)


def emulated_flash(q, k, v, *, causal, window, mm, tile=TILE):
    """The kernel's forward: q pre-scaled in f32, products by ``mm``,
    masked scores at -1e30, running max / sum / accumulator in f32 over
    ``tile``-key tiles, out = acc / max(l, 1e-30)."""
    b, sq, h, d = q.shape
    sk, n_kv = k.shape[1], k.shape[2]
    qf = (q.float() * d ** -0.5).permute(0, 2, 1, 3)
    kf, vf = (t.float().permute(0, 2, 1, 3).repeat_interleave(h // n_kv, 1)
              for t in (k, v))
    rows = torch.arange(sq)[:, None] + (sk - sq)
    m = torch.full((b, h, sq, 1), NEG_INF)
    l = torch.zeros((b, h, sq, 1))
    acc = torch.zeros((b, h, sq, v.shape[-1]))
    for k0 in range(0, sk, tile):
        k1 = min(k0 + tile, sk)
        s = mm(qf, kf[:, :, k0:k1].transpose(-1, -2))
        cols = torch.arange(k0, k1)[None, :]
        ok = torch.ones((sq, k1 - k0), dtype=torch.bool)
        if causal:
            ok &= cols <= rows
        if window:
            ok &= cols > rows - window
        s = s.masked_fill(~ok, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + mm(p, vf[:, :, k0:k1])
        m = m_new
    return (acc / l.clamp_min(1e-30)).permute(0, 2, 1, 3)


def _excess(got, want, atol, rtol):
    return float(((got - want).abs() - (atol + rtol * want.abs())).max())


def test_tf32_rounds_as_cvt_rna():
    one = 1.0
    ulp = 2.0 ** -10  # TF32's mantissa step at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2),
                      one + ulp / 2 - 2 ** -20, one + 3 * ulp / 2, 3.0, -0.0],
                     dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0,
                         -0.0])
    assert torch.equal(tf32(x), want)
    # hi + lo carries ~21 bits: the split is within 2^-21 of x
    r = torch.as_tensor(np.random.default_rng(0).standard_normal(10_000)
                        .astype(np.float32))
    hi, lo = split(r)
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32(lo), lo)
    assert float(((hi + lo - r).abs() / r.abs()).max()) <= 2.0 ** -21


@pytest.mark.parametrize("b,sq,sk,h,kv,d,dv,causal,window",
                         FLASH_CASES + WIDE_FLASH_CASES)
def test_3xtf32_matches_plain_and_reference(b, sq, sk, h, kv, d, dv, causal,
                                            window):
    q, k, v = _flash_inputs(sq + d, b, sq, sk, h, kv, d, dv, torch.float32)
    got = emulated_flash(q, k, v, causal=causal, window=window,
                         mm=mm_3xtf32, tile=TILE if d <= 128 else WIDE_TILE)
    plain = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    ref = flash_attention_jnp(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                              causal=causal, window=window, q_block=sq,
                              k_block=sk)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **F32_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)


@pytest.mark.parametrize("b,sq,sk,h,kv,d,dv,causal,window",
                         [c for c in FLASH_CASES if c[5] == 128])
def test_1xtf32_misses_the_f32_bar(b, sq, sk, h, kv, d, dv, causal, window):
    q, k, v = _flash_inputs(sq + d, b, sq, sk, h, kv, d, dv, torch.float32)
    plain = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    one = emulated_flash(q, k, v, causal=causal, window=window,
                         mm=mm_1xtf32)
    three = emulated_flash(q, k, v, causal=causal, window=window,
                           mm=mm_3xtf32)
    assert _excess(one, plain, **F32_TOL) > 0
    assert _excess(three, plain, **F32_TOL) <= 0
