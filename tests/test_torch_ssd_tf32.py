"""The SSD kernel's arithmetic, emulated on the CPU.

The kernel (``csrc/ssd.cu``, ``ssd_kernel``) walks 64-step chunks with a
float64 in-chunk decay and runs the chunked form's four products on the
tensor cores in split precision: each operand a becomes hi = tf32(a) and
lo = tf32(a - hi) (round to nearest, ties away, as ``cvt.rna``), and a.b
is taken as hi.hi + (lo.hi + hi.lo) with float32 accumulation.  Each CTA
owns a slice of PS columns of P and carries that slice of the state.
The emulation below repeats that arithmetic in torch, slice by slice and
chunk by chunk, and is held to the plain version evaluated in float64
and to the JAX reference's ``ssd_pallas`` (interpret mode) at the
kernel's bar (atol 3e-4, rtol 1e-3): the ``gpu`` tests' shapes, ragged S,
G = 2, both slice widths, a non-zero initial state and strong decay.  One
TF32 product alone keeps about three digits and misses that bar.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ssd_pallas
from repro_torch.kernels import ssd as sk
from test_torch_flash_tf32 import split, tf32
from test_torch_kernels_gpu import SSD_CASES, _ssd_inputs

TOL = dict(atol=3e-4, rtol=1e-3)
Q = 64  # the kernel's chunk


def mm_3xtf32(a, b):
    """The big term and the two small ones summed apart, then added."""
    (ah, al), (bh, bl) = split(a), split(b)
    return ah @ bh + (al @ bh + ah @ bl)


def mm_1xtf32(a, b):
    return tf32(a) @ tf32(b)


def emulated_ssd(x, dt, a, bm, cm, d=None, init_state=None, *, ps=32,
                 mm=mm_3xtf32):
    """The kernel's scan: per slice of ``ps`` columns of P and per 64-step
    chunk, dac as a float64 cumsum of dt a, then scores = C B^T decayed by
    exp(f32(dac_t - dac_s)) dt_s below the diagonal, y = scores x +
    exp(dac_t) C S^T + d x, S' = exp(dac_Q) S + (x w)^T B with w_s = dt_s
    exp(f32(dac_Q - dac_s)); products by ``mm``."""
    b, s, h, p = x.shape
    hg = h // bm.shape[2]
    heads = lambda t: t.repeat_interleave(hg, 2).permute(0, 2, 1, 3)
    bh_, ch_ = heads(bm), heads(cm)                  # (b, h, s, n)
    xh, dth = x.permute(0, 2, 1, 3), dt.permute(0, 2, 1)
    dsk = torch.zeros(h) if d is None else d
    y = torch.empty((b, h, s, p))
    state = torch.empty((b, h, p, bm.shape[3]))
    for p0 in range(0, p, ps):
        xs = xh[..., p0:p0 + ps]
        st = (torch.zeros((b, h, xs.shape[-1], bm.shape[3]))
              if init_state is None else init_state[:, :, p0:p0 + ps].clone())
        for t0 in range(0, s, Q):
            t1 = min(t0 + Q, s)
            xc, bc, cc = xs[:, :, t0:t1], bh_[:, :, t0:t1], ch_[:, :, t0:t1]
            dtc = dth[:, :, t0:t1]
            dac = torch.cumsum(dtc.double() * a.double()[None, :, None], -1)
            e = torch.exp(dac.float())
            w = dtc * torch.exp((dac[..., -1:] - dac).float())
            rows = torch.arange(t1 - t0)
            below = rows[None, :] <= rows[:, None]
            decay = torch.exp((dac[..., :, None] - dac[..., None, :]).float())
            scores = torch.where(below, mm(cc, bc.transpose(-1, -2)) * decay
                                 * dtc[..., None, :], 0.0)
            y[:, :, t0:t1, p0:p0 + ps] = (
                mm(scores, xc) + e[..., None] * mm(cc, st.transpose(-1, -2))
                + dsk[None, :, None, None] * xc)
            st = e[..., -1, None, None] * st + mm(
                (xc * w[..., None]).transpose(-1, -2), bc)
        state[:, :, p0:p0 + ps] = st
    return y.permute(0, 2, 1, 3), state


def _excess(got, want):
    return float(((got.double() - want).abs()
                  - (TOL["atol"] + TOL["rtol"] * want.abs())).max())


def _float64_plain(args, init_state=None):
    return sk.ssd_plain(*(None if t is None else t.double() for t in args),
                        chunk=32,
                        init_state=None if init_state is None
                        else init_state.double())


def test_split_keeps_float32_level_products():
    """hi + lo carries ~21 bits of each operand, so the three products
    land within a few float32 roundings of the float64 product."""
    rng = np.random.default_rng(1)
    a, b = (torch.as_tensor(rng.standard_normal((64, 64)).astype(np.float32))
            for _ in range(2))
    exact = a.double() @ b.double()
    scale = (a.double().abs() @ b.double().abs())
    err3 = float(((mm_3xtf32(a, b).double() - exact).abs() / scale).max())
    err1 = float(((mm_1xtf32(a, b).double() - exact).abs() / scale).max())
    assert err3 <= 2e-6 < 2e-4 <= err1


@pytest.mark.parametrize("b,s,h,p,g,n", SSD_CASES + [
    (1, 200, 2, 48, 1, 48), (2, 130, 8, 16, 2, 16)])
@pytest.mark.parametrize("ps", [16, 32])
def test_3xtf32_matches_float64_plain_and_reference(b, s, h, p, g, n, ps):
    args = _ssd_inputs(s + p, b, s, h, p, g, n)
    y, st = emulated_ssd(*args, ps=ps)
    want_y, want_s = _float64_plain(args)
    assert _excess(y, want_y) <= 0 and _excess(st, want_s) <= 0
    ref_y, ref_s = ssd_pallas(*(jnp.asarray(t.numpy()) for t in args),
                              chunk=min(32, s))
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(ref_s), **TOL)


def test_initial_state_strong_decay_and_no_skip():
    """From a non-zero state, without the D term, and under strong decay
    (dt 50x: the in-chunk decay reaches hundreds, where a float32 cumsum
    loses exp(dac_t - dac_s)'s digits near the diagonal)."""
    args = _ssd_inputs(5, 2, 150, 4, 32, 2, 16)[:5]
    init = torch.as_tensor(np.random.default_rng(6).standard_normal(
        (2, 4, 32, 16)).astype(np.float32))
    y, st = emulated_ssd(*args, init_state=init, ps=16)
    want_y, want_s = _float64_plain(args + (None,), init)
    assert _excess(y, want_y) <= 0 and _excess(st, want_s) <= 0
    strong = _ssd_inputs(7, 1, 200, 2, 16, 1, 16, decay_scale=50.0)
    y, st = emulated_ssd(*strong)
    want_y, want_s = _float64_plain(strong)
    assert bool(torch.isfinite(y).all() and torch.isfinite(st).all())
    assert _excess(y, want_y) <= 0 and _excess(st, want_s) <= 0


def test_zamba2_head_at_full_length():
    """zamba2-1.2b's head shape (P = N = 64) over S = 2048 for two heads:
    the state carries 32 chunks of split-precision updates."""
    args = _ssd_inputs(8, 1, 2048, 2, 64, 1, 64)
    y, st = emulated_ssd(*args)
    want_y, want_s = _float64_plain(args)
    assert _excess(y, want_y) <= 0 and _excess(st, want_s) <= 0


def test_1xtf32_misses_the_bar():
    args = _ssd_inputs(8, 1, 2048, 2, 64, 1, 64)
    want_y, _ = _float64_plain(args)
    y, _ = emulated_ssd(*args, mm=mm_1xtf32)
    assert _excess(y, want_y) > 0
