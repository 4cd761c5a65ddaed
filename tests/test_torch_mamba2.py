"""The port's Mamba2 against the JAX reference on the CPU.

``ssd_plain`` (what the ``ssd`` wrapper runs for CPU tensors) is held to
the reference's Pallas kernel in interpret mode, to its ``ssd_chunked``
plus the D term, and to ``tests/test_kernels_ssd.py``'s exact
recurrence, over that file's shapes (G = 2, ragged S = 100) and chunks
16/32/64 at its tolerance (atol 3e-4, rtol 1e-3); a strongly decaying
case stays finite; ``gated_rmsnorm``, ``mamba2_forward`` (its conv tail
and final state, also from a state) and ``mamba2_decode`` are held to
the reference's at the zamba2 smoke width with the same weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ssd_pallas
from repro.models import layers as jL
from repro.models import mamba2 as jm2
from repro.models.config import Mamba2Config as JMamba2Config
from repro_torch.convert import _map_tree
from repro_torch.kernels import ssd as sk
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as m2
from repro_torch.models.config import Mamba2Config
from test_kernels_ssd import _ref_recurrence

TOL = dict(atol=3e-4, rtol=1e-3)


def _inputs(seed, b, s, h, p, g, n, decay_scale=1.0):
    """x, dt (post-softplus), a < 0, B, C, d_skip as float32 numpy."""
    rng = np.random.default_rng(seed)
    mk = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    x = mk(b, s, h, p)
    dt = (decay_scale * np.log1p(np.exp(mk(b, s, h)))).astype(np.float32)
    a = (-np.exp(mk(h))).astype(np.float32)
    bm, cm = mk(b, s, g, n), mk(b, s, g, n)
    d = np.linspace(0.5, 1.5, h).astype(np.float32)
    return x, dt, a, bm, cm, d


def _t(arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("b,s,h,p,g,n", [
    (1, 64, 2, 8, 1, 8),
    (2, 96, 4, 16, 2, 8),
    (1, 100, 2, 8, 1, 8),  # non-multiple S
])
@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_plain_matches_pallas_chunked_and_recurrence(b, s, h, p, g, n,
                                                     chunk):
    arrays = _inputs(s + chunk, b, s, h, p, g, n)
    x, dt, a, bm, cm, d = map(jnp.asarray, arrays)
    y_rec, s_rec = _ref_recurrence(x, dt, a, bm, cm, d)
    y_pal, s_pal = ssd_pallas(x, dt, a, bm, cm, d, chunk=chunk)
    y_chk, s_chk = jm2.ssd_chunked(
        x, dt, a, bm, cm, JMamba2Config(d_state=n, chunk_size=chunk))
    y_chk = y_chk + x * d[None, None, :, None]
    y, st = sk.ssd(*_t(arrays), chunk=chunk)
    assert y.shape == (b, s, h, p) and st.shape == (b, h, p, n)
    for want_y, want_s in ((y_rec, s_rec), (y_pal, s_pal), (y_chk, s_chk)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(want_s), **TOL)


@pytest.mark.parametrize("chunk", [16, 64])
def test_plain_from_a_state_matches(chunk):
    x, dt, a, bm, cm, _ = _inputs(3, 2, 70, 4, 16, 2, 8)
    init = np.random.default_rng(4).standard_normal(
        (2, 4, 16, 8)).astype(np.float32)
    want_y, want_s = jm2.ssd_chunked(
        *map(jnp.asarray, (x, dt, a, bm, cm)),
        JMamba2Config(d_state=8, chunk_size=chunk),
        init_state=jnp.asarray(init))
    y, st = sk.ssd(*_t((x, dt, a, bm, cm)), None, chunk=chunk,
                   init_state=torch.as_tensor(init))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(want_s), **TOL)


def test_plain_strong_decay_stays_finite():
    arrays = _inputs(5, 2, 128, 2, 16, 1, 16, decay_scale=50.0)
    y_rec, s_rec = _ref_recurrence(*map(jnp.asarray, arrays))
    y, st = sk.ssd_plain(*_t(arrays), chunk=64)
    assert bool(torch.isfinite(y).all() and torch.isfinite(st).all())
    np.testing.assert_allclose(y.numpy(), np.asarray(y_rec), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(s_rec), **TOL)


def test_wrapper_cpu_route_and_checks():
    x, dt, a, bm, cm, d = _t(_inputs(6, 1, 40, 4, 8, 2, 8))
    before = sk.LAUNCHES["ssd"]
    y, st = sk.ssd(x, dt, a, bm, cm, d, chunk=16)
    y2, st2 = sk.ssd_plain(x, dt, a, bm, cm, d, chunk=16)
    assert torch.equal(y, y2) and torch.equal(st, st2)
    assert sk.LAUNCHES["ssd"] == before
    with pytest.raises(TypeError):
        sk.ssd(x.double(), dt, a, bm, cm, d)
    with pytest.raises(TypeError):
        sk.ssd(x, dt, a.double(), bm, cm, d)
    with pytest.raises(ValueError, match="shape"):
        sk.ssd(x, dt[:, 1:], a, bm, cm, d)
    with pytest.raises(ValueError, match="shape"):
        sk.ssd(x, dt, a, bm, cm, d[:1])
    with pytest.raises(ValueError, match="multiple of groups"):
        sk.ssd(x[:, :, :3], dt[:, :, :3], a[:3], bm, cm, d[:3])


def test_gated_rmsnorm_matches():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    gate = (3 * rng.standard_normal((2, 9, 64))).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    want = jL.gated_rmsnorm({"scale": scale}, x, gate, 1e-5)
    got = L.gated_rmsnorm({"scale": torch.as_tensor(scale)},
                          torch.as_tensor(x), torch.as_tensor(gate), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert L.init_gated_rmsnorm(64, torch.float32, "cpu")["scale"].shape \
        == (64,)


# the zamba2 smoke width: d_model 128, 8 heads of 32, N 16, chunk 16
D_MODEL = 128
SMOKE = dict(d_state=16, d_conv=4, expand=2, head_dim=32, n_groups=1,
             chunk_size=16)


def _mixer(seed, n_groups=1):
    kw = dict(SMOKE, n_groups=n_groups)
    jmc, mc = JMamba2Config(**kw), Mamba2Config(**kw)
    p = jax.tree.map(np.asarray, jm2.init_mamba2(jax.random.PRNGKey(seed),
                                                 D_MODEL, jmc, jnp.float32))
    rng = np.random.default_rng(seed)
    # move the constant inits off their defaults so every term (conv
    # bias, D skip, dt bias, norm scale) takes part
    for name in ("conv_b", "D", "dt_bias"):
        p[name] = (p[name] + 0.3 * rng.standard_normal(
            p[name].shape)).astype(np.float32)
    p["norm"]["scale"] = (1 + 0.3 * rng.standard_normal(
        p["norm"]["scale"].shape)).astype(np.float32)
    return jmc, mc, p, _map_tree(p, lambda a: torch.as_tensor(a.copy()))


@pytest.mark.parametrize("s,n_groups", [(37, 1), (16, 2), (2, 1)])
def test_mamba2_forward_matches(s, n_groups):
    jmc, mc, jp, tp = _mixer(s, n_groups)
    x = np.random.default_rng(s + 1).standard_normal(
        (2, s, D_MODEL)).astype(np.float32)
    want, (want_tail, want_ssm) = jm2.mamba2_forward(jp, jnp.asarray(x),
                                                     jmc, 1e-5)
    got, (tail, ssm) = m2.mamba2_forward(tp, torch.as_tensor(x), mc, 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(tail.numpy(), np.asarray(want_tail),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ssm.numpy(), np.asarray(want_ssm), **TOL)
    # and on from that state, conv tail included
    x2 = np.random.default_rng(s + 2).standard_normal(
        (2, 11, D_MODEL)).astype(np.float32)
    want2, (wt2, ws2) = jm2.mamba2_forward(
        jp, jnp.asarray(x2), jmc, 1e-5,
        init_state=(want_tail, want_ssm))
    got2, (t2, s2) = m2.mamba2_forward(tp, torch.as_tensor(x2), mc, 1e-5,
                                       init_state=(tail, ssm))
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(t2.numpy(), np.asarray(wt2), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(s2.numpy(), np.asarray(ws2), **TOL)


def test_mamba2_forward_hands_strided_views_and_d_to_the_scan(monkeypatch):
    """x, B and C reach the scan as strided views of the conv output (no
    copy) and the D skip term is folded into the call."""
    _, mc, _, tp = _mixer(8)
    seen = {}

    def spy(x, dt, a, b, c, d_skip, **kw):
        seen.update(x_contig=x.is_contiguous(), b_contig=b.is_contiguous(),
                    d=d_skip)
        return sk.ssd(x, dt, a, b, c, d_skip, **kw)

    monkeypatch.setattr(m2, "ssd", spy)
    m2.mamba2_forward(tp, torch.randn(2, 20, D_MODEL), mc, 1e-5)
    assert not seen["x_contig"] and not seen["b_contig"]
    assert seen["d"] is tp["D"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d_inner,gn,heads", [(4096, 64, 64), (256, 16, 8)])
def test_scan_operands_of_the_model_need_no_copy(dtype, d_inner, gn, heads):
    """The kernel copies x, B and C in 16-byte pieces: at zamba2-1.2b's
    and the smoke config's conv layout the model's slices already start
    on 16 bytes with strides of whole 16-byte pieces, so the wrapper
    hands them over as they are; a view one element off is copied into an
    aligned buffer with the same values."""
    from repro_torch.kernels import _build
    conv = torch.zeros((2, 5, d_inner + 2 * gn), dtype=dtype)
    xs = conv[..., :d_inner].reshape(2, 5, heads, d_inner // heads)
    bs = conv[..., d_inner:d_inner + gn].reshape(2, 5, 1, gn)
    cs = conv[..., d_inner + gn:].reshape(2, 5, 1, gn)
    assert all(_build.aligned(t) is t for t in (xs, bs, cs))
    off = torch.randn((2, 5, d_inner + 1)).to(dtype)[..., 1:]
    xo = off.reshape(2, 5, heads, d_inner // heads)
    copied = _build.aligned(xo)
    assert copied is not xo and torch.equal(copied, xo)
    assert copied.data_ptr() % 16 == 0


def test_mamba2_decode_matches():
    jmc, mc, jp, tp = _mixer(9)
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 13, D_MODEL)).astype(np.float32)
    _, jstate = jm2.mamba2_forward(jp, jnp.asarray(x), jmc, 1e-5)
    _, state = m2.mamba2_forward(tp, torch.as_tensor(x), mc, 1e-5)
    tail, ssm = state
    for i in range(4):
        x1 = rng.standard_normal((2, 1, D_MODEL)).astype(np.float32)
        want, jstate = jm2.mamba2_decode(jp, jnp.asarray(x1), jstate, jmc,
                                         1e-5)
        got, (tail2, ssm2) = m2.mamba2_decode(tp, torch.as_tensor(x1),
                                              (tail, ssm), mc, 1e-5)
        assert tail2 is tail and ssm2 is ssm  # updated in place
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4, err_msg=str(i))
        np.testing.assert_allclose(tail.numpy(), np.asarray(jstate[0]),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(ssm.numpy(), np.asarray(jstate[1]),
                                   **TOL)
