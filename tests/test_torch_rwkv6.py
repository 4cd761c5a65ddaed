"""The port's RWKV6 against the JAX reference on the CPU.

``wkv6_plain`` (the chunked form the ``wkv6`` wrapper runs for CPU
tensors) is held to the reference's Pallas kernel in interpret mode and
to its exact recurrence, at ``tests/test_kernels_wkv6.py``'s tolerances
(atol 5e-4 / rtol 1e-3; bf16 5e-2) and over its shapes, chunks and decay
regimes; the time-mix and channel-mix blocks are held to the
reference's with the same weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6 import wkv6_pallas
from repro.models import rwkv6 as jr6
from repro.models.config import RWKV6Config as JRWKV6Config
from repro_torch.convert import _map_tree
from repro_torch.kernels import wkv6 as wk
from repro_torch.models import rwkv6 as r6
from repro_torch.models.config import RWKV6Config
from repro_torch.models.layers import ParamTree

TOL = dict(atol=5e-4, rtol=1e-3)


def _inputs(seed, b, s, h, n, decay_scale=1.0):
    rng = np.random.default_rng(seed)
    mk = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    r, k, v = mk(b, s, h, n), mk(b, s, h, n), mk(b, s, h, n)
    lw = (-decay_scale * np.exp(mk(b, s, h, n))).astype(np.float32)
    return r, k, v, lw, (0.5 * mk(h, n)).astype(np.float32)


def _t(arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("b,s,h,n", [(1, 64, 2, 16), (2, 128, 3, 32),
                                     (1, 200, 2, 16)])  # non-multiple S
@pytest.mark.parametrize("chunk", [64, 16])
def test_plain_matches_pallas_and_recurrence(b, s, h, n, chunk):
    arrays = _inputs(s + chunk, b, s, h, n)
    o_ref, s_ref = jr6.wkv6_recurrent(*map(jnp.asarray, arrays))
    o_pl, s_pl = wkv6_pallas(*map(jnp.asarray, arrays), chunk=chunk,
                             tile=16)
    o, st = wk.wkv6(*_t(arrays), chunk=chunk)
    for got, want in ((o, o_ref), (st, s_ref), (o, o_pl), (st, s_pl)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("decay_scale", [0.05, 1.0, 5.0])
def test_plain_extreme_decays_stable(decay_scale):
    arrays = _inputs(7, 2, 128, 2, 16, decay_scale)
    o_ref, s_ref = jr6.wkv6_recurrent(*map(jnp.asarray, arrays))
    o, st = wk.wkv6_plain(*_t(arrays), chunk=64)
    assert bool(torch.isfinite(o).all())
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(s_ref), **TOL)


def test_plain_bfloat16():
    r, k, v, lw, u = _inputs(9, 1, 64, 2, 16)
    rb, kb, vb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (r, k, v))
    o_ref, _ = jr6.wkv6_recurrent(rb.astype(jnp.float32),
                                  kb.astype(jnp.float32),
                                  vb.astype(jnp.float32), lw, u)
    tb = [torch.as_tensor(a).to(torch.bfloat16) for a in (r, k, v)]
    o, _ = wk.wkv6(*tb, torch.as_tensor(lw), torch.as_tensor(u), chunk=32)
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(o_ref, np.float32), atol=5e-2,
                               rtol=5e-2)


def test_recurrence_from_a_state_matches():
    arrays = _inputs(11, 2, 5, 2, 16)
    state = np.random.default_rng(12).standard_normal(
        (2, 2, 16, 16)).astype(np.float32)
    o_ref, s_ref = jr6.wkv6_recurrent(*map(jnp.asarray, arrays),
                                      init_state=jnp.asarray(state))
    o, st = r6.wkv6_recurrent(*_t(arrays), init_state=torch.as_tensor(state))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(s_ref), **TOL)


def test_wrapper_cpu_route_and_checks():
    arrays = _t(_inputs(13, 1, 40, 2, 16))
    before = wk.LAUNCHES["wkv6"]
    o, st = wk.wkv6(*arrays, chunk=16)
    o2, st2 = r6.wkv6_chunked(*arrays, chunk=16)
    assert torch.equal(o, o2) and torch.equal(st, st2)
    assert wk.LAUNCHES["wkv6"] == before
    r, k, v, lw, u = arrays
    with pytest.raises(TypeError):
        wk.wkv6(r, k, v, lw.double(), u)
    with pytest.raises(ValueError, match="shape"):
        wk.wkv6(r, k, v, lw, u[:1])
    with pytest.raises(ValueError, match="contiguous"):
        wk.wkv6(r.transpose(1, 2).contiguous().transpose(1, 2), k, v, lw, u)


def _block_params(seed, d, d_ff, jrc):
    p = jr6.init_rwkv6(jax.random.PRNGKey(seed), d, d_ff, jrc, jnp.float32)
    rng = np.random.default_rng(seed)
    # move the zero / constant inits off their defaults so every term
    # (u bonus, mixing offsets, norm affine) takes part
    p = jax.tree.map(np.asarray, p)
    for name in ("mu_x", "u", "ln_x_bias", "w0"):
        p["tm"][name] = (p["tm"][name] + 0.3 * rng.standard_normal(
            p["tm"][name].shape)).astype(np.float32)
    return p, ParamTree(_map_tree(p, lambda a: torch.as_tensor(a.copy())))


@pytest.mark.parametrize("s,chunk", [(24, 16), (7, 64)])
def test_time_mix_and_channel_mix_match(s, chunk):
    d, d_ff, n = 128, 224, 32
    jrc = JRWKV6Config(head_dim=n, token_shift_rank=8, decay_rank=16,
                       chunk_size=chunk)
    rc = RWKV6Config(head_dim=n, token_shift_rank=8, decay_rank=16,
                     chunk_size=chunk)
    jp, tp = _block_params(s, d, d_ff, jrc)
    x = np.random.default_rng(s + 1).standard_normal((2, s, d)).astype(
        np.float32)
    xj, xt = jnp.asarray(x), torch.as_tensor(x)
    want, want_state = jr6.rwkv6_time_mix(jp["tm"], xj, jr6.token_shift(xj),
                                          jrc)
    got, state = r6.rwkv6_time_mix(tp["tm"], xt, r6.token_shift(xt), rc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_state),
                               **TOL)
    # one decode step from the prefill state, through the recurrence
    x1 = np.random.default_rng(s + 2).standard_normal((2, 1, d)).astype(
        np.float32)
    want1, _ = jr6.rwkv6_time_mix(jp["tm"], jnp.asarray(x1), xj[:, -1:],
                                  jrc, wkv_state=want_state,
                                  use_chunked=False)
    got1, _ = r6.rwkv6_time_mix(tp["tm"], torch.as_tensor(x1), xt[:, -1:],
                                rc, wkv_state=state)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(
        r6.rwkv6_channel_mix(tp["cm"], xt, r6.token_shift(xt)).numpy(),
        np.asarray(jr6.rwkv6_channel_mix(jp["cm"], xj,
                                         jr6.token_shift(xj))),
        atol=1e-4, rtol=1e-4)


def test_token_shift_matches():
    x = np.random.default_rng(3).standard_normal((2, 5, 8)).astype(
        np.float32)
    last = np.random.default_rng(4).standard_normal((2, 8)).astype(
        np.float32)
    np.testing.assert_array_equal(
        r6.token_shift(torch.as_tensor(x)).numpy(),
        np.asarray(jr6.token_shift(jnp.asarray(x))))
    np.testing.assert_array_equal(
        r6.token_shift(torch.as_tensor(x), torch.as_tensor(last)).numpy(),
        np.asarray(jr6.token_shift(jnp.asarray(x), jnp.asarray(last))))
