"""The port's attention against the JAX reference on the CPU.

``flash_attention_plain`` (the kernel's plain version, which the
``flash_attention`` wrapper runs for CPU tensors) is held to the
reference's Pallas kernel in interpret mode — as
``tests/test_kernels_flash.py`` runs it — and to its ``naive_attention``
oracle, at that test's tolerances (f32: atol 3e-5 / rtol 1e-4; bf16:
3e-2), over MHA/GQA/MQA, windows, the zoo's head dims, Dk != Dv, ragged
S and a continuation (Sq < Sk).  ``decode_attention`` is held to the
reference's on a wrapped ring.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import attention as jattn
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention as attn

F32_TOL = dict(atol=3e-5, rtol=1e-4)
BF16_TOL = dict(atol=3e-2, rtol=3e-2)


def _inputs(seed, b, sq, sk, h, kv, d, dv=None):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    return mk(b, sq, h, d), mk(b, sk, kv, d), mk(b, sk, kv, dv or d)


def _port(fn, arrays, dtype=torch.float32, **kw):
    out = fn(*(torch.as_tensor(a).to(dtype) for a in arrays), **kw)
    return out.float().numpy()


@pytest.mark.parametrize("b,s,h,kv,d", [
    (1, 128, 4, 4, 32),   # MHA
    (2, 128, 8, 2, 64),   # GQA 4x
    (1, 128, 4, 1, 64),   # MQA
    (1, 128, 4, 2, 60),   # danube's non-128-aligned family
    (2, 64, 2, 2, 128),   # large head_dim
])
@pytest.mark.parametrize("window", [0, 64])
def test_plain_matches_pallas_and_naive(b, s, h, kv, d, window):
    q, k, v = _inputs(b * s + d + window, b, s, s, h, kv, d)
    ref = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=True, window=window,
                                 q_blk=64, kv_blk=64)
    naive = jattn.naive_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True,
                                  window=window)
    got = _port(attn.flash_attention_plain, (q, k, v), window=window,
                q_block=64, k_block=64)
    np.testing.assert_allclose(got, np.asarray(ref), **F32_TOL)
    np.testing.assert_allclose(got, np.asarray(naive), **F32_TOL)
    np.testing.assert_allclose(
        _port(attn.naive_attention, (q, k, v), window=window),
        np.asarray(naive), **F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_dtypes_match_pallas(dtype):
    q, k, v = _inputs(3, 2, 128, 128, 4, 2, 32)
    jd = getattr(jnp, dtype)
    ref = flash_attention_pallas(*(jnp.asarray(a).astype(jd)
                                   for a in (q, k, v)),
                                 causal=True, q_blk=64, kv_blk=64)
    got = fa.flash_attention(*(torch.as_tensor(a).to(getattr(torch, dtype))
                               for a in (q, k, v)), causal=True)
    assert got.dtype == getattr(torch, dtype)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), **tol)


def test_plain_dk_neq_dv_and_noncausal():
    q, k, v = _inputs(4, 2, 128, 128, 4, 4, 48, 32)
    ref = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=True, q_blk=64,
                                 kv_blk=64)
    np.testing.assert_allclose(
        _port(attn.flash_attention_plain, (q, k, v), q_block=64,
              k_block=64), np.asarray(ref), **F32_TOL)
    q, k, v = _inputs(5, 1, 128, 128, 2, 2, 32)
    ref = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=False, q_blk=64,
                                 kv_blk=64)
    np.testing.assert_allclose(
        _port(fa.flash_attention, (q, k, v), causal=False),
        np.asarray(ref), **F32_TOL)


@pytest.mark.parametrize("sq,sk,window,blk", [
    (100, 100, 0, 64), (200, 200, 48, 64), (37, 165, 0, 32),
    (1, 77, 16, 32), (70, 70, 0, 512)])
def test_plain_ragged_and_continuation_match_naive(sq, sk, window, blk):
    """Any S (the reference's kernel needs block multiples) and query
    rows aligned to the end of the keys (q_off = Sk - Sq)."""
    q, k, v = _inputs(sq + sk, 2, sq, sk, 4, 2, 32)
    want = jattn.naive_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=True, window=window)
    got = _port(attn.flash_attention_plain, (q, k, v), window=window,
                q_block=blk, k_block=blk)
    np.testing.assert_allclose(got, np.asarray(want), **F32_TOL)


def test_wrapper_cpu_route_is_the_plain_version():
    q, k, v = _inputs(6, 1, 96, 96, 4, 2, 64)
    before = fa.LAUNCHES["flash_attention"]
    got = _port(fa.flash_attention, (q, k, v), window=40)
    want = _port(attn.flash_attention_plain, (q, k, v), window=40)
    np.testing.assert_array_equal(got, want)
    assert fa.LAUNCHES["flash_attention"] == before  # no kernel launched


def test_wrapper_rejects_bad_inputs():
    q, k, v = (torch.as_tensor(a) for a in _inputs(7, 1, 8, 4, 4, 2, 32))
    with pytest.raises(ValueError, match="Sq <= Sk"):
        fa.flash_attention(q, k, v, causal=True)
    q, k, v = (torch.as_tensor(a) for a in _inputs(7, 1, 8, 8, 4, 3, 32))
    with pytest.raises(ValueError, match="multiple of kv heads"):
        fa.flash_attention(q, k, v)
    q, k, v = (torch.as_tensor(a) for a in _inputs(7, 1, 8, 8, 4, 2, 32))
    with pytest.raises(TypeError):
        fa.flash_attention(q, k.double(), v)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), k.half(), v.half())


def test_decode_attention_on_a_wrapped_ring():
    """One query against a ring whose slots hold keys out of order, with
    some slots not yet filled."""
    rng = np.random.default_rng(8)
    b, cap, h, kv, d = 2, 24, 4, 2, 32
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    kc = rng.standard_normal((b, cap, kv, d)).astype(np.float32)
    vc = rng.standard_normal((b, cap, kv, d)).astype(np.float32)
    for n_valid in (7, cap):
        valid = np.broadcast_to(np.roll(np.arange(cap) < n_valid, 5),
                                (b, cap))
        want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                      jnp.asarray(vc), jnp.asarray(valid))
        got = attn.decode_attention(
            torch.as_tensor(q), torch.as_tensor(kc), torch.as_tensor(vc),
            torch.as_tensor(valid.copy()))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **F32_TOL)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 64), (torch.float32, 60),
                                     (torch.bfloat16, 128),
                                     (torch.bfloat16, 60)])
def test_wrapper_hands_the_kernel_aligned_operands(dtype, d):
    """What the wrapper passes the kernel's 16-byte copies: an aligned
    operand as it is; a view that starts off 16 bytes, or bf16 rows of 60
    columns, as a copy whose strides are multiples of 16 bytes; an axis
    of length 1 with a stride past the tensor."""
    unit = 16 // torch.empty((), dtype=dtype).element_size()
    q = torch.as_tensor(_inputs(9, 2, 5, 5, 3, 1, d)[0]).to(dtype)
    for t in (q, q.transpose(1, 2).contiguous().transpose(1, 2),
              torch.nn.functional.pad(q, (2, 6))[..., 2:2 + d], q[:, :1]):
        a = _build.aligned(t)
        assert torch.equal(a, t)
        assert a.data_ptr() % 16 == 0
        assert all(s % unit == 0 for s in _build.row_strides(a))
        aligned = t.data_ptr() % 16 == 0 and all(
            t.stride(i) % unit == 0 for i in range(3) if t.shape[i] > 1)
        assert (a is t) == aligned
    assert _build.row_strides(q[:, :1])[1] >= q[:, :1].numel()
