"""The WKV6 kernel's chunked design, emulated on the CPU, against the
reference.

``csrc/wkv6.cu`` runs the recurrence in chunks of L steps: a pass that
forms each chunk's state from a zero state (sum over its steps of k_t
times the product of w over the later steps, outer v_t, latest step
first) and its per-row decay product, a scan that carries the state
across chunks, and a pass that reruns each chunk from its carried state
and emits o.  ``emulate`` does the same three passes in float32 with the
kernel's order of operations (products with a separate rounding where
the kernel fuses a multiply-add): o's row sums per row group of N / 4
rows, the groups combined as (g0 + g2) + (g1 + g3), and the bonus
sum_i r u k in quads of rows added pairwise across the lanes that loaded
them.  It is held to the JAX
package's exact recurrence ``wkv6_recurrent`` and its Pallas kernel (in
interpret mode) at the kernel tests' tolerance (atol 5e-4, rtol 1e-3),
at the wrapper's L and at the smallest L it picks, over head dims 16, 32
and 64, S = 1, L - 1, L, L + 1 and 3 L + 5, and decay scales 0.05, 1 and
5; the final state too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6 import wkv6_pallas
from repro.models.rwkv6 import wkv6_recurrent
from repro_torch.kernels import _build

TOL = dict(atol=5e-4, rtol=1e-3)
L_MAIN = _build.STEPS_PER_CTA


def _inputs(seed, b, s, h, n, decay_scale=1.0):
    rng = np.random.default_rng(seed)
    mk = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    r, k, v = mk(b, s, h, n), mk(b, s, h, n), mk(b, s, h, n)
    lw = (-decay_scale * np.exp(mk(b, s, h, n))).astype(np.float32)
    return r, k, v, lw, (0.5 * mk(h, n)).astype(np.float32)


def _pairwise(x):
    """Sum over the last axis as a butterfly of shuffles adds it."""
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def _emit_chunk(state, r, k, v, w, bonus):
    """The recurrence over one chunk from ``state`` (B, H, N, N); r, k, v,
    w (B, T, H, N).  Returns o (B, T, H, N)."""
    n = state.shape[-1]
    ti = n // 4
    outs = []
    for t in range(k.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]
        # per row group, rows summed in order, as each thread does
        acc = []
        for g in range(4):
            a = torch.zeros_like(vt)
            for m in range(g * ti, (g + 1) * ti):
                a = a + rt[..., m, None] * state[..., m, :]
            acc.append(a)
        o = (acc[0] + acc[2]) + (acc[1] + acc[3])
        outs.append(o + bonus[:, t, :, None] * vt)
        state = wt[..., None] * state + kt[..., :, None] * vt[..., None, :]
    return torch.stack(outs, dim=1)


def _bonus(r, k, u):
    """sum_i r u k per step: fused over each quad of rows in order, then
    the quads added pairwise."""
    b, s, h, n = r.shape
    ru = (r * u).reshape(b, s, h, n // 4, 4)
    kq = k.reshape(b, s, h, n // 4, 4)
    a = ru[..., 0] * kq[..., 0]
    for x in range(1, 4):
        a = a + ru[..., x] * kq[..., x]
    return _pairwise(a)


def emulate(r, k, v, lw, u, steps):
    """The kernel's three passes in float32, ``steps`` steps per chunk.
    Returns (o, final state)."""
    b, s, h, n = r.shape
    r, k, v, lw, u = (torch.as_tensor(a) for a in (r, k, v, lw, u))
    w = torch.exp(lw)
    bonus = _bonus(r, k, u)
    bounds = [(c0, min(s, c0 + steps)) for c0 in range(0, s, steps)]
    zero = torch.zeros((b, h, n, n))
    # pass 1: each chunk's state from zero, latest step first, with k
    # scaled by the product of w over the chunk's later steps
    local, decay = [], []
    for c0, c1 in bounds:
        st, d = zero, torch.ones((b, h, n))
        for t in range(c1 - 1, c0 - 1, -1):
            st = st + (k[:, t] * d)[..., :, None] * v[:, t, :, None, :]
            d = d * w[:, t]
        local.append(st)
        decay.append(d)
    # scan: the state entering each chunk, and the final state
    carry, entering = zero, []
    for st, d in zip(local, decay):
        entering.append(carry)
        carry = d[..., None] * carry + st
    # pass 3: each chunk from its entering state, emitting o
    o = torch.zeros((b, s, h, n))
    for (c0, c1), st in zip(bounds, entering):
        o[:, c0:c1] = _emit_chunk(st, r[:, c0:c1], k[:, c0:c1],
                                  v[:, c0:c1], w[:, c0:c1], bonus[:, c0:c1])
    return o, carry


def _check(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("decay_scale", [0.05, 1.0, 5.0])
@pytest.mark.parametrize("s", [1, L_MAIN - 1, L_MAIN, L_MAIN + 1,
                               3 * L_MAIN + 5])
@pytest.mark.parametrize("n", [16, 32, 64])
def test_chunks_match_recurrence(n, s, decay_scale):
    arrays = _inputs(s + n, 1, s, 2, n, decay_scale)
    got = emulate(*arrays, L_MAIN)
    assert bool(torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all())
    _check(got, wkv6_recurrent(*map(jnp.asarray, arrays)))


@pytest.mark.parametrize("steps", [_build.MIN_STEPS, 17, L_MAIN])
@pytest.mark.parametrize("n,s", [(16, 3 * L_MAIN + 5), (64, L_MAIN + 1)])
def test_chunks_match_pallas(n, s, steps):
    """Against the TPU kernel (interpret mode, its chunk of 64), at the
    wrapper's L, its smallest, and an L off the 16-step staging."""
    arrays = _inputs(7 * s + n, 2, s, 2, n)
    want = wkv6_pallas(*map(jnp.asarray, arrays), chunk=64, tile=16,
                       interpret=True)
    _check(emulate(*arrays, steps), want)


@pytest.mark.parametrize("decay_scale", [0.05, 5.0])
def test_chunk_decay_underflow_is_exact_zero_carry(decay_scale):
    """At strong decay a chunk's decay product underflows to 0 and the
    carried state is the previous chunk's local state alone, which is the
    recurrence's value; at weak decay the carry spans many chunks."""
    arrays = _inputs(3, 1, 4 * _build.MIN_STEPS + 3, 2, 16, decay_scale)
    w = torch.exp(torch.as_tensor(arrays[3][:, :4 * _build.MIN_STEPS]))
    chunk_decay = w.reshape(1, 4, _build.MIN_STEPS, 2, 16).prod(dim=2)
    assert bool((chunk_decay == 0).any()) == (decay_scale > 1)
    _check(emulate(*arrays, _build.MIN_STEPS),
           wkv6_recurrent(*map(jnp.asarray, arrays)))


@pytest.mark.parametrize("bh,s,n_sms,want", [
    (128, 2048, 132, 256),   # rwkv6-1.6b prefill, B 4 x H 32: 1,024 CTAs
    (32, 2048, 132, 64),     # batch 1: 1,024 CTAs
    (16, 2048, 132, 32),     # halved until four CTAs per SM
    (1, 2048, 132, 16),      # the floor
    (1, 1, 132, 16),
    (128, 300, 132, 64),
])
def test_chunk_len(bh, s, n_sms, want):
    steps = _build.chunk_len(bh, s, n_sms)
    assert steps == want
    assert bh * -(-s // steps) >= min(_build.CTAS_PER_SM * n_sms,
                                      bh * -(-s // _build.MIN_STEPS))
