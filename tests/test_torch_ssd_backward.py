"""The SSD backward: the plain version against the JAX reference's VJP,
the backward kernels' algorithm emulated on the CPU against float64
autograd, and ``gradcheck`` of the autograd function.

``ssd_backward_plain`` (autograd through the port's ``ssd_chunked`` plus
the D skip term) is held to ``jax.vjp`` of the reference's
``ssd_chunked`` plus ``d * x`` within 1e-4 of each gradient's largest
magnitude (zamba2's gradient bar in ``test_torch_train_parity.py``): the
gradients of x, dt, a, B, C, D and the initial state, at a ragged S,
strong decay, G = 2, with a cotangent on the final state and a non-zero
initial state.

``emulate_backward`` repeats the passes of ``csrc/ssd.cu``'s backward in
float32 at the kernel's chunk lengths: each chunk's state from zero and
its gradient from a zero end gradient with its decay product, the scans
that carry both across chunks (dinit the last carry), per chunk a
forward walk (dC per head, <S_e, dS_out_c>) and a reverse walk (dx and
dS^T x per head), then a reverse walk over the per-head vectors for dt's
gradient with the chunk-local decay sums, dB = dt dS^T x, da's and dd's
per-chunk partials, and each group's heads summed.  It is held to
float64 autograd of the plain version within 1e-4 of each gradient's
largest magnitude, the bar the kernel meets on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.config import Mamba2Config
from repro.models.mamba2 import ssd_chunked as jssd_chunked
from repro_torch.kernels import _build
from repro_torch.kernels import ssd as sk

NAMES = ("dx", "ddt", "da", "db", "dc", "dd", "dinit")
VJP_BAR = 1e-4
KERNEL_BAR = 1e-4
L_MAIN = _build.STEPS_PER_CTA


def _inputs(seed, b, s, h, p, g, n, decay_scale=1.0, init=True,
            dstate=True):
    rng = np.random.default_rng(seed)
    mk = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    x = mk(b, s, h, p)
    dt = (decay_scale * np.log1p(np.exp(mk(b, s, h)))).astype(np.float32)
    a = (-np.exp(mk(h))).astype(np.float32)
    bm, cm = mk(b, s, g, n), mk(b, s, g, n)
    d = np.linspace(0.5, 1.5, h).astype(np.float32)
    st0 = mk(b, h, p, n) if init else None
    dy = mk(b, s, h, p)
    ds = mk(b, h, p, n) if dstate else None
    return (x, dt, a, bm, cm, d, st0), dy, ds


def _rel_to_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _assert_close(got, want, bar):
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None, name
            continue
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        w = w.detach().numpy() if isinstance(w, torch.Tensor) else w
        assert g.shape == w.shape, name
        assert np.isfinite(g).all(), name
        err = _rel_to_max(g, w)
        assert err <= bar, f"{name}: {err} of its largest magnitude"


def _torch(args):
    return [None if a is None else torch.as_tensor(a) for a in args]


CASES = [  # b, s, h, p, g, n, decay_scale, init, dstate, chunk
    (2, 64, 2, 8, 1, 8, 1.0, False, False, 16),
    (1, 100, 4, 16, 2, 8, 1.0, True, True, 32),    # ragged, G 2, init
    (2, 70, 2, 16, 1, 16, 8.0, True, True, 16),    # strong decay
    (1, 130, 4, 8, 2, 16, 0.05, False, True, 64),  # weak decay, P != N
    (1, 1, 2, 8, 1, 8, 1.0, True, True, 16),
]


@pytest.mark.parametrize("b,s,h,p,g,n,decay_scale,init,dstate,chunk", CASES)
def test_plain_backward_matches_reference_vjp(b, s, h, p, g, n, decay_scale,
                                              init, dstate, chunk):
    args, dy, ds = _inputs(s + p, b, s, h, p, g, n, decay_scale, init,
                           dstate)
    mc = Mamba2Config(d_state=n, head_dim=p, n_groups=g, chunk_size=chunk)

    def ref(x, dt, a, bm, cm, d, *st0):
        y, fin = jssd_chunked(x, dt, a, bm, cm, mc, st0[0] if st0 else None)
        return y + x * d[None, None, :, None], fin

    live = [jnp.asarray(t) for t in args if t is not None]
    cot = np.zeros((b, h, p, n), np.float32) if ds is None else ds
    grads = jax.jit(lambda cots, *a: jax.vjp(ref, *a)[1](cots))
    want = [np.asarray(w) for w in grads((jnp.asarray(dy), jnp.asarray(cot)),
                                         *live)]
    if not init:
        want.append(None)
    got = sk.ssd_backward_plain(*_torch(args), torch.as_tensor(dy),
                                None if ds is None else torch.as_tensor(ds),
                                chunk=chunk)
    _assert_close(got, want, VJP_BAR)


def emulate_backward(x, dt, a, bm, cm, d, init, dy, dstate, steps):
    """The backward kernels' passes in float32, ``steps`` steps a chunk:
    (dx, ddt, da, db, dc, dd, dinit)."""
    x, dt, a, bm, cm, d, dy = (torch.as_tensor(t)
                               for t in (x, dt, a, bm, cm, d, dy))
    b, s, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    hg = h // g
    bh, ch = (t.repeat_interleave(hg, dim=2) for t in (bm, cm))
    e = torch.exp(a * dt)
    bounds = [(c0, min(s, c0 + steps)) for c0 in range(0, s, steps)]
    outer = lambda col, row: col[..., :, None] * row[..., None, :]
    zero = torch.zeros((b, h, p, n))
    # pass 1: each chunk's state from zero and its gradient at its start
    # from a zero end gradient, with the chunk's decay product
    s_loc, d_loc, dec = [], [], []
    for c0, c1 in bounds:
        st, gr, run = zero, zero, torch.ones((b, h))
        for t in range(c0, c1):
            st = e[:, t, :, None, None] * st + outer(
                x[:, t], dt[:, t, :, None] * bh[:, t])
            run = run * e[:, t]
            gr = gr + outer(dy[:, t], run[..., None] * ch[:, t])
        s_loc.append(st)
        d_loc.append(gr)
        dec.append(run[..., None, None])
    # pass 2: S_in_c forward from the initial state, dS_out_c backward
    # from the final state's gradient; dinit the last carry
    carry, s_in = zero if init is None else torch.as_tensor(init), []
    for st, dc_ in zip(s_loc, dec):
        s_in.append(carry)
        carry = dc_ * carry + st
    carry = zero if dstate is None else torch.as_tensor(dstate)
    d_out = [None] * len(bounds)
    for c in reversed(range(len(bounds))):
        d_out[c] = carry
        carry = dec[c] * carry + d_loc[c]
    dinit = None if init is None else carry
    # pass 3: dC per head and <S_e, dS_out_c>; dx and dS^T x per head
    dx = torch.zeros_like(x)
    dc_h, dsx_h = torch.zeros((b, s, h, n)), torch.zeros((b, s, h, n))
    sds = []
    for (c0, c1), st, ds in zip(bounds, s_in, d_out):
        for t in range(c0, c1):
            st = e[:, t, :, None, None] * st + outer(
                x[:, t], dt[:, t, :, None] * bh[:, t])
            dc_h[:, t] = (st * dy[:, t, ..., None]).sum(-2)
        sds.append((st * ds).sum((-1, -2)))
        for t in range(c1 - 1, c0 - 1, -1):
            ds = ds + outer(dy[:, t], ch[:, t])
            dsx_h[:, t] = (ds * x[:, t, ..., None]).sum(-2)
            dx[:, t] = (dt[:, t, :, None] * (ds * bh[:, t, :, None, :]).sum(-1)
                        + d[:, None] * dy[:, t])
            ds = e[:, t, :, None, None] * ds
    # pass 4: dt's gradient with the chunk-local sums D_m = <S_e, dS_e> +
    # sum_{t >= m} (C . dC - B . dB); dB = dt dS^T x; da's and dd's
    # per-chunk partials
    ddt = torch.zeros_like(dt)
    db_h = torch.zeros_like(dsx_h)
    da_part, dd_part = [], []
    for (c0, c1), acc in zip(bounds, sds):
        da_c, dd_c = torch.zeros((b, h)), torch.zeros((b, h))
        for t in range(c1 - 1, c0 - 1, -1):
            cdc = (ch[:, t] * dc_h[:, t]).sum(-1)
            bsx = (bh[:, t] * dsx_h[:, t]).sum(-1)
            acc = acc + (cdc - dt[:, t] * bsx)
            ddt[:, t] = a * acc + bsx
            da_c = da_c + dt[:, t] * acc
            dd_c = dd_c + (dy[:, t] * x[:, t]).sum(-1)
            db_h[:, t] = dt[:, t, :, None] * dsx_h[:, t]
        da_part.append(da_c)
        dd_part.append(dd_c)
    da = torch.stack(da_part, dim=1).sum(dim=(0, 1))
    dd = torch.stack(dd_part, dim=1).sum(dim=(0, 1))
    db, dc = (t.view(b, s, g, hg, n).sum(3) for t in (db_h, dc_h))
    return dx, ddt, da, db, dc, dd, dinit


@pytest.mark.parametrize("b,s,h,p,g,n,decay_scale,steps", [
    (1, L_MAIN + 1, 2, 16, 1, 16, 1.0, L_MAIN),     # two chunks
    (1, 3 * _build.MIN_STEPS + 5, 4, 8, 2, 16, 1.0, _build.MIN_STEPS),  # G 2
    (2, 4 * _build.MIN_STEPS + 3, 2, 8, 1, 8, 8.0, _build.MIN_STEPS),   # e = 0
    (1, 200, 2, 16, 1, 8, 0.05, 17),                # weak decay, P != N
    (1, 9, 2, 8, 1, 8, 1.0, L_MAIN),
])
def test_kernel_emulation_matches_f64_autograd(b, s, h, p, g, n, decay_scale,
                                               steps):
    args, dy, ds = _inputs(3 * s + n, b, s, h, p, g, n, decay_scale)
    got = emulate_backward(*args, dy, ds, steps)
    want = sk.ssd_backward_plain(
        *(None if t is None else t.double() for t in _torch(args)),
        torch.as_tensor(dy).double(), torch.as_tensor(ds).double())
    _assert_close(got, want, KERNEL_BAR)


def test_ssd_function_gradcheck():
    """``SSD`` on the CPU in float64, G = 2, with the skip term, an initial
    state and the final state's gradient: its backward (the plain
    version) against finite differences."""
    rng = np.random.default_rng(8)
    mk = lambda *sh: torch.as_tensor(rng.standard_normal(sh))
    x, bm, cm = mk(1, 5, 4, 2), mk(1, 5, 2, 3), mk(1, 5, 2, 3)
    dt = torch.nn.functional.softplus(mk(1, 5, 4))
    a, d, st0 = -torch.exp(mk(4)), mk(4), mk(1, 4, 2, 3)
    leaves = [t.requires_grad_() for t in (x, dt, a, bm, cm, d, st0)]
    assert torch.autograd.gradcheck(lambda *t: sk.SSD.apply(*t), leaves)


def test_cpu_autograd_through_ssd_is_the_plain_version():
    """On CPU tensors ``ssd`` under grad differentiates through its plain
    version, x, B and C as strided views of one buffer as the model
    hands them over: the same gradients as ``ssd_backward_plain``, in
    the views' shapes, and no launch."""
    args, dy, ds = _inputs(4, 1, 40, 2, 8, 1, 8, init=False)
    x, dt, a, bm, cm, d, _ = _torch(args)
    conv = torch.cat([x.reshape(1, 40, 16), bm.reshape(1, 40, 8),
                      cm.reshape(1, 40, 8)], dim=-1).requires_grad_()
    views = (conv[..., :16].reshape(1, 40, 2, 8),
             conv[..., 16:24].reshape(1, 40, 1, 8),
             conv[..., 24:].reshape(1, 40, 1, 8))
    before = dict(sk.LAUNCHES)
    y, state = sk.ssd(views[0], dt, a, views[1], views[2], d)
    got = torch.autograd.grad((y, state), conv, (torch.as_tensor(dy),
                                                 torch.as_tensor(ds)))[0]
    want = sk.ssd_backward_plain(x, dt, a, bm, cm, d, None,
                                 torch.as_tensor(dy), torch.as_tensor(ds))
    assert sk.LAUNCHES == before
    torch.testing.assert_close(got, torch.cat(
        [want[0].reshape(1, 40, 16), want[3].reshape(1, 40, 8),
         want[4].reshape(1, 40, 8)], dim=-1), atol=0, rtol=0)
