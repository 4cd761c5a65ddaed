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

``emulate_backward`` runs ``ssd_backward``'s kernel route on the CPU
with each launch replaced by ``emulate_call``, which repeats the passes
of ``csrc/ssd.cu``'s backward in float32: sub-chunks of 64 steps (or the
case's smaller q), the decay's cumulative sums in float64, each
sub-chunk's state and gradient from zero, the scans that carry both
across sub-chunks (dinit the last carry), then per sub-chunk the chunked
form's products in the kernel's order, from the state at its start and
the gradient at its end, the decay's gradient summed in reverse within
the sub-chunk, and da's and dd's partials per sub-chunk; the wrapper slices
P and N wider than 64 and adds the partials pairwise.  It is held to
float64 autograd of the plain version within 1e-4 of each gradient's
largest magnitude, the bar the kernel meets on the card, and its da to
the float32 plain backward's own distance at S 2,048.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.config import Mamba2Config
from repro.models.mamba2 import ssd_chunked as jssd_chunked
from repro_torch.kernels import ssd as sk

NAMES = ("dx", "ddt", "da", "db", "dc", "dd", "dinit")
VJP_BAR = 1e-4
KERNEL_BAR = 1e-4


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


def emulate_call(lib, x, dt, a, bm, cm, d, init, dy, dstate, q=64):
    """One launch of the backward kernels in float32, ``q`` steps a
    sub-chunk, with ``ssd._backward_call``'s arguments and outputs: (dx,
    ddt, db_head, dc_head, dinit, da_part, dd_part), the partials per
    (batch, head, sub-chunk)."""
    b, s, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    hg = h // g
    n_sub = -(-s // q)
    sp = n_sub * q

    def heads(t):  # (b, h, sp, .), zero past S
        t = torch.cat([t, t.new_zeros((b, sp - s) + t.shape[2:])], dim=1)
        return t.transpose(1, 2)

    X, DY, DT = heads(x), heads(dy), heads(dt)
    Bm, Cm = (heads(t.repeat_interleave(hg, dim=2)) for t in (bm, cm))
    a64 = a.double()[None, :, None]
    dsk = torch.zeros(h) if d is None else d

    def sub(j):
        cut = slice(j * q, (j + 1) * q)
        return X[:, :, cut], DY[:, :, cut], Bm[:, :, cut], Cm[:, :, cut], \
            DT[:, :, cut]

    def decay(dtj):  # dac in float64; e^dac, w, E as the kernel's expf
        dac = torch.cumsum(dtj.double() * a64, -1)
        return (dac, torch.exp(dac.float()),
                torch.exp((dac[..., -1:] - dac).float()),
                torch.exp(dac[..., -1].float())[..., None, None])

    zero = torch.zeros((b, h, p, n))
    # pass 1: each sub-chunk's state from zero and its gradient at its
    # start from a zero end gradient, its decay E
    s_loc, d_loc, dec = [], [], []
    for j in range(n_sub):
        xj, dyj, bj, cj, dtj = sub(j)
        _, ex, w, e = decay(dtj)
        s_loc.append(torch.einsum("bhsn,bhsp->bhpn",
                                  bj * (dtj * w)[..., None], xj))
        d_loc.append(torch.einsum("bhtn,bhtp->bhpn", cj * ex[..., None],
                                  dyj))
        dec.append(e)
    # pass 2: S_in of each sub-chunk forward from the initial state,
    # dS_out backward from the final state's gradient; dinit the last carry
    carry, s_in = zero if init is None else init, []
    for st, dc_ in zip(s_loc, dec):
        s_in.append(carry)
        carry = dc_ * carry + st
    carry = zero if dstate is None else dstate
    d_out = [None] * n_sub
    for j in reversed(range(n_sub)):
        d_out[j] = carry
        carry = dec[j] * carry + d_loc[j]
    dinit = None if init is None else carry
    # pass 3, per sub-chunk: the products of csrc/ssd.cu from S_in and
    # dS_out, each in a fresh accumulator
    dx, ddt = torch.zeros((b, h, sp, p)), torch.zeros((b, h, sp))
    db_h, dc_h = torch.zeros((b, h, sp, n)), torch.zeros((b, h, sp, n))
    da_part, dd_part = torch.zeros((b, h, n_sub)), torch.zeros((b, h, n_sub))
    tri = torch.tril(torch.ones(q, q, dtype=torch.bool))
    for j in range(n_sub):
        xj, dyj, bj, cj, dtj = sub(j)
        dac, ex, w, e = decay(dtj)
        st, dso, rows = s_in[j], d_out[j], slice(j * q, (j + 1) * q)
        lm = torch.where(tri, torch.exp(
            (dac[..., :, None] - dac[..., None, :]).float()), 0.0)
        m = torch.einsum("bhtn,bhsn->bhts", cj, bj) * lm
        dm = torch.where(tri, torch.einsum("bhtp,bhsp->bhts", dyj, xj)
                         * dtj[..., None, :], 0.0)
        dms, dmm = dm * lm, dm * m
        u3 = torch.einsum("bhpn,bhtp->bhnt", st, dyj) * ex[..., None, :]
        goff = (cj.transpose(-1, -2) * u3).sum(-2)
        u1 = torch.einsum("bhpn,bhsn->bhps", dso, bj) * w[..., None, :]
        du = torch.einsum("bhtp,bhts->bhps", dyj, m) + u1
        xt, dyt = xj.transpose(-1, -2), dyj.transpose(-1, -2)
        dx[:, :, rows] = (dtj[..., None, :] * du
                          + dsk[None, :, None, None] * dyt
                          ).transpose(-1, -2)
        u2 = torch.einsum("bhpn,bhsp->bhns", dso, xj)
        db_h[:, :, rows] = (torch.einsum("bhtn,bhts->bhns", cj, dms)
                            + u2 * (w * dtj)[..., None, :]
                            ).transpose(-1, -2)
        dc_h[:, :, rows] = (torch.einsum("bhsn,bhts->bhnt", bj, dms)
                            + u3).transpose(-1, -2)
        # the decay's gradient and its reverse cumulative sum within the
        # sub-chunk
        r = dtj * (xt * u1).sum(-2)
        gd = dmm.sum(-1) - dmm.sum(-2) + goff - r
        gd[..., -1] += r.sum(-1) + e[..., 0, 0] * (st * dso).sum((-1, -2))
        rr = torch.flip(torch.cumsum(torch.flip(gd, [-1]), -1), [-1])
        ddt[:, :, rows] = (xt * du).sum(-2) + a[None, :, None] * rr
        da_part[..., j] = (dtj * rr).sum(-1)
        dd_part[..., j] = (dyt * xt).sum((-1, -2))
    back = lambda t: t.transpose(1, 2)[:, :s].contiguous()
    return (back(dx), back(ddt), back(db_h), back(dc_h), dinit, da_part,
            dd_part)


def emulate_backward(x, dt, a, bm, cm, d, init, dy, dstate, q=64):
    """``ssd_backward``'s kernel route in float32 on the CPU: the
    wrapper's own slicing of P and N, its sums of the slices' gradients
    and its pairwise sums of da's and dd's partials, over
    :func:`emulate_call` in place of each launch, ``q`` steps a
    sub-chunk."""
    from unittest import mock
    call = lambda lib, *t: emulate_call(lib, *t, q=q)
    with mock.patch.object(sk, "_backward_call", call), \
            mock.patch.object(sk, "_lib", lambda: None), \
            mock.patch.object(sk._build, "route", lambda dev: "cuda"), \
            mock.patch.object(sk, "SUB", q):
        return sk.ssd_backward(*_torch((x, dt, a, bm, cm, d, init)),
                               *_torch((dy, dstate)))


@pytest.mark.parametrize("b,s,h,p,g,n,decay_scale,q", [
    (1, 2 * 64 + 1, 2, 16, 1, 16, 1.0, 64),   # three sub-chunks
    (1, 3 * 16 + 5, 4, 8, 2, 16, 1.0, 16),    # G 2
    (2, 4 * 16 + 3, 2, 8, 1, 8, 8.0, 16),     # e = 0
    (1, 200, 2, 16, 1, 8, 0.05, 16),          # weak decay, P != N
    (1, 9, 2, 8, 1, 8, 1.0, 64),
    (1, 70, 2, 80, 1, 72, 1.0, 64),   # P, N past one slice of 64
    (1, 40, 2, 128, 2, 128, 1.0, 32),  # P = N = 128, G 2
])
def test_kernel_emulation_matches_f64_autograd(b, s, h, p, g, n, decay_scale,
                                               q):
    args, dy, ds = _inputs(3 * s + n, b, s, h, p, g, n, decay_scale)
    got = emulate_backward(*args, dy, ds, q)
    want = sk.ssd_backward_plain(
        *(None if t is None else t.double() for t in _torch(args)),
        torch.as_tensor(dy).double(), torch.as_tensor(ds).double())
    _assert_close(got, want, KERNEL_BAR)


@pytest.mark.parametrize("decay_scale", [1.0, 8.0])
def test_emulated_da_within_the_f32_plain_distance(decay_scale):
    """da's partials per 64-step sub-chunk: at S 2,048, normal and strong
    decay, the emulated kernels' da lies no further from float64 autograd
    (over its largest magnitude) than the float32 plain backward's own,
    autograd through ``ssd_chunked`` at the config's chunk of 256, as
    chip_smoke.py's plain version runs it."""
    args, dy, ds = _inputs(11, 1, 2048, 2, 16, 1, 16, decay_scale)
    got = emulate_backward(*args, dy, ds)
    t = _torch(args)
    want = sk.ssd_backward_plain(*(x.double() for x in t),
                                 torch.as_tensor(dy).double(),
                                 torch.as_tensor(ds).double(), chunk=256)
    f32 = sk.ssd_backward_plain(*t, torch.as_tensor(dy),
                                torch.as_tensor(ds), chunk=256)
    assert _rel_to_max(got[2], want[2]) <= _rel_to_max(f32[2], want[2])


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
