"""The WKV6 backward: the plain version against the JAX reference's VJP,
the backward kernels' algorithm emulated on the CPU against float64
autograd, and ``gradcheck`` of the autograd function.

``wkv6_backward_plain`` (autograd through the port's ``wkv6_chunked``)
is held to ``jax.vjp`` of the reference's ``wkv6_chunked`` within 1e-5
of each gradient's largest magnitude: ragged S, weak and strong decay,
with and without a cotangent on the final state.  At strong decay the
chunked form's own float32 rounding is larger than that: there the bar
is ``GAP_K`` (2) times the reference's own float32 gradient's distance
to the exact gradient, measured in the test (2.5e-5 of dr's largest
magnitude at (2, 77, 2, 64), decay scale 5).  The exact gradient is
float64 autograd through ``exact_scan``, the recurrence step by step,
which shares no code with the port, so no fault of the port can widen
the bar; the port's plain backward in float64 is held to it within
``F64_BAR``.

``emulate_backward`` repeats the passes of ``csrc/wkv6.cu``'s backward
in float32 at the kernel's chunk lengths: each chunk's gradient from a
zero end gradient with its decay product, the reverse scan across
chunks, then per chunk a forward walk from the forward's chunk state
(dr, r dr') and a reverse walk from the carried gradient (dk, dv and
the chunk-local dlw, whose sums start from rowsum(S_e . dS_e) at the
chunk's last step), and du from per-chunk partials.  It is held to
float64 autograd of the plain version within 1e-4 of each gradient's
largest magnitude, the bar the kernel meets on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.rwkv6 import wkv6_chunked as jwkv6_chunked
from repro_torch.kernels import wkv6 as wk

NAMES = ("dr", "dk", "dv", "dlw", "du")
VJP_BAR = 1e-5    # plain version against the reference's VJP
GAP_K = 2         # ... or this multiple of the reference's f32-f64 gap
F64_BAR = 1e-12   # the plain version in float64 against the exact scan
KERNEL_BAR = 1e-4  # the kernel's algorithm against float64 autograd
L_MAIN, L_MIN = wk._build.STEPS_PER_CTA, wk._build.MIN_STEPS


def _inputs(seed, b, s, h, n, decay_scale=1.0, dstate=True):
    rng = np.random.default_rng(seed)
    mk = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    r, k, v = mk(b, s, h, n), mk(b, s, h, n), mk(b, s, h, n)
    lw = (-decay_scale * np.exp(mk(b, s, h, n))).astype(np.float32)
    u = (0.5 * mk(h, n)).astype(np.float32)
    do = mk(b, s, h, n)
    ds = mk(b, h, n, n) if dstate else None
    return (r, k, v, lw, u), do, ds


def _rel_to_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _assert_close(got, want, bar):
    bars = bar if isinstance(bar, (list, tuple)) else [bar] * len(NAMES)
    for name, g, w, bar in zip(NAMES, got, want, bars):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        w = w.detach().numpy() if isinstance(w, torch.Tensor) else w
        assert g.shape == w.shape, name
        assert np.isfinite(g).all(), name
        err = _rel_to_max(g, w)
        assert err <= bar, f"{name}: {err} of its largest magnitude"


@pytest.mark.parametrize("b,s,h,n,decay_scale,dstate,chunk", [
    (2, 64, 2, 16, 1.0, False, 64),
    (1, 100, 3, 32, 1.0, True, 64),     # ragged S, final-state cotangent
    (2, 77, 2, 64, 5.0, True, 32),      # strong decay: w underflows
    (1, 130, 2, 16, 0.05, True, 64),    # weak decay, carried far
    (1, 1, 2, 16, 1.0, True, 64),
])
def test_plain_backward_matches_reference_vjp(b, s, h, n, decay_scale,
                                              dstate, chunk):
    args, do, ds = _inputs(s + n, b, s, h, n, decay_scale, dstate)
    cot = np.zeros((b, h, n, n), np.float32) if ds is None else ds
    grads = jax.jit(lambda cots, *a: jax.vjp(
        lambda *a_: jwkv6_chunked(*a_, chunk=chunk), *a)[1](cots))
    want = [np.asarray(w) for w in grads((jnp.asarray(do), jnp.asarray(cot)),
                                         *map(jnp.asarray, args))]
    got = wk.wkv6_backward_plain(
        *map(torch.as_tensor, args), torch.as_tensor(do),
        None if ds is None else torch.as_tensor(ds), chunk=chunk)
    exact = _exact_grads(args, do, ds)
    bars = [max(VJP_BAR, GAP_K * _rel_to_max(w, t.numpy()))
            for w, t in zip(want, exact)]
    _assert_close(got, want, bars)
    _assert_close(_f64_autograd(args, do, ds, chunk=chunk), exact, F64_BAR)


def exact_scan(r, k, v, lw, u):
    """The WKV recurrence step by step from a zero state: o_t = S^T r_t +
    (r_t . (u k_t)) v_t, S_t = diag(exp(lw_t)) S + k_t v_t^T."""
    b, s, h, n = r.shape
    st, outs = torch.zeros((b, h, n, n), dtype=r.dtype), []
    for t in range(s):
        outs.append((r[:, t, ..., None] * st).sum(-2)
                    + (r[:, t] * u * k[:, t]).sum(-1, keepdim=True) * v[:, t])
        st = (torch.exp(lw[:, t])[..., None] * st
              + k[:, t, ..., None] * v[:, t, :, None, :])
    return torch.stack(outs, dim=1), st


def _exact_grads(args, do, ds):
    """float64 autograd of :func:`exact_scan`: (dr, dk, dv, dlw, du)."""
    leaves = [torch.as_tensor(a).double().requires_grad_() for a in args]
    o, st = exact_scan(*leaves)
    outs, cots = [o], [torch.as_tensor(do).double()]
    if ds is not None:
        outs.append(st)
        cots.append(torch.as_tensor(ds).double())
    return torch.autograd.grad(outs, leaves, cots)


def _chunk_states(k, v, w, bounds):
    """The state entering each chunk, as the forward leaves it."""
    b, _, h, n = k.shape
    st, out = torch.zeros((b, h, n, n)), []
    for c0, c1 in bounds:
        out.append(st)
        for t in range(c0, c1):
            st = w[:, t, ..., None] * st + k[:, t, ..., None] * v[:, t, :,
                                                                  None, :]
    return out


def emulate_backward(r, k, v, lw, u, do, dstate, steps):
    """The backward kernels' passes in float32, ``steps`` steps a chunk:
    (dr, dk, dv, dlw, du)."""
    r, k, v, lw, u, do = (torch.as_tensor(a) for a in (r, k, v, lw, u, do))
    b, s, h, n = r.shape
    w = torch.exp(lw)
    vg = (v * do).sum(-1)[..., None]          # v . do per step
    ruk = (r * u * k).sum(-1)[..., None]      # r . (u k) per step
    bounds = [(c0, min(s, c0 + steps)) for c0 in range(0, s, steps)]
    s_in = _chunk_states(k, v, w, bounds)
    # pass 1: each chunk's gradient at its start from a zero end gradient
    local, decay = [], []
    for c0, c1 in bounds:
        acc, e = torch.zeros((b, h, n, n)), torch.ones((b, h, n))
        for t in range(c0, c1):
            acc = acc + (r[:, t] * e)[..., None] * do[:, t, :, None, :]
            e = e * w[:, t]
        local.append(acc)
        decay.append(e)
    # pass 2: the gradient at each chunk's end, carried from the last
    carry = (torch.zeros((b, h, n, n)) if dstate is None
             else torch.as_tensor(dstate))
    d_out = [None] * len(bounds)
    for c in reversed(range(len(bounds))):
        d_out[c] = carry
        carry = decay[c][..., None] * carry + local[c]
    # pass 3: per chunk, a forward walk (dr, r dr') and a reverse walk
    # (dk, dv, dlw); du from per-chunk partials
    dr, dk, dv, dlw = (torch.zeros_like(r) for _ in range(4))
    du_part = []
    for (c0, c1), st, ds in zip(bounds, s_in, d_out):
        term = {}
        for t in range(c0, c1):
            drp = (st * do[:, t, :, None, :]).sum(-1)
            dr[:, t] = drp + u * k[:, t] * vg[:, t]
            term[t] = r[:, t] * drp
            st = w[:, t, ..., None] * st + k[:, t, ..., None] * v[:, t, :,
                                                                  None, :]
        run = (st * ds).sum(-1)   # rowsum(S_e . dS_e)
        for t in range(c1 - 1, c0 - 1, -1):
            dkp = (ds * v[:, t, :, None, :]).sum(-1)
            dk[:, t] = dkp + u * r[:, t] * vg[:, t]
            dv[:, t] = (ds * k[:, t, ..., None]).sum(-2) + ruk[:, t] * do[:, t]
            dlw[:, t] = run - k[:, t] * dkp
            run = dlw[:, t] + term[t]
            ds = w[:, t, ..., None] * ds + r[:, t, ..., None] * do[:, t, :,
                                                                   None, :]
        du_part.append((r[:, c0:c1] * k[:, c0:c1] * vg[:, c0:c1]).sum(1))
    du = torch.stack(du_part, dim=1).sum(dim=(0, 1))
    return dr, dk, dv, dlw, du


def _f64_autograd(args, do, ds, chunk=64):
    return wk.wkv6_backward_plain(
        *(torch.as_tensor(a).double() for a in args),
        torch.as_tensor(do).double(),
        None if ds is None else torch.as_tensor(ds).double(), chunk=chunk)


@pytest.mark.parametrize("n,s,steps,decay_scale,dstate", [
    (64, L_MAIN + 1, L_MAIN, 1.0, True),        # rwkv6's N, two chunks
    (16, 3 * L_MAIN + 5, L_MAIN, 0.05, True),   # weak decay over chunks
    (32, L_MAIN - 1, L_MAIN, 5.0, False),       # one ragged chunk
    (16, 4 * L_MIN + 5, L_MIN, 1.0, True),
    (16, 4 * L_MIN + 3, L_MIN, 5.0, True),  # decay product 0
    (64, 9, L_MAIN, 1.0, True),                 # one stage and a step
    (32, 200, 17, 0.05, False),                 # off the 8-step staging
])
def test_kernel_emulation_matches_f64_autograd(n, s, steps, decay_scale,
                                               dstate):
    args, do, ds = _inputs(3 * s + n, 1, s, 2, n, decay_scale, dstate)
    got = emulate_backward(*args, do, ds, steps)
    _assert_close(got, _f64_autograd(args, do, ds), KERNEL_BAR)


def test_chunk_local_dlw_equals_direct_form():
    """dlw from the chunk-local sums equals w_m rowsum(dS_m . S_{m-1}),
    its definition, walked step by step in float64."""
    args, do, ds = _inputs(11, 1, 40, 2, 16, 1.0, True)
    r, k, v, lw, u = (torch.as_tensor(a).double() for a in args)
    do, ds = torch.as_tensor(do).double(), torch.as_tensor(ds).double()
    w = torch.exp(lw)
    states = [torch.zeros((1, 2, 16, 16), dtype=torch.float64)]
    for t in range(40):
        states.append(w[:, t, ..., None] * states[-1]
                      + k[:, t, ..., None] * v[:, t, :, None, :])
    direct, g = torch.zeros_like(lw), ds
    for t in range(39, -1, -1):
        direct[:, t] = w[:, t] * (g * states[t]).sum(-1)
        g = w[:, t, ..., None] * g + r[:, t, ..., None] * do[:, t, :, None, :]
    got = emulate_backward(*(a.float() for a in (r, k, v, lw, u)),
                           do.float(), ds.float(), 16)[3]
    assert _rel_to_max(got.numpy(), direct.numpy()) <= KERNEL_BAR


def test_wkv6_function_gradcheck():
    """``WKV6`` on the CPU in float64: its backward (the plain version)
    against finite differences, the final state's gradient included."""
    rng = np.random.default_rng(5)
    mk = lambda *sh: torch.as_tensor(rng.standard_normal(sh)).requires_grad_()
    r, k, v = mk(1, 5, 2, 3), mk(1, 5, 2, 3), mk(1, 5, 2, 3)
    lw = (-torch.exp(torch.as_tensor(rng.standard_normal((1, 5, 2, 3))))
          ).requires_grad_()
    u = mk(2, 3)
    assert torch.autograd.gradcheck(lambda *a: wk.WKV6.apply(*a),
                                    (r, k, v, lw, u))


def test_cpu_autograd_through_wkv6_is_the_plain_version():
    """On CPU tensors ``wkv6`` under grad differentiates through its plain
    version: the same gradients as ``wkv6_backward_plain``, no launch."""
    args, do, ds = _inputs(2, 1, 64, 2, 16)
    leaves = [torch.as_tensor(a).requires_grad_() for a in args]
    before = dict(wk.LAUNCHES)
    o, state = wk.wkv6(*leaves)
    got = torch.autograd.grad((o, state), leaves, (torch.as_tensor(do),
                                                   torch.as_tensor(ds)))
    want = wk.wkv6_backward_plain(*map(torch.as_tensor, args),
                                  torch.as_tensor(do), torch.as_tensor(ds))
    assert wk.LAUNCHES == before
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
