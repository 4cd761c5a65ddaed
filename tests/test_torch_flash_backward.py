"""The flash backward of the port against the JAX reference's custom VJP,
on the CPU.

``flash_attention_backward_plain`` (the plain version of the backward
kernel) and ``torch.autograd.grad`` through ``flash_attention`` (the
``FlashAttention`` function's CPU route) against ``jax.vjp`` of
``repro.models.attention.flash_attention_jnp`` on the same numpy-seeded
q, k, v and output gradient: causal, a sliding window, GQA, a
continuation (Sq < Sk), Dk != Dv, full attention and MLA's head dims
(Dk 192, Dv 128, the kernel's widest tiling); dq, dk and dv within
1e-5 of each reference tensor's largest magnitude.  The LSE that the
forward hands to the backward against the reference's ``_flash_fwd_impl``
within 1e-5.  The routes: CPU tensors never reach the kernels' library,
and on CUDA tensors (fake ones, ``FakeTensorMode``) a gradient that no
backward kernel takes raises before any launch: bf16 flash, f32 flash at
D > 192, WKV6 and SSD.  The card's cases are in
``tests/test_torch_kernels_gpu.py``.
"""
import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.models.attention import _flash_fwd_impl, flash_attention_jnp
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd as sk
from repro_torch.kernels import wkv6 as wk

# (B, Sq, Sk, H, KV, D, Dv, causal, window, q_block, k_block)
CASES = [
    (2, 64, 64, 4, 4, 16, 16, True, 0, 16, 16),
    (1, 48, 48, 4, 2, 16, 16, True, 12, 16, 16),
    (2, 32, 32, 8, 2, 8, 8, True, 0, 8, 16),
    (1, 16, 48, 4, 1, 16, 16, True, 0, 8, 16),
    (1, 32, 32, 2, 2, 24, 8, True, 0, 16, 16),
    (1, 32, 32, 2, 1, 8, 16, False, 0, 16, 8),
    (1, 48, 48, 2, 2, 192, 128, True, 0, 16, 16),
]
IDS = ["causal", "window", "gqa", "sq_lt_sk", "dk_ne_dv", "full", "mla"]


def _inputs(case, seed=0):
    b, sq, sk, h, kv, d, dv = case[:7]
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    return mk(b, sq, h, d), mk(b, sk, kv, d), mk(b, sk, kv, dv), \
        mk(b, sq, h, dv)


def _reference(case, q, k, v, do):
    causal, window, qb, kb = case[7:]
    fn = lambda q, k, v: flash_attention_jnp(
        q, k, v, causal=causal, window=window, q_block=qb, k_block=kb)
    o, vjp = jax.vjp(fn, q, k, v)
    return np.asarray(o), [np.asarray(g) for g in vjp(do)]


def _assert_grads(got, want):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        err = float(np.abs(g.detach().numpy() - w).max() / np.abs(w).max())
        assert err <= 1e-5, (name, err)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_reference_vjp(case):
    q, k, v, do = _inputs(case)
    causal, window = case[7:9]
    _, want = _reference(case, q, k, v, do)
    t = [torch.as_tensor(a) for a in (q, k, v, do)]
    o, lse = fa.flash_attention_plain(*t[:3], causal=causal, window=window,
                                      return_lse=True)
    got = fa.flash_attention_backward_plain(*t[:3], o, lse, t[3],
                                            causal=causal, window=window)
    _assert_grads(got, want)
    # blocks smaller than the sequence: the same gradients
    small = fa.flash_attention_backward_plain(*t[:3], o, lse, t[3],
                                              causal=causal, window=window,
                                              q_block=8, k_block=16)
    _assert_grads(small, want)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_autograd_through_flash_attention_matches_reference(case):
    q, k, v, do = _inputs(case, seed=1)
    causal, window = case[7:9]
    want_o, want = _reference(case, q, k, v, do)
    leaves = [torch.as_tensor(a).requires_grad_(True) for a in (q, k, v)]
    o = fa.flash_attention(*leaves, causal=causal, window=window)
    assert o.grad_fn is not None
    np.testing.assert_allclose(o.detach().numpy(), want_o, atol=1e-5,
                               rtol=1e-5)
    _assert_grads(torch.autograd.grad(o, leaves, torch.as_tensor(do)), want)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_lse_matches_reference_forward(case):
    q, k, v, _ = _inputs(case, seed=2)
    b, sq, _, h = case[:4]
    causal, window, qb, kb = case[7:]
    _, jlse = _flash_fwd_impl(q, k, v, causal, window, qb, kb,
                              q.shape[-1] ** -0.5)
    _, lse = fa.flash_attention_plain(*(torch.as_tensor(a) for a in (q, k, v)),
                                      causal=causal, window=window,
                                      return_lse=True)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(jlse).reshape(b, h, sq),
                               atol=1e-5, rtol=0)


def test_cpu_tensors_never_reach_the_kernels(monkeypatch):
    """On CPU tensors, forward and backward (through autograd too) run
    the plain versions: the library is never loaded."""
    def no_library():
        raise AssertionError("the CUDA library was reached from the CPU")
    monkeypatch.setattr(fa, "_lib", no_library)
    q, k, v, do = (torch.as_tensor(a) for a in _inputs(CASES[1], seed=3))
    before = dict(fa.LAUNCHES)
    leaves = [t.requires_grad_(True) for t in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=True, window=12)
    torch.autograd.grad(out, leaves, do)
    assert fa.LAUNCHES == before


class _Launch(Exception):
    """Raised by a stand-in for the kernels' library: the call got there."""


def test_grad_without_a_backward_kernel_raises_on_cuda(monkeypatch):
    """Fake CUDA tensors: a gradient through bf16 flash (MLA's D 192
    too), f32 flash at D 224, bf16 WKV6 or bf16 SSD raises
    ``NotImplementedError`` naming the roadmap before any library is
    loaded; under ``no_grad``, or without an input that requires a
    gradient, the guard lets the call through.  f32 flash at MLA's D 192
    / Dv 128, f32 WKV6 and f32 SSD pass every guard: the call under grad
    takes its autograd function's forward, and its backward reaches the
    backward kernel's launch, past every check (the library it loads
    there is a stand-in that raises, the forward a stand-in for its
    kernel)."""
    with FakeTensorMode():
        cuda = torch.device("cuda")
        mk = lambda *s, dt=torch.float32: torch.empty(s, device=cuda,
                                                      dtype=dt)
        bf16 = torch.bfloat16
        q, k, v = (mk(1, 8, 2, 64, dt=bf16) for _ in range(3))
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            fa.flash_attention(q.requires_grad_(), k, v)
        q, k = (mk(1, 8, 2, 192, dt=bf16) for _ in range(2))
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            fa.flash_attention(q, k, mk(1, 8, 2, 128, dt=bf16)
                               .requires_grad_())
        q, k, v = mk(1, 8, 2, 224), mk(1, 8, 2, 224), mk(1, 8, 2, 128)
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            fa.flash_attention(q, k, v.requires_grad_())
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            fa._check_grad_kernel(mk(1, 8, 2, 192), 192, 136)
        r = mk(1, 8, 2, 64, dt=bf16).requires_grad_()
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            wk.wkv6(r, mk(1, 8, 2, 64, dt=bf16), mk(1, 8, 2, 64, dt=bf16),
                    mk(1, 8, 2, 64), mk(2, 64))
        x = mk(1, 8, 4, 16, dt=bf16).requires_grad_()
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            sk.ssd(x, mk(1, 8, 4, dt=bf16), mk(4), mk(1, 8, 1, 16, dt=bf16),
                   mk(1, 8, 1, 16, dt=bf16))
        with torch.no_grad():
            for name, t in (("wkv6", r), ("ssd", x)):
                fa._build.refuse_grad(name, cuda, t)
        fa._build.refuse_grad("wkv6", cuda, r.detach())
        reached = []

        def forward(q, k, v, causal, window, scale, with_lse):
            reached.append(("flash forward", with_lse))
            b, sq, h, _ = q.shape
            return q.new_empty((b, sq, h, v.shape[-1])), q.new_empty(
                (b, h, sq))

        def wkv6_forward(r, k, v, lw, u, steps):
            reached.append(("wkv6 forward", steps))
            b, s, h, n = r.shape
            return (torch.empty_like(r), r.new_empty((b, h, n, n)),
                    r.new_empty((b, h, -(-s // steps), n, n)))

        def ssd_forward(x, dt, a, b, c, d_skip, init_state):
            reached.append(("ssd forward", None))
            return torch.empty_like(x), x.new_empty(
                (x.shape[0], x.shape[2], x.shape[3], b.shape[3]))

        def launch(name):
            def lib():
                reached.append((f"{name} backward", None))
                raise _Launch
            return lib

        def ctx():  # an autograd context for a Function run by hand
            return type("Ctx", (), {
                "save_for_backward": lambda self, *t: setattr(
                    self, "saved_tensors", t),
                "set_materialize_grads": lambda self, v: None})()

        # each Function's own forward and backward, run without the
        # autograd engine (which needs a card)
        ctxs = {}
        for mod, fn, fwd_name, fwd in ((fa, fa.FlashAttention, "_forward",
                                        forward),
                                       (wk, wk.WKV6, "_launch",
                                        wkv6_forward),
                                       (sk, sk.SSD, "_launch", ssd_forward)):
            ctxs[fn] = ctx()
            monkeypatch.setattr(mod, fwd_name, fwd)
            monkeypatch.setattr(mod, "_lib", launch(mod.__name__.split(
                ".")[-1]))
            monkeypatch.setattr(fn, "apply", staticmethod(
                lambda *a, fn=fn: fn.forward(ctxs[fn], *a)))
        monkeypatch.setattr(fa._build, "steps_for", lambda t: 16)
        q, k = mk(1, 8, 2, 192), mk(1, 8, 2, 192)
        v = mk(1, 8, 2, 128).requires_grad_()
        out = fa.flash_attention(q, k, v, causal=True)
        assert out.shape == (1, 8, 2, 128)
        # (the engine runs a backward with grad mode off)
        with torch.no_grad(), pytest.raises(_Launch):
            fa.FlashAttention.backward(ctxs[fa.FlashAttention],
                                       torch.ones_like(out))
        r, k, v, lw = (mk(1, 40, 2, 64) for _ in range(4))
        o, state = wk.wkv6(r.requires_grad_(), k, v, lw, mk(2, 64))
        assert o.shape == r.shape and state.shape == (1, 2, 64, 64)
        with torch.no_grad(), pytest.raises(_Launch):
            wk.WKV6.backward(ctxs[wk.WKV6], torch.ones_like(o), None)
        x = mk(1, 40, 4, 16).requires_grad_()
        y, state = sk.ssd(x, mk(1, 40, 4), mk(4), mk(1, 40, 2, 16),
                          mk(1, 40, 2, 16), mk(4), init_state=mk(1, 4, 16,
                                                                 16))
        assert y.shape == x.shape and state.shape == (1, 4, 16, 16)
        with torch.no_grad(), pytest.raises(_Launch):
            sk.SSD.backward(ctxs[sk.SSD], torch.ones_like(y),
                            torch.ones_like(state))
        assert reached == [("flash forward", True),
                           ("flash_attention backward", None),
                           ("wkv6 forward", 16), ("wkv6 backward", None),
                           ("ssd forward", None), ("ssd backward", None)]
