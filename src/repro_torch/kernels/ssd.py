"""Mamba2 SSD scan: the hand-written kernels and their plain versions.

``ssd(x, dt, a, b, c, d_skip, chunk=, init_state=)`` checks its tensors
and picks its route from their device alone: on CUDA tensors it launches
the kernel of ``csrc/ssd.cu`` (and raises if the launch fails); on CPU
tensors it runs :func:`ssd_plain`, the chunked form ``ssd_chunked`` of
``repro_torch.models.mamba2`` plus the D skip term.  Nothing on the CUDA
path calls the plain version.  Each kernel launch adds one to
``LAUNCHES["ssd"]``.
Under autograd (grad mode on and an input requiring a gradient) a
float32 CUDA call goes through :class:`SSD`, whose backward,
:func:`ssd_backward`, launches the backward kernels (one more in
``LAUNCHES["ssd_backward"]`` a call) for the gradients of x, dt, a, b,
c, d_skip and the initial state; a bfloat16 one raises
``NotImplementedError`` naming ``ROADMAP.md``, since there is no bf16
backward kernel yet.  The plain version differentiates on the CPU.

Semantics, as the reference's ``ssd_pallas``: x (B, S, H, P), dt
(B, S, H) after softplus and b, c (B, S, G, N), all float32 or all
bfloat16, read through their strides (the last axis of x, b and c must
be contiguous; head h reads group h // (H / G), nothing is repeated);
a (H,) float32 < 0; d_skip (H,) float32 or None (no skip term); an
optional initial state (B, H, P, N) float32 (None: zero).  Returns
y (B, S, H, P) in x's dtype and the final state (B, H, P, N) float32.
The kernel takes any S and P, N up to 128; its chunk is its own (64
steps), ``chunk`` is the plain version's.

The kernel runs its products on the tensor cores as 3xTF32 (float32-level
accuracy) and copies x, b and c into shared memory in 16-byte pieces, so
each must start on 16 bytes and have batch, sequence and head strides
that are multiples of 16 bytes; one that does not is first copied into
an aligned buffer (``_build.aligned``).  The model's x, b and c, slices
of one float32 convolution output whose width is a multiple of 4, are
never copied.

The backward kernels (``csrc/ssd.cu``, exact per-step recurrences on the
CUDA cores in float32) walk chunks of ``_build.chunk_len`` steps, one CTA per
chunk and role: a pass that runs each chunk's state from zero and its
gradient from a zero end gradient, a scan that carries both across
chunks (the chunk states are recomputed, not kept by the forward), a
pass that walks each chunk forward (dC) and back (dx, dS^T x), and a
warp a chunk for dt's gradient with the chunk-local decay sums.  They
read x, b and c through their strides, so the gradients of the model's
views need no copy of their inputs; dB and dC come per head and each
group's heads, like da's and dd's per-chunk partials, are summed here in
a fixed order.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = {"ssd": 0, "ssd_backward": 0}
MAX_DIM = 128

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
         _P]
_SIGNATURES = {"ssd_f32": _ARGS, "ssd_bf16": _ARGS,
               "ssd_backward_f32": [_P] * 21 + [_I] * 8 + [_P]}
_FN = {torch.float32: "ssd_f32", torch.bfloat16: "ssd_bf16"}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    return _build.load("ssd", _SIGNATURES)


def ssd_plain(x, dt, a, b, c, d_skip=None, *, chunk: int = 64,
              init_state=None):
    """Plain version: ``ssd_chunked`` plus ``d_skip * x``."""
    from repro_torch.models.mamba2 import ssd_chunked  # imports this module
    y, state = ssd_chunked(x, dt, a, b, c, chunk, init_state=init_state)
    if d_skip is not None:
        y = y + x * d_skip.to(y.dtype)[None, None, :, None]
    return y, state


def ssd_backward_plain(x, dt, a, b, c, d_skip, init_state, dy,
                       dstate=None, *, chunk: int = 64):
    """Plain backward: ``torch.autograd.grad`` through :func:`ssd_plain`,
    recomputed; (dx, ddt, da, db, dc, dd, dinit), dd and dinit None when
    d_skip and init_state are."""
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_(True)
                  for t in (x, dt, a, b, c, d_skip, init_state)]
        y, state = ssd_plain(*leaves[:6], chunk=chunk,
                             init_state=leaves[6])
        outs, grads = [y], [dy]
        if dstate is not None:
            outs.append(state)
            grads.append(dstate)
        live = [t for t in leaves if t is not None]
        got = iter(torch.autograd.grad(outs, live, grads,
                                       allow_unused=True))
        grads = [None if t is None else next(got) for t in leaves]
        return tuple(torch.zeros_like(t) if g_ is None and t is not None
                     else g_ for g_, t in zip(grads, leaves))


def _checks(x, dt, a, b, c, d_skip, init_state):
    bb, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    dev = x.device
    if x.dtype not in _FN:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    _build.check("dt", dt, x.dtype, (bb, s, h), dev, contiguous=False)
    for name, t in (("b", b), ("c", c)):
        _build.check(name, t, x.dtype, (bb, s, g, n), dev, contiguous=False)
    _build.check("a", a, torch.float32, (h,), dev)
    if d_skip is not None:
        _build.check("d_skip", d_skip, torch.float32, (h,), dev)
    if init_state is not None:
        _build.check("init_state", init_state, torch.float32, (bb, h, p, n),
                     dev)
    if g == 0 or h % g:
        raise ValueError(f"heads {h} must be a multiple of groups {g}")


def _kernel_checks(x, b, c):
    p, n = x.shape[3], b.shape[3]
    if not (0 < p <= MAX_DIM and 0 < n <= MAX_DIM):
        raise ValueError(f"the ssd kernel takes P and N up to {MAX_DIM}, "
                         f"got P={p}, N={n}")
    if any(t.stride(-1) != 1 for t in (x, b, c)):
        raise ValueError("the last axis of x, b and c must be contiguous")


def _strides(x, dt, b, c):
    return (ctypes.c_longlong * 12)(
        *_build.row_strides(x), *(dt.stride(i) for i in (0, 1, 2)),
        *_build.row_strides(b), *_build.row_strides(c))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(x, dt, a, b, c, d_skip, init_state):
    """The forward kernel on checked CUDA tensors: (y, final state)."""
    bb, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    dev = x.device
    y = torch.empty((bb, s, h, p), dtype=x.dtype, device=dev)
    state = torch.empty((bb, h, p, n), dtype=torch.float32, device=dev)
    if bb * h == 0:
        return y, state
    x, b, c = (_build.aligned(t) for t in (x, b, c))
    err = getattr(_lib(), _FN[x.dtype])(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), _ptr(d_skip), _ptr(init_state), y.data_ptr(),
        state.data_ptr(), _strides(x, dt, b, c), bb, s, h, g, p, n,
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on(err, "ssd")
    LAUNCHES["ssd"] += 1
    return y, state


def ssd_backward(x, dt, a, b, c, d_skip, init_state, dy, dstate=None):
    """(dx, ddt, da, db, dc, dd, dinit) of :func:`ssd` at its inputs for
    the output gradient ``dy`` and the final state's ``dstate`` (None:
    zero); dd and dinit are None when d_skip and init_state are.  The
    backward kernels on CUDA tensors (float32), :func:`ssd_backward_plain`
    on CPU tensors."""
    bb, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    dev = x.device
    if _build.route(dev) == "cpu":
        return ssd_backward_plain(x, dt, a, b, c, d_skip, init_state, dy,
                                  dstate)
    if x.dtype != torch.float32:
        raise TypeError(f"the ssd backward kernel takes float32, got "
                        f"{x.dtype}")
    _checks(x, dt, a, b, c, d_skip, init_state)
    _kernel_checks(x, b, c)
    _build.check("dy", dy, torch.float32, (bb, s, h, p), dev,
                 contiguous=False)
    if dstate is not None:
        _build.check("dstate", dstate, torch.float32, (bb, h, p, n), dev,
                     contiguous=False)
        dstate = dstate.contiguous()
    dy = dy.contiguous()
    # the kernels write every element of these
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((bb, s, h, p), **f32)
    ddt = torch.empty((bb, s, h), **f32)
    db_head, dc_head = (torch.empty((bb, s, h, n), **f32) for _ in range(2))
    dinit = None if init_state is None else torch.empty((bb, h, p, n), **f32)
    if bb * h * s > 0:
        lib, steps = _lib(), _build.steps_for(x)
        n_chunks = -(-s // steps)
        da_part, dd_part, decay, sds = (torch.empty((bb, h, n_chunks), **f32)
                                        for _ in range(4))
        s_chunks, ds_chunks = (torch.empty((bb, h, n_chunks, p, n), **f32)
                               for _ in range(2))
        err = lib.ssd_backward_f32(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), _ptr(d_skip), _ptr(init_state), dy.data_ptr(),
            _ptr(dstate), dx.data_ptr(), ddt.data_ptr(), db_head.data_ptr(),
            dc_head.data_ptr(), _ptr(dinit), da_part.data_ptr(),
            dd_part.data_ptr(), s_chunks.data_ptr(), ds_chunks.data_ptr(),
            decay.data_ptr(), sds.data_ptr(), _strides(x, dt, b, c), bb, s,
            h, g, p, n, steps, dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
        _build.raise_on(err, "ssd_backward")
        LAUNCHES["ssd_backward"] += 1
        da, dd = da_part.sum(dim=(0, 2)), dd_part.sum(dim=(0, 2))
    else:  # no step: the final state is the initial one
        da, dd = torch.zeros_like(a), torch.zeros((h,), **f32)
        if dinit is not None and dstate is not None:
            dinit.copy_(dstate)
        elif dinit is not None:
            dinit.zero_()
    # each group's heads, and da's and dd's partials, in a fixed order
    db, dc = (t.view(bb, s, g, h // g, n).sum(dim=3)
              for t in (db_head, dc_head))
    return (dx, ddt, da, db, dc, None if d_skip is None else dd, dinit)


class SSD(torch.autograd.Function):
    """The SSD scan with its backward: the forward keeps its inputs, the
    backward recomputes the chunk states from them."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, d_skip, init_state):
        ctx.set_materialize_grads(False)
        if _build.route(x.device) == "cpu":
            y, state = ssd_plain(x, dt, a, b, c, d_skip,
                                 init_state=init_state)
        else:
            y, state = _launch(x, dt, a, b, c, d_skip, init_state)
        ctx.save_for_backward(x, dt, a, b, c, d_skip, init_state)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, a, b, c, d_skip, init_state = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        return ssd_backward(x, dt, a, b, c, d_skip, init_state, dy, dstate)


def ssd(x, dt, a, b, c, d_skip=None, *, chunk: int = 64, init_state=None):
    """(y (B,S,H,P), final state (B,H,P,N) f32) of the SSD scan."""
    dev = x.device
    _checks(x, dt, a, b, c, d_skip, init_state)
    args = (x, dt, a, b, c, d_skip, init_state)
    if x.dtype == torch.bfloat16:
        _build.refuse_grad("ssd", dev, *args)
    if _build.route(dev) == "cpu":
        return ssd_plain(x, dt, a, b, c, d_skip, chunk=chunk,
                         init_state=init_state)
    _kernel_checks(x, b, c)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in args):
        return SSD.apply(*args)
    return _launch(*args)
