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

The backward (``csrc/ssd.cu``) is the chunked SSD form's gradient on the
tensor cores (3xTF32 ``wgmma``), per sub-chunk of 64 steps, with state
passing over the sub-chunks: a pass that runs each sub-chunk's state
from zero and its gradient from a zero end gradient, a scan that carries
both across sub-chunks (their states are recomputed, not kept by the
forward), and a pass that computes every gradient of a sub-chunk from
the state at its start and the gradient at its end.  They read x,
b, c and dy through their strides, so the gradients of the model's views
need no copy of their inputs; the kernels take P and N up to 64, so a
wider P or N is split into slices of 64 here (the scan is a sum of
independent scans over slices of P and of N) and their gradients summed.
dB and dC come per head and each group's heads, like da's and dd's
per-sub-chunk partials (added pairwise), are summed here in a fixed
order.  The kernels write dx, dB, dC and the sub-chunks' states by TMA,
whose strides are multiples of 16 bytes, so those rows are padded here
to a multiple of 4 floats and the gradients returned as views.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = {"ssd": 0, "ssd_backward": 0}
MAX_DIM = 128
BWD_SLICE = 64  # P and N of one backward kernel call
SUB = 64  # steps of the backward's sub-chunk: wgmma's M

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
         _P]
_SIGNATURES = {"ssd_f32": _ARGS, "ssd_bf16": _ARGS,
               "ssd_backward_f32": [_P] * 20 + [_I] * 7 + [_P]}
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


def _pairwise(t):
    """Sum over the last axis by adjacent pairs, level by level: a fixed
    order, and no running sum over the whole axis."""
    while t.shape[-1] > 1:
        if t.shape[-1] % 2:
            t = torch.cat([t, t.new_zeros(t.shape[:-1] + (1,))], dim=-1)
        t = t[..., 0::2] + t[..., 1::2]
    return t[..., 0]


def _backward_call(lib, x, dt, a, b, c, d_skip, init_state, dy, dstate):
    """One launch of the backward kernels on a slice of at most
    BWD_SLICE columns of P and of N: (dx, ddt, db_head, dc_head, dinit,
    da_part, dd_part), the partials per (batch, head, 64-step
    sub-chunk)."""
    bb, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    x, b, c, dy = (_build.aligned(t) for t in (x, b, c, dy))
    init_state, dstate = (None if t is None else t.contiguous()
                          for t in (init_state, dstate))
    # the kernels write every element of these but the columns past P or
    # N of the rows they pad to a multiple of 4 (TMA's 16-byte strides)
    p4, n4 = -(-p // 4) * 4, -(-n // 4) * 4
    dx = torch.empty((bb, s, h, p4), **f32)
    ddt = torch.empty((bb, s, h), **f32)
    db_head, dc_head = (torch.empty((bb, s, h, n4), **f32) for _ in range(2))
    dinit = None if init_state is None else torch.empty((bb, h, p, n), **f32)
    n_sub = -(-s // SUB)
    da_part, dd_part, decay = (torch.empty((bb, h, n_sub), **f32)
                               for _ in range(3))
    s_chunks, ds_chunks = (torch.empty((bb, h, n_sub, p, n4), **f32)
                           for _ in range(2))
    strides = (ctypes.c_longlong * 15)(
        *_build.row_strides(x), *(dt.stride(i) for i in (0, 1, 2)),
        *_build.row_strides(b), *_build.row_strides(c),
        *_build.row_strides(dy))
    err = lib.ssd_backward_f32(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), _ptr(d_skip), _ptr(init_state), dy.data_ptr(),
        _ptr(dstate), dx.data_ptr(), ddt.data_ptr(), db_head.data_ptr(),
        dc_head.data_ptr(), _ptr(dinit), da_part.data_ptr(),
        dd_part.data_ptr(), s_chunks.data_ptr(), ds_chunks.data_ptr(),
        decay.data_ptr(), strides, bb, s, h, g, p, n, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on(err, "ssd_backward")
    return (dx[..., :p], ddt, db_head[..., :n], dc_head[..., :n], dinit,
            da_part, dd_part)


def _slices(n):
    return [(i, min(n, i + BWD_SLICE)) for i in range(0, n, BWD_SLICE)]


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
    if dy.stride(-1) != 1:
        dy = dy.contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    if bb * h * s == 0:  # no step: the final state is the initial one
        dinit = None
        if init_state is not None:
            dinit = torch.zeros((bb, h, p, n), **f32)
            if dstate is not None:
                dinit.copy_(dstate)
        return (torch.empty((bb, s, h, p), **f32),
                torch.empty((bb, s, h), **f32), torch.zeros_like(a),
                torch.zeros((bb, s, g, n), **f32),
                torch.zeros((bb, s, g, n), **f32),
                None if d_skip is None else torch.zeros((h,), **f32), dinit)
    lib = _lib()
    cut = lambda t, p_, n_: None if t is None else t[:, :, p_[0]:p_[1],
                                                      n_[0]:n_[1]]
    ps, ns = _slices(p), _slices(n)
    parts = {(i, j): _backward_call(
        lib, x[..., pi[0]:pi[1]], dt, a, b[..., nj[0]:nj[1]],
        c[..., nj[0]:nj[1]], d_skip if j == 0 else None,
        cut(init_state, pi, nj), dy[..., pi[0]:pi[1]], cut(dstate, pi, nj))
        for i, pi in enumerate(ps) for j, nj in enumerate(ns)}
    LAUNCHES["ssd_backward"] += 1
    one = lambda ts: ts[0] if len(ts) == 1 else ts[0] + ts[1]
    cat = lambda ts, dim: ts[0] if len(ts) == 1 else torch.cat(ts, dim)
    # dx sums over N's slices, dB and dC over P's, ddt and da over both
    dx = cat([one([parts[i, j][0] for j in range(len(ns))])
              for i in range(len(ps))], -1)
    ddt = parts[0, 0][1] if len(parts) == 1 else _pairwise(
        torch.stack([t[1] for t in parts.values()], -1))
    db_head, dc_head = (cat([one([parts[i, j][k] for i in range(len(ps))])
                             for j in range(len(ns))], -1) for k in (2, 3))
    dinit = None
    if init_state is not None:
        dinit = cat([cat([parts[i, j][4] for j in range(len(ns))], -1)
                     for i in range(len(ps))], -2)
    # da's and dd's partials per sub-chunk, pairwise over batch, slices
    # and sub-chunks
    flat = lambda ts: torch.stack(ts).permute(2, 0, 1, 3).reshape(h, -1)
    da = _pairwise(flat([t[5] for t in parts.values()]))
    dd = _pairwise(flat([parts[i, 0][6] for i in range(len(ps))]))
    # each group's heads in a fixed order
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
