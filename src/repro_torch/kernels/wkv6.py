"""RWKV6 WKV recurrence: the hand-written kernels and their plain versions.

``wkv6(r, k, v, lw, u)`` checks its tensors and picks its route from
their device alone: on CUDA tensors it launches the kernels of
``csrc/wkv6.cu`` (and raises if a launch fails); on CPU tensors it
runs :func:`wkv6_plain`, the chunked form ``wkv6_chunked`` of
``repro_torch.models.rwkv6``.  Nothing on the CUDA path calls the plain
version.  Each call that launches adds one to ``LAUNCHES["wkv6"]``.
Under autograd (grad mode on and an input requiring a gradient) a
float32 CUDA call goes through :class:`WKV6`, whose backward,
:func:`wkv6_backward`, launches the backward kernels (one more in
``LAUNCHES["wkv6_backward"]`` a call); a bfloat16 one raises
``NotImplementedError`` naming ``ROADMAP.md``, since there is no bf16
backward kernel yet.  The plain version differentiates on the CPU.

Prefill semantics, as the reference's ``wkv6_pallas``: zero initial
state, r/k/v (B, S, H, N) float32 or bfloat16, lw (B, S, H, N) float32
(<= 0), u (H, N) float32, all contiguous; returns o (B, S, H, N) in r's
dtype and the final state (B, H, N, N) float32.  The kernel takes any S
and N in (16, 32, 64).

On the card the recurrence runs in chunks of ``_build.chunk_len`` steps,
one CTA each: a pass that runs every chunk from a zero state, a scan
that carries the state across chunks, and a pass that reruns every chunk
from its carried state and writes o (``csrc/wkv6.cu``).  The chunk states
live in a scratch the wrapper allocates on the caller's stream; under
autograd the forward keeps them (16 MB a layer at rwkv6-1.6b's training
shape) and the backward starts each chunk's walks from them: a pass that
forms each chunk's gradient from a zero end gradient, a reverse scan
across chunks, and a pass that walks each chunk forward (dr) and back
(dk, dv, the chunk-local dlw).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = {"wkv6": 0, "wkv6_backward": 0}
HEAD_DIMS = (16, 32, 64)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 9 + [_I] * 6 + [_P]
_SIGNATURES = {"wkv6_f32": _ARGS, "wkv6_bf16": _ARGS,
               "wkv6_backward_f32": [_P] * 15 + [_I] * 6 + [_P]}
_FN = {torch.float32: "wkv6_f32", torch.bfloat16: "wkv6_bf16"}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    return _build.load("wkv6", _SIGNATURES)


def wkv6_plain(r, k, v, lw, u, *, chunk: int = 64):
    """Plain version: the chunked WKV from a zero state."""
    from repro_torch.models.rwkv6 import wkv6_chunked  # imports this module
    return wkv6_chunked(r, k, v, lw, u, chunk=chunk)


def wkv6_backward_plain(r, k, v, lw, u, do, dstate=None, *,
                        chunk: int = 64):
    """Plain backward: ``torch.autograd.grad`` through :func:`wkv6_plain`,
    recomputed; (dr, dk, dv, dlw, du)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (r, k, v, lw, u)]
        o, state = wkv6_plain(*leaves, chunk=chunk)
        outs, grads = [o], [do]
        if dstate is not None:
            outs.append(state)
            grads.append(dstate)
        return torch.autograd.grad(outs, leaves, grads)


def _launch(r, k, v, lw, u, steps: int):
    """The kernels on checked CUDA tensors, ``steps`` steps per CTA:
    (o, final state, the chunk states S_in_c)."""
    b, s, h, n = r.shape
    dev = r.device
    # the kernel copies rows four elements at a time with cp.async
    r, k, v, lw = (_build.aligned(t) for t in (r, k, v, lw))
    o = torch.empty_like(r)
    state = torch.empty((b, h, n, n), dtype=torch.float32, device=dev)
    n_chunks = -(-s // steps)
    chunk_state = torch.empty((b, h, n_chunks, n, n), dtype=torch.float32,
                              device=dev)
    chunk_decay = torch.empty((b, h, n_chunks, n), dtype=torch.float32,
                              device=dev)
    err = getattr(_lib(), _FN[r.dtype])(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
        u.data_ptr(), o.data_ptr(), state.data_ptr(), chunk_state.data_ptr(),
        chunk_decay.data_ptr(), b, s, h, n, steps, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on(err, "wkv6")
    LAUNCHES["wkv6"] += 1
    return o, state, chunk_state


def wkv6_backward(r, k, v, lw, u, chunk_state, do, dstate=None):
    """(dr, dk, dv, dlw, du) of :func:`wkv6` at (r, k, v, lw, u) for the
    output gradient ``do`` and the final state's ``dstate`` (None: zero):
    the backward kernels on CUDA tensors (float32, from the forward's
    ``chunk_state``), :func:`wkv6_backward_plain` on CPU tensors (which
    ignores ``chunk_state``)."""
    b, s, h, n = r.shape
    dev = r.device
    if _build.route(dev) == "cpu":
        return wkv6_backward_plain(r, k, v, lw, u, do, dstate)
    for name, t in (("r", r), ("k", k), ("v", v), ("lw", lw)):
        _build.check(name, t, torch.float32, (b, s, h, n), dev)
    _build.check("do", do, torch.float32, (b, s, h, n), dev,
                 contiguous=False)
    _build.check("u", u, torch.float32, (h, n), dev)
    if dstate is not None:
        _build.check("dstate", dstate, torch.float32, (b, h, n, n), dev,
                     contiguous=False)
        dstate = dstate.contiguous()
    if n not in HEAD_DIMS:
        raise ValueError(f"the wkv6 kernel takes head dims {HEAD_DIMS}, "
                         f"got {n}")
    steps = _build.steps_for(r)
    n_chunks = -(-s // steps)
    _build.check("chunk_state", chunk_state, torch.float32,
                 (b, h, n_chunks, n, n), dev)
    grads = [torch.empty_like(r) for _ in range(4)]
    if b * h * n_chunks == 0:
        return (*grads, torch.zeros_like(u))
    lib = _lib()
    r, k, v, lw, do = (_build.aligned(t) for t in (r, k, v, lw,
                                                    do.contiguous()))
    du_part = torch.empty((b, h, n_chunks, n), dtype=torch.float32,
                          device=dev)
    dchunks = torch.empty_like(chunk_state)
    decay = torch.empty((b, h, n_chunks, n), dtype=torch.float32,
                        device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = lib.wkv6_backward_f32(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
        u.data_ptr(), chunk_state.data_ptr(), do.data_ptr(), ptr(dstate),
        *(g_.data_ptr() for g_ in grads), du_part.data_ptr(),
        dchunks.data_ptr(), decay.data_ptr(), b, s, h, n, steps, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on(err, "wkv6_backward")
    LAUNCHES["wkv6_backward"] += 1
    # du: the per-CTA partials summed in a fixed order
    return (*grads, du_part.sum(dim=(0, 2)))


class WKV6(torch.autograd.Function):
    """WKV6 with its backward: the forward keeps the chunk states the
    kernel computes, the backward walks each chunk from them."""

    @staticmethod
    def forward(ctx, r, k, v, lw, u):
        ctx.set_materialize_grads(False)
        if _build.route(r.device) == "cpu":
            (o, state), chunk_state = wkv6_plain(r, k, v, lw, u), None
        else:
            o, state, chunk_state = _launch(r, k, v, lw, u,
                                            _build.steps_for(r))
        ctx.save_for_backward(r, k, v, lw, u, chunk_state)
        return o, state

    @staticmethod
    def backward(ctx, do, dstate):
        r, k, v, lw, u, chunk_state = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(r)
        return wkv6_backward(r, k, v, lw, u, chunk_state, do, dstate)


def wkv6(r, k, v, lw, u, *, chunk: int = 64):
    """(o (B,S,H,N), state (B,H,N,N)) from a zero state.  ``chunk`` is the
    plain version's chunk length; the kernel's is :func:`chunk_len`."""
    b, s, h, n = r.shape
    dev = r.device
    if r.dtype not in _FN:
        raise TypeError(f"r must be float32 or bfloat16, got {r.dtype}")
    for name, t in (("r", r), ("k", k), ("v", v)):
        _build.check(name, t, r.dtype, (b, s, h, n), dev)
    _build.check("lw", lw, torch.float32, (b, s, h, n), dev)
    _build.check("u", u, torch.float32, (h, n), dev)
    if r.dtype == torch.bfloat16:
        _build.refuse_grad("wkv6", dev, r, k, v, lw, u)
    if _build.route(dev) == "cpu":
        return wkv6_plain(r, k, v, lw, u, chunk=chunk)
    if n not in HEAD_DIMS:
        raise ValueError(f"the wkv6 kernel takes head dims {HEAD_DIMS}, "
                         f"got {n}")
    if b * h == 0:
        return (torch.empty_like(r),
                torch.empty((b, h, n, n), dtype=torch.float32, device=dev))
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (r, k, v, lw, u)):
        return WKV6.apply(r, k, v, lw, u)
    return _launch(r, k, v, lw, u, _build.steps_for(r))[:2]
