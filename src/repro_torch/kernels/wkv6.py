"""RWKV6 WKV recurrence: the hand-written kernel and its plain version.

``wkv6(r, k, v, lw, u)`` checks its tensors and picks its route from
their device alone: on CUDA tensors it launches the kernels of
``csrc/wkv6.cu`` (and raises if a launch fails); on CPU tensors it
runs :func:`wkv6_plain`, the chunked form ``wkv6_chunked`` of
``repro_torch.models.rwkv6``.  Nothing on the CUDA path calls the plain
version.  Each call that launches adds one to ``LAUNCHES["wkv6"]``.
The kernel has no backward yet: a CUDA call under autograd (grad mode
on and an input requiring a gradient) raises ``NotImplementedError``
naming ``ROADMAP.md`` rather than return an output with no gradient
path; the plain version differentiates on the CPU.

Prefill semantics, as the reference's ``wkv6_pallas``: zero initial
state, r/k/v (B, S, H, N) float32 or bfloat16, lw (B, S, H, N) float32
(<= 0), u (H, N) float32, all contiguous; returns o (B, S, H, N) in r's
dtype and the final state (B, H, N, N) float32.  The kernel takes any S
and N in (16, 32, 64).

On the card the recurrence runs in chunks of ``chunk_len`` steps, one
CTA each: a pass that runs every chunk from a zero state, a scan that
carries the state across chunks, and a pass that reruns every chunk from
its carried state and writes o (``csrc/wkv6.cu``).  The chunk states
live in a scratch the wrapper allocates on the caller's stream.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = {"wkv6": 0}
HEAD_DIMS = (16, 32, 64)
# steps per CTA, halved (down to MIN_STEPS) while the grid would give
# fewer than four CTAs per SM (tools/wkv6_chunks.py times the choices)
STEPS_PER_CTA, MIN_STEPS, CTAS_PER_SM = 256, 16, 4

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 9 + [_I] * 6 + [_P]
_SIGNATURES = {"wkv6_f32": _ARGS, "wkv6_bf16": _ARGS}
_FN = {torch.float32: "wkv6_f32", torch.bfloat16: "wkv6_bf16"}


def reset_launch_counts() -> None:
    LAUNCHES["wkv6"] = 0


def _lib() -> ctypes.CDLL:
    return _build.load("wkv6", _SIGNATURES)


def wkv6_plain(r, k, v, lw, u, *, chunk: int = 64):
    """Plain version: the chunked WKV from a zero state."""
    from repro_torch.models.rwkv6 import wkv6_chunked  # imports this module
    return wkv6_chunked(r, k, v, lw, u, chunk=chunk)


def chunk_len(bh: int, s: int, n_sms: int) -> int:
    """Steps per CTA of the kernel for ``bh`` (batch, head) pairs of ``s``
    steps on a card of ``n_sms`` SMs."""
    steps = STEPS_PER_CTA
    while steps > MIN_STEPS and bh * -(-s // steps) < CTAS_PER_SM * n_sms:
        steps //= 2
    return steps


def _launch(r, k, v, lw, u, steps: int):
    """The kernels on checked CUDA tensors, ``steps`` steps per CTA."""
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
    return o, state


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
    _build.refuse_grad("wkv6", dev, r, k, v, lw, u)
    if _build.route(dev) == "cpu":
        return wkv6_plain(r, k, v, lw, u, chunk=chunk)
    if n not in HEAD_DIMS:
        raise ValueError(f"the wkv6 kernel takes head dims {HEAD_DIMS}, "
                         f"got {n}")
    if b * h == 0:
        return (torch.empty_like(r),
                torch.empty((b, h, n, n), dtype=torch.float32, device=dev))
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return _launch(r, k, v, lw, u, chunk_len(b * h, s, n_sms))
