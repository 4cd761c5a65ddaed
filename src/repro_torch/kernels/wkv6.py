"""RWKV6 WKV recurrence: the hand-written kernel and its plain version.

``wkv6(r, k, v, lw, u)`` checks its tensors and picks its route from
their device alone: on CUDA tensors it launches the kernel of
``csrc/wkv6.cu`` (and raises if the launch fails); on CPU tensors it
runs :func:`wkv6_plain`, the chunked form ``wkv6_chunked`` of
``repro_torch.models.rwkv6``.  Nothing on the CUDA path calls the plain
version.  Each kernel launch adds one to ``LAUNCHES["wkv6"]``.

Prefill semantics, as the reference's ``wkv6_pallas``: zero initial
state, r/k/v (B, S, H, N) float32 or bfloat16, lw (B, S, H, N) float32
(<= 0), u (H, N) float32, all contiguous; returns o (B, S, H, N) in r's
dtype and the final state (B, H, N, N) float32.  The kernel takes any S
and N in (16, 32, 64).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = {"wkv6": 0}
HEAD_DIMS = (16, 32, 64)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
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


def wkv6(r, k, v, lw, u, *, chunk: int = 64):
    """(o (B,S,H,N), state (B,H,N,N)) from a zero state.  ``chunk`` is the
    plain version's chunk length; the kernel runs step by step."""
    b, s, h, n = r.shape
    dev = r.device
    if r.dtype not in _FN:
        raise TypeError(f"r must be float32 or bfloat16, got {r.dtype}")
    for name, t in (("r", r), ("k", k), ("v", v)):
        _build.check(name, t, r.dtype, (b, s, h, n), dev)
    _build.check("lw", lw, torch.float32, (b, s, h, n), dev)
    _build.check("u", u, torch.float32, (h, n), dev)
    if _build.route(dev) == "cpu":
        return wkv6_plain(r, k, v, lw, u, chunk=chunk)
    if n not in HEAD_DIMS:
        raise ValueError(f"the wkv6 kernel takes head dims {HEAD_DIMS}, "
                         f"got {n}")
    o = torch.empty_like(r)
    state = torch.empty((b, h, n, n), dtype=torch.float32, device=dev)
    if b * h == 0:
        return o, state
    err = getattr(_lib(), _FN[r.dtype])(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
        u.data_ptr(), o.data_ptr(), state.data_ptr(), b, s, h, n,
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on(err, "wkv6")
    LAUNCHES["wkv6"] += 1
    return o, state
