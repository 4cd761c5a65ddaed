"""Mamba2 SSD scan: the hand-written kernel and its plain version.

``ssd(x, dt, a, b, c, d_skip, chunk=, init_state=)`` checks its tensors
and picks its route from their device alone: on CUDA tensors it launches
the kernel of ``csrc/ssd.cu`` (and raises if the launch fails); on CPU
tensors it runs :func:`ssd_plain`, the chunked form ``ssd_chunked`` of
``repro_torch.models.mamba2`` plus the D skip term.  Nothing on the CUDA
path calls the plain version.  Each kernel launch adds one to
``LAUNCHES["ssd"]``.
The kernel has no backward yet: a CUDA call under autograd (grad mode
on and an input requiring a gradient) raises ``NotImplementedError``
naming ``ROADMAP.md`` rather than return an output with no gradient
path; the plain version differentiates on the CPU.

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
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = {"ssd": 0}
MAX_DIM = 128

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
         _P]
_SIGNATURES = {"ssd_f32": _ARGS, "ssd_bf16": _ARGS}
_FN = {torch.float32: "ssd_f32", torch.bfloat16: "ssd_bf16"}


def reset_launch_counts() -> None:
    LAUNCHES["ssd"] = 0


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


def ssd(x, dt, a, b, c, d_skip=None, *, chunk: int = 64, init_state=None):
    """(y (B,S,H,P), final state (B,H,P,N) f32) of the SSD scan."""
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
    _build.refuse_grad("ssd", dev, x, dt, a, b, c, d_skip, init_state)
    if _build.route(dev) == "cpu":
        return ssd_plain(x, dt, a, b, c, d_skip, chunk=chunk,
                         init_state=init_state)
    if not (0 < p <= MAX_DIM and 0 < n <= MAX_DIM):
        raise ValueError(f"the ssd kernel takes P and N up to {MAX_DIM}, "
                         f"got P={p}, N={n}")
    if any(t.stride(-1) != 1 for t in (x, b, c)):
        raise ValueError("the last axis of x, b and c must be contiguous")
    y = torch.empty((bb, s, h, p), dtype=x.dtype, device=dev)
    state = torch.empty((bb, h, p, n), dtype=torch.float32, device=dev)
    if bb * h == 0:
        return y, state
    x, b, c = (_build.aligned(t) for t in (x, b, c))
    strides = (ctypes.c_longlong * 12)(
        *_build.row_strides(x), *(dt.stride(i) for i in (0, 1, 2)),
        *_build.row_strides(b), *_build.row_strides(c))
    ptr = lambda t: None if t is None else t.data_ptr()
    err = getattr(_lib(), _FN[x.dtype])(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), ptr(d_skip), ptr(init_state), y.data_ptr(),
        state.data_ptr(), strides, bb, s, h, g, p, n, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on(err, "ssd")
    LAUNCHES["ssd"] += 1
    return y, state
