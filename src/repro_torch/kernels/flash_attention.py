"""Flash attention: the hand-written forward and backward kernels and
their plain versions.

``flash_attention(q, k, v, causal=, window=, scale=)`` checks its tensors
and picks its route from their device alone: on CUDA tensors it launches
the kernels of ``csrc/flash_attention.cu`` (and raises if a launch
fails); on CPU tensors it runs :func:`flash_attention_plain` (the
blockwise online-softmax forward of ``repro_torch.models.attention``).
Nothing on the CUDA path calls a plain version.  Each forward launch adds
one to ``LAUNCHES["flash_attention"]``, each backward call (two kernels,
dK / dV then dQ) one to ``LAUNCHES["flash_attention_backward"]``.

Gradients: when grad mode is on and an input requires a gradient, the
call goes through :class:`FlashAttention`, a ``torch.autograd.Function``
whose forward also writes each row's log-sum-exp and whose backward is
:func:`flash_attention_backward` (the kernel on CUDA,
``flash_attention_backward_plain`` on the CPU, the reference's custom
VJP).  The backward kernel takes float32 with D up to 192 (MLA's Dk
192) and Dv up to 128: a bfloat16 call, or float32 past those, under
grad on CUDA raises ``NotImplementedError`` naming ``ROADMAP.md``.
Otherwise the call takes the forward alone, with no LSE buffer.

Layouts: q (B, Sq, H, D), k (B, Sk, KV, D), v (B, Sk, KV, Dv), H a
multiple of KV, all float32 or all bfloat16; the output is a new
(B, Sq, H, Dv) tensor of q's dtype.  Operands are read through their
strides (the last axis must be contiguous).  The forward kernel takes any
S, and D, Dv in multiples of 4: D up to 192 and Dv up to 128 in either
dtype (MLA's prefill attends with Dk = 192, Dv = 128, its V a strided
view that both instances read in place); causal attention needs Sq <= Sk
(every query row then sees at least one key).

Both forward instances run on the tensor cores: float32 as 3xTF32
``mma.sync`` fed by ``cp.async`` (float32-level accuracy; at D > 128 with
32-key tiles, so that its shared memory fits), bfloat16 as ``wgmma`` fed
by TMA, with P rounded to bfloat16 before P V (at D > 128 with a ring
of three 64-key stages).  Their copies move 16-byte chunks, so an
operand must start on 16 bytes and have strides that are multiples of
16 bytes; one that does not (an odd view, or bfloat16 with
D or Dv not a multiple of 8) is first copied into an aligned buffer whose
last axis is padded to a multiple of 16 bytes.  Operands from a
contiguous float32 allocation, and bfloat16 ones with D and Dv multiples
of 8, are never copied.  The backward kernels (dK / dV, then dQ, each
over a resident block of 64 rows) run every product on TF32 ``wgmma`` as
three products (3xTF32, float32-level accuracy), their tiles streamed
by TMA into an mbarrier ring; each streamed tile's share of dK, dV or dQ
sums in a fresh accumulator that is added in float32 (streamed tiles of
32 rows; 16 in the dK / dV kernel at D > 128).  They read contiguous
operands (the wrapper makes them so) through tensor maps, use no
atomics (two calls give bit-identical gradients), and delta =
rowsum(dO * O) is one PyTorch reduction before them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.models.attention import (flash_attention_backward_plain,
                                          flash_attention_plain)

LAUNCHES = {"flash_attention": 0, "flash_attention_backward": 0}
# the forward kernel's largest (D, Dv), both dtypes
MAX_HEAD_DIMS = (192, 128)
# the backward kernel's: float32 only
MAX_GRAD_HEAD_DIMS = (192, 128)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_TAIL = [_I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P]
_SIGNATURES = {
    # q, k, v, o, lse, strides, B, H, KV, Sq, Sk, D, Dv, scale, causal,
    # window, device, stream
    "flash_attention_f32": [_P] * 6 + _TAIL,
    "flash_attention_bf16": [_P] * 5 + _TAIL,
    # q, k, v, dout, lse, delta, dq, dk, dv, then as above
    "flash_attention_backward_f32": [_P] * 9 + _TAIL,
}
_FN = {torch.float32: "flash_attention_f32",
       torch.bfloat16: "flash_attention_bf16"}

__all__ = ["LAUNCHES", "FlashAttention", "flash_attention",
           "flash_attention_backward", "flash_attention_backward_plain",
           "flash_attention_plain", "reset_launch_counts"]


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    return _build.load("flash_attention", _SIGNATURES)


def _grad_later(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"the flash backward kernel takes float32 with D up to "
        f"{MAX_GRAD_HEAD_DIMS[0]} and Dv up to {MAX_GRAD_HEAD_DIMS[1]}, "
        f"got {what}: not ported yet (ROADMAP.md queue 1 item 10)")


def _check_grad_kernel(q, d: int, dv: int) -> None:
    """Raise unless the backward kernel takes this call."""
    if q.dtype != torch.float32:
        raise _grad_later(str(q.dtype))
    if d > MAX_GRAD_HEAD_DIMS[0] or dv > MAX_GRAD_HEAD_DIMS[1]:
        raise _grad_later(f"D={d}, Dv={dv}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None):
    """Fused attention.  q: (B, Sq, H, D); k/v: (B, Sk, KV, D|Dv)
    → (B, Sq, H, Dv); differentiable (see the module docstring)."""
    b, sq, h, d = q.shape
    _, sk, n_kv, dv = v.shape
    dev = q.device
    if q.dtype not in _FN:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    _build.check("k", k, q.dtype, (b, sk, n_kv, d), dev, contiguous=False)
    _build.check("v", v, q.dtype, (b, sk, n_kv, dv), dev, contiguous=False)
    if n_kv == 0 or h % n_kv:
        raise ValueError(f"query heads {h} must be a multiple of kv heads "
                         f"{n_kv}")
    if causal and sq > sk:
        raise ValueError(f"causal attention needs Sq <= Sk, got {sq} > {sk}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    scale = scale if scale is not None else d ** -0.5
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if _build.route(dev) == "cuda":
            _check_grad_kernel(q, d, dv)
        return FlashAttention.apply(q, k, v, causal, window, scale)
    return _forward(q, k, v, causal, window, scale, with_lse=False)[0]


def _forward(q, k, v, causal: bool, window: int, scale: float,
             with_lse: bool):
    """(o, lse (B, H, Sq) float32 or None): the kernel on CUDA tensors,
    the plain version on CPU tensors."""
    b, sq, h, d = q.shape
    _, sk, n_kv, dv = v.shape
    dev = q.device
    if _build.route(dev) == "cpu":
        if with_lse:
            return flash_attention_plain(q, k, v, causal=causal,
                                         window=window, scale=scale,
                                         return_lse=True)
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale), None
    max_d, max_dv = MAX_HEAD_DIMS
    if d > max_d or dv > max_dv or d % 4 or dv % 4:
        raise ValueError(f"the flash kernel takes D up to {max_d} and Dv "
                         f"up to {max_dv}, in multiples of 4, got D={d}, "
                         f"Dv={dv} (ROADMAP.md queue 1 item 10)")
    if (sq + 127) // 128 > 65535:
        raise ValueError(f"the flash kernel takes Sq up to {128 * 65535}, "
                         f"got {sq}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the last axis of q, k and v must be contiguous")
    if with_lse and q.dtype != torch.float32:
        raise _grad_later(str(q.dtype))
    o = torch.empty((b, sq, h, dv), dtype=q.dtype, device=dev)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=dev)
           if with_lse else None)
    if o.numel() == 0:
        return o, lse
    q, k, v = (_build.aligned(t) for t in (q, k, v))
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, o) for s in _build.row_strides(t)))
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr()]
    if q.dtype == torch.float32:
        ptrs.append(None if lse is None else lse.data_ptr())
    err = getattr(_lib(), _FN[q.dtype])(
        *ptrs, strides, b, h, n_kv, sq, sk, d, dv, float(scale),
        int(causal), int(window), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return o, lse


def flash_attention_backward(q, k, v, o, lse, do, *, causal: bool = True,
                             window: int = 0, scale: float | None = None):
    """(dq, dk, dv) of :func:`flash_attention` at (q, k, v), from its
    output ``o``, its LSE (B, H, Sq) float32 and the output gradient
    ``do``: the kernel on CUDA tensors (float32, D up to 192, Dv up to
    128), the reference's blockwise VJP on CPU tensors."""
    b, sq, h, d = q.shape
    _, sk, n_kv, dv = v.shape
    dev = q.device
    _build.check("o", o, q.dtype, (b, sq, h, dv), dev, contiguous=False)
    _build.check("do", do, q.dtype, (b, sq, h, dv), dev, contiguous=False)
    _build.check("lse", lse, torch.float32, (b, h, sq), dev,
                 contiguous=False)
    scale = scale if scale is not None else d ** -0.5
    if _build.route(dev) == "cpu":
        return flash_attention_backward_plain(q, k, v, o, lse, do,
                                              causal=causal, window=window,
                                              scale=scale)
    _check_grad_kernel(q, d, dv)
    if (sq + 63) // 64 > 65535 or (sk + 63) // 64 > 65535:
        raise ValueError("the flash backward kernel takes S up to "
                         f"{64 * 65535}, got Sq={sq}, Sk={sk}")
    lib = _lib()
    q, k, v, do, lse = (t.contiguous() for t in (q, k, v, do, lse))
    # delta = rowsum(dO * O), (B, H, Sq), the reference's order
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    dq, dk, dv_ = (torch.empty_like(t) for t in (q, k, v))
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv_.zero_()
    err = lib.flash_attention_backward_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv_.data_ptr(), b, h, n_kv, sq, sk, d, dv, float(scale),
        int(causal), int(window), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on(err, "flash_attention_backward")
    LAUNCHES["flash_attention_backward"] += 1
    return dq, dk, dv_


class FlashAttention(torch.autograd.Function):
    """Flash attention with its backward: the forward saves q, k, v, o
    and the LSE, the backward recomputes P blockwise from them (O(S)
    memory, as the reference's custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        o, lse = _forward(q, k, v, causal, window, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.attn = (causal, window, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, scale = ctx.attn
        dq, dk, dv = flash_attention_backward(
            q, k, v, o, lse, do, causal=causal, window=window, scale=scale)
        return dq, dk, dv, None, None, None
