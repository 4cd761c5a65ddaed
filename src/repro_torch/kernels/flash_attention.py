"""Forward flash attention: the hand-written kernel and its plain version.

``flash_attention(q, k, v, causal=, window=, scale=)`` checks its tensors
and picks its route from their device alone: on CUDA tensors it launches
the kernel of ``csrc/flash_attention.cu`` (and raises if the launch
fails); on CPU tensors it runs :func:`flash_attention_plain` (the
blockwise online-softmax forward of ``repro_torch.models.attention``).
Nothing on the CUDA path calls the plain version.  Each kernel launch
adds one to ``LAUNCHES["flash_attention"]``.

Layouts: q (B, Sq, H, D), k (B, Sk, KV, D), v (B, Sk, KV, Dv), H a
multiple of KV, all float32 or all bfloat16; the output is a new
(B, Sq, H, Dv) tensor of q's dtype.  Operands are read through their
strides (the last axis must be contiguous).  The kernel takes any S, and
D, Dv in multiples of 4: float32 D up to 192 and Dv up to 128 (MLA's
prefill attends with Dk = 192, Dv = 128), bfloat16 both up to 128 (bf16
at D > 128 is still to do, ROADMAP.md); causal attention needs Sq <= Sk
(every query row then sees at least one key).

Both instances run on the tensor cores: float32 as 3xTF32 ``mma.sync``
fed by ``cp.async`` (float32-level accuracy; at D > 128 with 32-key
tiles, so that its shared memory fits), bfloat16 as ``wgmma`` fed by
TMA, with P rounded to bfloat16 before P V.  Their copies move 16-byte
chunks, so an operand must start on 16 bytes and have strides that are
multiples of 16 bytes; one that does not (an odd view, or bfloat16 with
D or Dv not a multiple of 8) is first copied into an aligned buffer whose
last axis is padded to a multiple of 16 bytes.  Operands from a
contiguous float32 allocation, and bfloat16 ones with D and Dv multiples
of 8, are never copied.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.models.attention import flash_attention_plain

LAUNCHES = {"flash_attention": 0}
# the kernel's largest (D, Dv) per dtype
MAX_HEAD_DIMS = {torch.float32: (192, 128), torch.bfloat16: (128, 128)}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P]
_SIGNATURES = {"flash_attention_f32": _ARGS, "flash_attention_bf16": _ARGS}
_FN = {torch.float32: "flash_attention_f32",
       torch.bfloat16: "flash_attention_bf16"}

__all__ = ["LAUNCHES", "flash_attention", "flash_attention_plain",
           "reset_launch_counts"]


def reset_launch_counts() -> None:
    LAUNCHES["flash_attention"] = 0


def _lib() -> ctypes.CDLL:
    return _build.load("flash_attention", _SIGNATURES)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None):
    """Fused forward attention.  q: (B, Sq, H, D); k/v: (B, Sk, KV, D|Dv)
    → (B, Sq, H, Dv)."""
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
    if _build.route(dev) == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    max_d, max_dv = MAX_HEAD_DIMS[q.dtype]
    if d > max_d or dv > max_dv or d % 4 or dv % 4:
        later = (" (bfloat16 at D > 128 is not ported yet: ROADMAP.md "
                 "queue 1 item 10)" if q.dtype == torch.bfloat16
                 and d > max_d else "")
        raise ValueError(f"the {q.dtype} flash kernel takes D up to {max_d} "
                         f"and Dv up to {max_dv}, in multiples of 4, got "
                         f"D={d}, Dv={dv}{later}")
    if (sq + 127) // 128 > 65535:
        raise ValueError(f"the flash kernel takes Sq up to {128 * 65535}, "
                         f"got {sq}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the last axis of q, k and v must be contiguous")
    o = torch.empty((b, sq, h, dv), dtype=q.dtype, device=dev)
    if o.numel() == 0:
        return o
    q, k, v = (_build.aligned(t) for t in (q, k, v))
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, o) for s in _build.row_strides(t)))
    err = getattr(_lib(), _FN[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), strides,
        b, h, n_kv, sq, sk, d, dv, float(scale), int(causal), int(window),
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return o
