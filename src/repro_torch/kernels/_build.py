"""Build and load the port's CUDA sources at first use.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into a shared library bound with ``ctypes``: a
file that includes no PyTorch header builds in seconds.  Libraries go to
``_build/`` beside this module (listed in ``.gitignore``), named by a
hash of the source and flags, so a changed source is rebuilt and an
unchanged one is loaded as it is; processes that build one source at
once (the ranks of a cells group) take turns on a file lock, so it is
compiled once.  A missing ``nvcc`` raises.  The
wrappers' shared checks (``check``, ``route``, ``refuse_grad``,
``raise_on``) live here
too, with the 16-byte alignment helpers of the kernels that copy with
``cp.async`` or TMA (``row_strides``, ``aligned``) and the chunk length
of the chunked scans (``chunk_len``).
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[Path, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler PyTorch's build helpers find, else the one on
    ``PATH``; raises when there is none."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built from source at first use and need the "
                           "CUDA toolkit")
    return found


def library_path(source: Path) -> Path:
    """The library of ``source``, named by a hash of it, the headers of
    ``csrc/`` and the flags."""
    text = source.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{source.stem}-{digest[:16]}.so"


def build(source: Path, force: bool = False) -> tuple[Path, str]:
    """Compile ``source`` unless its library exists (or ``force``), with
    ``csrc/`` on the include path (a variant written elsewhere finds the
    shared header).  Returns the library path and nvcc's output
    (``-Xptxas -v`` register and shared-memory lines), empty when nothing
    was compiled."""
    out = library_path(source)
    if out.exists() and not force:
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{out.stem}.lock", "w") as lock:
        # one builder at a time; the others find its library
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists() and not force:
            return out, ""
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
             str(source)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name} "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a loader never sees a partial file
    return out, proc.stdout + proc.stderr


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed, with
    ``argtypes`` declared from ``signatures`` ({function: argtypes}; every
    function returns a C ``int``)."""
    source = CSRC / f"{name}.cu"
    lib = _loaded.get(source)
    if lib is None:
        path, _ = build(source)
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[source] = lib
    return lib


def check(name: str, t: torch.Tensor, dtype, shape, device,
          contiguous: bool = True) -> None:
    """Raise unless ``t`` has this dtype, shape and device (and, when
    asked, is contiguous)."""
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def route(device: torch.device) -> str:
    """"cuda" launches the kernel, "cpu" runs its plain version; any
    other device raises."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no route for tensors on {device}")
    return device.type


def refuse_grad(name: str, device: torch.device, *tensors) -> None:
    """Raise ``NotImplementedError`` naming ``ROADMAP.md`` when a bfloat16
    call of ``name`` on CUDA tensors would need a gradient (grad mode on
    and an input requiring one): there is no bf16 backward kernel yet, and
    the kernel's output would carry no gradient path.  The wrappers call
    it for bf16 only (their float32 calls differentiate through their
    backward kernels); CPU tensors pass, since their plain versions
    differentiate."""
    if (device.type == "cuda" and torch.is_grad_enabled()
            and any(t is not None and t.requires_grad for t in tensors)):
        raise NotImplementedError(
            f"{name} has no bfloat16 backward kernel yet, so it cannot run "
            f"in bfloat16 under autograd on the card (ROADMAP.md queue 1 "
            f"item 10.4c)")


# steps per CTA of the chunked scans (WKV6's forward and backward), halved
# (down to MIN_STEPS) while the grid would give fewer than CTAS_PER_SM
# CTAs per SM (chosen by timing the WKV6 forward, tools/wkv6_chunks.py;
# tools/bwd_chunks.py times the backward by chunk length)
STEPS_PER_CTA, MIN_STEPS, CTAS_PER_SM = 256, 16, 4


def chunk_len(bh: int, s: int, n_sms: int) -> int:
    """Steps per CTA of a chunked scan over ``bh`` (batch, head) pairs of
    ``s`` steps on a card of ``n_sms`` SMs."""
    steps = STEPS_PER_CTA
    while steps > MIN_STEPS and bh * -(-s // steps) < CTAS_PER_SM * n_sms:
        steps //= 2
    return steps


def steps_for(t: torch.Tensor) -> int:
    """:func:`chunk_len` for a (B, S, H, ...) operand on its card."""
    b, s, h = t.shape[:3]
    return chunk_len(b * h, s, torch.cuda.get_device_properties(
        t.device).multi_processor_count)


def raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{err}")


def row_strides(t: torch.Tensor) -> tuple[int, int, int]:
    """Element strides of the (batch, seq, head) axes of a 4-d operand;
    an axis of length 1 gets one past the whole tensor (its index is
    always 0), so it never breaks the 16-byte rule."""
    unit = 16 // t.element_size()
    beyond = max(t.stride(i) * t.shape[i] for i in range(4))
    beyond = -(-beyond // unit) * unit
    return tuple(t.stride(i) if t.shape[i] > 1 else beyond for i in range(3))


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when it starts on 16 bytes and its ``row_strides`` are
    multiples of 16 bytes, else a copy in a buffer whose last axis is
    padded to a multiple of 16 bytes (a view of it, cut back to ``t``'s
    shape)."""
    unit = 16 // t.element_size()
    if t.data_ptr() % 16 == 0 and all(s % unit == 0 for s in row_strides(t)):
        return t
    d = t.shape[-1]
    buf = torch.empty((*t.shape[:-1], -(-d // unit) * unit), dtype=t.dtype,
                      device=t.device)
    return buf[..., :d].copy_(t)
