"""Pytree checkpoints in the reference's byte format, without ``msgpack``.

The reference (``repro.checkpoint.ckpt``) writes ``msgpack.packb(tree,
use_bin_type=True)`` of a tree whose arrays are maps ``{"__arr__": True,
"dtype", "shape", "data": raw bytes}`` and whose tuples are maps
``{"__tuple__": [...]}``.  The machine with the card has no ``msgpack``,
so this module encodes and decodes the subset of MessagePack that format
uses — maps, arrays, str, bin, int, float, bool and nil — with the same
bytes ``msgpack.packb`` writes (smallest encoding of every int, float64
floats, str8 and bin types on).  Restored arrays are CPU tensors.
"""
from __future__ import annotations

import os
import struct
from typing import Any

import numpy as np
import torch

_ARR = "__arr__"
_TUP = "__tuple__"


# ------------------------------------------------------------ tree <-> raw
def _encode(obj):
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    if isinstance(obj, np.ndarray) or hasattr(obj, "dtype"):
        arr = np.asarray(obj)
        return {_ARR: True, "dtype": str(arr.dtype),
                "shape": list(arr.shape), "data": arr.tobytes()}
    if isinstance(obj, dict):
        return {k: _encode(v) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return {_TUP: [_encode(v) for v in obj]}
    if isinstance(obj, list):
        return [_encode(v) for v in obj]
    if obj is None or isinstance(obj, (bool, int, float, str, bytes)):
        return obj
    raise TypeError(f"cannot checkpoint {type(obj)}")


def _decode(obj):
    if isinstance(obj, dict):
        if obj.get(_ARR):
            arr = np.frombuffer(obj["data"], dtype=np.dtype(obj["dtype"]))
            return torch.from_numpy(arr.reshape(obj["shape"]).copy())
        if _TUP in obj:
            return tuple(_decode(v) for v in obj[_TUP])
        return {k: _decode(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode(v) for v in obj]
    return obj


# ------------------------------------------------------- MessagePack subset
def _head(n: int, fix: int | None, fix_max: int, codes) -> bytes:
    """Type byte(s) + length for a sized type: the fix form when it
    fits, else the 8/16/32-bit length form (``codes`` maps a length
    width in bytes to its type byte; width 1 may be absent)."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for width, fmt in ((1, ">B"), (2, ">H"), (4, ">I")):
        if width in codes and n < 1 << (8 * width):
            return bytes([codes[width]]) + struct.pack(fmt, n)
    raise ValueError(f"object of length {n} is too large to pack")


def _pack_int(v: int) -> bytes:
    if 0 <= v < 128:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v > 0:
        for code, fmt, lim in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < lim:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        for code, fmt, lim in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                               (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if v >= -lim:
                return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"integer {v} does not fit in 64 bits")


def packb(obj) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for the subset above."""
    out = bytearray()

    def put(o):
        if o is None:
            out.append(0xC0)
        elif o is True or o is False:
            out.append(0xC3 if o else 0xC2)
        elif isinstance(o, int):
            out.extend(_pack_int(o))
        elif isinstance(o, float):
            out.append(0xCB)
            out.extend(struct.pack(">d", o))
        elif isinstance(o, str):
            b = o.encode("utf-8")
            out.extend(_head(len(b), 0xA0, 31, {1: 0xD9, 2: 0xDA, 4: 0xDB}))
            out.extend(b)
        elif isinstance(o, (bytes, bytearray, memoryview)):
            b = bytes(o)
            out.extend(_head(len(b), None, 0, {1: 0xC4, 2: 0xC5, 4: 0xC6}))
            out.extend(b)
        elif isinstance(o, (list, tuple)):
            out.extend(_head(len(o), 0x90, 15, {2: 0xDC, 4: 0xDD}))
            for v in o:
                put(v)
        elif isinstance(o, dict):
            out.extend(_head(len(o), 0x80, 15, {2: 0xDE, 4: 0xDF}))
            for k, v in o.items():
                put(k)
                put(v)
        else:
            raise TypeError(f"cannot pack {type(o)}")

    put(obj)
    return bytes(out)


def unpackb(data: bytes):
    """Inverse of :func:`packb` (also reads float32 and raw str8/16/32
    as ``msgpack.unpackb(raw=False)`` does)."""
    buf = memoryview(data)
    pos = 0

    def take(n):
        nonlocal pos
        if pos + n > len(buf):
            raise ValueError("truncated checkpoint")
        chunk = buf[pos:pos + n]
        pos += n
        return chunk

    def unpack(fmt):
        return struct.unpack(fmt, take(struct.calcsize(fmt)))[0]

    sized = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I",      # str
             0xC4: ">B", 0xC5: ">H", 0xC6: ">I",      # bin
             0xDC: ">H", 0xDD: ">I",                  # array
             0xDE: ">H", 0xDF: ">I"}                  # map
    fixed = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
             0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
             0xCA: ">f", 0xCB: ">d"}

    def get():
        t = take(1)[0]
        if t < 0x80:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return items(t & 0x0F, True)
        if 0x90 <= t <= 0x9F:
            return items(t & 0x0F, False)
        if 0xA0 <= t <= 0xBF:
            return bytes(take(t & 0x1F)).decode("utf-8")
        if t == 0xC0:
            return None
        if t in (0xC2, 0xC3):
            return t == 0xC3
        if t in fixed:
            return unpack(fixed[t])
        if t in sized:
            n = unpack(sized[t])
            if t in (0xD9, 0xDA, 0xDB):
                return bytes(take(n)).decode("utf-8")
            if t in (0xC4, 0xC5, 0xC6):
                return bytes(take(n))
            return items(n, t in (0xDE, 0xDF))
        raise ValueError(f"unsupported MessagePack type byte 0x{t:02x}")

    def items(n, is_map):
        if is_map:
            return {get(): get() for _ in range(n)}
        return [get() for _ in range(n)]

    obj = get()
    if pos != len(buf):
        raise ValueError("trailing bytes after checkpoint object")
    return obj


# ------------------------------------------------------------------- files
def save(path: str, tree: Any) -> None:
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(packb(_encode(tree)))
    os.replace(tmp, path)


def restore(path: str) -> Any:
    with open(path, "rb") as f:
        return _decode(unpackb(f.read()))
