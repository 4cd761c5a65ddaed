"""Pytree checkpoints in the reference's byte format, without ``msgpack``.

The reference (``repro.checkpoint.ckpt``) writes ``msgpack.packb(tree,
use_bin_type=True)`` of a tree whose arrays are maps ``{"__arr__": True,
"dtype", "shape", "data": raw bytes}`` and whose tuples are maps
``{"__tuple__": [...]}``.  The machine with the card has no ``msgpack``,
so this module encodes and decodes the subset of MessagePack that format
uses — maps, arrays, str, bin, int, float, bool and nil — with the same
bytes ``msgpack.packb`` writes (smallest encoding of every int, float64
floats, str8 and bin types on).  Restored arrays are CPU tensors.  A
bfloat16 array is written as the reference writes one (dtype string
``"bfloat16"``, its raw 16-bit words) and read back as a
``torch.bfloat16`` tensor, without ``ml_dtypes``.  ``restore_like``
re-imposes a template's structure, as the reference's does.

``save`` streams the file leaf by leaf and ``restore`` reads it through
a memory map, so a checkpoint of several GB (an LM's training state)
never sits in host memory twice.  ``save_train_state`` /
``load_train_state`` write and read an LM ``TrainState``
(``repro_torch.training.train_step``): parameters by name, the
optimizer's state and the step.
"""
from __future__ import annotations

import mmap
import os
import struct
from typing import Any

import numpy as np
import torch

_ARR = "__arr__"
_TUP = "__tuple__"


# ------------------------------------------------------------ tree <-> raw
def _host_array(obj) -> tuple[np.ndarray, str]:
    """(a C-contiguous numpy array of ``obj``'s bytes, its dtype string).
    A bfloat16 tensor, which numpy cannot hold, goes as its 16-bit words
    under the name ``"bfloat16"``, as the reference writes an
    ``ml_dtypes.bfloat16`` array."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy(), "bfloat16"
        obj = t.numpy()
    arr = np.asarray(obj)
    if not arr.flags.c_contiguous:  # (ascontiguousarray makes 0-d 1-d)
        arr = arr.copy()
    return arr, str(arr.dtype)


def _encode(obj):
    if _is_array(obj):
        arr, dtype = _host_array(obj)
        return {_ARR: True, "dtype": dtype, "shape": list(arr.shape),
                "data": arr.tobytes()}
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
    if isinstance(obj, memoryview):  # a bin read as a view (restore)
        return bytes(obj)
    if isinstance(obj, dict):
        if obj.get(_ARR):
            if obj["dtype"] == "bfloat16":  # 16-bit words, no ml_dtypes
                arr = np.frombuffer(obj["data"], dtype=np.int16)
                return torch.from_numpy(arr.reshape(obj["shape"]).copy()
                                        ).view(torch.bfloat16)
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
    _pack(obj, out.extend, encode=False)
    return bytes(out)


def _is_array(o) -> bool:
    return isinstance(o, (torch.Tensor, np.ndarray)) or hasattr(o, "dtype")


def _pack(obj, write, encode: bool = True) -> None:
    """Write ``obj`` through ``write``.  ``encode``: arrays and tuples are
    encoded as :func:`_encode` encodes them when they are reached, one at
    a time, and an array's bytes go out as a view, uncopied (without it,
    ``obj`` is already encoded, as :func:`packb` takes it)."""

    def put(o):
        if encode and _is_array(o):
            arr, dtype = _host_array(o)
            if dtype == "bfloat16" and arr.dtype != np.int16:
                arr = arr.view(np.int16)  # an ml_dtypes array's words
            put({_ARR: True, "dtype": dtype, "shape": list(arr.shape),
                 "data": memoryview(arr.reshape(-1)).cast("B")})
        elif encode and isinstance(o, tuple):
            put({_TUP: list(o)})
        elif o is None:
            write(b"\xc0")
        elif o is True or o is False:
            write(b"\xc3" if o else b"\xc2")
        elif isinstance(o, int):
            write(_pack_int(o))
        elif isinstance(o, float):
            write(b"\xcb")
            write(struct.pack(">d", o))
        elif isinstance(o, str):
            b = o.encode("utf-8")
            write(_head(len(b), 0xA0, 31, {1: 0xD9, 2: 0xDA, 4: 0xDB}))
            write(b)
        elif isinstance(o, (bytes, bytearray, memoryview)):
            n = o.nbytes if isinstance(o, memoryview) else len(o)
            write(_head(n, None, 0, {1: 0xC4, 2: 0xC5, 4: 0xC6}))
            write(o)
        elif isinstance(o, (list, tuple)):
            write(_head(len(o), 0x90, 15, {2: 0xDC, 4: 0xDD}))
            for v in o:
                put(v)
        elif isinstance(o, dict):
            write(_head(len(o), 0x80, 15, {2: 0xDE, 4: 0xDF}))
            for k, v in o.items():
                put(k)
                put(v)
        else:
            raise TypeError(f"cannot pack {type(o)}")

    put(obj)


def unpackb(data: bytes, *, views: bool = False):
    """Inverse of :func:`packb` (also reads float32 and raw str8/16/32
    as ``msgpack.unpackb(raw=False)`` does).  ``views``: bin payloads
    come back as memoryviews of ``data``, uncopied."""
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
                return take(n) if views else bytes(take(n))
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
        _pack(tree, f.write)
    os.replace(tmp, path)


def restore(path: str) -> Any:
    """The tree saved at ``path``; arrays are decoded from a read-only map
    of the file (unmapped once the last view of it is gone)."""
    with open(path, "rb") as f:
        if os.fstat(f.fileno()).st_size == 0:
            return _decode(unpackb(b""))
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    return _decode(unpackb(memoryview(mm), views=True))


def _leaves(tree) -> list:
    """The leaves of a tree in the reference's (JAX's) order: a dict's
    values by sorted key, a list's, tuple's or NamedTuple's in order,
    None holds none."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _unflatten(template, leaves):
    """``template``'s structure over the iterator ``leaves``."""
    if isinstance(template, dict):
        got = {k: _unflatten(template[k], leaves) for k in sorted(template)}
        return {k: got[k] for k in template}
    if isinstance(template, list):
        return [_unflatten(v, leaves) for v in template]
    if isinstance(template, tuple):
        items = [_unflatten(v, leaves) for v in template]
        return (type(template)(*items) if hasattr(template, "_fields")
                else tuple(items))
    return None if template is None else next(leaves)


def restore_like(path: str, template: Any) -> Any:
    """The tree saved at ``path`` with ``template``'s structure imposed
    (NamedTuples included), leaf for leaf in the reference's order, as
    ``repro.checkpoint.ckpt.restore_like``; raises if the leaf counts
    differ."""
    flat = _leaves(restore(path))
    n = len(_leaves(template))
    if len(flat) != n:
        raise ValueError(f"checkpoint holds {len(flat)} leaves, the "
                         f"template {n}")
    return _unflatten(template, iter(flat))


# ------------------------------------------------------ LM training state
def save_train_state(path: str, state) -> None:
    """An LM ``TrainState``: {"params": {name: tensor}, "opt_state":
    {"kind": the state's class, field: value ...}, "step": tensor}."""
    from repro_torch.training.train_step import param_tree
    opt = state.opt_state
    save(path, {"params": param_tree(state.params),
                "opt_state": {"kind": type(opt).__name__,
                              **opt._asdict()},
                "step": state.step})


def load_train_state(path: str, like):
    """The ``TrainState`` saved at ``path``, in the structure and on the
    device of ``like`` (a state of the same config and optimizer): its
    parameters are overwritten in place, the optimizer's state and the
    step are new tensors.  Raises if a name or shape differs."""
    from repro_torch.training.train_step import TrainState, param_tree
    tree = restore(path)
    params = param_tree(like.params)
    if set(tree["params"]) != set(params):
        raise ValueError("checkpoint parameters differ from the model's")
    opt = like.opt_state
    if tree["opt_state"].pop("kind") != type(opt).__name__:
        raise ValueError(f"checkpoint holds another optimizer state than "
                         f"{type(opt).__name__}")

    def to_like(saved, live):
        if isinstance(live, dict):
            if set(saved) != set(live):
                raise ValueError("checkpoint optimizer state differs")
            return {k: to_like(saved[k], v) for k, v in live.items()}
        if live is None:
            return None
        if tuple(saved.shape) != tuple(live.shape):
            raise ValueError(f"checkpoint shape {tuple(saved.shape)} != "
                             f"{tuple(live.shape)}")
        return saved.to(live.device, live.dtype)

    with torch.no_grad():
        for name, p in params.items():
            p.copy_(to_like(tree["params"][name], p))
    fields = {f: to_like(tree["opt_state"][f], getattr(opt, f))
              for f in opt._fields}
    return TrainState(like.params, type(opt)(**fields),
                      to_like(tree["step"], like.step))
