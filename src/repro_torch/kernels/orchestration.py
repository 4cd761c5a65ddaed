"""The serving tick's two orchestration kernels, and their plain versions.

``queue_admit``
    Admits one tick's arrival burst into the per-cell FIFO rings: a valid
    lane's rank is the count of earlier valid lanes of its cell; it is
    admitted iff ``q_len0[c] + rank < Q``, at ring slot ``(head + q_len0
    + rank) % Q`` — exactly the sequential per-lane loop.
``group_occupancy``
    ``out[i] = sum_j own[j] * [groups[j] == groups[i]]``, each cell's
    edge-group total.

Each wrapper checks its tensors and picks its route from their device
alone: on CUDA tensors it launches the hand-written kernel of
``csrc/orchestration.cu`` (and raises if the launch fails); on CPU tensors
it runs the plain PyTorch version beside it.  The plain versions are the
CPU path and the reference ``chip_smoke.py`` holds the kernels against;
nothing on the CUDA path calls them.  Each kernel launch adds one to its
count in :data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = {"queue_admit": 0, "group_occupancy": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "queue_admit": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "group_occupancy_i32": [_P, _P, _P, _P, _I, _I, _P],
    "group_occupancy_f32": [_P, _P, _P, _P, _I, _I, _P],
}
_GROUP_FN = {torch.int32: "group_occupancy_i32",
             torch.float32: "group_occupancy_f32"}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    return _build.load("orchestration", _SIGNATURES)


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _route(device: torch.device) -> str:
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no route for tensors on {device}")
    return device.type


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{err}")


# -------------------------------------------------------------- queue_admit
def queue_admit(q_ids, q_head, q_len, rid, cell, valid):
    """Admit one tick's burst into the per-cell rings.

    q_ids: (C, Q) int32 ring slots; q_head, q_len: (C,) int32; rid, cell:
    (A,) int32 arrival lanes; valid: (A,) bool (invalid lanes are
    padding).  A valid lane must name a cell in [0, C); both routes clamp
    the id, so a bad one can never write outside the rings.

    ``q_ids`` and ``q_len`` are updated **in place** (the reference
    returned fresh copies of both) and returned with ``admitted`` (A,)
    bool: ``(q_ids, q_len, admitted)``."""
    c, q = q_ids.shape
    a = rid.shape[0]
    dev = q_ids.device
    if c == 0 or q == 0:
        raise ValueError(f"queue_admit needs C, Q >= 1, got {(c, q)}")
    _check("q_ids", q_ids, torch.int32, (c, q), dev)
    _check("q_head", q_head, torch.int32, (c,), dev)
    _check("q_len", q_len, torch.int32, (c,), dev)
    _check("rid", rid, torch.int32, (a,), dev)
    _check("cell", cell, torch.int32, (a,), dev)
    _check("valid", valid, torch.bool, (a,), dev)
    if _route(dev) == "cpu":
        return queue_admit_plain(q_ids, q_head, q_len, rid, cell, valid)
    admitted = torch.empty((a,), dtype=torch.bool, device=dev)
    seen = torch.empty((c,), dtype=torch.int32, device=dev)
    err = _lib().queue_admit(
        q_ids.data_ptr(), q_head.data_ptr(), q_len.data_ptr(),
        rid.data_ptr(), cell.data_ptr(), valid.data_ptr(),
        admitted.data_ptr(), seen.data_ptr(), c, q, a, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "queue_admit")
    LAUNCHES["queue_admit"] += 1
    return q_ids, q_len, admitted


def queue_admit_plain(q_ids, q_head, q_len, rid, cell, valid):
    """Plain version of :func:`queue_admit` (same in-place contract).

    The FIFO rank comes from a stable sort of the lanes by cell (invalid
    lanes last): a lane's rank is its distance from the first lane of its
    cell in sorted order, which is its count of earlier same-cell valid
    lanes."""
    c, q = q_ids.shape
    a = rid.shape[0]
    cl = cell.long().clamp(0, c - 1)
    key = torch.where(valid, cl, torch.full_like(cl, c))
    sorted_key, order = torch.sort(key, stable=True)
    first = torch.searchsorted(sorted_key, sorted_key)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(a, device=cl.device) - first
    len0 = q_len.long()[cl]
    ok = valid & (len0 + rank < q)
    slot = (q_head.long()[cl] + len0 + rank) % q
    q_ids[cl[ok], slot[ok]] = rid[ok]
    q_len += torch.bincount(cl[ok], minlength=c).to(torch.int32)
    return q_ids, q_len, ok


# ---------------------------------------------------------- group_occupancy
def group_occupancy(own, groups):
    """(C,) group totals ``out[i] = sum_j own[j] * [groups[j] ==
    groups[i]]`` for int32 (exact) or float32 ``own`` and (C,) int32
    ``groups`` in [0, C).  Returns a new tensor of ``own``'s dtype."""
    n = own.shape[0]
    dev = own.device
    if own.dtype not in _GROUP_FN:
        raise TypeError(f"own must be int32 or float32, got {own.dtype}")
    _check("own", own, own.dtype, (n,), dev)
    _check("groups", groups, torch.int32, (n,), dev)
    if _route(dev) == "cpu":
        return group_occupancy_plain(own, groups)
    totals = torch.empty_like(own)
    out = torch.empty_like(own)
    err = getattr(_lib(), _GROUP_FN[own.dtype])(
        own.data_ptr(), groups.data_ptr(), totals.data_ptr(),
        out.data_ptr(), n, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "group_occupancy")
    LAUNCHES["group_occupancy"] += 1
    return out


def group_occupancy_plain(own, groups):
    """Plain version of :func:`group_occupancy`: ``index_add_`` into
    zeroed totals, then a gather."""
    g = groups.long()
    totals = torch.zeros_like(own).index_add_(0, g, own)
    return totals[g]
