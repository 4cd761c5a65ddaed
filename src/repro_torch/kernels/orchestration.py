"""The serving tick's two orchestration kernels, and their plain versions.

``queue_admit``
    Admits one tick's arrival burst into the per-cell FIFO rings: a valid
    lane's rank is the count of earlier valid lanes of its cell; it is
    admitted iff ``q_len0[c] + rank < Q``, at ring slot ``(head + q_len0
    + rank) % Q`` — exactly the sequential per-lane loop.
``group_occupancy``
    ``out[i] = sum_j own[j] * [groups[j] == groups[i]]``, each cell's
    edge-group total, over a :class:`GroupIndex` that :func:`group_index`
    builds once per deployment: the cells sorted by group and cut into
    tiles on group boundaries, each tile one CTA's slots.
    :func:`group_occupancy_tree` is the kernel's fixed summation order in
    plain PyTorch, the yardstick for its float32 bits.

Each wrapper checks its tensors and picks its route from their device
alone: on CUDA tensors it launches the hand-written kernel of
``csrc/orchestration.cu`` (and raises if the launch fails); on CPU tensors
it runs the plain PyTorch version beside it.  The plain versions are the
CPU path and the reference ``chip_smoke.py`` holds the kernels against;
nothing on the CUDA path calls them.  Each wrapper call that launches
adds one to its count in :data:`LAUNCHES` (a ``queue_admit`` call is a
memset and three kernels; a ``group_occupancy`` call is one kernel, and
a second, combining one when the index has a group larger than a tile).
"""
from __future__ import annotations

import bisect
import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

LAUNCHES = {"queue_admit": 0, "group_occupancy": 0}
# lanes per CTA of the queue_admit kernels (kAdmitTile in the source)
ADMIT_TILE = 1024

# slots per CTA of the group_occupancy kernel (kGroupTile in the source),
# and the most cells a group index takes: its slots stay int32-indexable,
# and the combining launch sums at most GROUP_TILE blocks of GROUP_TILE
# tile sums
GROUP_TILE = 1024
MAX_CELLS = 1 << 29

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "queue_admit": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "group_occupancy_i32": [_P] * 6 + [_I, _I, _I, _I, _P],
    "group_occupancy_f32": [_P] * 6 + [_I, _I, _I, _I, _P],
    "empty_launch": [_I, _P],
}
_GROUP_FN = {torch.int32: "group_occupancy_i32",
             torch.float32: "group_occupancy_f32"}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    return _build.load("orchestration", _SIGNATURES)


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
    _build.check("q_ids", q_ids, torch.int32, (c, q), dev)
    _build.check("q_head", q_head, torch.int32, (c,), dev)
    _build.check("q_len", q_len, torch.int32, (c,), dev)
    _build.check("rid", rid, torch.int32, (a,), dev)
    _build.check("cell", cell, torch.int32, (a,), dev)
    _build.check("valid", valid, torch.bool, (a,), dev)
    if _build.route(dev) == "cpu":
        return queue_admit_plain(q_ids, q_head, q_len, rid, cell, valid)
    admitted = torch.empty((a,), dtype=torch.bool, device=dev)
    # each tile's per-cell counts (zeroed by the kernel's stream) and the
    # lanes' in-tile ranks
    scratch = torch.empty((-(-a // ADMIT_TILE) * c + a,), dtype=torch.int32,
                          device=dev)
    err = _lib().queue_admit(
        q_ids.data_ptr(), q_head.data_ptr(), q_len.data_ptr(),
        rid.data_ptr(), cell.data_ptr(), valid.data_ptr(),
        admitted.data_ptr(), scratch.data_ptr(), c, q, a, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on(err, "queue_admit")
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
class GroupIndex(NamedTuple):
    """The edge groups of one deployment, laid out once for the
    ``group_occupancy`` kernel (:func:`group_index` builds it).

    Tensors on the groups' device.  ``members`` lists the cells stably
    sorted by group; ``offsets`` holds each non-empty group's start in
    ``members`` and, last, C; ``size`` is each cell's group size.  The
    kernel's tiles cut ``members`` on group boundaries into runs of at
    most ``tile`` entries (a group larger than a tile gets whole tiles of
    its own from its start); tile b's entries sit at slots ``b * tile +
    j``, the rest of its slots are padding.  ``slot_cell`` holds each
    slot's cell (-1 for padding) and ``slot_seg`` its place r in its
    group's run within the tile and that run's length n, as ``r << 16 |
    n`` (0 for padding); ``tile_chunk[b]`` is (its group's first tile,
    the group's tile count) for a tile of a group larger than a tile,
    else (-1, 0).  Python values: the group count, the largest group's
    size, the tile, and whether a group spans tiles (so a call adds the
    combining launch).  The index of one rank's block of a fleet
    (``FleetScenario.shard``) also carries where its groups sit in the
    fleet (``block``, a ``repro_torch.fleet.workload.CellBlock``)."""
    groups: torch.Tensor      # (C,) int32 group ids in [0, C)
    members: torch.Tensor     # (C,) int32
    offsets: torch.Tensor     # (G+1,) int32
    size: torch.Tensor        # (C,) int32
    slot_cell: torch.Tensor   # (tiles * tile,) int32
    slot_seg: torch.Tensor    # (tiles * tile,) int32
    tile_chunk: torch.Tensor  # (tiles, 2) int32
    n_groups: int
    max_size: int
    tile: int
    chunked: bool
    block: object = None

    @property
    def n_tiles(self) -> int:
        return self.tile_chunk.shape[0]

    def to(self, device) -> "GroupIndex":
        return GroupIndex(*(v.to(device) if hasattr(v, "to") else v
                            for v in self))


def _tile_plan(offsets: list, n: int, tile: int) -> tuple[list, list]:
    """Tiles of ``members`` from the group ``offsets``: each takes whole
    groups, as many as fit in ``tile`` entries; a group larger than that
    gets tiles of its own, ``tile`` entries each from its start (the last
    one shorter).  Returns the tiles' starts (and n) and each tile's
    (first tile, tile count) of the group it cuts, or (-1, 0)."""
    starts, chunk, s = [], [], 0
    while s < n:
        end = offsets[bisect.bisect_right(offsets, s + tile) - 1]
        if end > s:
            starts.append(s)
            chunk.append((-1, 0))
            s = end
            continue
        end = offsets[bisect.bisect_right(offsets, s)]
        first, m = len(starts), -(-(end - s) // tile)
        starts += range(s, end, tile)
        chunk += [(first, m)] * m
        s = end
    return starts + [n], chunk


def group_index(groups: torch.Tensor, tile: int = GROUP_TILE) -> GroupIndex:
    """Index (C,) int32 group ids in [0, C) for :func:`group_occupancy`.
    Plain PyTorch on the groups' device (a sort, and the group offsets
    copied to the host once to cut the tiles); build it once per
    deployment.  The CUDA kernel takes ``tile = GROUP_TILE``; the tests
    emulate its design at smaller tiles."""
    n = groups.shape[0]
    dev = groups.device
    _build.check("groups", groups, torch.int32, (n,), dev)
    if not 0 < n <= MAX_CELLS:
        raise ValueError(f"group_index needs 1 to {MAX_CELLS} cells, got {n}")
    if not 0 < tile < 1 << 16:  # a slot packs its run's place and length
        raise ValueError(f"tile must lie in [1, 65535], got {tile}")
    if int(groups.min()) < 0 or int(groups.max()) >= n:
        raise ValueError(f"group ids must lie in [0, {n})")
    sorted_groups, members = torch.sort(groups, stable=True)
    counts = torch.bincount(sorted_groups, minlength=n)
    counts = counts[counts > 0]
    offsets = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    starts, chunk = _tile_plan(offsets.tolist(), n, tile)
    # each sorted entry's tile, slot and run [lo, hi) in the tile: its
    # group, cut to the tile where the group spans tiles
    tile_lo = torch.tensor(starts, device=dev)
    pos = torch.arange(n, device=dev)
    b = torch.searchsorted(tile_lo[:-1], pos, right=True) - 1
    rank = torch.repeat_interleave(torch.arange(len(counts), device=dev),
                                   counts)
    lo = torch.maximum(offsets[rank], tile_lo[b])
    hi = torch.minimum(offsets[rank + 1], tile_lo[b + 1])
    slot = b * tile + pos - tile_lo[b]
    i32 = dict(dtype=torch.int32, device=dev)
    slot_cell = torch.full((len(chunk) * tile,), -1, **i32)
    slot_cell[slot] = members.to(torch.int32)
    slot_seg = torch.zeros((len(chunk) * tile,), **i32)
    slot_seg[slot] = ((pos - lo) << 16 | (hi - lo)).to(torch.int32)
    return GroupIndex(
        groups=groups, members=members.to(torch.int32),
        offsets=offsets.to(torch.int32),
        size=torch.bincount(groups, minlength=n)[groups.long()].to(
            torch.int32),
        slot_cell=slot_cell, slot_seg=slot_seg,
        tile_chunk=torch.tensor(chunk, **i32).reshape(-1, 2),
        n_groups=len(counts), max_size=int(counts.max()), tile=tile,
        chunked=any(m for _, m in chunk))


def group_occupancy(own, index: GroupIndex):
    """(C,) group totals ``out[i] = sum_j own[j] * [groups[j] ==
    groups[i]]`` for int32 (exact) or float32 ``own`` over the groups of
    ``index``.  Returns a new tensor of ``own``'s dtype.  On CUDA each
    group is summed in the fixed order of :func:`group_occupancy_tree`,
    so float32 results repeat bit for bit."""
    n = own.shape[0]
    dev = own.device
    if own.dtype not in _GROUP_FN:
        raise TypeError(f"own must be int32 or float32, got {own.dtype}")
    _build.check("own", own, own.dtype, (n,), dev)
    _build.check("index.groups", index.groups, torch.int32, (n,), dev)
    if _build.route(dev) == "cpu":
        return group_occupancy_plain(own, index.groups)
    if index.tile != GROUP_TILE:
        raise ValueError(f"the kernel takes tiles of {GROUP_TILE} entries, "
                         f"the index has {index.tile}")
    slots = index.n_tiles * GROUP_TILE
    _build.check("index.slot_cell", index.slot_cell, torch.int32, (slots,),
                 dev)
    _build.check("index.slot_seg", index.slot_seg, torch.int32, (slots,),
                 dev)
    _build.check("index.tile_chunk", index.tile_chunk, torch.int32,
                 (index.n_tiles, 2), dev)
    out = torch.empty_like(own)
    # the tile sums of groups that span tiles, each written before read
    partial = torch.empty((index.n_tiles if index.chunked else 0,),
                          dtype=own.dtype, device=dev)
    err = getattr(_lib(), _GROUP_FN[own.dtype])(
        own.data_ptr(), index.slot_cell.data_ptr(),
        index.slot_seg.data_ptr(), index.tile_chunk.data_ptr(),
        out.data_ptr(), partial.data_ptr(), index.n_tiles,
        min(index.max_size, GROUP_TILE), int(index.chunked), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on(err, "group_occupancy")
    LAUNCHES["group_occupancy"] += 1
    return out


def group_occupancy_plain(own, groups):
    """Plain version of :func:`group_occupancy`: ``index_add_`` into
    zeroed totals, then a gather."""
    g = groups.long()
    totals = torch.zeros_like(own).index_add_(0, g, own)
    return totals[g]


def group_occupancy_tree(own, index: GroupIndex):
    """:func:`group_occupancy` summed in the CUDA kernel's order, in plain
    PyTorch: each group's members in ``members`` order, added pairwise in
    a tree whose stride doubles (at stride d, member r adds member r + d
    when r is a multiple of 2d).  A group's tree does not depend on how
    the tiles cut it, so this is the kernel's float32 result bit for
    bit."""
    n = own.shape[0]
    v = own[index.members.long()].clone()
    pos = torch.arange(n, device=own.device)
    first = index.offsets[:-1].long().repeat_interleave(
        index.offsets.diff().long())
    rel = pos - first
    length = index.size[index.members.long()]
    d = 1
    while d < index.max_size:
        at = pos[(rel % (2 * d) == 0) & (rel + d < length)]
        v[at] = v[at] + v[at + d]
        d *= 2
    out = torch.empty_like(own)
    out[index.members.long()] = v[first]
    return out


def empty_launch(device: torch.device) -> None:
    """Launch an empty kernel on ``device`` through the same path as the
    others: the floor under the device time of any one-launch call."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    err = _lib().empty_launch(index,
                              torch.cuda.current_stream(index).cuda_stream)
    _build.raise_on(err, "empty_launch")
