"""The orchestration kernels' plain versions against the reference.

``queue_admit_plain`` must equal the sequential ``queue_admit_lax`` (and
the Pallas kernel, in interpret mode) bit for bit for any lane order:
interleaved cells, overflow past Q, invalid lanes, C straddling the TPU
kernel's 128-wide blocks.  ``group_occupancy_plain`` must equal
``group_occupancy_lax`` exactly on integer counts.  On CPU tensors the
wrappers take these plain versions; ``test_torch_kernels_gpu.py`` holds
the CUDA kernels to them on the card.

``emulate_admit`` is the multi-block CUDA ``queue_admit``'s design in
numpy (in-tile ranks and per-tile cell counts, a walk over the tiles per
cell, then one pass per lane), held to ``queue_admit_lax`` bit for bit on
bursts of more than three tiles in every lane order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.orchestration import (group_occupancy_lax,
                                         group_occupancy_pallas,
                                         queue_admit_lax, queue_admit_pallas)
from repro_torch.kernels import orchestration as orch

from test_torch_kernels_gpu import (ADMIT_CASES, GROUP_LAYOUTS, admit_case,
                                    group_layout)


# ------------------------------------------------------------ queue_admit
def _plain(case):
    t = [torch.as_tensor(x.copy()) for x in case]
    q_ids, q_len, adm = orch.queue_admit(*t)
    return q_ids.numpy(), q_len.numpy(), adm.numpy()


def _ref(case, fn=queue_admit_lax):
    q_ids, q_head, q_len, rid, cell, valid = case
    valid_in = valid & (cell >= 0) & (cell < q_ids.shape[0])
    cell_in = np.clip(cell, 0, q_ids.shape[0] - 1)
    out = fn(jnp.asarray(q_ids), jnp.asarray(q_head), jnp.asarray(q_len),
             jnp.asarray(rid), jnp.asarray(cell_in), jnp.asarray(valid_in))
    return tuple(np.asarray(x) for x in out)


@pytest.mark.parametrize("seed,c,q,a,order,fill", ADMIT_CASES)
def test_queue_admit_plain_matches_sequential(seed, c, q, a, order, fill):
    case = admit_case(seed, c, q, a, order, fill)
    for got, want, name in zip(_plain(case), _ref(case),
                               ("q_ids", "q_len", "admitted")):
        np.testing.assert_array_equal(got, want, name)


@pytest.mark.parametrize("seed", [0, 1])
def test_queue_admit_plain_matches_pallas_interpret(seed):
    case = admit_case(seed, 129, 4, 64, "random", "near_full")
    want = _ref(case, lambda *a: queue_admit_pallas(*a, interpret=True))
    for got, w in zip(_plain(case), want):
        np.testing.assert_array_equal(got, w)


def test_queue_admit_updates_rings_in_place():
    case = admit_case(3, 10, 4, 30)
    t = [torch.as_tensor(x.copy()) for x in case]
    q_ids, q_len, _ = orch.queue_admit(*t)
    assert q_ids is t[0] and q_len is t[2]


def test_queue_admit_overflow_keeps_fifo_order():
    q_ids = torch.full((2, 3), -1, dtype=torch.int32)
    q_head = torch.tensor([2, 0], dtype=torch.int32)
    q_len = torch.tensor([1, 0], dtype=torch.int32)
    rid = torch.arange(7, dtype=torch.int32)
    cell = torch.tensor([0, 1, 0, 0, 1, 0, 0], dtype=torch.int32)
    valid = torch.tensor([True, True, False, True, True, True, True])
    q_ids, q_len, adm = orch.queue_admit(q_ids, q_head, q_len, rid, cell,
                                         valid)
    # cell 0 had one slot taken at ring position 2: lanes 0 and 3 fill
    # positions 0 and 1 (lane 2 is invalid), lanes 5 and 6 overflow
    assert adm.tolist() == [True, True, False, True, True, False, False]
    assert q_ids.tolist() == [[0, 3, -1], [1, 4, -1]]
    assert q_len.tolist() == [3, 2]


def test_queue_admit_checks_its_inputs():
    case = [torch.as_tensor(x.copy()) for x in admit_case(0, 4, 3, 5)]
    with pytest.raises(TypeError, match="rid"):
        orch.queue_admit(*case[:3], case[3].long(), *case[4:])
    with pytest.raises(ValueError, match="contiguous"):
        orch.queue_admit(case[0].t().contiguous().t(), *case[1:])
    with pytest.raises(ValueError, match="shape"):
        orch.queue_admit(case[0], case[1][:2], *case[2:])


def emulate_admit(q_ids, q_head, q_len, rid, cell, valid,
                  tile=orch.ADMIT_TILE):
    """``csrc/orchestration.cu``'s three queue_admit launches in numpy."""
    q_ids, q_len = q_ids.copy(), q_len.copy()
    c_n, q = q_ids.shape
    a = rid.shape[0]
    n_tiles = -(-a // tile)
    cl = np.clip(cell, 0, c_n - 1)
    # 1. in-tile rank: earlier valid lanes of the cell in the tile; each
    #    tile's count per cell (zero where the cell is absent)
    count = np.zeros((n_tiles, c_n), np.int64)
    rank = np.zeros(a, np.int64)
    for t in range(n_tiles):
        seen = {}
        for i in range(t * tile, min(a, (t + 1) * tile)):
            if valid[i]:
                rank[i] = seen.get(cl[i], 0)
                seen[cl[i]] = rank[i] + 1
                count[t, cl[i]] = max(count[t, cl[i]], rank[i] + 1)
    # 2. per cell: each present tile's count becomes the queue position
    #    before that tile; q_len takes the admitted lanes
    for c in range(c_n):
        len0, run = int(q_len[c]), 0
        for t in range(n_tiles):
            if count[t, c]:
                count[t, c], run = len0 + run, run + count[t, c]
        if run:
            q_len[c] = len0 + max(0, min(run, q - len0))
    # 3. per lane: position, admission, ring slot
    admitted = np.zeros(a, bool)
    for i in np.flatnonzero(valid):
        pos = count[i // tile, cl[i]] + rank[i]
        if pos < q:
            admitted[i] = True
            q_ids[cl[i], (q_head[cl[i]] + pos) % q] = rid[i]
    return q_ids, q_len, admitted


@pytest.mark.parametrize("order", ["one_cell", "interleaved", "reversed",
                                   "random"])
@pytest.mark.parametrize("fill", ["random", "near_full"])
@pytest.mark.parametrize("c,a", [(300, 3 * orch.ADMIT_TILE + 77),
                                 (5, 4 * orch.ADMIT_TILE)])
def test_queue_admit_tiles_match_sequential(c, a, order, fill):
    case = admit_case(c + a, c, 8, a, order, fill)
    got = emulate_admit(*case)
    for g, w, name in zip(got, _ref(case), ("q_ids", "q_len", "admitted")):
        np.testing.assert_array_equal(g, w, name)
    assert (case[5] & ~got[2]).any()  # the burst overflows some ring


# ------------------------------------------------------- group_occupancy
def _index(groups):
    return orch.group_index(torch.as_tensor(groups))


@pytest.mark.parametrize("c,n_groups,seed", [(1, 1, 0), (7, 3, 1),
                                             (127, 12, 2), (128, 5, 3),
                                             (129, 129, 4), (300, 1, 5),
                                             (1000, 250, 6)])
def test_group_occupancy_plain_matches_lax(c, n_groups, seed):
    rng = np.random.default_rng(seed)
    own = rng.integers(0, 9, c).astype(np.int32)
    groups = rng.integers(0, n_groups, c).astype(np.int32)
    want = np.asarray(group_occupancy_lax(jnp.asarray(own),
                                          jnp.asarray(groups)))
    index = _index(groups)
    got = orch.group_occupancy(torch.as_tensor(own), index)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    got_f = orch.group_occupancy(torch.as_tensor(own, dtype=torch.float32),
                                 index)
    np.testing.assert_array_equal(got_f.numpy(), want.astype(np.float32))


def test_group_occupancy_plain_matches_pallas_interpret():
    rng = np.random.default_rng(9)
    own = rng.integers(0, 9, 200).astype(np.int32)
    groups = (np.arange(200) // 4).astype(np.int32)
    want = np.asarray(group_occupancy_pallas(jnp.asarray(own),
                                             jnp.asarray(groups),
                                             interpret=True))
    got = orch.group_occupancy(torch.as_tensor(own), _index(groups))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("c", [1, 2, 7, 128, 129, 300])
@pytest.mark.parametrize("layout", GROUP_LAYOUTS)
def test_group_index_layouts_match_reference(layout, c):
    """The indexed plain route against ``group_occupancy_lax`` and the
    Pallas kernel in interpret mode, int32 bit for bit."""
    groups = group_layout(layout, c, seed=c)
    own = np.random.default_rng(c).integers(0, 9, c).astype(np.int32)
    got = orch.group_occupancy(torch.as_tensor(own), _index(groups)).numpy()
    j_own, j_groups = jnp.asarray(own), jnp.asarray(groups)
    np.testing.assert_array_equal(
        got, np.asarray(group_occupancy_lax(j_own, j_groups)))
    np.testing.assert_array_equal(
        got, np.asarray(group_occupancy_pallas(j_own, j_groups,
                                               interpret=True)))


@pytest.mark.parametrize("c", [1, 7, 300, 2 * orch.GROUP_TILE + 500])
@pytest.mark.parametrize("layout", GROUP_LAYOUTS)
def test_group_index_fields(layout, c):
    groups = group_layout(layout, c, seed=c)
    index = _index(groups)
    members = index.members.numpy()
    # a stable sort of the cells by group
    np.testing.assert_array_equal(members, np.argsort(groups, kind="stable"))
    ids, counts = np.unique(groups, return_counts=True)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    np.testing.assert_array_equal(index.offsets.numpy(), offsets)
    np.testing.assert_array_equal(index.size.numpy(),
                                  np.bincount(groups, minlength=c)[groups])
    assert (index.n_groups, index.max_size) == (ids.size, counts.max())
    assert index.chunked == (counts.max() > orch.GROUP_TILE)
    # each tile's slots: a run of members in order, then padding; each
    # run of one group in a tile numbered from 0 with its length
    tile = orch.GROUP_TILE
    cells = index.slot_cell.numpy().reshape(-1, tile)
    segs = index.slot_seg.numpy().reshape(-1, tile)
    filled = (cells >= 0).sum(1)
    assert (filled > 0).all() and filled.sum() == c
    for b, n in enumerate(filled):
        assert (cells[b, n:] == -1).all() and (segs[b, n:] == 0).all()
    np.testing.assert_array_equal(cells[cells >= 0], members)
    starts = np.concatenate([[0], np.cumsum(filled)])
    for b, (first, m) in enumerate(index.tile_chunk.tolist()):
        rel, length = segs[b, :filled[b]] >> 16, segs[b, :filled[b]] & 0xffff
        g = groups[cells[b, :filled[b]]]
        if first < 0:
            assert starts[b] in offsets and starts[b + 1] in offsets
            for gid in np.unique(g):
                run = g == gid
                np.testing.assert_array_equal(rel[run],
                                              np.arange(run.sum()))
                assert (length[run] == run.sum()).all()
        else:
            assert first <= b < first + m and len(set(g)) == 1
            assert starts[b] == starts[first] + (b - first) * tile
            np.testing.assert_array_equal(rel, np.arange(filled[b]))
            assert (length == filled[b]).all()


def test_group_index_rejects_bad_ids():
    with pytest.raises(ValueError, match="group ids"):
        orch.group_index(torch.tensor([0, 3, 1], dtype=torch.int32))
    with pytest.raises(ValueError, match="group ids"):
        orch.group_index(torch.tensor([0, -1], dtype=torch.int32))
    with pytest.raises(TypeError, match="groups"):
        orch.group_index(torch.zeros(4, dtype=torch.int64))


def test_group_occupancy_rejects_other_dtypes():
    with pytest.raises(TypeError, match="int32 or float32"):
        orch.group_occupancy(torch.zeros(4, dtype=torch.int64),
                             _index(np.zeros(4, np.int32)))


def test_cpu_route_launches_no_kernel():
    orch.reset_launch_counts()
    orch.group_occupancy(torch.ones(8, dtype=torch.int32),
                         _index(np.zeros(8, np.int32)))
    assert orch.LAUNCHES == {"queue_admit": 0, "group_occupancy": 0}


def _group_sum_bound(own, groups):
    """A rigorous bound on two float32 orders' distance for each group's
    sum: (group size + 16) units of 2^-24 times the sum of |own|."""
    g = torch.as_tensor(groups).long()
    abs_sum = torch.zeros(len(groups), dtype=torch.float64).index_add_(
        0, g, torch.as_tensor(own).double().abs())[g]
    size = torch.bincount(g, minlength=len(groups))[g]
    return ((size + 16) * 2.0 ** -24 * abs_sum).numpy()


@pytest.mark.parametrize("c", [5, 300, 2 * orch.GROUP_TILE + 500])
@pytest.mark.parametrize("layout", GROUP_LAYOUTS)
def test_group_occupancy_tree_matches_plain(layout, c):
    """The kernel's summation order in plain PyTorch: int32 bit-equal to
    the plain version, float32 within rounding of it."""
    groups = group_layout(layout, c, seed=c)
    index = _index(groups)
    rng = np.random.default_rng(c)
    own = torch.as_tensor(rng.integers(-9, 9, c).astype(np.int32))
    assert torch.equal(orch.group_occupancy_tree(own, index),
                       orch.group_occupancy_plain(own, index.groups))
    own_f = torch.as_tensor(rng.standard_normal(c).astype(np.float32))
    tree = orch.group_occupancy_tree(own_f, index).double().numpy()
    plain = orch.group_occupancy_plain(own_f, index.groups).double().numpy()
    assert (np.abs(tree - plain) <= _group_sum_bound(own_f, groups)).all()


def _tree(v):
    d = 1
    while d < len(v):
        for t in range(0, len(v) - d, 2 * d):
            v[t] = v[t] + v[t + d]
        d *= 2
    return v[0]


def emulate_group_kernel(own, index):
    """``csrc/orchestration.cu``'s group_occupancy launches in numpy over
    the index's slots: per tile, each run's tree in place (no two
    threads of a level touch one slot, so a level is one vector step),
    then the members' totals or the tile sum of a group that spans tiles;
    then the combining launch's tree over those tile sums, in blocks of
    ``index.tile``."""
    own = np.asarray(own)
    tile = index.tile
    cells = index.slot_cell.numpy()
    segs = index.slot_seg.numpy()
    chunk = index.tile_chunk.tolist()
    span = min(index.max_size, tile)
    out = np.zeros_like(own)
    partial = np.zeros(len(chunk), own.dtype)
    for b, (first_tile, _) in enumerate(chunk):
        cell = cells[b * tile:(b + 1) * tile]
        seg = segs[b * tile:(b + 1) * tile]
        s_val = np.where(cell >= 0, own[np.maximum(cell, 0)], 0).astype(
            own.dtype)
        rel, length = seg >> 16, seg & 0xffff
        d = 1
        while d < span:
            at = np.flatnonzero((rel & (2 * d - 1) == 0) & (rel + d < length))
            s_val[at] = s_val[at] + s_val[at + d]
            d *= 2
        if first_tile >= 0:
            partial[b] = s_val[0]
        else:
            live = cell >= 0
            out[cell[live]] = s_val[np.flatnonzero(live) - rel[live]]
    for b, (first_tile, m) in enumerate(chunk):
        if first_tile >= 0:
            blocks = [_tree(partial[first_tile + k:first_tile
                                    + min(m, k + tile)].copy())
                      for k in range(0, m, tile)]
            cell = cells[b * tile:(b + 1) * tile]
            out[cell[cell >= 0]] = _tree(np.array(blocks, own.dtype))
    return out


@pytest.mark.parametrize("tile,c", [(orch.GROUP_TILE, 300),
                                    (orch.GROUP_TILE, 2 * orch.GROUP_TILE
                                     + 500),
                                    (8, 150), (4, 100)])
@pytest.mark.parametrize("layout", GROUP_LAYOUTS + ("half_one_group",))
def test_group_kernel_design_matches_tree(layout, tile, c):
    """The kernel's launches, emulated, give the tree order's float32 bits
    whatever the tiles (small tiles make groups span many tiles, and at
    tile 4 the combining launch sums its tile sums in blocks) and the
    plain version's int32 sums."""
    groups = (np.where(np.arange(c) < c // 2, 0, np.arange(c))
              .astype(np.int32) if layout == "half_one_group"
              else group_layout(layout, c, seed=c))
    index = orch.group_index(torch.as_tensor(groups), tile)
    rng = np.random.default_rng(c + tile)
    own_f = torch.as_tensor(rng.standard_normal(c).astype(np.float32))
    np.testing.assert_array_equal(
        emulate_group_kernel(own_f.numpy(), index).view(np.uint32),
        orch.group_occupancy_tree(own_f, index).numpy().view(np.uint32))
    own = torch.as_tensor(rng.integers(0, 9, c).astype(np.int32))
    np.testing.assert_array_equal(
        emulate_group_kernel(own.numpy(), index),
        orch.group_occupancy_plain(own, index.groups).numpy())
