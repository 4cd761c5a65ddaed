"""The orchestration kernels' plain versions against the reference.

``queue_admit_plain`` must equal the sequential ``queue_admit_lax`` (and
the Pallas kernel, in interpret mode) bit for bit for any lane order:
interleaved cells, overflow past Q, invalid lanes, C straddling the TPU
kernel's 128-wide blocks.  ``group_occupancy_plain`` must equal
``group_occupancy_lax`` exactly on integer counts.  On CPU tensors the
wrappers take these plain versions; ``test_torch_kernels_gpu.py`` holds
the CUDA kernels to them on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.orchestration import (group_occupancy_lax,
                                         group_occupancy_pallas,
                                         queue_admit_lax, queue_admit_pallas)
from repro_torch.kernels import orchestration as orch

from test_torch_kernels_gpu import ADMIT_CASES, admit_case


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


# ------------------------------------------------------- group_occupancy
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
    got = orch.group_occupancy(torch.as_tensor(own), torch.as_tensor(groups))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    got_f = orch.group_occupancy(torch.as_tensor(own, dtype=torch.float32),
                                 torch.as_tensor(groups))
    np.testing.assert_array_equal(got_f.numpy(), want.astype(np.float32))


def test_group_occupancy_plain_matches_pallas_interpret():
    rng = np.random.default_rng(9)
    own = rng.integers(0, 9, 200).astype(np.int32)
    groups = (np.arange(200) // 4).astype(np.int32)
    want = np.asarray(group_occupancy_pallas(jnp.asarray(own),
                                             jnp.asarray(groups),
                                             interpret=True))
    got = orch.group_occupancy(torch.as_tensor(own), torch.as_tensor(groups))
    np.testing.assert_array_equal(got.numpy(), want)


def test_group_occupancy_rejects_other_dtypes():
    with pytest.raises(TypeError, match="int32 or float32"):
        orch.group_occupancy(torch.zeros(4, dtype=torch.int64),
                             torch.zeros(4, dtype=torch.int32))


def test_cpu_route_launches_no_kernel():
    orch.reset_launch_counts()
    orch.group_occupancy(torch.ones(8, dtype=torch.int32),
                         torch.zeros(8, dtype=torch.int32))
    assert orch.LAUNCHES == {"queue_admit": 0, "group_occupancy": 0}
