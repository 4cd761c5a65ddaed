"""The CUDA kernels against their plain versions, on the card.

Imports only torch, numpy and the port, so it runs on a machine with a
card and no JAX (the tests skip without a card):

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py

``admit_case`` and ``ADMIT_CASES`` are also the lane orders
``test_torch_orchestration.py`` holds the plain versions to the
reference with: interleaved cells, one cell's burst past Q, reversed
order, invalid lanes with junk cell ids, C straddling 128.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import orchestration as orch


def admit_case(seed, c, q, a, order="random", fill="random"):
    rng = np.random.default_rng(seed)
    q_ids = rng.integers(-1, 1000, (c, q)).astype(np.int32)
    q_head = rng.integers(0, q, c).astype(np.int32)
    if fill == "near_full":
        q_len = rng.integers(max(0, q - 3), q + 1, c).astype(np.int32)
    else:
        q_len = rng.integers(0, q + 1, c).astype(np.int32)
    cell = rng.integers(0, c, a).astype(np.int32)
    if order == "one_cell":
        cell[:] = rng.integers(0, c)
    elif order == "interleaved":
        cell = (np.arange(a) % min(c, 3)).astype(np.int32)
    elif order == "reversed":
        cell = np.sort(cell)[::-1].copy()
    rid = (10_000 + rng.permutation(a)).astype(np.int32)
    valid = rng.random(a) < 0.8
    # invalid lanes carry junk cell ids, as padded engine lanes do
    cell = np.where(valid, cell, rng.integers(-5, c + 5, a)).astype(np.int32)
    return q_ids, q_head, q_len, rid, cell, valid


ADMIT_CASES = [(s, c, q, a, order, fill)
               for s, (c, q, a, order, fill) in enumerate([
                   (1, 4, 9, "one_cell", "random"),
                   (5, 3, 40, "interleaved", "random"),
                   (127, 8, 300, "random", "random"),
                   (128, 8, 300, "reversed", "near_full"),
                   (129, 2, 257, "random", "near_full"),
                   (200, 64, 1500, "random", "random"),
                   (17, 5, 2100, "one_cell", "random"),
                   (40, 6, 700, "interleaved", "near_full"),
               ])]


def _plain(case):
    t = [torch.as_tensor(x.copy()) for x in case]
    return orch.queue_admit_plain(*t)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("seed,c,q,a,order,fill", ADMIT_CASES)
def test_queue_admit_kernel_matches_plain(cuda, seed, c, q, a, order, fill):
    case = admit_case(seed, c, q, a, order, fill)
    want = [x.numpy() for x in _plain(case)]
    t = [torch.as_tensor(x.copy(), device=cuda) for x in case]
    before = orch.LAUNCHES["queue_admit"]
    got = orch.queue_admit(*t)
    torch.cuda.synchronize()
    assert orch.LAUNCHES["queue_admit"] == before + 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w)


@pytest.mark.gpu
@pytest.mark.parametrize("c,n_groups", [(1, 1), (129, 7), (65536, 16384)])
def test_group_occupancy_kernel_matches_plain(cuda, c, n_groups):
    g = torch.Generator().manual_seed(c)
    own = torch.randint(0, 9, (c,), generator=g, dtype=torch.int32)
    groups = torch.randint(0, n_groups, (c,), generator=g,
                           dtype=torch.int32)
    want = orch.group_occupancy_plain(own, groups)
    got = orch.group_occupancy(own.to(cuda), groups.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    # float32: atomic order varies, so equal only to f32 rounding
    got_f = orch.group_occupancy(own.float().to(cuda), groups.to(cuda))
    torch.testing.assert_close(got_f.cpu(), want.float())
