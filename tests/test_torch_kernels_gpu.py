"""The CUDA kernels against their plain versions, on the card: the
orchestration kernels, flash attention (forward, its LSE, and the
backward kernel, alone and through autograd), WKV6 and the SSD scan
(forward, and the backward kernels alone and through autograd), the
refusal of a gradient where there is no backward kernel (bf16); and the
orchestration kernels under a 2-rank cells group against the port's
plain route on the CPU.

Imports only torch, numpy and the port, so it runs on a machine with a
card and no JAX (the tests skip without a card, but for one CPU test of
the bf16 row bar):

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py

``admit_case`` and ``ADMIT_CASES`` are also the lane orders
``test_torch_orchestration.py`` holds the plain versions to the
reference with: interleaved cells, one cell's burst past Q, reversed
order, invalid lanes with junk cell ids, C straddling 128; and
``group_layout`` its four edge-group layouts.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import orchestration as orch
from repro_torch.kernels import ssd as sk
from repro_torch.kernels import wkv6 as wk
from repro_torch.models.rwkv6 import wkv6_recurrent


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


GROUP_LAYOUTS = ("groups_of_4", "singleton", "one_group", "random")


def group_layout(name, c, seed=0):
    """(c,) int32 edge-group ids: the deployment's contiguous groups of 4,
    every cell its own group, one group of all cells, or random ids in
    [0, c) (so some ids have no cell)."""
    if name == "groups_of_4":
        return (np.arange(c) // 4).astype(np.int32)
    if name == "singleton":
        return np.arange(c, dtype=np.int32)
    if name == "one_group":
        return np.zeros(c, np.int32)
    return np.random.default_rng(seed).integers(0, c, c).astype(np.int32)


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
@pytest.mark.parametrize("order", ["random", "one_cell", "interleaved",
                                   "reversed"])
@pytest.mark.parametrize("fill", ["random", "near_full"])
@pytest.mark.parametrize("a", [39519, 131072])
def test_queue_admit_kernel_deployment_bursts(cuda, a, order, fill):
    """The deployment's ring (C 65,536, Q 64) under a burst of its busiest
    tick's size and one of 131,072 lanes (39 and 128 tiles), in every lane
    order."""
    case = admit_case(a, 65536, 64, a, order, fill)
    want = [x.numpy() for x in _plain(case)]
    got = orch.queue_admit(*(torch.as_tensor(x.copy(), device=cuda)
                             for x in case))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w)


@pytest.mark.gpu
def test_queue_admit_kernel_repeats_bit_identical(cuda):
    """Ten launches on the same inputs give the same rings, lengths and
    admissions."""
    case = admit_case(4, 65536, 64, 39519, "random", "near_full")
    outs = []
    for _ in range(10):
        got = orch.queue_admit(*(torch.as_tensor(x.copy(), device=cuda)
                                 for x in case))
        outs.append([g.cpu() for g in got])
    for other in outs[1:]:
        assert all(torch.equal(x, y) for x, y in zip(outs[0], other))


@pytest.mark.gpu
@pytest.mark.parametrize("c,n_groups", [(1, 1), (129, 7), (65536, 16384)])
def test_group_occupancy_kernel_matches_plain(cuda, c, n_groups):
    g = torch.Generator().manual_seed(c)
    own = torch.randint(0, 9, (c,), generator=g, dtype=torch.int32)
    groups = torch.randint(0, n_groups, (c,), generator=g,
                           dtype=torch.int32)
    want = orch.group_occupancy_plain(own, groups)
    index = orch.group_index(groups.to(cuda))
    got = orch.group_occupancy(own.to(cuda), index)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    # float32: each group summed in the kernel's fixed tree order
    got_f = orch.group_occupancy(own.float().to(cuda), index)
    want_f = orch.group_occupancy_tree(own.float(), index.to("cpu"))
    assert torch.equal(got_f.cpu(), want_f)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", GROUP_LAYOUTS)
def test_group_occupancy_kernel_layouts(cuda, layout):
    """The four layouts at the deployment's 65,536 cells: int32 equal to
    the plain version, float32 equal to the kernel's order emulated on the
    CPU and the same across ten launches; one kernel launch per call (the
    one-group layout through its combining launch)."""
    c = 65536
    groups = torch.as_tensor(group_layout(layout, c, seed=1))
    rng = np.random.default_rng(2)
    own = torch.as_tensor(rng.integers(0, 9, c).astype(np.int32))
    own_f = torch.as_tensor(rng.standard_normal(c).astype(np.float32))
    index = orch.group_index(groups.to(cuda))
    assert index.chunked == (layout == "one_group")
    before = orch.LAUNCHES["group_occupancy"]
    got = orch.group_occupancy(own.to(cuda), index)
    assert orch.LAUNCHES["group_occupancy"] == before + 1
    assert torch.equal(got.cpu(), orch.group_occupancy_plain(own, groups))
    want_f = orch.group_occupancy_tree(own_f, index.to("cpu"))
    own_f = own_f.to(cuda)
    for _ in range(10):
        got_f = orch.group_occupancy(own_f, index)
        assert torch.equal(got_f.cpu(), want_f)


# ------------------------------------------------------------ LM kernels
# (b, sq, sk, h, kv, d, dv, causal, window): MHA/GQA/MQA, ragged S, the
# zoo's head dims (32, 60, 64, 120, 128), Dk != Dv, a continuation
# (Sq < Sk), full attention; then the pipelines' edges: one key past a
# 128-key stage (129, 257), one query row against 4097 keys, a window
# smaller than a key tile (16) and a window of 1 (each row sees only its
# own key)
FLASH_CASES = [
    (1, 128, 128, 4, 4, 32, 32, True, 0),
    (2, 256, 256, 8, 2, 64, 64, True, 64),
    (1, 100, 100, 4, 1, 64, 64, True, 0),
    (2, 200, 200, 4, 2, 60, 60, True, 32),
    (1, 300, 300, 4, 2, 120, 120, True, 128),
    (2, 64, 64, 2, 2, 128, 128, True, 0),
    (2, 130, 130, 4, 4, 48, 32, True, 0),
    (1, 37, 165, 4, 2, 64, 64, True, 0),
    (1, 128, 128, 2, 2, 32, 32, False, 0),
    (1, 1, 77, 8, 2, 128, 128, True, 0),
    (1, 129, 129, 4, 2, 128, 128, True, 0),
    (2, 257, 257, 4, 1, 64, 64, True, 0),
    (1, 1, 4097, 8, 2, 128, 128, True, 0),
    (1, 300, 300, 4, 2, 128, 128, True, 16),
    (2, 150, 150, 4, 4, 64, 64, True, 1),
]
# both kernels' layouts for D in (128, 192] (MLA's prefill: Dk 192, Dv
# 128): ragged S, one key past a 32-key tile (33), GQA, a continuation,
# a window smaller than a tile, D not a multiple of 8 (132), Dv < 128,
# full attention, one query row against 4097 keys
WIDE_FLASH_CASES = [
    (1, 128, 128, 4, 4, 192, 128, True, 0),
    (2, 100, 100, 4, 2, 192, 128, True, 0),
    (1, 33, 33, 2, 1, 192, 128, True, 0),
    (1, 37, 165, 4, 2, 192, 128, True, 0),
    (1, 300, 300, 4, 2, 160, 128, True, 16),
    (1, 130, 130, 2, 2, 132, 100, True, 0),
    (1, 129, 129, 2, 1, 192, 64, True, 0),
    (1, 128, 128, 2, 2, 192, 128, False, 0),
    (1, 1, 4097, 4, 2, 192, 128, True, 0),
]
TOL = {torch.float32: dict(atol=3e-5, rtol=1e-4),
       torch.bfloat16: dict(atol=3e-2, rtol=3e-2)}
# bf16 is also held row by row: one bf16 step is at most 2^-7 of a value,
# so a row off by a step in every element is off by 7.8e-3 of its norm
BF16_ROW_BAR = 1e-2


def _flash_inputs(seed, b, sq, sk, h, kv, d, dv, dtype):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.as_tensor(
        rng.standard_normal(s).astype(np.float32)).to(dtype)
    return mk(b, sq, h, d), mk(b, sk, kv, d), mk(b, sk, kv, dv)


def _row_rel_err(got, want):
    """The largest |got row - want row| / |want row| over the (batch,
    query, head) rows."""
    diff = (got.float().cpu() - want.float()).norm(dim=-1)
    return float((diff / want.float().norm(dim=-1).clamp_min(1e-30)).max())


def _assert_flash_close(got, want):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().numpy(), **TOL[want.dtype])
    if want.dtype == torch.bfloat16:
        assert _row_rel_err(got, want) <= BF16_ROW_BAR


def test_bf16_row_bar_catches_lost_keys():
    """On the CPU: at the yi-6b length, outputs whose last 128 query rows
    lost 8 keys' share of P V (one register pair of P's operand, keys
    1024-1031, still counted in the row sums) stay inside the
    element-wise bf16 bar and fail the row bar by far."""
    s, lost = 2048, slice(1024, 1032)
    q, k, v = _flash_inputs(8, 1, s, s, 2, 1, 128, 128, torch.bfloat16)
    want = fa.flash_attention_plain(q, k, v, causal=True)
    rows = torch.arange(s - 128, s)[:, None]
    scores = (q[0, -128:].float().transpose(0, 1) * 128 ** -0.5
              @ k[0, :, 0].float().T)
    p = torch.softmax(scores.masked_fill(torch.arange(s) > rows, -1e30), -1)
    wrong = want.clone()
    wrong[0, -128:] = (want[0, -128:].float() - (p[..., lost]
                       @ v[0, lost, 0].float()).transpose(0, 1)).bfloat16()
    np.testing.assert_allclose(wrong.float().numpy(), want.float().numpy(),
                               **TOL[torch.bfloat16])
    assert _row_rel_err(wrong, want) > 10 * BF16_ROW_BAR


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,sq,sk,h,kv,d,dv,causal,window", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, b, sq, sk, h, kv, d, dv, causal,
                                    window, dtype):
    q, k, v = _flash_inputs(sq + d, b, sq, sk, h, kv, d, dv, dtype)
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q.to(cuda), k.to(cuda), v.to(cuda),
                             causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 1
    assert got.shape == (b, sq, h, dv) and got.dtype == dtype
    _assert_flash_close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,h,kv,d,dv,causal,window", WIDE_FLASH_CASES)
def test_flash_kernel_wide_head_dims(cuda, b, sq, sk, h, kv, d, dv, causal,
                                     window):
    q, k, v = _flash_inputs(sq + d + dv, b, sq, sk, h, kv, d, dv,
                            torch.float32)
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q.to(cuda), k.to(cuda), v.to(cuda),
                             causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 1
    assert got.shape == (b, sq, h, dv)
    _assert_flash_close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,h,kv,d,dv,causal,window", WIDE_FLASH_CASES)
def test_flash_kernel_wide_head_dims_bf16(cuda, b, sq, sk, h, kv, d, dv,
                                          causal, window):
    """The bf16 ``wgmma`` instance at D in (128, 192] (three K panels,
    its cut ring) on the same cases as the float32 layout."""
    q, k, v = _flash_inputs(sq + d + dv, b, sq, sk, h, kv, d, dv,
                            torch.bfloat16)
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q.to(cuda), k.to(cuda), v.to(cuda),
                             causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 1
    assert got.shape == (b, sq, h, dv) and got.dtype == torch.bfloat16
    _assert_flash_close(got, want)


@pytest.mark.gpu
def test_flash_kernel_mla_views_and_bf16_limit(cuda):
    """MLA's operands as ``mla_prefill`` hands them over: K the
    concatenation of 128 nope and 64 rope columns, V the strided view
    ``kv[..., 128:]`` of the decompressed (B, S, H, 256) latents, read in
    place, in float32 and in bfloat16 (both instances at D 192, one
    launch each); D 200 raises, naming the roadmap."""
    b, s, h = 2, 160, 4
    rng = np.random.default_rng(192)
    mk = lambda *sh: torch.as_tensor(
        rng.standard_normal(sh).astype(np.float32))
    q32, kv32, k_pe32 = mk(b, s, h, 192), mk(b, s, h, 256), mk(b, s, 1, 64)
    for dtype in (torch.float32, torch.bfloat16):
        q, kv, k_pe = (t.to(dtype) for t in (q32, kv32, k_pe32))
        k = torch.cat([kv[..., :128], k_pe.expand(b, s, h, 64)], -1)
        v = kv[..., 128:]
        want = fa.flash_attention_plain(q, k, v, causal=True,
                                        scale=192 ** -0.5)
        kv_c = kv.to(cuda)
        v_c = kv_c[..., 128:]
        assert not v_c.is_contiguous() and fa._build.aligned(v_c) is v_c
        before = fa.LAUNCHES["flash_attention"]
        got = fa.flash_attention(q.to(cuda), k.to(cuda), v_c, causal=True,
                                 scale=192 ** -0.5)
        assert fa.LAUNCHES["flash_attention"] == before + 1
        assert got.dtype == dtype
        _assert_flash_close(got, want)
    wide = mk(b, s, h, 200)
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="ROADMAP.md"):
            fa.flash_attention(*(t.to(cuda, dtype) for t in (wide, wide)),
                               kv32[..., 128:].to(cuda, dtype), causal=True)


@pytest.mark.gpu
def test_flash_kernel_bf16_and_strided(cuda):
    q, k, v = _flash_inputs(3, 2, 192, 192, 8, 2, 128, 128, torch.float32)
    want = fa.flash_attention_plain(q, k, v, causal=True)
    got = fa.flash_attention(*(t.to(cuda, torch.bfloat16)
                               for t in (q, k, v)), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().cpu().numpy(), want.numpy(),
                               atol=3e-2, rtol=3e-2)
    for dtype in (torch.float32, torch.bfloat16):
        want = fa.flash_attention_plain(*(t.to(dtype) for t in (q, k, v)),
                                        causal=True)
        # (B, H, S, D) storage read through strides, no copy
        qs, ks, vs = (t.to(cuda, dtype).transpose(1, 2).contiguous()
                      .transpose(1, 2) for t in (q, k, v))
        assert not qs.is_contiguous()
        _assert_flash_close(fa.flash_attention(qs, ks, vs, causal=True),
                            want)
        # views that start 2 elements into a wider buffer: not 16-byte
        # aligned, so the wrapper copies them into an aligned buffer
        qo, ko, vo = (torch.nn.functional.pad(t.to(cuda, dtype), (2, 6))
                      [..., 2:2 + t.shape[-1]] for t in (q, k, v))
        assert qo.data_ptr() % 16
        _assert_flash_close(fa.flash_attention(qo, ko, vo, causal=True),
                            want)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,kv,d,dv", [(4, 2048, 32, 8, 128, 128),
                                           (4, 2048, 48, 8, 128, 128),
                                           (4, 2048, 128, 128, 192, 128),
                                           (4, 3072, 28, 4, 128, 128)],
                         ids=["mistral-nemo-12b", "nemotron-4-15b",
                              "deepseek-v2-236b_mla", "qwen2-vl-7b"])
def test_flash_kernel_dense_serving_shapes(cuda, b, s, h, kv, d, dv):
    """The prefill attention of mistral-nemo-12b, nemotron-4-15b,
    deepseek-v2-236b (MLA: Dk 192, Dv 128, 128 heads) and qwen2-vl-7b
    (2,048 text and 1,024 patch positions) in f32, causal, the plain
    version on the card beside."""
    q, k, v = (t.to(cuda) for t in _flash_inputs(h, b, s, s, h, kv, d, dv,
                                                 torch.float32))
    want = fa.flash_attention_plain(q, k, v, causal=True)
    got = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    _assert_flash_close(got, want.cpu())


# the flash backward kernel (float32, D up to 192, Dv up to 128): ragged
# S, GQA, a window smaller and larger than a 64-row tile (not 1: a row
# that sees one key has dq = dk = 0 exactly, and both sides give rounding
# noise of ~1e-7), a continuation
# (Sq < Sk), Dk != Dv both ways, D not a multiple of 8, full attention,
# one query row, musicgen-medium's heads (D 64); then the tiling of D in
# (128, 192] (16-row streamed tiles in the dK / dV kernel): MLA's Dk 192
# / Dv 128 ragged and with GQA, a window, a continuation, Dv <= 64, D not
# a multiple of 8, full attention; then the edges of the kernels' tiles
# (64 resident rows; streamed tiles of 32 rows, 16 in the dK / dV kernel
# at D > 128): S one past and one short of a streamed tile and of a
# 64-row block, a continuation at both, a small window at 128 - 1, D 192
# with Dv <= 64 and a window, GQA 4 at D 192, full attention at 64 + 1
# with D and Dv not multiples of 8
BWD_CASES = [
    (2, 100, 100, 4, 2, 64, 64, True, 0),
    (1, 129, 129, 8, 1, 128, 128, True, 0),
    (1, 300, 300, 4, 2, 120, 120, True, 40),
    (2, 150, 150, 2, 2, 64, 64, True, 3),
    (1, 37, 165, 4, 2, 64, 64, True, 0),
    (1, 130, 130, 4, 2, 128, 64, True, 0),
    (1, 70, 70, 2, 1, 64, 128, True, 0),
    (1, 66, 66, 2, 2, 100, 36, True, 0),
    (1, 96, 80, 2, 1, 32, 32, False, 0),
    (1, 1, 257, 4, 4, 64, 64, True, 0),
    (2, 256, 256, 24, 24, 64, 64, True, 0),
    (1, 150, 150, 4, 2, 192, 128, True, 0),
    (1, 300, 300, 2, 2, 192, 128, True, 40),
    (1, 37, 165, 4, 2, 192, 128, True, 0),
    (1, 100, 100, 2, 1, 160, 64, True, 0),
    (1, 66, 66, 2, 2, 132, 100, True, 0),
    (1, 96, 80, 2, 1, 192, 128, False, 0),
    (1, 33, 33, 2, 1, 64, 64, True, 0),
    (1, 31, 95, 4, 2, 128, 128, True, 0),
    (1, 63, 65, 2, 2, 128, 128, True, 0),
    (1, 127, 127, 4, 2, 128, 64, True, 7),
    (1, 200, 200, 2, 1, 192, 64, True, 50),
    (1, 96, 96, 8, 2, 192, 128, True, 0),
    (1, 17, 47, 4, 2, 192, 128, True, 0),
    (1, 65, 65, 2, 2, 100, 36, False, 0),
]


def _rel_to_max(got, want):
    """|got - want| over want's largest magnitude."""
    return float((got.float().cpu() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,h,kv,d,dv,causal,window", BWD_CASES)
def test_flash_backward_kernel_matches_plain(cuda, b, sq, sk, h, kv, d, dv,
                                             causal, window):
    """The forward's LSE within 1e-5 of the plain version's; dQ, dK, dV
    of the backward kernel within 1e-4 of each plain tensor's largest
    magnitude, from the same o, LSE and dO; one launch each; a second
    backward call gives bit-identical gradients."""
    q, k, v = _flash_inputs(sq + d + 7, b, sq, sk, h, kv, d, dv,
                            torch.float32)
    do = torch.as_tensor(np.random.default_rng(sk).standard_normal(
        (b, sq, h, dv)).astype(np.float32))
    o, lse = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                      return_lse=True)
    before = dict(fa.LAUNCHES)
    got_o, got_lse = fa._forward(q.to(cuda), k.to(cuda), v.to(cuda), causal,
                                 window, d ** -0.5, with_lse=True)
    torch.cuda.synchronize()
    _assert_flash_close(got_o, o)
    assert float((got_lse.cpu() - lse).abs().max()) <= 1e-5
    want = fa.flash_attention_backward_plain(q, k, v, o, lse, do,
                                             causal=causal, window=window)
    got = fa.flash_attention_backward(*(t.to(cuda) for t in (q, k, v, o, lse,
                                                             do)),
                                      causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert fa.LAUNCHES["flash_attention_backward"] == \
        before["flash_attention_backward"] + 1
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert _rel_to_max(g, w) <= 1e-4, name
    again = fa.flash_attention_backward(
        *(t.to(cuda) for t in (q, k, v, o, lse, do)), causal=causal,
        window=window)
    assert all(torch.equal(g, a) for g, a in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("d,dv", [(64, 64), (128, 128), (192, 128)])
def test_flash_backward_kernel_repeats_bit_identical(cuda, d, dv):
    """Five backward calls on the same inputs give bit-identical dq, dk
    and dv (no atomics: dK and dV sum a kv head's query heads in one CTA,
    in a fixed order), at each tiling of the head dims, with GQA and a
    window."""
    q, k, v = (t.to(cuda) for t in _flash_inputs(d + dv, 2, 300, 300, 8, 2,
                                                 d, dv, torch.float32))
    do = torch.as_tensor(np.random.default_rng(d).standard_normal(
        (2, 300, 8, dv)).astype(np.float32)).to(cuda)
    o, lse = fa._forward(q, k, v, True, 100, d ** -0.5, with_lse=True)
    outs = [fa.flash_attention_backward(q, k, v, o, lse, do, causal=True,
                                        window=100) for _ in range(5)]
    torch.cuda.synchronize()
    for other in outs[1:]:
        assert all(torch.equal(x, y) for x, y in zip(outs[0], other))


@pytest.mark.gpu
def test_flash_autograd_launches_the_backward_kernel(cuda):
    """``torch.autograd.grad`` through ``flash_attention`` on the card
    runs the forward kernel with its LSE and the backward kernel, and
    agrees with the CPU's plain route within 1e-4 of each gradient's
    largest magnitude; repeated, it gives bit-identical gradients."""
    q, k, v = _flash_inputs(5, 2, 200, 200, 8, 2, 64, 64, torch.float32)
    do = torch.as_tensor(np.random.default_rng(6).standard_normal(
        (2, 200, 8, 64)).astype(np.float32))

    def grads(dev):
        leaves = [t.to(dev).requires_grad_(True) for t in (q, k, v)]
        out = fa.flash_attention(*leaves, causal=True, window=50)
        return torch.autograd.grad(out, leaves, do.to(dev))

    want = grads("cpu")
    fa.reset_launch_counts()
    got = grads(cuda)
    again = grads(cuda)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"flash_attention": 2,
                           "flash_attention_backward": 2}
    for g, w, a in zip(got, want, again):
        assert _rel_to_max(g, w) <= 1e-4
        assert torch.equal(g, a)


@pytest.mark.gpu
def test_flash_autograd_at_mla_head_dims(cuda):
    """``torch.autograd.grad`` through ``flash_attention`` at MLA's Dk 192
    / Dv 128, V the strided view of the latents as ``mla_prefill`` hands
    it over: one forward and one backward launch, the gradients within
    1e-4 of the CPU's plain route."""
    rng = np.random.default_rng(193)
    mk = lambda *sh: torch.as_tensor(
        rng.standard_normal(sh).astype(np.float32))
    q, kv, do = mk(1, 130, 4, 192), mk(1, 130, 4, 256), mk(1, 130, 4, 128)

    def grads(dev):
        leaves = [t.to(dev).requires_grad_(True) for t in (q, kv)]
        k, v = leaves[1][..., :192], leaves[1][..., 128:]
        out = fa.flash_attention(leaves[0], k, v, causal=True)
        return torch.autograd.grad(out, leaves, do.to(dev))

    want = grads("cpu")
    fa.reset_launch_counts()
    got = grads(cuda)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"flash_attention": 1,
                           "flash_attention_backward": 1}
    for g, w in zip(got, want):
        assert _rel_to_max(g, w) <= 1e-4


@pytest.mark.gpu
def test_kernels_without_a_backward_refuse_grad(cuda):
    """Under grad, bf16 flash (at D 192 too), f32 flash at D 224, and bf16
    WKV6 and SSD raise naming the roadmap (float32 WKV6 and SSD have
    their backward kernels); under ``no_grad`` the same calls run."""
    q, k, v = (t.to(cuda) for t in _flash_inputs(1, 1, 64, 64, 2, 2, 64, 64,
                                                 torch.float32))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        fa.flash_attention(q.bfloat16().requires_grad_(), k.bfloat16(),
                           v.bfloat16())
    qw, kw, vw = (t.to(cuda) for t in _flash_inputs(
        2, 1, 64, 64, 2, 2, 192, 128, torch.float32))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        fa.flash_attention(qw.bfloat16(), kw.bfloat16().requires_grad_(),
                           vw.bfloat16())
    qw, kw, vw = (t.to(cuda) for t in _flash_inputs(
        2, 1, 64, 64, 2, 2, 224, 128, torch.float32))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        fa.flash_attention(qw, kw.requires_grad_(), vw)
    r, kk, vv, lw, u = (t.to(cuda) for t in _wkv_inputs(3, 1, 32, 2, 64))
    r, kk, vv = (t.bfloat16() for t in (r, kk, vv))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        wk.wkv6(r.requires_grad_(), kk, vv, lw, u)
    x, dt, a, bm, cm, d = (t.to(cuda) for t in _ssd_inputs(4, 1, 32, 4, 16,
                                                           1, 16))
    x, dt, bm, cm = (t.bfloat16() for t in (x, dt, bm, cm))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        sk.ssd(x.requires_grad_(), dt, a, bm, cm, d)
    with torch.no_grad():
        assert wk.wkv6(r, kk, vv, lw, u)[0].shape == r.shape
        assert sk.ssd(x, dt, a, bm, cm, d)[0].shape == x.shape


def _wkv_inputs(seed, b, s, h, n, decay_scale=1.0):
    rng = np.random.default_rng(seed)
    mk = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    r, k, v = mk(b, s, h, n), mk(b, s, h, n), mk(b, s, h, n)
    lw = -decay_scale * np.exp(mk(b, s, h, n))
    u = 0.5 * mk(h, n)
    return tuple(torch.as_tensor(a) for a in (r, k, v, lw, u))


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,n,decay_scale", [
    (1, 64, 2, 16, 1.0), (2, 128, 3, 32, 1.0), (1, 200, 2, 64, 1.0),
    (2, 77, 4, 64, 0.05), (2, 128, 2, 64, 5.0), (1, 1, 2, 64, 1.0),
])
def test_wkv6_kernel_matches_plain(cuda, b, s, h, n, decay_scale):
    r, k, v, lw, u = _wkv_inputs(s + n, b, s, h, n, decay_scale)
    want_o, want_s = wkv6_recurrent(r, k, v, lw, u)
    plain_o, _ = wk.wkv6_plain(r, k, v, lw, u)
    before = wk.LAUNCHES["wkv6"]
    got_o, got_s = wk.wkv6(*(t.to(cuda) for t in (r, k, v, lw, u)))
    torch.cuda.synchronize()
    assert wk.LAUNCHES["wkv6"] == before + 1
    assert bool(torch.isfinite(got_o).all())
    for got, want in ((got_o, want_o), (got_s, want_s), (got_o, plain_o)):
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   atol=5e-4, rtol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h", [(4, 2048, 32), (4, 2000, 32),
                                   (1, 2048, 1)])
def test_wkv6_kernel_serving_lengths(cuda, b, s, h):
    """rwkv6-1.6b's prefill (B 4, H 32, N 64) at S 2048 and a ragged 2000,
    and one (batch, head) at S 2048 (the smallest chunks), against the
    recurrence and the plain version on the card."""
    args = tuple(t.to(cuda) for t in _wkv_inputs(s, b, s, h, 64))
    want_o, want_s = wkv6_recurrent(*args)
    plain_o, _ = wk.wkv6_plain(*args)
    got_o, got_s = wk.wkv6(*args)
    assert bool(torch.isfinite(got_o).all())
    for got, want in ((got_o, want_o), (got_s, want_s), (got_o, plain_o)):
        torch.testing.assert_close(got, want, atol=5e-4, rtol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("steps", [1, 15, 16, 17, 100, 128, 256])
def test_wkv6_kernel_chunk_lengths(cuda, steps):
    """Every chunk length the launcher takes: one step per CTA, ragged
    staging, a chunk longer than S."""
    r, k, v, lw, u = (t.to(cuda) for t in _wkv_inputs(steps, 2, 200, 3, 32))
    want_o, want_s = wkv6_recurrent(r, k, v, lw, u)
    got_o, got_s, _ = wk._launch(r, k, v, lw, u, steps)
    torch.testing.assert_close(got_o, want_o, atol=5e-4, rtol=1e-3)
    torch.testing.assert_close(got_s, want_s, atol=5e-4, rtol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_kernel_unaligned_views(cuda, dtype):
    """Contiguous views that start off 16 bytes (the kernel copies rows in
    16- or 8-byte pieces): the wrapper copies them first."""
    args = _wkv_inputs(6, 2, 77, 3, 32)
    want_o, want_s = wkv6_recurrent(*(
        t.to(dtype).float() if i < 3 else t for i, t in enumerate(args)))
    moved = []
    for i, t in enumerate(args):
        t = t.to(cuda, dtype if i < 3 else torch.float32)
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        moved.append(buf[1:].view(t.shape).copy_(t))
    assert all(t.data_ptr() % 16 for t in moved)
    got_o, got_s = wk.wkv6(*moved)
    tol = (5e-4, 1e-3) if dtype == torch.float32 else (5e-2, 5e-2)
    torch.testing.assert_close(got_o.float(), want_o.to(cuda), atol=tol[0],
                               rtol=tol[1])
    torch.testing.assert_close(got_s, want_s.to(cuda), atol=5e-4, rtol=1e-3)


@pytest.mark.gpu
def test_wkv6_kernel_repeats_bit_identical(cuda):
    args = tuple(t.to(cuda) for t in _wkv_inputs(5, 4, 512, 32, 64))
    first = wk.wkv6(*args)
    for _ in range(9):
        again = wk.wkv6(*args)
        assert all(torch.equal(x, y) for x, y in zip(first, again))


@pytest.mark.gpu
def test_wkv6_kernel_bf16_serving_shape(cuda):
    """bf16 r, k, v at rwkv6-1.6b's prefill shape against the float32
    recurrence on the same bf16 values."""
    r, k, v, lw, u = (t.to(cuda) for t in _wkv_inputs(12, 4, 2048, 32, 64))
    rb, kb, vb = (t.to(torch.bfloat16) for t in (r, k, v))
    want_o, want_s = wkv6_recurrent(rb.float(), kb.float(), vb.float(), lw,
                                    u)
    got_o, got_s = wk.wkv6(rb, kb, vb, lw, u)
    assert got_o.dtype == torch.bfloat16
    torch.testing.assert_close(got_o.float(), want_o, atol=5e-2, rtol=5e-2)
    torch.testing.assert_close(got_s, want_s, atol=5e-4, rtol=1e-3)


@pytest.mark.gpu
def test_wkv6_kernel_bf16(cuda):
    r, k, v, lw, u = _wkv_inputs(9, 1, 96, 2, 64)
    rb, kb, vb = (t.to(torch.bfloat16) for t in (r, k, v))
    want, _ = wkv6_recurrent(rb.float(), kb.float(), vb.float(), lw, u)
    got, _ = wk.wkv6(*(t.to(cuda) for t in (rb, kb, vb, lw, u)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().cpu().numpy(), want.numpy(),
                               atol=5e-2, rtol=5e-2)


def _ssd_inputs(seed, b, s, h, p, g, n, decay_scale=1.0):
    rng = np.random.default_rng(seed)
    mk = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    x = mk(b, s, h, p)
    dt = decay_scale * np.log1p(np.exp(mk(b, s, h)))  # softplus
    a = -np.exp(mk(h))
    bm, cm = mk(b, s, g, n), mk(b, s, g, n)
    d = np.linspace(0.5, 1.5, h).astype(np.float32)
    return tuple(torch.as_tensor(np.asarray(v, np.float32))
                 for v in (x, dt, a, bm, cm, d))


def ssd_recurrence(x, dt, a, bm, cm, d, init_state=None):
    """The exact per-step recurrence, float32 (the JAX test's oracle)."""
    b, s, h, p = x.shape
    hg = h // bm.shape[2]
    bh, ch = (t.repeat_interleave(hg, dim=2) for t in (bm, cm))
    state = (torch.zeros((b, h, p, bm.shape[3])) if init_state is None
             else init_state.clone())
    ys = []
    for t in range(s):
        state = (state * torch.exp(dt[:, t] * a)[..., None, None]
                 + torch.einsum("bhp,bhn->bhpn", x[:, t] * dt[:, t, :, None],
                                bh[:, t]))
        ys.append(torch.einsum("bhpn,bhn->bhp", state, ch[:, t]))
    return torch.stack(ys, dim=1) + x * d[None, None, :, None], state


# (b, s, h, p, g, n): the JAX test's shapes, ragged S, G = 2, P != N, the
# zamba2 smoke width, the largest tile; then the tensor-core kernel's
# edges: S under one chunk and off a multiple of 64, P and N of 16, 48,
# 64 and 128 (48 fills two P slices unevenly and pads N's tile), G = 2
# with H = 8
SSD_CASES = [
    (1, 64, 2, 8, 1, 8), (2, 96, 4, 16, 2, 8), (1, 100, 2, 8, 1, 8),
    (2, 200, 4, 32, 1, 16), (1, 130, 4, 64, 2, 32), (1, 70, 2, 128, 1, 128),
    (2, 1, 2, 16, 1, 16),
    (1, 40, 2, 16, 1, 48), (2, 190, 2, 48, 1, 16), (1, 129, 2, 48, 1, 128),
    (1, 100, 2, 128, 1, 64), (1, 257, 4, 64, 1, 48), (2, 130, 8, 32, 2, 64),
    (1, 63, 8, 16, 2, 128),
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,p,g,n", SSD_CASES)
def test_ssd_kernel_matches_plain(cuda, b, s, h, p, g, n):
    args = _ssd_inputs(s + p, b, s, h, p, g, n)
    want_y, want_s = ssd_recurrence(*args)
    plain_y, plain_s = sk.ssd_plain(*args, chunk=32)
    before = sk.LAUNCHES["ssd"]
    got_y, got_s = sk.ssd(*(t.to(cuda) for t in args), chunk=32)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["ssd"] == before + 1
    assert bool(torch.isfinite(got_y).all())
    for got, want in ((got_y, want_y), (got_s, want_s), (got_y, plain_y),
                      (got_s, plain_s)):
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   atol=3e-4, rtol=1e-3)


@pytest.mark.gpu
def test_ssd_kernel_initial_state_strides_and_decay(cuda):
    """A non-zero initial state; x, B and C as strided slices of one
    buffer (as the model hands them over); no skip term; a strongly
    decaying case that stays finite."""
    b, s, h, p, g, n = 2, 150, 4, 32, 2, 16
    x, dt, a, bm, cm, _ = _ssd_inputs(5, b, s, h, p, g, n)
    init = torch.as_tensor(np.random.default_rng(6).standard_normal(
        (b, h, p, n)).astype(np.float32))
    want_y, want_s = ssd_recurrence(x, dt, a, bm, cm, torch.zeros(h), init)
    packed = torch.cat([x.reshape(b, s, h * p), bm.reshape(b, s, g * n),
                        cm.reshape(b, s, g * n)], dim=-1).to(cuda)
    xs = packed[..., :h * p].reshape(b, s, h, p)
    bs = packed[..., h * p:h * p + g * n].reshape(b, s, g, n)
    cs = packed[..., h * p + g * n:].reshape(b, s, g, n)
    assert not xs.is_contiguous()
    got_y, got_s = sk.ssd(xs, dt.to(cuda), a.to(cuda), bs, cs, None,
                          init_state=init.to(cuda))
    np.testing.assert_allclose(got_y.cpu().numpy(), want_y.numpy(),
                               atol=3e-4, rtol=1e-3)
    np.testing.assert_allclose(got_s.cpu().numpy(), want_s.numpy(),
                               atol=3e-4, rtol=1e-3)
    args = _ssd_inputs(7, 1, 128, 2, 16, 1, 16, decay_scale=50.0)
    want_y, want_s = ssd_recurrence(*args)
    got_y, got_s = sk.ssd(*(t.to(cuda) for t in args))
    assert bool(torch.isfinite(got_y).all() and torch.isfinite(got_s).all())
    np.testing.assert_allclose(got_y.cpu().numpy(), want_y.numpy(),
                               atol=3e-4, rtol=1e-3)


@pytest.mark.gpu
def test_ssd_kernel_zamba2_width_and_bf16(cuda):
    """zamba2-1.2b's head shape at B = 1 (P split in slices of 16: 64
    heads in slices of 32 would not fill the card) and B = 4 (slices of
    32) against the plain version on the card (chunk 256, the config's),
    evaluated in float64 on the same inputs: at S = 2048 the float32
    plain version's own rounding comes near the bar; bf16 against
    float32 inputs."""
    for seed, b in ((8, 1), (10, 4)):
        args = tuple(t.to(cuda) for t in _ssd_inputs(seed, b, 2048, 64, 64,
                                                      1, 64))
        want_y, want_s = sk.ssd_plain(*(t.double() for t in args),
                                      chunk=256)
        got_y, got_s = sk.ssd(*args, chunk=256)
        torch.testing.assert_close(got_y.double(), want_y, atol=3e-4,
                                   rtol=1e-3)
        torch.testing.assert_close(got_s.double(), want_s, atol=3e-4,
                                   rtol=1e-3)
        del args, want_y, want_s, got_y, got_s
    x, dt, a, bm, cm, d = _ssd_inputs(9, 1, 96, 2, 64, 1, 64)
    xb, dtb, bb, cb = (t.to(torch.bfloat16) for t in (x, dt, bm, cm))
    want, _ = ssd_recurrence(xb.float(), dtb.float(), a, bb.float(),
                             cb.float(), d)
    got, _ = sk.ssd(*(t.to(cuda) for t in (xb, dtb, a, bb, cb, d)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().cpu().numpy(), want.numpy(),
                               atol=5e-2, rtol=5e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,p,g,n", [
    (1, 40, 2, 16, 1, 48), (2, 190, 2, 48, 1, 16), (1, 130, 8, 64, 2, 64),
    (1, 100, 2, 128, 1, 128)])
def test_ssd_kernel_bf16_edges(cuda, b, s, h, p, g, n):
    """bf16 operands across the kernel's edges, against the float32
    recurrence on the same bf16 values: y rounds to bf16 (within 3e-2 and
    1e-2 of each output row's norm), the state stays float32 (3e-4,
    1e-3)."""
    x, dt, a, bm, cm, d = _ssd_inputs(s + n, b, s, h, p, g, n)
    xb, dtb, bb, cb = (t.to(torch.bfloat16) for t in (x, dt, bm, cm))
    want_y, want_s = ssd_recurrence(xb.float(), dtb.float(), a, bb.float(),
                                    cb.float(), d)
    got_y, got_s = sk.ssd(*(t.to(cuda) for t in (xb, dtb, a, bb, cb, d)))
    assert got_y.dtype == torch.bfloat16 and got_s.dtype == torch.float32
    got_y = got_y.float().cpu()
    np.testing.assert_allclose(got_y.numpy(), want_y.numpy(), atol=3e-2,
                               rtol=3e-2)
    rows = ((got_y - want_y).norm(dim=-1)
            / want_y.norm(dim=-1).clamp_min(1e-30))
    assert float(rows.max()) <= 1e-2
    np.testing.assert_allclose(got_s.cpu().numpy(), want_s.numpy(),
                               atol=3e-4, rtol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_conv_slices_and_copied_views(cuda, dtype):
    """x, B and C as the model hands them over at zamba2's layout (slices
    of one conv output whose width is d_inner + 2 G N) reach the kernel
    without a copy; views that start off 16 bytes, or whose rows are not
    multiples of 16 bytes, are copied by the wrapper first; both give the
    plain version's result."""
    from repro_torch.kernels import _build
    b, s, h, p, g, n = 2, 150, 4, 64, 1, 64
    x, dt, a, bm, cm, d = _ssd_inputs(11, b, s, h, p, g, n)
    conv = torch.cat([x.reshape(b, s, h * p), bm.reshape(b, s, g * n),
                      cm.reshape(b, s, g * n)], dim=-1).to(cuda, dtype)
    xs = conv[..., :h * p].reshape(b, s, h, p)
    bs = conv[..., h * p:h * p + g * n].reshape(b, s, g, n)
    cs = conv[..., h * p + g * n:].reshape(b, s, g, n)
    assert all(_build.aligned(t) is t for t in (xs, bs, cs))
    dtc = dt.to(cuda, dtype)
    want_y, want_s = sk.ssd_plain(*(t.double() for t in (
        xs, dtc, a.to(cuda), bs, cs, d.to(cuda))), chunk=32)
    tol = ((3e-4, 1e-3) if dtype == torch.float32 else (3e-2, 3e-2))
    got_y, got_s = sk.ssd(xs, dtc, a.to(cuda), bs, cs, d.to(cuda))
    torch.testing.assert_close(got_y.double(), want_y, atol=tol[0],
                               rtol=tol[1])
    torch.testing.assert_close(got_s.double(), want_s, atol=3e-4, rtol=1e-3)
    # one element off 16 bytes, and rows of 63 columns
    off = torch.zeros((b, s, h * p + 1), dtype=dtype, device=cuda)
    xo = off[..., 1:].reshape(b, s, h, p).copy_(xs)
    assert _build.aligned(xo) is not xo
    got_y, got_s = sk.ssd(xo, dtc, a.to(cuda), bs, cs, d.to(cuda))
    torch.testing.assert_close(got_y.double(), want_y, atol=tol[0],
                               rtol=tol[1])
    narrow = conv[..., :h * 63].reshape(b, s, h, 63)
    assert _build.aligned(narrow) is not narrow
    want_y, want_s = sk.ssd_plain(*(t.double() for t in (
        narrow, dtc, a.to(cuda), bs, cs, d.to(cuda))), chunk=32)
    got_y, got_s = sk.ssd(narrow, dtc, a.to(cuda), bs, cs, d.to(cuda))
    torch.testing.assert_close(got_y.double(), want_y, atol=tol[0],
                               rtol=tol[1])
    torch.testing.assert_close(got_s.double(), want_s, atol=3e-4, rtol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["groups_of_4", "spanning"])
def test_cells_group_on_the_card_matches_the_cpu(cuda, layout):
    """A 2-rank cells group on the card (gloo on one card, NCCL on two)
    serves what one device serves on the CPU's plain route: flags and
    actions identical, floats within 1e-5, each rank launching
    ``queue_admit`` once and ``group_occupancy`` 3 times a tick; edge
    groups inside each rank's block, and groups of ``cell % 16`` that
    span both."""
    from repro_torch import random as rnd
    from repro_torch.fleet.workload import random_fleet
    from repro_torch.policy.adapters import heuristic_greedy_policy
    from repro_torch.policy.bundle import PolicyBundle
    from repro_torch.serve import (ServeConfig, poisson_request_stream,
                                   serve_stream)
    from repro_torch.serve.sharded import ServeJob, serve_sharded
    from repro_torch.specs.observation import make_spec

    cpu, cells = torch.device("cpu"), 64
    scn = random_fleet(rnd.PRNGKey(3, cpu), cells, n_max=5, cells_per_edge=4)
    if layout == "spanning":
        groups = torch.arange(cells, dtype=torch.int32) % 16
        scn = scn._replace(edge_group=groups,
                           group_index=orch.group_index(groups))
    cfg = ServeConfig(n_max=5, obs_spec="full", shared_cloud=True,
                      shared_edge=True, telemetry=True)
    horizon = 4 * cfg.round_ms
    stream = poisson_request_stream(rnd.PRNGKey(4, cpu), scn, horizon,
                                    rate=3.0, round_ms=cfg.round_ms,
                                    epoch_ms=horizon / 2)
    pol = heuristic_greedy_policy(make_spec("full", 5))
    want = serve_stream(pol, pol.init(0, cpu), scn, stream, cfg,
                        key=rnd.PRNGKey(5, cpu), device=cpu)
    got, = serve_sharded([ServeJob(PolicyBundle("greedy", "full", 5, {}),
                                   scn, stream, cfg, rnd.PRNGKey(5, cpu))],
                         2, "cuda")
    for k in ("dropped", "served", "violated", "action"):
        np.testing.assert_array_equal(got["records"][k], want["records"][k])
    for k in ("wait_ms", "service_ms", "art_ms"):
        np.testing.assert_allclose(got["records"][k], want["records"][k],
                                   atol=1e-5, rtol=0)
    assert got["telemetry"]["latency_hist"] == \
        want["telemetry"]["latency_hist"]
    for r in got["ranks"]:
        assert r["launches"] == {"queue_admit": got["n_ticks"],
                                 "group_occupancy": 3 * got["n_ticks"]}


# ----------------------------------------------------- WKV6 / SSD backward
def _wkv_bwd_case(seed, b, s, h, n, decay_scale=1.0, dstate=True):
    args = _wkv_inputs(seed, b, s, h, n, decay_scale)
    rng = np.random.default_rng(seed + 1)
    do = torch.as_tensor(rng.standard_normal((b, s, h, n)).astype(
        np.float32))
    ds = (torch.as_tensor(rng.standard_normal((b, h, n, n)).astype(
        np.float32)) if dstate else None)
    return args, do, ds


def _wkv_bwd_kernel(args, do, ds, cuda):
    """The forward kernel's chunk states, then the backward kernels."""
    r, k, v, lw, u = (t.to(cuda) for t in args)
    _, _, chunk_state = wk._launch(r, k, v, lw, u, wk._build.steps_for(r))
    return wk.wkv6_backward(r, k, v, lw, u, chunk_state, do.to(cuda),
                            None if ds is None else ds.to(cuda))


def _f64_on(dev, ts):
    return [None if t is None else t.to(dev, torch.float64) for t in ts]


# (b, s, h, n, decay_scale, dstate): one and several chunks of the
# smallest length, ragged S, weak and strong decay (w underflows), N 16 /
# 32 / 64, no final-state gradient
WKV_BWD_CASES = [
    (1, 64, 2, 16, 1.0, True), (2, 200, 3, 32, 1.0, False),
    (2, 77, 4, 64, 0.05, True), (2, 128, 2, 64, 5.0, True),
    (1, 9, 2, 64, 1.0, True), (4, 300, 8, 64, 1.0, True),
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,n,decay_scale,dstate", WKV_BWD_CASES)
def test_wkv6_backward_kernel_matches_plain(cuda, b, s, h, n, decay_scale,
                                            dstate):
    """dr, dk, dv, dlw, du of the backward kernels within 1e-4 of each
    float64 plain gradient's largest magnitude; one launch a call."""
    args, do, ds = _wkv_bwd_case(s + n, b, s, h, n, decay_scale, dstate)
    want = wk.wkv6_backward_plain(*_f64_on(cuda, (*args, do, ds)))
    before = wk.LAUNCHES["wkv6_backward"]
    got = _wkv_bwd_kernel(args, do, ds, cuda)
    torch.cuda.synchronize()
    assert wk.LAUNCHES["wkv6_backward"] == before + 1
    for name, g, w in zip(("dr", "dk", "dv", "dlw", "du"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        assert _rel_to_max(g, w.cpu()) <= 1e-4, name


@pytest.mark.gpu
@pytest.mark.parametrize("s", [2048, 2000])
def test_wkv6_backward_kernel_training_shape(cuda, s):
    """rwkv6-1.6b's training shape (B 4, H 32, N 64) and a ragged S."""
    args, do, ds = _wkv_bwd_case(s, 4, s, 32, 64)
    want = wk.wkv6_backward_plain(*_f64_on(cuda, (*args, do, ds)))
    got = _wkv_bwd_kernel(args, do, ds, cuda)
    for g, w in zip(got, want):
        assert _rel_to_max(g, w.cpu()) <= 1e-4


@pytest.mark.gpu
def test_wkv6_backward_kernel_repeats_bit_identical(cuda):
    """No atomics: five backward calls give the same bits (du from the
    per-CTA partials summed in a fixed order)."""
    args, do, ds = _wkv_bwd_case(7, 4, 512, 32, 64)
    outs = [_wkv_bwd_kernel(args, do, ds, cuda) for _ in range(5)]
    for other in outs[1:]:
        assert all(torch.equal(x, y) for x, y in zip(outs[0], other))


@pytest.mark.gpu
def test_wkv6_autograd_launches_the_backward_kernel(cuda):
    """``torch.autograd.grad`` through ``wkv6`` on the card (o and the
    final state used) runs one forward and one backward launch and
    agrees with the CPU's plain route within 1e-4 of each gradient's
    largest magnitude; repeated, bit for bit."""
    args, do, ds = _wkv_bwd_case(8, 2, 150, 4, 32)

    def grads(dev):
        leaves = [t.to(dev).requires_grad_(True) for t in args]
        o, state = wk.wkv6(*leaves)
        return torch.autograd.grad((o, state), leaves,
                                   (do.to(dev), ds.to(dev)))

    want = grads("cpu")
    wk.reset_launch_counts()
    got = grads(cuda)
    assert wk.LAUNCHES == {"wkv6": 1, "wkv6_backward": 1}
    again = grads(cuda)
    for g, w, a in zip(got, want, again):
        assert _rel_to_max(g, w) <= 1e-4
        assert torch.equal(g, a)


def _ssd_bwd_case(seed, b, s, h, p, g, n, decay_scale=1.0, init=True,
                  dstate=True):
    args = _ssd_inputs(seed, b, s, h, p, g, n, decay_scale)
    rng = np.random.default_rng(seed + 1)
    mk = lambda *sh: torch.as_tensor(rng.standard_normal(sh).astype(
        np.float32))
    st0 = mk(b, h, p, n) if init else None
    return (*args, st0), mk(b, s, h, p), (mk(b, h, p, n) if dstate
                                         else None)


SSD_BWD_NAMES = ("dx", "ddt", "da", "db", "dc", "dd", "dinit")
# (b, s, h, p, g, n, decay_scale, init, dstate): the forward's shapes
# with the three tile widths (D 32, 64, 128), G = 2, P != N, ragged S,
# weak and strong decay
SSD_BWD_CASES = [
    (1, 64, 2, 8, 1, 8, 1.0, False, False),
    (2, 96, 4, 16, 2, 8, 1.0, True, True),
    (1, 130, 4, 64, 2, 32, 1.0, True, True),
    (1, 70, 2, 128, 1, 128, 1.0, False, True),
    (1, 40, 2, 16, 1, 48, 8.0, True, True),
    (2, 190, 2, 48, 1, 16, 0.05, True, False),
    (1, 257, 4, 64, 1, 48, 1.0, False, True),
    (2, 1, 2, 16, 1, 16, 1.0, True, True),
]


def _ssd_bwd_kernel(args, dy, ds, dev):
    return sk.ssd_backward(*(None if t is None else t.to(dev) for t in args),
                           dy.to(dev), None if ds is None else ds.to(dev))


def _assert_ssd_grads(got, want, bar=1e-4):
    for name, g, w in zip(SSD_BWD_NAMES, got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.shape == w.shape and g.dtype == torch.float32, name
        assert _rel_to_max(g, w.cpu()) <= bar, name


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,p,g,n,decay_scale,init,dstate",
                         SSD_BWD_CASES)
def test_ssd_backward_kernel_matches_plain(cuda, b, s, h, p, g, n,
                                           decay_scale, init, dstate):
    """dx, ddt, da, dB, dC, dd and dinit of the backward kernels within
    1e-4 of each float64 plain gradient's largest magnitude; one launch
    a call."""
    args, dy, ds = _ssd_bwd_case(s + p, b, s, h, p, g, n, decay_scale, init,
                                 dstate)
    want = sk.ssd_backward_plain(*_f64_on(cuda, (*args, dy, ds)))
    before = sk.LAUNCHES["ssd_backward"]
    got = _ssd_bwd_kernel(args, dy, ds, cuda)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["ssd_backward"] == before + (1 if s else 0)
    _assert_ssd_grads(got, want)


@pytest.mark.gpu
def test_ssd_backward_kernel_training_shape(cuda):
    """zamba2-1.2b's training shape (B 4, S 2048, H 64, P 64, G 1, N 64),
    and its ragged S at G = 2."""
    for s, g in ((2048, 1), (2000, 2)):
        args, dy, ds = _ssd_bwd_case(s, 4, s, 64, 64, g, 64)
        want = sk.ssd_backward_plain(*_f64_on(cuda, (*args, dy, ds)))
        _assert_ssd_grads(_ssd_bwd_kernel(args, dy, ds, cuda), want)


@pytest.mark.gpu
def test_ssd_backward_kernel_repeats_bit_identical(cuda):
    args, dy, ds = _ssd_bwd_case(9, 4, 512, 16, 64, 2, 64)
    outs = [_ssd_bwd_kernel(args, dy, ds, cuda) for _ in range(5)]
    for other in outs[1:]:
        assert all(torch.equal(x, y) for x, y in zip(outs[0], other))


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,p,g,n", [
    (2, 300, 4, 128, 2, 128),  # P = N = 128: four slices, ragged S, G 2
    (1, 517, 2, 96, 1, 40),    # P != N, a slice of 32 columns of P
    (2, 70, 4, 24, 2, 72),     # N past one slice, one short sub-chunk
    (1, 100, 2, 6, 1, 10),     # P and N not multiples of 4 (padded rows)
    (1, 70, 2, 70, 2, 66),     # slices of 6 and 2 columns past 64
])
def test_ssd_backward_kernel_slices_and_repeats(cuda, b, s, h, p, g, n):
    """P or N past the kernels' 64 columns (the wrapper's slices), P or N
    not a multiple of 4 (the outputs' rows padded for TMA), a ragged S and
    G = 2, with an initial state and a final-state gradient:
    every gradient within 1e-4 of the float64 plain backward's largest
    magnitude, one launch counted a call, and two calls bit-identical."""
    args, dy, ds = _ssd_bwd_case(s * n + p, b, s, h, p, g, n)
    want = sk.ssd_backward_plain(*_f64_on(cuda, (*args, dy, ds)))
    before = sk.LAUNCHES["ssd_backward"]
    got = _ssd_bwd_kernel(args, dy, ds, cuda)
    again = _ssd_bwd_kernel(args, dy, ds, cuda)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["ssd_backward"] == before + 2
    _assert_ssd_grads(got, want)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.gpu
def test_ssd_autograd_launches_the_backward_kernel(cuda):
    """``torch.autograd.grad`` through ``ssd`` on the card, x, B and C the
    strided views of one convolution output as the model hands them
    over, the skip term and an initial state: one forward and one
    backward launch, the gradients of the buffer, dt, a, D and the
    initial state within 1e-4 of the CPU's plain route; repeated, bit for
    bit."""
    (x, dt, a, bm, cm, d, st0), dy, ds = _ssd_bwd_case(10, 2, 150, 4, 16, 2,
                                                       16)
    conv = torch.cat([x.reshape(2, 150, 64), bm.reshape(2, 150, 32),
                      cm.reshape(2, 150, 32)], dim=-1)

    def grads(dev):
        leaves = [t.to(dev).requires_grad_(True)
                  for t in (conv, dt, a, d, st0)]
        c_ = leaves[0]
        y, state = sk.ssd(c_[..., :64].reshape(2, 150, 4, 16), leaves[1],
                          leaves[2], c_[..., 64:96].reshape(2, 150, 2, 16),
                          c_[..., 96:].reshape(2, 150, 2, 16), leaves[3],
                          init_state=leaves[4])
        return torch.autograd.grad((y, state), leaves,
                                   (dy.to(dev), ds.to(dev)))

    want = grads("cpu")
    sk.reset_launch_counts()
    got = grads(cuda)
    assert sk.LAUNCHES == {"ssd": 1, "ssd_backward": 1}
    again = grads(cuda)
    for g, w, a_ in zip(got, want, again):
        assert _rel_to_max(g, w) <= 1e-4
        assert torch.equal(g, a_)
