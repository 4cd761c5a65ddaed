"""The port's replay buffers (``repro_torch.hltrain.buffers``) against
``repro.hltrain.buffers``.

Every buffer case of ``tests/test_hltrain.py`` runs on both packages
(the hypothesis property included), and the two are held together on the
same inputs: ring writes that wrap and masked writes bit-equal (every
field, cursor and size), ``hash_state_action`` bit-equal on random
states with negative features, the sorted membership test equal to the
reference's dense compare (unwritten slots, duplicate keys, a wrapped
ring), uniform draws bit-equal, prioritized draws' indices equal and
their weights within 1e-6, priority updates within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.hltrain import buffers as ref
from repro_torch import convert
from repro_torch.hltrain import buffers as port

CPU = torch.device("cpu")
PKGS = ("reference", "port")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tensors this small gain nothing from intra-op threads, whose idle
    pool spins on the cores that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x, dtype=dtype))


def _key(seed):
    k = jax.random.PRNGKey(seed)
    return k, convert.key_from_data(np.asarray(k), CPU)


def _ring_arrays(buf):
    """A ring's fields as numpy, the port's trash row dropped."""
    if isinstance(buf, port.Ring):
        return {f: (getattr(buf, f)[:-1] if getattr(buf, f).dim() else
                    getattr(buf, f)).numpy() for f in buf._fields}
    return {f: np.asarray(getattr(buf, f)) for f in buf._fields}


def _assert_rings_equal(got, want):
    g, w = _ring_arrays(got), _ring_arrays(want)
    for f in w:
        np.testing.assert_array_equal(g[f], w[f], err_msg=f)


# ------------------------------------------- tests/test_hltrain.py's cases
class _Ops:
    """One package's buffer API on numpy inputs, for the shared cases."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.mod = ref if pkg == "reference" else port

    def arr(self, x, dtype=None):
        x = np.array(x, dtype)
        if self.pkg == "reference":
            return jnp.asarray(x)
        return torch.as_tensor(x)

    def key(self, seed):
        return _key(seed)[self.pkg == "port"]

    def init(self, name, cap, dim):
        fn = getattr(self.mod, name)
        return fn(cap, dim) if self.pkg == "reference" else fn(cap, dim, CPU)

    def host(self, x):
        return np.asarray(x) if self.pkg == "reference" else x.numpy()


@pytest.mark.parametrize("pkg", PKGS)
def test_ring_buffer_wraparound_and_masked_writes(pkg):
    o = _Ops(pkg)
    buf = o.init("ring_init", 8, 2)
    s = o.arr(np.arange(12, dtype=np.float32).reshape(6, 2))
    a, r, done = o.arr(np.arange(6)), o.arr(np.arange(6), np.float32), \
        o.arr(np.zeros(6), np.float32)
    buf = o.mod.ring_add(buf, s, a, r, s, done)
    assert int(buf.size) == 6 and int(buf.ptr) == 6
    # masked write: only rows 0 and 2 land, at consecutive slots 6, 7
    mask = o.arr([True, False, True, False, False, False])
    buf = o.mod.ring_add(buf, s + 100, a + 10, r, s, done, mask=mask)
    assert int(buf.size) == 8 and int(buf.ptr) == 0
    np.testing.assert_array_equal(o.host(buf.a[6:8]), [10, 12])
    # wraparound: the next write overwrites slot 0
    buf = o.mod.ring_add(buf, s[:1], o.arr([99]), r[:1], s[:1], done[:1])
    assert int(buf.a[0]) == 99 and int(buf.size) == 8 and int(buf.ptr) == 1


@pytest.mark.parametrize("pkg", PKGS)
def test_ring_add_rejects_batch_wider_than_capacity(pkg):
    o = _Ops(pkg)
    buf = o.init("ring_init", 4, 2)
    x = o.arr(np.zeros((5, 2)), np.float32)
    z = o.arr(np.zeros(5), np.float32)
    with pytest.raises(ValueError, match="exceeds buffer capacity"):
        o.mod.ring_add(buf, x, o.arr(np.zeros(5), np.int32), z, x, z)


def _fill_prio(o, cap=64, dim=3, n=5):
    buf = o.init("prio_init", cap, dim)
    for i in range(n):  # 4 rows each
        x = o.arr(np.full((4, dim), float(i)), np.float32)
        buf = o.mod.prio_add(buf, x, o.arr(np.full(4, i), np.int32),
                             o.arr(np.zeros(4), np.float32), x,
                             o.arr(np.zeros(4), np.float32))
    return buf


@pytest.mark.parametrize("pkg", PKGS)
def test_prio_sample_only_written_slots(pkg):
    o = _Ops(pkg)
    buf = _fill_prio(o)
    key = jax.random.PRNGKey(0)
    for _ in range(20):
        key, k = jax.random.split(key)
        k = k if pkg == "reference" else convert.key_from_data(
            np.asarray(k), CPU)
        _, idx, w = o.mod.prio_sample(buf, k, 16)
        idx, w = o.host(idx), o.host(w)
        assert np.all(idx < int(buf.ring.size))
        assert np.all(w > 0) and np.all(w <= 1 + 1e-6)


@pytest.mark.parametrize("pkg", PKGS)
def test_prio_update_shifts_sampling(pkg):
    o = _Ops(pkg)
    buf = o.init("prio_init", 32, 1)
    x = o.arr(np.zeros((16, 1)), np.float32)
    z = o.arr(np.zeros(16), np.float32)
    buf = o.mod.prio_add(buf, x, o.arr(np.arange(16), np.int32), z, x, z)
    # give slot 3 overwhelming priority
    buf = o.mod.prio_update(buf, o.arr(np.arange(16)),
                            o.arr(np.where(np.arange(16) == 3, 1e4, 1e-3),
                                  np.float32))
    _, idx, _ = o.mod.prio_sample(buf, o.key(1), 4)
    assert 3 in o.host(idx)


@pytest.mark.parametrize("pkg", PKGS)
def test_plan_buffer_novelty_dedupe(pkg):
    o = _Ops(pkg)
    buf = o.init("plan_init", 32, 4)
    s = o.arr(np.ones((3, 4)) * np.arange(3)[:, None], np.float32)
    a = o.arr([0, 1, 0], np.int32)
    z = o.arr(np.zeros(3), np.float32)
    h = o.mod.hash_state_action(s, a)
    assert not bool(o.mod.plan_contains(buf, h).any())
    buf = o.mod.plan_add(buf, h, s, a, z, s, z)
    assert bool(o.mod.plan_contains(buf, h).all())
    # a distinct action at the same state is novel; the same (s, a) is not
    h2 = o.mod.hash_state_action(s, a + 5)
    assert not bool(o.mod.plan_contains(buf, h2).any())
    # a masked add skips non-novel rows: the size does not grow
    before = int(buf.buf.ring.size)
    buf = o.mod.plan_add(buf, h, s, a, z, s, z,
                         mask=~o.mod.plan_contains(buf, h))
    assert int(buf.buf.ring.size) == before


@pytest.mark.parametrize("pkg", PKGS)
def test_hash_state_action_discriminates(pkg):
    o = _Ops(pkg)
    rng = np.random.default_rng(0)
    s = o.arr(rng.random((256, 28)), np.float32)
    h0 = o.host(o.mod.hash_state_action(s, o.arr(np.zeros(256), np.int32)))
    h1 = o.host(o.mod.hash_state_action(s, o.arr(np.ones(256), np.int32)))
    assert len(np.unique(h0)) == 256  # distinct states
    assert not np.any(h0 == h1)       # the action is folded in
    # quantization: states equal to 3 decimals collide (by design)
    h2 = o.host(o.mod.hash_state_action(
        s + 1e-6, o.arr(np.zeros(256), np.int32)))
    assert np.mean(h2 == h0) > 0.9


try:
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=25, deadline=None)
    @given(st.integers(1, 40), st.integers(0, 2 ** 31 - 1))
    def test_property_prio_never_samples_unwritten(n_adds, seed):
        """Neither package's prioritized buffer samples an unwritten slot
        once ``batch`` slots are written, and both draw the same
        indices."""
        bufs = {pkg: _Ops(pkg).init("prio_init", 64, 2) for pkg in PKGS}
        # the reference's add compiled once, not dispatched op by op
        adds = {"reference": jax.jit(ref.prio_add), "port": port.prio_add}
        key = jax.random.PRNGKey(seed)
        for i in range(n_adds):
            key, k1 = jax.random.split(key)
            x = np.asarray(jax.random.uniform(k1, (2, 2)))
            for pkg, buf in bufs.items():
                o = _Ops(pkg)
                xs = o.arr(x)
                bufs[pkg] = adds[pkg](
                    buf, xs, o.arr(np.full(2, i % 10), np.int32),
                    o.arr(np.zeros(2), np.float32), xs,
                    o.arr(np.zeros(2), np.float32))
        size = int(bufs["port"].ring.size)
        assert size == int(bufs["reference"].ring.size)
        batch = 8
        if size >= batch:
            key, k2 = jax.random.split(key)
            idx = {}
            for pkg, buf in bufs.items():
                o = _Ops(pkg)
                k = k2 if pkg == "reference" else convert.key_from_data(
                    np.asarray(k2), CPU)
                _, i_, w = o.mod.prio_sample(buf, k, batch)
                idx[pkg] = o.host(i_)
                assert np.all(idx[pkg] < size)
                assert np.all(np.isfinite(o.host(w)))
            np.testing.assert_array_equal(idx["port"], idx["reference"])
except ImportError:  # pragma: no cover - hypothesis is optional
    pass


# ------------------------------------------------ the two packages together
def _batch(rng, n, dim):
    s = rng.normal(size=(n, dim)).astype(np.float32)
    return (s, rng.integers(0, 5, n).astype(np.int32),
            rng.normal(size=n).astype(np.float32),
            rng.normal(size=(n, dim)).astype(np.float32),
            (rng.random(n) < 0.3).astype(np.float32))


def test_ring_writes_wrap_and_mask_bit_equal():
    """Full and masked batched writes that wrap the ring several times
    leave every field, the cursor and the size as the reference's."""
    rng = np.random.default_rng(1)
    cap, dim = 37, 5
    r_buf, p_buf = ref.ring_init(cap, dim), port.ring_init(cap, dim, CPU)
    for step in range(12):
        # from one row to the whole ring, in a few widths: every new width
        # recompiles the reference's eager ops
        n = int(rng.choice((1, 11, 29, cap)))
        b = _batch(rng, n, dim)
        mask = None if step % 3 == 0 else rng.random(n) < 0.6
        r_buf = ref.ring_add(r_buf, *map(jnp.asarray, b),
                             mask=None if mask is None else jnp.asarray(mask))
        p_buf = port.ring_add(p_buf, *map(torch.as_tensor, b),
                              mask=None if mask is None else
                              torch.as_tensor(mask))
        _assert_rings_equal(p_buf, r_buf)
    # uniform draws: the same indices and rows
    for seed in range(4):
        rk, pk = _key(seed)
        (r_rows, r_idx), (p_rows, p_idx) = (ref.ring_sample(r_buf, rk, 64),
                                            port.ring_sample(p_buf, pk, 64))
        np.testing.assert_array_equal(p_idx.numpy(), np.asarray(r_idx))
        for g, w in zip(p_rows, r_rows):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_prio_buffer_matches_reference():
    """Writes, prioritized draws and priority updates of a wrapped
    prioritized ring: integers and priorities as the reference's, drawn
    indices equal, weights within 1e-6."""
    rng = np.random.default_rng(2)
    cap, dim, batch = 300, 4, 32
    r_buf, p_buf = ref.prio_init(cap, dim), port.prio_init(cap, dim, CPU)
    key = jax.random.PRNGKey(7)
    for step in range(10):
        b = _batch(rng, 64, dim)
        mask = rng.random(64) < 0.8 if step % 2 else None
        r_buf = ref.prio_add(r_buf, *map(jnp.asarray, b),
                             mask=None if mask is None else jnp.asarray(mask))
        p_buf = port.prio_add(p_buf, *map(torch.as_tensor, b),
                              mask=None if mask is None else
                              torch.as_tensor(mask))
        key, k = jax.random.split(key)
        _, r_idx, r_w = ref.prio_sample(r_buf, k, batch)
        _, p_idx, p_w = port.prio_sample(
            p_buf, convert.key_from_data(np.asarray(k), CPU), batch)
        np.testing.assert_array_equal(p_idx.numpy(), np.asarray(r_idx))
        np.testing.assert_allclose(p_w.numpy(), np.asarray(r_w), atol=1e-6,
                                   rtol=0)
        td = rng.normal(size=batch).astype(np.float32) * 3
        upd = rng.random(batch) < 0.7
        r_buf = ref.prio_update(r_buf, r_idx, jnp.asarray(td),
                                mask=jnp.asarray(upd))
        p_buf = port.prio_update(p_buf, p_idx, torch.as_tensor(td),
                                 mask=torch.as_tensor(upd))
        _assert_rings_equal(p_buf.ring, r_buf.ring)
        np.testing.assert_allclose(p_buf.prio[:-1].numpy(),
                                   np.asarray(r_buf.prio), atol=1e-6, rtol=0)
        np.testing.assert_allclose(float(p_buf.max_prio),
                                   float(r_buf.max_prio), atol=1e-6, rtol=0)


def test_hash_state_action_bit_equal_with_negative_features():
    rng = np.random.default_rng(3)
    for dim in (1, 8, 28, 33):
        s = (rng.normal(size=(512, dim)) * 3).astype(np.float32)
        # exact .5 thousandths: round half to even in both packages
        s[:8, 0] = np.array([0.0005, -0.0005, 0.0015, -0.0025, 2.5e-3,
                             -1.0, 4.2, -7.3], np.float32)
        a = rng.integers(0, 5, 512).astype(np.int32)
        want = np.asarray(ref.hash_state_action(jnp.asarray(s),
                                                jnp.asarray(a)))
        got = port.hash_state_action(torch.as_tensor(s), torch.as_tensor(a))
        assert want.dtype == np.uint32
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
        assert got.min() >= 0 and got.max() < 2 ** 32


@pytest.mark.parametrize("case", ["empty", "partial", "duplicates",
                                  "wrapped"])
def test_sorted_membership_equals_dense_compare(case):
    """``plan_contains`` (sorted keys + binary search) gives the
    reference's dense-compare booleans: unwritten slots (whose stale keys
    must not count), duplicate keys, a wrapped ring."""
    rng = np.random.default_rng(4)
    cap, dim = 64, 3
    r_buf, p_buf = ref.plan_init(cap, dim), port.plan_init(cap, dim, CPU)
    writes = {"empty": [], "partial": [20], "duplicates": [16, 16, 16],
              "wrapped": [40, 40, 40]}[case]
    states = rng.integers(-3, 4, size=(40, dim)).astype(np.float32) / 10
    for n in writes:
        pick = rng.integers(0, 12 if case == "duplicates" else 40, n)
        s, a = states[pick], rng.integers(0, 2, n).astype(np.int32)
        z = np.zeros(n, np.float32)
        h = ref.hash_state_action(jnp.asarray(s), jnp.asarray(a))
        r_buf = ref.plan_add(r_buf, h, *map(jnp.asarray, (s, a, z, s, z)))
        p_buf = port.plan_add(
            p_buf, port.hash_state_action(torch.as_tensor(s),
                                          torch.as_tensor(a)),
            *map(torch.as_tensor, (s, a, z, s, z)))
    np.testing.assert_array_equal(p_buf.keys[:-1].numpy().astype(np.uint32),
                                  np.asarray(r_buf.keys))
    q_s = states[rng.integers(0, 40, 200)]
    q_a = rng.integers(0, 2, 200).astype(np.int32)
    # one query key equal to a stale, unwritten slot's key (0) and the
    # largest uint32 key
    h_ref = np.asarray(ref.hash_state_action(jnp.asarray(q_s),
                                             jnp.asarray(q_a)))
    h_ref = np.concatenate([h_ref, np.array([0, 2 ** 32 - 1], np.uint32)])
    want = np.asarray(ref.plan_contains(r_buf, jnp.asarray(h_ref)))
    got = port.plan_contains(p_buf, torch.as_tensor(h_ref.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)
    if case != "empty":
        assert want.any() and not want.all()
