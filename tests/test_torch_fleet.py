"""The port's latency model and FleetEnv against the reference.

* ``response_times`` against the numpy ``repro.env.latency_model`` in
  float64 at 1e-5 (and in float32, the serving dtype, at 1e-6 relative).
* ``round_metrics`` against ``repro.fleet.latency.round_metrics`` at
  1e-5: quiet and with busy flags and background, unmasked and masked,
  with a cell whose mask is all false.
* ``random_fleet`` bit-equal to the reference's from the same key, at
  7, 1,000 and 65,536 cells.
* ``observe`` / ``step`` against ``repro.fleet.env.make_fleet_env`` for
  every ported spec variant, with and without the shared-cloud /
  shared-edge couplings, with background noise on: the same scenario,
  key and actions give observations, rewards and per-slot ``times``
  within 1e-5 and identical ``done`` and actions.
"""
import jax
import numpy as np
import pytest
import torch

from repro.env import latency_model as ref_lm
from repro.fleet.env import FleetConfig as RefFleetConfig
from repro.fleet.env import make_fleet_env as ref_make_fleet_env
from repro.fleet.latency import round_metrics as ref_round_metrics
from repro.fleet.workload import random_fleet as ref_random_fleet
from repro_torch import convert
from repro_torch import random as rnd
from repro_torch.fleet import latency
from repro_torch.fleet.env import FleetConfig, make_fleet_env
from repro_torch.fleet.workload import random_fleet

CPU = torch.device("cpu")


def _random_rounds(seed, c, n):
    rng = np.random.default_rng(seed)
    return dict(
        actions=rng.integers(0, ref_lm.N_ACTIONS, (c, n)),
        weak_s=rng.random((c, n)) < 0.4, weak_e=rng.random(c) < 0.4,
        busy_p_s=rng.random((c, n)) < 0.3, busy_m_s=rng.random((c, n)) < 0.3,
        busy_m_e=rng.random(c) < 0.3, busy_m_c=rng.random(c) < 0.3,
        bg_edge=rng.integers(0, 3, c), bg_cloud=rng.integers(0, 3, c))


def _port_times(x, dtype):
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    for k in ("actions", "bg_edge", "bg_cloud"):
        t[k] = t[k].to(torch.int32)
    mask = torch.ones_like(t["weak_s"])
    return latency.response_times(
        t["actions"], t["weak_s"], t["weak_e"], t["busy_p_s"],
        t["busy_m_s"], t["busy_m_e"], t["busy_m_c"], t["bg_edge"],
        t["bg_cloud"], mask, dtype=dtype).numpy()


def _ref_times(x):
    return np.stack([ref_lm.response_times(
        x["actions"][i], x["weak_s"][i], bool(x["weak_e"][i]),
        busy_p_s=x["busy_p_s"][i], busy_m_s=x["busy_m_s"][i],
        busy_m_e=bool(x["busy_m_e"][i]), busy_m_c=bool(x["busy_m_c"][i]),
        bg_edge=int(x["bg_edge"][i]), bg_cloud=int(x["bg_cloud"][i]))
        for i in range(len(x["weak_e"]))])


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 5), (2, 8)])
def test_response_times_match_numpy_reference(seed, n):
    x = _random_rounds(seed, 400, n)
    want = _ref_times(x)
    np.testing.assert_allclose(_port_times(x, torch.float64), want,
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(_port_times(x, torch.float32), want,
                               rtol=1e-6)


def test_masked_slots_add_no_time_or_contention():
    x = _random_rounds(3, 50, 5)
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    mask = torch.zeros(50, 5, dtype=torch.bool)
    mask[:, :3] = True
    got = latency.response_times(
        t["actions"].int(), t["weak_s"], t["weak_e"], t["busy_p_s"],
        t["busy_m_s"], t["busy_m_e"], t["busy_m_c"], t["bg_edge"].int(),
        t["bg_cloud"].int(), mask)
    assert (got[:, 3:] == 0).all()
    x3 = {k: (v[:, :3] if np.ndim(v) == 2 else v) for k, v in x.items()}
    np.testing.assert_allclose(got[:, :3].numpy(), _ref_times(x3),
                               rtol=1e-6)


@pytest.mark.parametrize("masked,busy", [(False, False), (False, True),
                                          (True, False), (True, True)])
def test_round_metrics_match_reference(masked, busy):
    """(ART, accuracy) over each cell's real slots, with the reference's
    quiet defaults where no busy flag or background is given; a masked
    run holds one cell with no real slot, which reads 0."""
    x = _random_rounds(4 + 2 * masked + busy, 60, 6)
    rng = np.random.default_rng(9)
    mask = rng.random((60, 6)) < 0.6 if masked else None
    if masked:
        mask[7] = False
    names = (("busy_p_s", "busy_m_s", "busy_m_e", "busy_m_c", "bg_edge",
              "bg_cloud") if busy else ())
    bg = {k: x[k] for k in names}
    args = (x["actions"], x["weak_s"], x["weak_e"])

    def one(i):
        return ref_round_metrics(
            *(np.asarray(a[i]) for a in args),
            mask=None if mask is None else mask[i],
            **{k: np.asarray(v[i]) for k, v in bg.items()})

    want = np.array([[float(v) for v in one(i)] for i in range(60)])
    t = lambda v: torch.as_tensor(v).to(
        torch.int32 if v.dtype.kind in "iu" else torch.bool)
    got = latency.round_metrics(
        *(t(a) for a in args), mask=None if mask is None else t(mask),
        **{k: t(v) for k, v in bg.items()})
    assert all(g.dtype == torch.float32 and g.shape == (60,) for g in got)
    np.testing.assert_allclose(torch.stack(got, -1).numpy(), want,
                               atol=1e-5, rtol=1e-6)
    if masked:
        assert got[0][7] == 0 and got[1][7] == 0


def test_action_accuracy_matches_reference():
    a = torch.arange(ref_lm.N_ACTIONS)
    np.testing.assert_allclose(latency.action_accuracy(a).numpy(),
                               ref_lm.action_accuracy(a.numpy()),
                               rtol=1e-6)


def test_random_fleet_shapes_and_ranges():
    key = rnd.PRNGKey(3, CPU)
    scn = random_fleet(key, 64, n_max=5, cells_per_edge=4)
    assert scn.weak_s.shape == (64, 5) and scn.weak_s.dtype == torch.bool
    assert scn.n_users.dtype == torch.int32
    assert int(scn.n_users.min()) >= 2 and int(scn.n_users.max()) <= 5
    assert (scn.edge_group == torch.arange(64) // 4).all()
    assert scn.device == CPU
    again = random_fleet(key, 64, n_max=5, cells_per_edge=4)
    assert all(torch.equal(getattr(scn, f), getattr(again, f))
               for f in scn._fields if f != "group_index")
    # the fleet carries its group index, built from its edge groups
    assert scn.group_index.groups is scn.edge_group
    assert torch.equal(scn.group_index.members,
                       torch.arange(64, dtype=torch.int32))
    assert (scn.group_index.n_groups, scn.group_index.max_size) == (16, 4)


@pytest.mark.parametrize("cells", [7, 1000, 65_536])
def test_random_fleet_matches_reference(cells):
    """Every field bit-equal to the reference's fleet from the same key."""
    for seed in (0, 3):
        k = jax.random.split(jax.random.PRNGKey(seed), 4)[0]
        want = ref_random_fleet(k, cells, n_max=5, cells_per_edge=4)
        got = random_fleet(convert.key_from_data(np.asarray(k), CPU), cells,
                           n_max=5, cells_per_edge=4)
        assert got.group_index is not None
        for name in want._fields:
            g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(
                g.view(np.uint32) if g.dtype == np.float32 else g,
                w.view(np.uint32) if w.dtype == np.float32 else w, name)


# ------------------------------------------------------------ env parity
# every ported spec variant, and each coupling off, on its own and
# together with the other (they feed every spec's occupancy features)
CASES = [("base", False, False), ("contention", True, True),
         ("constraint", True, False), ("full", False, True)]


def _assert_close(got, want, name, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               atol=tol, rtol=0, err_msg=name)


@pytest.mark.parametrize("spec,shared_cloud,shared_edge", CASES)
def test_env_matches_reference(spec, shared_cloud, shared_edge):
    c, n_max, steps = 12, 4, 9
    ref_scn = ref_random_fleet(jax.random.PRNGKey(5), c, n_max=n_max,
                               cells_per_edge=3)
    kw = dict(n_max=n_max, obs_spec=spec, shared_cloud=shared_cloud,
              shared_edge=shared_edge)
    ref_env = ref_make_fleet_env(RefFleetConfig(**kw))
    env = make_fleet_env(FleetConfig(**kw))
    scn = convert.fleet_scenario(ref_scn, CPU)
    ref_key = jax.random.PRNGKey(11)
    ref_st = ref_env.init(ref_key, ref_scn)
    st = env.init(convert.key_from_data(np.asarray(ref_key), CPU), scn)
    _assert_close(env.observe(scn, st), ref_env.observe(ref_scn, ref_st),
                  "obs0")
    acts = np.random.default_rng(7).integers(
        0, ref_lm.N_ACTIONS, (steps, c)).astype(np.int32)
    # one compiled reference scan over the steps (its per-step outputs
    # are exactly ``step``'s), against the port stepping one at a time
    ref_st, traj = ref_env.rollout(ref_scn, ref_st, acts)
    for t in range(steps):
        st, obs, r, done, info = env.step(scn, st, torch.as_tensor(acts[t]))
        _assert_close(obs, traj["obs"][t], f"obs@{t}")
        _assert_close(r, traj["reward"][t], f"reward@{t}")
        _assert_close(info["times"], traj["times"][t], f"times@{t}")
        _assert_close(info["art"], traj["art"][t], f"art@{t}")
        for name in ("actions", "violated"):
            np.testing.assert_array_equal(info[name].numpy(),
                                          np.asarray(traj[name][t]), name)
        np.testing.assert_array_equal(done.numpy(),
                                      np.asarray(traj["done"][t]))
    np.testing.assert_array_equal(st.key.numpy(), np.asarray(ref_st.key))
    for name, v in st.bg._asdict().items():
        np.testing.assert_array_equal(
            v.numpy(), np.asarray(getattr(ref_st.bg, name)), name)


def test_rollout_matches_stepping():
    cfg = FleetConfig(n_max=4, obs_spec="full", shared_edge=True)
    env = make_fleet_env(cfg)
    scn = random_fleet(rnd.PRNGKey(1, CPU), 8, n_max=4, cells_per_edge=2)
    st0 = env.init(torch.tensor([0, 3]), scn)
    acts = torch.randint(0, 10, (5, 8), generator=torch.Generator()
                         .manual_seed(0), dtype=torch.int32)
    st_r, traj = env.rollout(scn, st0, acts)
    st = st0
    for t in range(5):
        st, obs, r, done, _ = env.step(scn, st, acts[t])
        assert torch.equal(traj["obs"][t], obs)
        assert torch.equal(traj["reward"][t], r)
    assert torch.equal(st.actions, st_r.actions)


@pytest.mark.parametrize("spec,shared_cloud,shared_edge", CASES)
def test_transition_is_step_without_the_observation(spec, shared_cloud,
                                                    shared_edge):
    """``transition`` gives ``step``'s state, reward, done and info bit
    for bit, and ``step``'s observation is ``observe`` of that state."""
    kw = dict(n_max=4, obs_spec=spec, shared_cloud=shared_cloud,
              shared_edge=shared_edge)
    env = make_fleet_env(FleetConfig(**kw))
    scn = random_fleet(rnd.PRNGKey(2, CPU), 12, n_max=4, cells_per_edge=3)
    st = env.init(rnd.PRNGKey(9, CPU), scn)
    acts = torch.as_tensor(np.random.default_rng(3).integers(
        0, ref_lm.N_ACTIONS, (6, 12)).astype(np.int32))
    for a in acts:
        st_s, obs, r_s, done_s, info_s = env.step(scn, st, a)
        st_t, r_t, done_t, info_t = env.transition(scn, st, a)
        for x, y in zip(st_s[:4] + tuple(st_s.bg), st_t[:4] + tuple(st_t.bg)):
            assert torch.equal(x, y)
        assert torch.equal(r_s, r_t) and torch.equal(done_s, done_t)
        assert info_s.keys() == info_t.keys()
        assert all(torch.equal(info_s[k], info_t[k]) for k in info_s)
        assert torch.equal(obs, env.observe(scn, st_t))
        st = st_s


def test_env_needs_the_group_index_once():
    """``observe`` and ``transition`` read the edge groups from the
    scenario's index and raise without one; ``rollout`` builds it once."""
    env = make_fleet_env(FleetConfig(n_max=4, obs_spec="full",
                                     shared_edge=True))
    scn = random_fleet(rnd.PRNGKey(1, CPU), 8, n_max=4, cells_per_edge=2)
    bare = scn._replace(group_index=None)
    st = env.init(rnd.PRNGKey(0, CPU), scn)
    acts = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="group index"):
        env.observe(bare, st)
    with pytest.raises(ValueError, match="group index"):
        env.transition(bare, st, acts[0])
    _, traj = env.rollout(bare, st, acts)
    _, want = env.rollout(scn, st, acts)
    assert all(torch.equal(traj[k], want[k]) for k in want)
