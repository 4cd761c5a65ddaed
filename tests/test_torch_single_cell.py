"""The port's single-cell MDP (``repro_torch.env.edge_cloud``), its numpy
observation encoder, the exact optimum, the replay buffers of Algorithm
1 and the Intelligent Orchestrator against the reference's.

* **Encoder.**  ``ObservationSpec.encode_np`` gives the reference's
  float32 row byte for byte, for every spec variant over 1,000 random
  single-cell states each (float64 arithmetic, one cast at the end).
* **Env.**  From one seed, 200 rounds of seeded random actions give the
  same observation bytes, rewards, done flags and info dicts, and the
  same numpy stream state; forks taken along the way replay the same
  streams.  ``rollout_greedy`` restores the env's round and config.
* **Optimum.**  ``brute_force_optimal`` and ``decision_string`` equal
  the reference's for the four scenarios at 89% and Min with 3 users,
  and at A/89% with 5 users (the paper's 269.8 ms).
* **Buffers.**  The same adds and seeds sample the same indices and
  weights bit for bit (uniform, prioritized with updated priorities,
  and the plan buffer's membership with refresh and ring eviction).
* **Orchestrator.**  ``decide_round`` from the reference's initial DQN,
  carried across, equals the reference's decisions.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import mobilenet_pool as ref_pool
from repro.core import replay as ref_replay
from repro.core.dqn import make_dqn as ref_make_dqn
from repro.core.orchestrator import IntelligentOrchestrator as RefOrch
from repro.env import edge_cloud as ref_ec
from repro.env import latency_model as ref_lm
from repro.env.scenarios import CONSTRAINTS as REF_CONSTRAINTS
from repro.env.scenarios import SCENARIOS as REF_SCENARIOS
from repro.policy.adapters import dqn_policy as ref_dqn_policy
from repro.policy.adapters import qtable_policy as ref_qtable_policy
from repro.policy.api import act_single as ref_act_single
from repro.specs import observation as ref_obs
from repro_torch import convert
from repro_torch.configs import mobilenet_pool
from repro_torch.core import replay
from repro_torch.core.orchestrator import (IntelligentOrchestrator,
                                           variant_pool_from_roofline)
from repro_torch.env import edge_cloud as ec
from repro_torch.env import latency_model as lm
from repro_torch.env.scenarios import CONSTRAINTS, SCENARIOS
from repro_torch.fleet import env as fleet_env
from repro_torch.policy.adapters import (dqn_policy, obs_table_key,
                                         qtable_policy)
from repro_torch.policy.api import act_single
from repro_torch.specs import observation as obs_spec

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tensors this small gain nothing from intra-op threads, whose idle
    pool spins on the cores that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(n=3, scenario="A", constraint="89%", seed=0, **kw):
    return (ref_ec.EnvConfig(REF_SCENARIOS[scenario],
                             REF_CONSTRAINTS[constraint], n_users=n,
                             seed=seed, **kw),
            ec.EnvConfig(SCENARIOS[scenario], CONSTRAINTS[constraint],
                         n_users=n, seed=seed, **kw))


def _assert_info_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v)
            assert got[k].dtype == v.dtype
        else:
            assert got[k] == v and type(got[k]) is type(v), k


# ----------------------------------------------------------- latency model
def test_latency_constants_match_the_reference():
    for name in ("MODELS", "N_MODELS", "T_EDGE_D0", "T_CLOUD_D0",
                 "WEAK_S_PENALTY", "WEAK_E_EDGE", "WEAK_E_CLOUD",
                 "BUSY_CPU_LOCAL", "BUSY_MEM", "N_ACTIONS", "A_EDGE",
                 "A_CLOUD"):
        assert getattr(lm, name) == getattr(ref_lm, name), name
    for name in ("ACCURACY", "T_LOCAL"):
        np.testing.assert_array_equal(getattr(lm, name),
                                      getattr(ref_lm, name))
    assert (fleet_env.PENALTY_BASE, fleet_env.PENALTY_PER_PCT,
            fleet_env.REWARD_SCALE) == (ec.PENALTY_BASE,
                                        ec.PENALTY_PER_PCT, ec.REWARD_SCALE)
    assert (ec.PENALTY_BASE, ec.PENALTY_PER_PCT, ec.REWARD_SCALE) == (
        ref_ec.PENALTY_BASE, ref_ec.PENALTY_PER_PCT, ref_ec.REWARD_SCALE)


def test_round_metrics_match_the_reference():
    rng = np.random.default_rng(0)
    for _ in range(300):
        n = int(rng.integers(1, 6))
        a = rng.integers(0, lm.N_ACTIONS, n)
        weak_s = rng.random(n) < 0.4
        weak_e = bool(rng.random() < 0.5)
        bg = dict(busy_p_s=rng.random(n) < 0.3, busy_m_s=rng.random(n) < 0.3,
                  busy_m_e=bool(rng.random() < 0.3),
                  busy_m_c=bool(rng.random() < 0.3),
                  bg_edge=int(rng.integers(0, 2)),
                  bg_cloud=int(rng.integers(0, 2)))
        assert lm.round_metrics(a, weak_s, weak_e, **bg) == \
            ref_lm.round_metrics(a, weak_s, weak_e, **bg)


def test_mobilenet_pool_matches_the_reference():
    assert [dataclasses.astuple(v) for v in mobilenet_pool.pool()] == \
        [dataclasses.astuple(v) for v in ref_pool.pool()]
    assert mobilenet_pool.tiers() == ref_pool.tiers()


# ----------------------------------------------------------------- encoder
def _random_inputs(rng, n_max: int, econ: bool) -> dict:
    n = int(rng.integers(1, n_max + 1))
    flags = lambda: rng.random(n_max) < 0.5
    out = dict(
        user=int(rng.integers(0, n)), n_users=n, busy_p_s=flags(),
        busy_m_s=flags(), weak_s=flags(),
        weak_e=bool(rng.random() < 0.5), busy_m_e=bool(rng.random() < 0.5),
        busy_m_c=bool(rng.random() < 0.5),
        k_edge=int(rng.integers(0, 12)), k_cloud=int(rng.integers(0, 12)),
        acc_sum=float(lm.action_accuracy(
            rng.integers(0, lm.N_ACTIONS, int(rng.integers(0, n + 1)))).sum()),
        cloud_fleet=float(rng.random() * 12), edge_group=float(
            rng.random() * 12),
        constraint=float(rng.choice(list(CONSTRAINTS.values()))),
        latency_target=float(rng.choice(obs_spec.LATENCY_TARGET_POOL)))
    if econ:
        out.update(econ_state=rng.integers(0, 3, 3),
                   econ_warm_ticks=rng.integers(0, 100, 3),
                   econ_price=rng.random(3) * 0.02)
    return out


@pytest.mark.parametrize("name", obs_spec.SPEC_NAMES)
def test_encode_np_bytes_match_the_reference(name):
    rng = np.random.default_rng(len(name))
    for i in range(1000):
        n_max = int(rng.integers(1, 9))
        x = _random_inputs(rng, n_max, econ=bool(i % 2))
        got = obs_spec.make_spec(name, n_max).encode_np(obs_spec.ObsInputs(**x))
        want = ref_obs.make_spec(name, n_max).encode_np(ref_obs.ObsInputs(**x))
        assert got.dtype == np.float32 and got.shape == want.shape
        assert got.tobytes() == want.tobytes(), (name, x)


# --------------------------------------------------------------------- env
@pytest.mark.parametrize("scenario,constraint,n,spec", [
    ("A", "89%", 3, "base"), ("B", "85%", 5, "full"),
    ("D", "Max", 4, "full_economy")])
def test_env_rounds_and_forks_match_the_reference(scenario, constraint, n,
                                                  spec):
    ref_cfg, cfg = _cfgs(n, scenario, constraint, seed=7, obs_spec=spec)
    ref, env = ref_ec.EdgeCloudEnv(ref_cfg), ec.EdgeCloudEnv(cfg)
    assert env.state_dim == ref.state_dim
    np.testing.assert_array_equal(env.observe(), ref.observe())
    acts = np.random.default_rng(1).integers(0, lm.N_ACTIONS, 200 * n)
    forks = []
    for t, a in enumerate(acts):
        if t % 37 == 0:
            forks.append((ref.fork(), env.fork()))
        got, want = env.step(int(a)), ref.step(int(a))
        assert got[0].tobytes() == want[0].tobytes()
        assert got[1] == want[1] and got[2] == want[2]
        _assert_info_equal(got[3], want[3])
    assert env.rng.bit_generator.state == ref.rng.bit_generator.state
    # each fork replays its own stream, apart from the parent's
    for i, (rf, pf) in enumerate(forks):
        for a in acts[:3 * n + i]:
            got, want = pf.step(int(a)), rf.step(int(a))
            assert got[0].tobytes() == want[0].tobytes()
            assert got[1] == want[1]
            _assert_info_equal(got[3], want[3])
        assert pf.rng.bit_generator.state == rf.rng.bit_generator.state


def test_rollout_greedy_matches_and_restores_the_env():
    ref_cfg, cfg = _cfgs(4, "C", "85%", seed=3)
    ref, env = ref_ec.EdgeCloudEnv(ref_cfg), ec.EdgeCloudEnv(cfg)
    for a in (2, 8):
        ref.step(a), env.step(a)
    before = (env.observe().tobytes(), env.rng.bit_generator.state, env.cfg)
    table = {}
    # a qtable policy whose rows send the quiet round's states to cloud
    # or edge: both packages' host-side adapters act on it
    probe = ec.EdgeCloudEnv(dataclasses.replace(cfg, quiet=True))
    for u in range(4):
        table[obs_table_key(probe.observe())] = np.eye(lm.N_ACTIONS)[8 + u % 2]
        probe.step(8 + u % 2)
    want = ref.rollout_greedy(ref_qtable_policy(), table)
    got = env.rollout_greedy(qtable_policy(), table)
    _assert_info_equal(got, want)
    assert list(got["actions"]) == [8, 9, 8, 9]
    assert (env.observe().tobytes(), env.rng.bit_generator.state,
            env.cfg) == before


def test_act_single_matches_the_reference_on_dqn_params():
    spec = ref_obs.make_spec("base", 3)
    params = ref_make_dqn(spec, lm.N_ACTIONS, hidden=(32, 32))[0](
        jax.random.PRNGKey(4)).params
    net = convert.mlp_from_layers(params, CPU)
    ref_pol = ref_dqn_policy(spec, hidden=(32, 32))
    pol = dqn_policy(obs_spec.make_spec("base", 3), hidden=(32, 32))
    rng = np.random.default_rng(0)
    for _ in range(200):
        obs = rng.random(spec.dim).astype(np.float32)
        got = act_single(pol, net, obs)
        assert isinstance(got, int)
        assert got == ref_act_single(ref_pol, params, obs)


# ----------------------------------------------------------------- optimum
@pytest.mark.parametrize("scenario,constraint,n", [
    *((s, c, 3) for s in "ABCD" for c in ("89%", "Min")), ("A", "89%", 5)])
def test_brute_force_optimum_matches_the_reference(scenario, constraint, n):
    got = ec.brute_force_optimal(SCENARIOS[scenario], CONSTRAINTS[constraint],
                                 n)
    want = ref_ec.brute_force_optimal(REF_SCENARIOS[scenario],
                                      REF_CONSTRAINTS[constraint], n)
    assert got["art"] == want["art"] and got["acc"] == want["acc"]
    np.testing.assert_array_equal(got["actions"], want["actions"])
    assert ec.decision_string(got["actions"]) == \
        ref_ec.decision_string(want["actions"])
    if (scenario, constraint, n) == ("A", "89%", 5):
        assert round(got["art"], 1) == 269.8
        assert sorted(ec.decision_string(got["actions"])) == \
            sorted(["d4, L"] * 4 + ["d0, E"])


# ----------------------------------------------------------------- buffers
def _transitions(rng, k: int, dim: int):
    for _ in range(k):
        yield (rng.random(dim).astype(np.float32),
               int(rng.integers(0, lm.N_ACTIONS)), float(rng.normal()),
               rng.random(dim).astype(np.float32), bool(rng.random() < 0.3))


def _assert_same_sample(got, want):
    (gb, gi, gw), (wb, wi, ww) = got, want
    np.testing.assert_array_equal(gi, wi)
    assert gw.tobytes() == ww.tobytes()
    for g, w in zip(gb, wb):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def _assert_same_rings(got, want):
    assert (got.n, got.ptr) == (want.n, want.ptr)
    for f in ("s", "a", "r", "s2", "done"):
        assert getattr(got, f).tobytes() == getattr(want, f).tobytes(), f
    if hasattr(want, "prio"):
        assert got.prio.tobytes() == want.prio.tobytes()
        assert got.max_prio == want.max_prio


def test_uniform_buffer_samples_identically():
    got, want = replay.ReplayBuffer(50, 6, seed=3), \
        ref_replay.ReplayBuffer(50, 6, seed=3)
    rng = np.random.default_rng(0)
    for t, tr in enumerate(_transitions(rng, 130, 6)):
        assert got.add(*tr) == want.add(*tr)
        if t >= 10 and t % 7 == 0:
            _assert_same_sample(got.sample(16), want.sample(16))
    _assert_same_rings(got, want)


def test_prioritized_buffer_samples_identically():
    got = replay.PrioritizedReplayBuffer(64, 5, seed=9)
    want = ref_replay.PrioritizedReplayBuffer(64, 5, seed=9)
    rng = np.random.default_rng(1)
    for t, tr in enumerate(_transitions(rng, 200, 5)):
        assert got.add(*tr) == want.add(*tr)
        if t >= 8 and t % 5 == 0:
            g, w = got.sample(16), want.sample(16)
            _assert_same_sample(g, w)
            td = rng.normal(size=16).astype(np.float32) * 3
            got.update_priorities(g[1], td)
            want.update_priorities(w[1], td)
    _assert_same_rings(got, want)


def test_plan_buffer_refreshes_and_evicts_identically():
    got = replay.PlanBuffer(24, 4, seed=5)
    want = ref_replay.PlanBuffer(24, 4, seed=5)
    rng = np.random.default_rng(2)
    keys = [tuple(np.round(rng.random(4), 3).tolist()) for _ in range(12)]
    for t, (s, a, r, s2, done) in enumerate(_transitions(rng, 150, 4)):
        key = keys[int(rng.integers(0, len(keys)))]
        a = a % 3  # collisions: refreshes in place
        assert got.contains(key, a) == want.contains(key, a)
        assert got.add_keyed(key, s, a, r, s2, done) == \
            want.add_keyed(key, s, a, r, s2, done)
        if t >= 16 and t % 6 == 0:
            g, w = got.sample(8), want.sample(8)
            _assert_same_sample(g, w)
            td = rng.normal(size=8)
            got.update_priorities(g[1], td)
            want.update_priorities(w[1], td)
    assert got._index == want._index and got._keys == want._keys
    assert len(got._index) < 150  # the ring evicted and refreshed
    _assert_same_rings(got, want)


# ------------------------------------------------------------ orchestrator
def test_decide_round_matches_the_reference_from_carried_params():
    ref_cfg, cfg = _cfgs(5, "B", "85%", seed=11)
    spec = ref_obs.make_spec("base", 5)
    params = ref_make_dqn(spec, lm.N_ACTIONS, hidden=(128, 128))[0](
        jax.random.PRNGKey(2)).params
    want = RefOrch(ref_ec.EdgeCloudEnv(ref_cfg), ref_dqn_policy(spec),
                   params).decide_round()
    got = IntelligentOrchestrator(
        ec.EdgeCloudEnv(cfg), dqn_policy(obs_spec.make_spec("base", 5)),
        convert.mlp_from_layers(params, CPU)).decide_round()
    assert [dataclasses.astuple(d) for d in got] == \
        [dataclasses.astuple(d) for d in want]


def test_variant_pool_from_roofline_names_its_queue_item():
    with pytest.raises(NotImplementedError, match="item 10.5"):
        variant_pool_from_roofline([], "yi-6b")
