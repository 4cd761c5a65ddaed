"""The port's policy layer and bundles against the reference.

* The MLP fed ``init_mlp_net`` params through ``convert`` gives Q-values
  within 1e-5 and the same argmax; greedy and guarded actions are
  identical on observations from the reference env.
* ``epsilon_greedy`` (over the greedy heuristic and a DQN), the solver
  oracle and the tabular Q policy give identical actions for the same
  key and observations; ``obs_table_key`` writes the reference's bytes.
* Bundles cross-load both ways (``dqn``, ``greedy``, ``oracle`` and
  ``qtable``), and the port's msgpack-free encoder writes the bytes
  ``msgpack.packb`` writes.
"""
import jax
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as ref_ckpt
from repro.core.networks import apply_mlp_net, init_mlp_net
from repro.fleet.env import FleetConfig as RefFleetConfig
from repro.fleet.env import make_fleet_env as ref_make_fleet_env
from repro.fleet.workload import random_fleet as ref_random_fleet
from repro.policy import adapters as ref_adapters
from repro.policy import bundle as ref_bundle
from repro.specs.observation import make_spec as ref_make_spec
from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.core.networks import MLP
from repro_torch.policy import adapters, bundle
from repro_torch.specs.observation import make_spec

CPU = torch.device("cpu")
N_MAX = 5


@pytest.fixture(scope="module")
def env_obs():
    """Observations of a coupled reference fleet at mid-round states,
    with the scenario they came from."""
    scn = ref_random_fleet(jax.random.PRNGKey(2), 64, n_max=N_MAX,
                           cells_per_edge=4)
    env = ref_make_fleet_env(RefFleetConfig(n_max=N_MAX, obs_spec="full",
                                            shared_cloud=True,
                                            shared_edge=True))
    st = env.init(jax.random.PRNGKey(3), scn)
    acts = np.random.default_rng(4).integers(0, 10, (3, 64)).astype(np.int32)
    _, traj = env.rollout(scn, st, acts)
    obs = np.asarray(traj["obs"]).reshape(-1, traj["obs"].shape[-1])
    return obs, scn


def _tile(scn, reps):
    """The scenario repeated to match stacked per-step observations."""
    return scn._replace(**{f: np.tile(np.asarray(getattr(scn, f)), reps)
                           for f in ("n_users", "constraint")})


@pytest.mark.parametrize("hidden", [(16,), (64, 64)])
def test_mlp_matches_reference(env_obs, hidden):
    obs, _ = env_obs
    sizes = (obs.shape[1], *hidden, 10)
    params = init_mlp_net(jax.random.PRNGKey(6), sizes)
    want = np.asarray(apply_mlp_net(params, obs))
    net = convert.mlp_from_layers(jax.tree.map(np.asarray, params), CPU)
    with torch.no_grad():
        got = net(torch.as_tensor(obs)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert net.sizes == sizes


def test_mlp_layer_list_round_trip():
    net = MLP((7, 5, 3), seed=4)
    again = MLP.from_layers(net.to_layers())
    x = torch.randn(6, 7, generator=torch.Generator().manual_seed(0))
    assert torch.equal(net(x), again(x))


def _acts(policy, params, obs):
    return policy.act(params, torch.as_tensor(obs),
                      torch.zeros(2, dtype=torch.int64)).numpy()


def test_greedy_actions_match_reference(env_obs):
    obs, scn = env_obs
    scn_t = _tile(scn, 3)
    ref_pol = ref_adapters.heuristic_greedy_policy(ref_make_spec("full",
                                                                 N_MAX))
    want = np.asarray(ref_pol.act(ref_pol.refresh(None, scn_t), obs, None))
    pol = adapters.heuristic_greedy_policy(make_spec("full", N_MAX))
    params = pol.refresh(None, convert.fleet_scenario(scn_t, CPU))
    np.testing.assert_array_equal(_acts(pol, params, obs), want)


def _port_key(key):
    return convert.key_from_data(np.asarray(key), CPU)


@pytest.mark.parametrize("base,epsilon", [("greedy", 0.3), ("dqn", 0.5),
                                          ("dqn", 0.0)])
def test_epsilon_greedy_matches_reference(env_obs, base, epsilon):
    obs, scn = env_obs
    scn_t = _tile(scn, 3)
    ref_spec, spec = ref_make_spec("full", N_MAX), make_spec("full", N_MAX)
    if base == "greedy":
        ref_base = ref_adapters.heuristic_greedy_policy(ref_spec)
        ref_params = ref_base.refresh(None, scn_t)
        pol_base = adapters.heuristic_greedy_policy(spec)
        params = pol_base.refresh(None, convert.fleet_scenario(scn_t, CPU))
    else:
        ref_base = ref_adapters.dqn_policy(ref_spec, hidden=(16,))
        ref_params = ref_base.init(jax.random.PRNGKey(4))
        pol_base = adapters.dqn_policy(spec, hidden=(16,))
        params = convert.policy_params(
            jax.tree.map(np.asarray, ref_params), CPU)
    ref_pol = ref_adapters.epsilon_greedy(ref_base, 10, epsilon)
    pol = adapters.epsilon_greedy(pol_base, 10, epsilon)
    assert pol.kind == ref_pol.kind and not pol.host_side
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(ref_pol.act(ref_params, obs, key))
        got = pol.act(params, torch.as_tensor(obs), _port_key(key))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    plain = np.asarray(ref_base.act(ref_params, obs, None))
    assert (want != plain).any() == (epsilon > 0)


def _oracle_params(scn, reps):
    """Reference oracle params for ``scn`` tiled ``reps`` times (one
    table block per stacked step of observations)."""
    tables = ref_adapters.solve_oracle(scn)
    return {"table": np.tile(tables["actions"], (reps, 1, 1)),
            "n_users": np.tile(np.asarray(scn.n_users), reps)}


def test_oracle_actions_match_reference(env_obs):
    obs, scn = env_obs
    ref_params = jax.tree.map(jax.numpy.asarray, _oracle_params(scn, 3))
    ref_pol = ref_adapters.oracle_policy(ref_make_spec("full", N_MAX))
    want = np.asarray(ref_pol.act(ref_params, obs, None))
    pol = adapters.oracle_policy(make_spec("full", N_MAX))
    params = convert.policy_params(jax.tree.map(np.asarray, ref_params), CPU)
    assert params["table"].dtype == torch.int32
    np.testing.assert_array_equal(_acts(pol, params, obs), want)
    # refresh / with_users rebind the round sizes, as the reference's do
    n = np.full(obs.shape[0], 2, np.int32)
    want = np.asarray(ref_pol.act(ref_pol.with_users(ref_params, n), obs,
                                  None))
    got = _acts(pol, pol.with_users(params, torch.as_tensor(n)), obs)
    np.testing.assert_array_equal(got, want)
    # oracle_params builds the port's table from the same solver
    own = adapters.oracle_params(convert.fleet_scenario(scn, CPU))
    np.testing.assert_array_equal(own["table"].numpy(),
                                  ref_adapters.solve_oracle(scn)["actions"])


def _qtable(obs, seed=0):
    """A Q table over half the observation rows, random values."""
    rng = np.random.default_rng(seed)
    return {ref_adapters.obs_table_key(row):
            rng.normal(size=10).astype(np.float32) for row in obs[::2]}


def test_qtable_actions_match_reference(env_obs):
    obs, _ = env_obs
    table = _qtable(obs)
    for row in obs[:5]:
        assert (adapters.obs_table_key(torch.as_tensor(row))
                == ref_adapters.obs_table_key(row))
    want = np.asarray(ref_adapters.qtable_policy().act(table, obs, None))
    pol = adapters.qtable_policy()
    assert pol.host_side
    params = convert.policy_params(table, CPU)
    assert all(isinstance(v, np.ndarray) for v in params.values())
    got = _acts(pol, params, obs)
    np.testing.assert_array_equal(got, want)
    assert (got[1::2] == 0).all() and (got[::2] != 0).any()


def test_guarded_dqn_actions_match_reference(env_obs):
    obs, scn = env_obs
    scn_t = _tile(scn, 3)
    ref_spec, spec = ref_make_spec("full", N_MAX), make_spec("full", N_MAX)
    ref_dqn = ref_adapters.dqn_policy(ref_spec, hidden=(32,))
    ref_pol = ref_adapters.slo_guarded(ref_dqn, ref_spec)
    ref_params = ref_pol.refresh(ref_adapters.slo_guarded_params(
        ref_dqn.init(jax.random.PRNGKey(9)), {}), scn_t)
    want = np.asarray(ref_pol.act(ref_params, obs, jax.random.PRNGKey(0)))
    pol = adapters.slo_guarded(adapters.dqn_policy(spec, hidden=(32,)), spec)
    params = pol.refresh(
        adapters.slo_guarded_params(
            convert.mlp_from_layers(
                jax.tree.map(np.asarray, ref_params["inner"]), CPU),
            {}, CPU),
        convert.fleet_scenario(scn_t, CPU))
    got = _acts(pol, params, obs)
    np.testing.assert_array_equal(got, want)
    # the guard overrode some of the untrained network's picks
    with torch.no_grad():
        raw = params["inner"](torch.as_tensor(obs)).argmax(-1).numpy()
    assert (raw != got).any()


# ---------------------------------------------------------------- bundles
def test_reference_bundle_loads_in_port(tmp_path, env_obs):
    obs, _ = env_obs
    spec = ref_make_spec("full", N_MAX)
    params = ref_adapters.dqn_policy(spec, hidden=(24,)).init(
        jax.random.PRNGKey(1))
    path = str(tmp_path / "ref.bundle.msgpack")
    ref_bundle.save_bundle(path, ref_bundle.PolicyBundle(
        "dqn", "full", N_MAX, params, meta={"shared_edge": True}))
    b = bundle.load_bundle(path, expect_spec="full", expect_n_max=N_MAX)
    assert b.meta == {"shared_edge": True}
    pol, net = bundle.policy_from_bundle(b, CPU)
    want = np.asarray(ref_adapters.dqn_policy(spec, hidden=(24,)).act(
        params, obs, None))
    np.testing.assert_array_equal(_acts(pol, net, obs), want)


def test_port_bundle_loads_in_reference(tmp_path):
    spec = make_spec("contention", 4)
    net = adapters.dqn_policy(spec, hidden=(8, 8)).init(3, CPU)
    path = str(tmp_path / "port.bundle.msgpack")
    bundle.save_bundle(path, bundle.PolicyBundle(
        "dqn", "contention", 4, net, meta={"cells_per_edge": 4}))
    b = ref_bundle.load_bundle(path, expect_spec="contention")
    for layer, ref_layer in zip(net.to_layers(), b.params):
        for k in ("w", "b"):
            np.testing.assert_array_equal(layer[k], np.asarray(ref_layer[k]))
    assert b.meta == {"cells_per_edge": 4}
    g_path = str(tmp_path / "greedy.bundle.msgpack")
    g = adapters.heuristic_greedy_policy(spec)
    bundle.save_bundle(g_path, bundle.PolicyBundle("greedy", "contention", 4,
                                                   g.init(0, CPU)))
    assert ref_bundle.load_bundle(g_path).kind == "greedy"
    pol, params = bundle.policy_from_bundle(bundle.load_bundle(g_path), CPU)
    assert pol.kind == "greedy" and params["n_users"].numel() == 0


@pytest.mark.parametrize("kind", ["oracle", "qtable"])
def test_oracle_and_qtable_bundles_cross_both_ways(tmp_path, env_obs, kind):
    obs, scn = env_obs
    if kind == "oracle":
        ref_params = jax.tree.map(jax.numpy.asarray, _oracle_params(scn, 3))
        port_params = convert.policy_params(
            jax.tree.map(np.asarray, ref_params), CPU)
        ref_pol = ref_adapters.oracle_policy(ref_make_spec("full", N_MAX))
    else:
        ref_params = _qtable(obs, 1)
        port_params = convert.policy_params(ref_params, CPU)
        ref_pol = ref_adapters.qtable_policy()
    want = np.asarray(ref_pol.act(ref_params, obs, None))
    meta = {"cells": 64}
    # reference → port
    path = str(tmp_path / "ref.bundle.msgpack")
    ref_bundle.save_bundle(path, ref_bundle.PolicyBundle(
        kind, "full", N_MAX, ref_params, meta=meta))
    b = bundle.load_bundle(path, expect_spec="full", expect_n_max=N_MAX)
    assert b.kind == kind and b.meta == meta
    pol, params = bundle.policy_from_bundle(b, CPU)
    assert pol.kind == kind and pol.host_side == (kind == "qtable")
    np.testing.assert_array_equal(_acts(pol, params, obs), want)
    # port → reference
    path = str(tmp_path / "port.bundle.msgpack")
    bundle.save_bundle(path, bundle.PolicyBundle(kind, "full", N_MAX,
                                                 port_params, meta=meta))
    rb = ref_bundle.load_bundle(path, expect_spec="full")
    r_pol, r_params = ref_bundle.policy_from_bundle(rb)
    assert r_pol.kind == kind and rb.meta == meta
    np.testing.assert_array_equal(np.asarray(r_pol.act(r_params, obs, None)),
                                  want)
    if kind == "qtable":
        assert set(r_params) == set(ref_params)


def test_encoder_bytes_equal_msgpack():
    net = MLP((6, 4, 10), seed=2)
    tree = {"format": bundle.BUNDLE_FORMAT, "version": 1, "kind": "dqn",
            "params": net.to_layers(), "n_max": 300, "neg": -70000,
            "meta": {"lam": 0.25, "flag": False, "none": None,
                     "tup": (1, "x" * 40)}}
    enc = ckpt._encode(tree)
    assert enc == ref_ckpt._encode(tree)
    packed = ckpt.packb(enc)
    assert packed == msgpack.packb(enc, use_bin_type=True)
    assert ckpt.unpackb(packed) == msgpack.unpackb(
        packed, raw=False, strict_map_key=False)


def test_bundle_code_imports_no_msgpack():
    import ast
    import inspect
    for mod in (ckpt, bundle):
        for node in ast.walk(ast.parse(inspect.getsource(mod))):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import) else [node.module])
                assert not any(n.split(".")[0] == "msgpack" for n in names)


def test_bundle_validation(tmp_path):
    spec = make_spec("base", N_MAX)
    net = adapters.dqn_policy(spec).init(0, CPU)
    with pytest.raises(bundle.SpecMismatchError):
        bundle.save_bundle(str(tmp_path / "x"), bundle.PolicyBundle(
            "dqn", "full", N_MAX, net))
    with pytest.raises(bundle.BundleError, match="later slice"):
        bundle.save_bundle(str(tmp_path / "x"), bundle.PolicyBundle(
            "cost_greedy", "base", N_MAX, {}))
    ckpt.save(str(tmp_path / "bare"), {"w": np.zeros(3)})
    with pytest.raises(bundle.BundleError, match="not a PolicyBundle"):
        bundle.load_bundle(str(tmp_path / "bare"))
    path = str(tmp_path / "ok")
    bundle.save_bundle(path, bundle.PolicyBundle("dqn", "base", N_MAX, net))
    with pytest.raises(bundle.SpecMismatchError):
        bundle.load_bundle(path, expect_n_max=N_MAX + 1)
