"""The port's batched policy evaluation against ``repro.fleet.evaluate``
and ``repro.hltrain.metrics``.

Same scenario, params and keys through both packages, with background
noise on and off, uncoupled and under the shared-cloud / shared-edge
couplings: ``run_policy_round`` (greedy heuristic, DQN, solver oracle),
``make_greedy_evaluator``, ``evaluate_vs_solver`` and the throughput
runner.  Integers (``violated``, the state's actions and cursor, the
background, the key) identical; floats within 1e-5.
"""
import jax
import numpy as np
import pytest
import torch

from repro.fleet import evaluate as ref_evaluate
from repro.fleet.env import FleetConfig as RefFleetConfig
from repro.fleet.env import make_fleet_env as ref_make_fleet_env
from repro.fleet.workload import random_fleet as ref_random_fleet
from repro.hltrain import metrics as ref_metrics
from repro.policy import adapters as ref_adapters
from repro_torch import convert
from repro_torch.fleet import evaluate
from repro_torch.fleet.env import FleetConfig, make_fleet_env
from repro_torch.hltrain import metrics
from repro_torch.policy import adapters

CPU = torch.device("cpu")
N_MAX, SPEC, CELLS = 5, "full", 24


def _scenario(seed):
    ref = ref_random_fleet(jax.random.PRNGKey(seed), CELLS, n_max=N_MAX,
                           cells_per_edge=4)
    return ref, convert.fleet_scenario(ref, CPU)


def _key(seed):
    k = jax.random.PRNGKey(seed)
    return k, convert.key_from_data(np.asarray(k), CPU)


def _policies(kind, ref_scn, scn):
    """(reference policy, its params, port policy, its params)."""
    cfg = FleetConfig(n_max=N_MAX, obs_spec=SPEC)
    ref_spec, spec = RefFleetConfig(n_max=N_MAX, obs_spec=SPEC).spec(), \
        cfg.spec()
    if kind == "greedy":
        ref_pol = ref_adapters.heuristic_greedy_policy(ref_spec)
        pol = adapters.heuristic_greedy_policy(spec)
        return (ref_pol, ref_pol.refresh(None, ref_scn), pol,
                pol.refresh(None, scn))
    if kind == "dqn":
        ref_pol = ref_adapters.dqn_policy(ref_spec, hidden=(32,))
        ref_params = ref_pol.init(jax.random.PRNGKey(3))
        return (ref_pol, ref_params, adapters.dqn_policy(spec, hidden=(32,)),
                convert.policy_params(jax.tree.map(np.asarray, ref_params),
                                      CPU))
    ref_pol = ref_adapters.oracle_policy(ref_spec)
    ref_params = ref_adapters.oracle_params(ref_scn)
    return (ref_pol, ref_params, adapters.oracle_policy(spec),
            convert.policy_params(jax.tree.map(np.asarray, ref_params), CPU))


def _assert_info(got, want):
    np.testing.assert_array_equal(got["violated"].numpy(),
                                  np.asarray(want["violated"]))
    for k in ("art", "acc"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, rtol=0, err_msg=k)


def _assert_states(got, want):
    for f in ("key", "actions", "user"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    np.testing.assert_allclose(got.charged.numpy(), np.asarray(want.charged),
                               atol=1e-5, rtol=0)
    for f in got.bg._fields:
        np.testing.assert_array_equal(getattr(got.bg, f).numpy(),
                                      np.asarray(getattr(want.bg, f)), f)


@pytest.mark.parametrize("kind,quiet,coupled", [
    ("greedy", True, False), ("greedy", False, True),
    ("dqn", False, False), ("dqn", True, True),
    ("oracle", False, True), ("oracle", True, False),
])
def test_run_policy_round_matches_reference(kind, quiet, coupled):
    ref_scn, scn = _scenario(1)
    kw = dict(n_max=N_MAX, obs_spec=SPEC, quiet=quiet, shared_cloud=coupled,
              shared_edge=coupled)
    ref_cfg, cfg = RefFleetConfig(**kw), FleetConfig(**kw)
    ref_env, env = ref_make_fleet_env(ref_cfg), make_fleet_env(cfg)
    ref_pol, ref_params, pol, params = _policies(kind, ref_scn, scn)
    (ref_k0, k0), (ref_k1, k1) = _key(5), _key(6)
    ref_state = ref_env.init(ref_k0, ref_scn)
    state = env.init(k0, scn)
    # two rounds back to back, the second from the first's end state
    for _ in range(2):
        ref_state, want = ref_evaluate.run_policy_round(
            ref_env, ref_pol, ref_cfg, ref_params, ref_scn, ref_state, ref_k1)
        state, got = evaluate.run_policy_round(env, pol, cfg, params, scn,
                                               state, k1)
        _assert_info(got, want)
        _assert_states(state, ref_state)
        ref_state = ref_env.reset_rounds(ref_state)
        state = env.reset_rounds(state)
        _assert_states(state, ref_state)
    if kind == "oracle" and quiet and not coupled:
        # the oracle reaches the exact optimum of each cell's round
        np.testing.assert_allclose(
            got["art"].numpy(),
            ref_adapters.solve_oracle(ref_scn)["art"][
                np.arange(CELLS), np.asarray(ref_scn.n_users) - 1],
            atol=1e-3, rtol=0)


@pytest.mark.parametrize("coupled", [False, True])
def test_greedy_evaluator_and_evaluate_vs_solver_match_reference(coupled):
    ref_scn, scn = _scenario(2)
    kw = dict(n_max=N_MAX, obs_spec=SPEC, shared_cloud=coupled,
              shared_edge=coupled)
    ref_cfg, cfg = RefFleetConfig(**kw), FleetConfig(**kw)
    ref_pol, ref_params, _, params = _policies("dqn", ref_scn, scn)
    ref_key, key = _key(9)
    want = ref_evaluate.make_greedy_evaluator(ref_cfg)(ref_params, ref_scn,
                                                       ref_key)
    got = evaluate.make_greedy_evaluator(cfg)(params, scn, key)
    _assert_info(got, want)
    # the heuristic through the evaluator, as the reference passes it
    ref_g, ref_gp, g, gp = _policies("greedy", ref_scn, scn)
    _assert_info(evaluate.make_greedy_evaluator(cfg, g)(gp, scn, key),
                 ref_evaluate.make_greedy_evaluator(ref_cfg, ref_g)(
                     ref_gp, ref_scn, ref_key))

    want = ref_metrics.evaluate_vs_solver(ref_params, ref_scn, ref_cfg,
                                          key=ref_key)
    got = metrics.evaluate_vs_solver(params, scn, cfg, key=key)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["violated"], np.asarray(want["violated"]))
    np.testing.assert_array_equal(got["opt_reward"], want["opt_reward"])
    for k in ("art", "acc", "policy_reward", "reward_gap"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-5,
                                   rtol=0, err_msg=k)
    for k in ("mean_policy_reward", "mean_opt_reward", "mean_reward_gap",
              "violation_rate"):
        assert abs(got[k] - want[k]) <= 1e-5, (k, got[k], want[k])
    again = metrics.evaluate_vs_solver(params, scn, cfg, key=key,
                                       opt_reward=got["opt_reward"])
    np.testing.assert_array_equal(again["reward_gap"], got["reward_gap"])
    # the optimum bounds every cell's reward from above
    assert (got["reward_gap"] >= -1e-6).all()
    np.testing.assert_array_equal(metrics.optimal_rewards(scn),
                                  ref_metrics.optimal_rewards(ref_scn))


@pytest.mark.parametrize("coupled", [False, True])
def test_throughput_runner_matches_reference(coupled):
    ref_scn, scn = _scenario(4)
    kw = dict(n_max=N_MAX, obs_spec=SPEC, shared_cloud=coupled,
              shared_edge=coupled)
    ref_pol, ref_params, pol, params = _policies("dqn", ref_scn, scn)
    ref_key, key = _key(12)
    want = ref_evaluate.make_throughput_runner(
        RefFleetConfig(**kw), ref_pol, n_steps=7)(ref_params, ref_scn, ref_key)
    got = evaluate.make_throughput_runner(FleetConfig(**kw), pol, n_steps=7)(
        params, scn, key)
    assert abs(float(got) - float(want)) <= 1e-5
