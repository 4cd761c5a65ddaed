"""The port's single-cell agents (``repro_torch.core.agent`` /
``baselines``) and the single-cell CLI against the reference's.

* **HL and DQL from carried networks.**  Each package builds its agent
  from one seed; the reference's initial DQN and system model cross with
  ``convert.dqn_state`` / ``system_model_state`` (the port's ``normal``
  rounds apart from ``jax.random.normal`` in the last bit).  HL trains 2
  epochs (the tiny schedule of ``tests/test_hltrain.py::_tiny_hp`` with
  batch 16, so every phase updates), DQL 1,000 steps.  Every integer is
  identical — counters, buffer sizes, pointers and action columns, plan
  keys, the numpy streams, the tracker's history; float buffers and
  priorities within 1e-5; parameters, target and Adam moments within
  2e-6.  Each decision is recorded in both packages in order (greedy Q
  rows, the planner's r̂ + γ max Q values); an argmax or top-k order may
  differ only where the port's own values put the two candidates within
  1e-4, and the comparison stops at that step.
* **QL** is host-side numpy in both packages: its whole run at 3 users,
  A/89%, seed 0 (``benchmarks/paper_tables.py::run_one``'s settings) is
  the reference's bit for bit — converged step, real steps, final ART,
  table.
* **The port's own HL converges** at n = 3 as the reference's
  ``test_hl_agent_converges_n3`` does, and its direct-step count equals
  ``real_step_budget`` of a 1-cell fleet (the counterpart of
  ``tests/test_hltrain.py::test_parity_real_step_accounting_vs_python_agent``).
* **The CLI** at ``--algo QL --users 2 --max-steps 2000`` prints the
  reference CLI's lines (wall and compute times aside) and writes a
  bundle the reference loads and acts on identically.  Agents built for
  the card without one raise.
"""
import re
import sys
import warnings

import numpy as np
import pytest
import torch

from repro.core.agent import ConvergenceTracker as RefTracker
from repro.core.agent import HLAgent as RefHL
from repro.core.agent import HLHyperParams as RefHP
from repro.core.baselines import DQLAgent as RefDQL
from repro.core.baselines import QLAgent as RefQL
from repro.core.baselines import QLHyperParams as RefQLHP
from repro.env.edge_cloud import EdgeCloudEnv as RefEnv
from repro.env.edge_cloud import EnvConfig as RefEnvConfig
from repro.env.scenarios import CONSTRAINTS as REF_CONSTRAINTS
from repro.env.scenarios import SCENARIOS as REF_SCENARIOS
from repro.launch import rl_train as ref_rl_train
from repro.policy.bundle import load_bundle as ref_load_bundle
from repro.policy.bundle import policy_from_bundle as ref_policy_from_bundle
from repro_torch import convert
from repro_torch import random as rnd
from repro_torch.core.agent import ConvergenceTracker, HLAgent, HLHyperParams
from repro_torch.core.baselines import DQLAgent, QLAgent, QLHyperParams
from repro_torch.env.edge_cloud import EdgeCloudEnv, EnvConfig
from repro_torch.env.scenarios import CONSTRAINTS, SCENARIOS
from repro_torch.fleet import FleetConfig, from_table4
from repro_torch.hltrain import (FleetHLParams, make_hl_trainer,
                                 real_step_budget)
from repro_torch.launch import rl_train
from repro_torch.policy.bundle import load_bundle, policy_from_bundle

CPU = torch.device("cpu")
# tests/test_hltrain.py::_tiny_hp's schedule, batch 16 so that every
# phase updates within 2 epochs
TINY = dict(epochs=2, n_direct=3, t_direct=6, n_world=6, n_suggest=2,
            t_suggest=3, n_plan=6, k_best=3, batch=16)
BUFFER_BAR, PARAM_BAR, NEAR_TIE = 1e-5, 2e-6, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tensors this small gain nothing from intra-op threads, whose idle
    pool spins on the cores that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _envs(n=3, scenario="A", constraint="89%", seed=0, **kw):
    return (RefEnv(RefEnvConfig(REF_SCENARIOS[scenario],
                                REF_CONSTRAINTS[constraint], n_users=n,
                                seed=seed, **kw)),
            EdgeCloudEnv(EnvConfig(SCENARIOS[scenario],
                                   CONSTRAINTS[constraint], n_users=n,
                                   seed=seed, **kw)))


# ------------------------------------------------------ decision records
def _record_ref(agent, log: list, gamma=None):
    """Wrap the reference agent's decisions: each greedy act's action,
    and (HL) each planning step's value vector."""
    pol = agent.policy

    def act(params, obs, key):
        out = pol.act(params, obs, key)
        log.append(("act", int(np.asarray(out)[0])))
        return out
    agent.policy = pol._replace(act=act)
    if gamma is None:
        return
    predict_all, q_values = agent.sm_predict_all, agent.q_values
    seen = {}

    def predict(params, s):
        seen["r_hat"] = np.asarray(predict_all(params, s)[0])
        return predict_all(params, s)

    def q(params, s2):
        out = q_values(params, s2)
        log.append(("plan", seen["r_hat"] + gamma * np.asarray(out).max(-1)))
        return out
    agent.sm_predict_all, agent.q_values = predict, q


def _record_port(agent, log: list, planning: bool):
    """Wrap the port agent's decisions: each greedy act's Q row, and
    (HL) each planning step's value vector."""
    pol = agent.policy

    def act(params, obs, key):
        with torch.no_grad():
            log.append(("act", params(obs)[0].numpy().copy()))
        return pol.act(params, obs, key)
    agent.policy = pol._replace(act=act)
    if planning:
        plan_values = agent._plan_values

        def values(obs):
            v = plan_values(obs)
            log.append(("plan", v.copy()))
            return v
        agent._plan_values = values


def _first_divergence(port_log, ref_log, k_best):
    """None if every recorded decision agrees; else (step, gap), the
    port's own gap between the two candidates that changed places."""
    assert len(port_log) >= 1 and len(ref_log) >= 1
    for i, ((kind, got), (ref_kind, want)) in enumerate(zip(port_log,
                                                            ref_log)):
        assert kind == ref_kind, i
        if kind == "act":
            a = int(np.argmax(got))
            if a != want:
                return i, float(got[a] - got[want])
            continue
        mine, theirs = np.argsort(-got)[:k_best], np.argsort(-want)[:k_best]
        for j in range(k_best):
            if mine[j] != theirs[j]:
                return i, float(abs(got[mine[j]] - got[theirs[j]]))
    assert len(port_log) == len(ref_log)
    return None


# -------------------------------------------------------------- compares
def _flat(layers):
    """A layer list as ``list(MLP.parameters())`` orders it."""
    return ([np.asarray(l["w"]) for l in layers]
            + [np.asarray(l["b"]) for l in layers])


def _assert_close(got: list, want: list, bar: float, what: str):
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        g = g.detach().cpu().numpy() if isinstance(g, torch.Tensor) else g
        assert g.shape == np.shape(w), what
        err = float(np.abs(g.astype(np.float64) - np.asarray(w)).max())
        assert err <= bar, (what, err)


def _assert_dqn_close(state, ref_state):
    _assert_close(list(state.params.parameters()), _flat(ref_state.params),
                  PARAM_BAR, "params")
    if hasattr(ref_state, "target_params"):
        _assert_close(list(state.target_params.parameters()),
                      _flat(ref_state.target_params), PARAM_BAR, "target")
    _assert_close(state.opt_state.mu, _flat(ref_state.opt_state.mu),
                  PARAM_BAR, "mu")
    _assert_close(state.opt_state.nu, _flat(ref_state.opt_state.nu),
                  PARAM_BAR, "nu")
    assert int(state.step) == int(ref_state.step)
    assert int(state.opt_state.step) == int(ref_state.opt_state.step)


def _assert_buffers_match(buf, ref):
    assert (buf.n, buf.ptr) == (ref.n, ref.ptr)
    assert buf.rng.bit_generator.state == ref.rng.bit_generator.state
    for f in ("s", "s2", "a", "done"):
        np.testing.assert_array_equal(getattr(buf, f), getattr(ref, f), f)
    for f in ("r", "prio"):
        if hasattr(ref, f):
            _assert_close([getattr(buf, f)], [getattr(ref, f)], BUFFER_BAR, f)
    if hasattr(ref, "max_prio"):
        assert abs(buf.max_prio - ref.max_prio) <= BUFFER_BAR


def _assert_counters_match(agent, ref, res, ref_res):
    assert (agent.real_steps, agent.compute_updates) == \
        (ref.real_steps, ref.compute_updates)
    assert agent.exp_time_ms == ref.exp_time_ms
    assert agent.rng.bit_generator.state == ref.rng.bit_generator.state
    assert agent.env.rng.bit_generator.state == ref.env.rng.bit_generator.state
    assert res.history == ref_res.history
    assert (res.steps_to_converge, res.real_steps, res.final_art) == \
        (ref_res.steps_to_converge, ref_res.real_steps, ref_res.final_art)
    np.testing.assert_array_equal(res.final_actions, ref_res.final_actions)


# ------------------------------------------------------------------ agents
def test_hl_two_epochs_from_carried_networks():
    ref_env, env = _envs(3, "B", "85%", seed=5)
    ref = RefHL(ref_env, RefHP(seed=5, **TINY))
    agent = HLAgent(env, HLHyperParams(seed=5, **TINY), device="cpu")
    agent.dqn = convert.dqn_state(ref.dqn, CPU)
    agent.sm = convert.system_model_state(ref.sm, CPU)
    ref_log, port_log = [], []
    _record_ref(ref, ref_log, gamma=ref.hp.gamma)
    _record_port(agent, port_log, planning=True)
    ref_res = ref.train(tracker=RefTracker(_envs(3, "B", "85%", 95)[0]),
                        stop_on_convergence=False)
    res = agent.train(tracker=ConvergenceTracker(_envs(3, "B", "85%", 95)[1]),
                      stop_on_convergence=False)
    tie = _first_divergence(port_log, ref_log, TINY["k_best"])
    if tie is not None:
        step, gap = tie
        assert gap < NEAR_TIE, f"decision {step} differs at a gap of {gap}"
        warnings.warn(f"identical up to a near-tie at decision {step} "
                      f"({gap}); the runs part there")
        return
    # every phase trained: direct and plan updates, model updates
    assert int(ref.dqn.step) > 0 and int(ref.sm.step) > 0
    assert len(ref.d_plan) > TINY["batch"]
    _assert_counters_match(agent, ref, res, ref_res)
    _assert_buffers_match(agent.d_direct, ref.d_direct)
    _assert_buffers_match(agent.d_world, ref.d_world)
    _assert_buffers_match(agent.d_plan, ref.d_plan)
    assert agent.d_plan._index == ref.d_plan._index
    _assert_dqn_close(agent.dqn, ref.dqn)
    _assert_dqn_close(agent.sm, ref.sm)


def test_dql_1000_steps_from_carried_networks():
    ref_env, env = _envs(3, "A", "89%", seed=2)
    hp = dict(seed=2, eps_decay_steps=800)
    ref = RefDQL(ref_env, RefHP(**hp))
    agent = DQLAgent(env, HLHyperParams(**hp), device="cpu")
    agent.dqn = convert.dqn_state(ref.dqn, CPU)
    ref_log, port_log = [], []
    _record_ref(ref, ref_log)
    _record_port(agent, port_log, planning=False)
    ref_res = ref.train(tracker=RefTracker(_envs(3, "A", "89%", 92)[0]),
                        max_steps=1000, eval_every=200)
    res = agent.train(tracker=ConvergenceTracker(_envs(3, "A", "89%", 92)[1]),
                      max_steps=1000, eval_every=200)
    tie = _first_divergence(port_log, ref_log, 1)
    if tie is not None:
        step, gap = tie
        assert gap < NEAR_TIE, f"decision {step} differs at a gap of {gap}"
        warnings.warn(f"identical up to a near-tie at decision {step} "
                      f"({gap}); the runs part there")
        return
    assert ref.compute_updates > 150
    _assert_counters_match(agent, ref, res, ref_res)
    _assert_buffers_match(agent.buf, ref.buf)
    _assert_dqn_close(agent.dqn, ref.dqn)


def test_ql_run_is_the_references_bit_for_bit():
    """Table VI's 3-user QL cell at A/89%, seed 0, as ``run_one`` runs it
    (ε over 50,000 steps, cap 400,000, an evaluation every 2,000)."""
    runs = []
    for env_cls, tracker_cls, agent_cls, hp_cls, pkg in (
            (RefEnv, RefTracker, RefQL, RefQLHP, 0),
            (EdgeCloudEnv, ConvergenceTracker, QLAgent, QLHyperParams, 1)):
        env, tr_env = _envs(3, "A", "89%", 0)[pkg], _envs(3, "A", "89%", 90)[pkg]
        agent = agent_cls(env, hp_cls(seed=0, eps_decay_steps=50_000))
        res = agent.train(tracker=tracker_cls(tr_env, patience=4),
                          max_steps=400_000, eval_every=2000)
        runs.append((agent, res))
    (ref, ref_res), (agent, res) = runs
    assert (res.steps_to_converge, res.real_steps, res.final_art) == \
        (22_000, 28_000, ref_res.final_art)
    assert round(res.final_art, 1) == 269.8
    _assert_counters_match(agent, ref, res, ref_res)
    assert agent.q.keys() == ref.q.keys()
    for k, row in ref.q.items():
        assert agent.q[k].dtype == np.float64
        assert agent.q[k].tobytes() == row.tobytes()


def test_port_hl_converges_n3():
    _, env = _envs(3, seed=0)
    tracker = ConvergenceTracker(_envs(3, seed=99)[1])
    agent = HLAgent(env, HLHyperParams(seed=0, epochs=200,
                                       eps_decay_steps=3000), device="cpu")
    res = agent.train(tracker=tracker)
    assert res.steps_to_converge is not None
    assert res.final_art <= tracker.opt_art * 1.01 + 1e-9


def test_direct_steps_equal_the_one_cell_fleet_budget():
    hp = FleetHLParams(epochs=6, n_direct=3, t_direct=6, n_world=6,
                       n_suggest=2, t_suggest=3, n_plan=6, k_best=3,
                       batch=32, seed=0, eps_cell_jitter=0.0)
    _, env = _envs(5, "B", "85%", 0)
    agent = HLAgent(env, HLHyperParams(
        epochs=hp.epochs, n_direct=hp.n_direct, t_direct=hp.t_direct,
        n_world=hp.n_world, n_suggest=hp.n_suggest, t_suggest=hp.t_suggest,
        n_plan=hp.n_plan, k_best=hp.k_best, batch=hp.batch, seed=0),
        device="cpu")
    res = agent.train(tracker=ConvergenceTracker(
        _envs(5, "B", "85%", 9, quiet=True)[1]), stop_on_convergence=False)
    direct = res.real_steps - agent.d_plan.n  # verifications add plan rows
    scn = from_table4(names=("B",), constraints=("85%",), device="cpu")
    trainer = make_hl_trainer(FleetConfig(n_max=5), hp)
    state = trainer.init(rnd.PRNGKey(0, CPU), scn)
    state, _ = trainer.run(state, scn, 0, hp.epochs)
    budget = real_step_budget(hp, n_cells=1)
    assert direct == budget["direct_steps"] == int(state.direct_steps)
    assert 0 < int(state.verify_steps) <= budget["verify_steps_max"]


# --------------------------------------------------------------------- CLI
def _mask(out: str) -> list:
    """The CLI's lines with the host clocks masked."""
    out = re.sub(r"\d+s wall", "<wall>", out)
    out = re.sub(r"compute time [\d.]+ min", "compute time <t>", out)
    return out.splitlines()


def test_cli_ql_prints_the_reference_lines_and_its_bundle_loads_there(
        tmp_path, capsys, monkeypatch):
    args = ["--algo", "QL", "--users", "2", "--max-steps", "2000"]
    port_path, ref_path = tmp_path / "port.msgpack", tmp_path / "ref.msgpack"
    rep = rl_train.main(args + ["--device", "cpu", "--ckpt", str(port_path)])
    port_out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv",
                        ["rl_train"] + args + ["--ckpt", str(ref_path)])
    ref_rl_train.main()
    ref_out = capsys.readouterr().out
    assert _mask(port_out) == _mask(ref_out.replace(str(ref_path),
                                                    str(port_path)))
    assert rep["result"].real_steps == 2000
    bundle = ref_load_bundle(str(port_path), expect_spec="base",
                             expect_n_max=2)
    assert bundle.kind == "qtable" and bundle.meta["algo"] == "QL"
    assert bundle.meta == ref_load_bundle(str(ref_path)).meta
    ref_pol, ref_params = ref_policy_from_bundle(bundle)
    pol, params = policy_from_bundle(load_bundle(str(port_path)), "cpu")
    agent = rep["agent"]
    obs = np.stack([np.frombuffer(k, np.float32) for k in agent.q])
    want = np.asarray(ref_pol.act(ref_params, obs, None))
    np.testing.assert_array_equal(
        pol.act(params, torch.as_tensor(obs), None).numpy(), want)
    np.testing.assert_array_equal(
        want, [int(np.argmax(agent.q[k])) for k in agent.q])


def test_cli_fleet_keeps_the_reference_algo_error(capsys):
    with pytest.raises(SystemExit):
        rl_train.main(["--fleet", "--algo", "DQL", "--device", "cpu"])
    assert "--fleet currently supports --algo HL only" in \
        capsys.readouterr().err


def test_agents_built_for_the_card_without_one_raise():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is valid")
    _, env = _envs(3)
    for make in (lambda: HLAgent(env), lambda: DQLAgent(env),
                 lambda: rl_train.train_single(algo="QL", users=2,
                                               max_steps=10, verbose=False)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
