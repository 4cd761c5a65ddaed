"""The port's fleet training CLI (``repro_torch.launch.rl_train
--fleet``) and its bundles against the reference's.

The CLI trains 8 cells on the CPU (``--device cpu``) from the reference
CLI's key split (``k_fleet, k_init, k_eval = split(PRNGKey(seed), 3)``:
its curriculum stages and held-out fleet are the reference's draws,
bit-equal), and its counters meet the closed-form budget.  A bundle the
port writes loads in the reference — the system model's layers in
``meta["system"]`` included — and serves in the port's ``serve_fleet``;
a bundle the reference writes loads in the port the same way.  Without
``--fleet`` the CLI trains a single-cell agent
(``tests/test_torch_agents.py`` holds it to the reference CLI).
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.dqn import make_dqn as ref_make_dqn
from repro.core.system_model import make_system_model as ref_make_sm
from repro.fleet import curriculum_fleets as ref_curriculum_fleets
from repro.fleet import random_fleet as ref_random_fleet
from repro.policy.bundle import PolicyBundle as RefPolicyBundle
from repro.policy.bundle import load_bundle as ref_load_bundle
from repro.policy.bundle import save_bundle as ref_save_bundle
from repro.specs.observation import make_spec as ref_make_spec
from repro_torch.fleet.latency import N_ACTIONS
from repro_torch.hltrain import real_step_budget
from repro_torch.launch import rl_train, serve_fleet
from repro_torch.policy.bundle import load_bundle, policy_from_bundle

ARGS = ["--algo", "HL", "--fleet", "--cells", "8", "--n-max", "3",
        "--epochs", "2", "--chunk", "1", "--obs-spec", "full",
        "--shared-cloud", "--shared-edge", "--cells-per-edge", "4",
        "--seed", "3", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tensors this small gain nothing from intra-op threads, whose idle
    pool spins on the cores that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_layers_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in ("w", "b"):
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]))


def test_cli_trains_on_the_cpu_and_its_bundle_loads_in_the_reference(
        tmp_path, capsys):
    path = str(tmp_path / "hl.bundle.msgpack")
    rep = rl_train.main(ARGS + ["--ckpt", path])
    out = capsys.readouterr().out
    assert "saved PolicyBundle" in out and "held-out fleet" in out
    state = rep["state"]
    assert int(state.direct_steps) == real_step_budget(
        rep["hp"], 8, epochs=2)["direct_steps"]
    assert [c["epochs"] for c in rep["chunks"]] == [1, 1]
    for ev in (rep["final"], rep["held_out"]):
        assert np.all(np.isfinite(ev["reward_gap"]))
        # the per-cell optimum bounds any policy's reward from above
        assert ev["reward_gap"].min() >= -1e-6
    # the reference CLI's draws: its curriculum stages and held-out fleet
    k_fleet = jax.random.split(jax.random.PRNGKey(3), 3)[0]
    ref_stages = ref_curriculum_fleets(k_fleet, 8, 2, start=2, end=3,
                                       cells_per_edge=4)
    ref_held = ref_random_fleet(jax.random.PRNGKey(3 + 1234), 8, n_max=3,
                                cells_per_edge=4)
    for got, want in zip(rep["stages"] + [rep["held"]],
                         ref_stages + [ref_held], strict=True):
        for f in ("weak_s", "weak_e", "n_users", "constraint",
                  "latency_target", "edge_group"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)))
    # the reference loads it, system model included
    b = ref_load_bundle(path, expect_spec="full", expect_n_max=3)
    assert b.kind == "dqn" and b.meta["trainer"] == "hltrain-fleet"
    _assert_layers_equal(b.params, state.dqn.params.to_layers())
    _assert_layers_equal(b.meta["system"], state.sm.params.to_layers())
    assert b.meta["shared_edge"] and b.meta["cells_per_edge"] == 4
    # and the port serves it
    report = serve_fleet.serve(bundle=path, cells=8, rounds=2, rate=2.0,
                               device="cpu", verbose=False)
    assert report["served_requests"] > 0
    pol, net = policy_from_bundle(load_bundle(path), "cpu")
    assert pol.kind == "dqn" and net.sizes == (24, 128, 128, N_ACTIONS)


def test_reference_bundle_with_a_system_model_loads_in_the_port(tmp_path):
    spec = ref_make_spec("full", 3)
    dqn_init = ref_make_dqn(spec, N_ACTIONS, hidden=(128, 128))[0]
    sm_init = ref_make_sm(spec, N_ACTIONS)[0]
    params = dqn_init(jax.random.PRNGKey(0)).params
    system = sm_init(jax.random.PRNGKey(1)).params
    path = str(tmp_path / "ref.bundle.msgpack")
    ref_save_bundle(path, RefPolicyBundle(
        kind="dqn", obs_spec="full", n_max=3, params=params,
        meta={"algo": "HL", "trainer": "hltrain-fleet", "system": system}))
    b = load_bundle(path, expect_spec="full", expect_n_max=3)
    _assert_layers_equal([{k: v.numpy() for k, v in l.items()}
                          for l in b.params], params)
    _assert_layers_equal([{k: v.numpy() for k, v in l.items()}
                          for l in b.meta["system"]], system)
    pol, net = policy_from_bundle(b, "cpu")
    obs = torch.zeros((4, spec.dim))
    assert pol.act(net, obs, None).shape == (4,)


def test_cli_without_fleet_names_the_single_cell_item(capsys):
    """Without ``--fleet`` the CLI runs the single-cell path (queue 1
    item 8, ported): the tabular agent, its optimum and its lines."""
    rep = rl_train.main(["--algo", "QL", "--users", "2", "--max-steps",
                         "500", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("target optimum: ART=")
    assert "QL: converged@" in out and "(total 500 interactions" in out
    assert rep["algo"] == "QL" and rep["result"].real_steps == 500


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rl_train.main([a for a in ARGS if a not in ("--device", "cpu")])
