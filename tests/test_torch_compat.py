"""The round gateway and the round-replay CLI against the reference's.

* ``replay_trace``: the same scenario, trace, params and key through
  ``repro.serve.compat.replay_trace`` and the port's, with background
  noise on and off, uncoupled and coupled, for the greedy heuristic, the
  solver oracle and a DQN: per-round rows and the summary identical in
  their integers, floats within 1e-5.
* ``round_synchronous_stream`` bit-equal to the reference's, and the
  port's round↔request parity as ``tests/test_serve.py`` holds the
  reference's: on such a stream the engine reproduces the gateway's
  request-weighted ART and violation rate within 1e-5, quiet and
  uncoupled (the reference does not hold it under the couplings: the
  gateway's early finishers start new rounds that load the shared tiers,
  the engine's idle cells run pinned phantom rounds).
* ``serve_fleet --round-replay`` reports what the reference CLI reports
  for the same seed and bundle.
* Both engines refuse a host-side policy before they serve.
"""
import jax
import numpy as np
import pytest
import torch

from repro.fleet.env import FleetConfig as RefFleetConfig
from repro.fleet.workload import poisson_round_trace as ref_round_trace
from repro.fleet.workload import random_fleet as ref_random_fleet
from repro.launch import serve_fleet as ref_serve_fleet
from repro.policy import adapters as ref_adapters
from repro.policy import bundle as ref_bundle
from repro.serve import compat as ref_compat
from repro.serve import stream as ref_stream
from repro_torch import convert
from repro_torch import random as rnd
from repro_torch.fleet.env import FleetConfig
from repro_torch.fleet.workload import poisson_round_trace, random_fleet
from repro_torch.launch import serve_fleet
from repro_torch.policy import adapters
from repro_torch.serve.compat import make_gateway, replay_trace
from repro_torch.serve.engine import ServeConfig, serve_stream
from repro_torch.serve.stream import round_synchronous_stream

CPU = torch.device("cpu")
ROW_INTS = ("round", "served_requests")
ROW_FLOATS = ("mean_art_ms", "opt_art_ms", "violation_rate", "mean_reward",
              "opt_reward")
SUMMARY_INTS = ("n_rounds", "n_cells", "served_requests")
SUMMARY_FLOATS = ("mean_art_ms", "opt_art_ms", "violation_rate",
                  "mean_reward", "opt_reward")


def _assert_replays_match(got, want):
    assert len(got["rounds"]) == len(want["rounds"])
    for g, w in zip(got["rounds"], want["rounds"]):
        assert set(g) == set(w)
        for k in ROW_INTS:
            assert g[k] == w[k], (k, g[k], w[k])
        for k in ROW_FLOATS:
            assert abs(g[k] - w[k]) <= 1e-5, (g["round"], k, g[k], w[k])
    for k in SUMMARY_INTS:
        assert got[k] == want[k], k
    for k in SUMMARY_FLOATS:
        assert abs(got[k] - want[k]) <= 1e-5, (k, got[k], want[k])
    assert got.get("trace_stats") == want.get("trace_stats")
    assert (got["decisions_per_s"] is None) == (want["decisions_per_s"]
                                                is None)


def _policies(kind, spec_name, n_max, ref_scn):
    """(reference policy, its params, port policy, its params)."""
    ref_spec = RefFleetConfig(n_max=n_max, obs_spec=spec_name).spec()
    spec = FleetConfig(n_max=n_max, obs_spec=spec_name).spec()
    if kind == "greedy":
        ref_pol = ref_adapters.heuristic_greedy_policy(ref_spec)
        pol = adapters.heuristic_greedy_policy(spec)
        return ref_pol, ref_pol.init(None), pol, pol.init(0, CPU)
    if kind == "dqn":
        ref_pol = ref_adapters.dqn_policy(ref_spec, hidden=(16,))
        ref_params = ref_pol.init(jax.random.PRNGKey(5))
        pol = adapters.dqn_policy(spec, hidden=(16,))
    else:
        ref_pol = ref_adapters.oracle_policy(ref_spec)
        ref_params = ref_adapters.oracle_params(ref_scn)
        pol = adapters.oracle_policy(spec)
    return (ref_pol, ref_params, pol,
            convert.policy_params(jax.tree.map(np.asarray, ref_params), CPU))


def _replay_both(kind, *, seed=11, cells=16, n_max=5, rounds=5, rate=3.0,
                 spec="full", **cfg_kw):
    ref_scn = ref_random_fleet(jax.random.PRNGKey(seed), cells, n_max=n_max,
                               cells_per_edge=4)
    trace, stats = ref_round_trace(jax.random.PRNGKey(seed + 1), ref_scn,
                                   rounds, rate=rate, with_stats=True)
    ref_pol, ref_params, pol, params = _policies(kind, spec, n_max, ref_scn)
    ref_key = jax.random.PRNGKey(seed + 2)
    kw = dict(n_max=n_max, obs_spec=spec, **cfg_kw)
    want = ref_compat.replay_trace(ref_pol, ref_params, ref_scn, trace,
                                   RefFleetConfig(**kw), key=ref_key,
                                   trace_stats=stats)
    got = replay_trace(pol, params, convert.fleet_scenario(ref_scn, CPU),
                       torch.as_tensor(np.asarray(trace)), FleetConfig(**kw),
                       key=convert.key_from_data(np.asarray(ref_key), CPU),
                       trace_stats=stats, device=CPU)
    return got, want


@pytest.mark.parametrize("kind,quiet,coupled", [
    ("greedy", False, False), ("greedy", True, True),
    ("oracle", True, False), ("oracle", False, True),
    ("dqn", False, True),
])
def test_replay_trace_matches_reference(kind, quiet, coupled):
    got, want = _replay_both(kind, quiet=quiet, shared_cloud=coupled,
                             shared_edge=coupled)
    _assert_replays_match(got, want)
    if kind != "dqn":
        assert got["violation_rate"] == 0.0
        for row in got["rounds"]:
            # the per-cell quiet optimum bounds every round from below
            assert row["mean_art_ms"] >= row["opt_art_ms"] - 1e-2
            if kind == "oracle" and quiet and not coupled:
                assert abs(row["mean_art_ms"] - row["opt_art_ms"]) <= 1e-3
    else:
        assert got["violation_rate"] > 0.0  # the untrained net violates


@pytest.mark.parametrize("shape,round_ms,kw", [
    ((5, 7), 250.0, {}),
    ((3, 4), 200.0, dict(slo_ms=120.0, epoch_ms=400.0)),
    ((4, 6), 50.0, dict(slo_ms="per_cell")),
])
def test_round_synchronous_stream_matches_reference(shape, round_ms, kw):
    rng = np.random.default_rng(shape[1])
    trace = rng.integers(1, 6, shape).astype(np.int32)
    if kw.get("slo_ms") == "per_cell":
        kw = dict(slo_ms=rng.uniform(100.0, 400.0, shape[1]))
    want = ref_stream.round_synchronous_stream(trace, round_ms, **kw)
    got = round_synchronous_stream(torch.as_tensor(trace), round_ms, **kw)
    for name in ("t_ms", "cell", "slo_ms"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, name)
    assert (got.horizon_ms, got.epoch_ms, got.n_cells) == (
        want.horizon_ms, want.epoch_ms, want.n_cells)


@pytest.mark.parametrize("kind", ["greedy", "dqn"])
def test_round_request_parity(kind):
    """On a round-synchronous stream of the trace, quiet and uncoupled,
    the port's engine reproduces the port's gateway: request-weighted ART
    and violation rate within 1e-5, every request served, none dropped or
    deferred — for the greedy baseline and a violating untrained DQN."""
    seed, cells, n_max, rounds = 11, 8, 4, 6
    scn = random_fleet(rnd.PRNGKey(seed, CPU), cells, n_max=n_max)
    trace = poisson_round_trace(rnd.PRNGKey(seed + 1, CPU), scn, rounds,
                                rate=2.0)
    spec = FleetConfig(n_max=n_max).spec()
    if kind == "greedy":
        pol = adapters.heuristic_greedy_policy(spec)
    else:
        pol = adapters.dqn_policy(spec, hidden=(16,))
    params = pol.init(5, CPU)
    key = rnd.PRNGKey(seed + 2, CPU)
    rep = replay_trace(pol, params, scn, trace,
                       FleetConfig(n_max=n_max, quiet=True), key=key,
                       device=CPU)
    scfg = ServeConfig(n_max=n_max, quiet=True)
    req = serve_stream(pol, params, scn,
                       round_synchronous_stream(trace, scfg.round_ms), scfg,
                       key=key, device=CPU)
    assert req["served_requests"] == rep["served_requests"]
    assert req["dropped_requests"] == 0 and req["deferred_requests"] == 0
    assert abs(req["mean_art_ms"] - rep["mean_art_ms"]) < 1e-5
    assert abs(req["violation_rate"] - rep["violation_rate"]) < 1e-5
    assert (rep["violation_rate"] > 0.0) == (kind == "dqn")


@pytest.mark.parametrize("kind,seed,coupled", [("greedy", 0, False),
                                               ("oracle", 3, True)])
def test_cli_round_replay_matches_reference_cli(tmp_path, capsys, kind, seed,
                                                coupled):
    """``serve_fleet --round-replay`` on a bundle: the fleet, trace and
    serving key from the same seed split, the same report."""
    cells, rounds, cpe = 16, 4, 4 if coupled else 1
    meta = {"shared_cloud": coupled, "shared_edge": coupled,
            "cells_per_edge": cpe}
    spec = RefFleetConfig(n_max=5, obs_spec="full").spec()
    if kind == "greedy":
        params = ref_adapters.heuristic_greedy_policy(spec).init(None)
    else:
        k_fleet = jax.random.split(jax.random.PRNGKey(seed), 4)[0]
        params = ref_adapters.oracle_params(ref_random_fleet(
            k_fleet, cells, n_max=5, cells_per_edge=cpe))
    path = str(tmp_path / f"{kind}.bundle.msgpack")
    ref_bundle.save_bundle(path, ref_bundle.PolicyBundle(
        kind, "full", 5, params, meta=meta))
    want = ref_serve_fleet.serve_bundle(path, rounds=rounds, cells=cells,
                                        seed=seed, round_replay=True,
                                        verbose=False)
    got = serve_fleet.main(["--bundle", path, "--round-replay", "--cells",
                            str(cells), "--rounds", str(rounds), "--seed",
                            str(seed), "--device", "cpu"])
    _assert_replays_match(got, want)
    assert got["config"]["shared_edge"] is coupled
    assert '"opt_art_ms"' in capsys.readouterr().out.splitlines()[-1]
    assert got["violation_rate"] == 0.0


def test_host_side_policies_are_refused(tmp_path):
    scn = random_fleet(rnd.PRNGKey(0, CPU), 4, n_max=3)
    trace = poisson_round_trace(rnd.PRNGKey(1, CPU), scn, 2)
    spec = FleetConfig(n_max=3).spec()
    q = adapters.qtable_policy()
    for pol in (q, adapters.epsilon_greedy(q, 10, 0.1),
                adapters.slo_guarded(q, spec)):
        assert pol.host_side
        with pytest.raises(ValueError, match="host-side"):
            replay_trace(pol, {}, scn, trace, FleetConfig(n_max=3),
                         device=CPU)
        with pytest.raises(ValueError, match="host-side"):
            make_gateway(pol, FleetConfig(n_max=3))
        scfg = ServeConfig(n_max=3)
        with pytest.raises(ValueError, match="host-side"):
            serve_stream(pol, {}, scn, round_synchronous_stream(
                trace, scfg.round_ms), scfg, device=CPU)
    # through the CLI: a qtable bundle is refused by both engines
    path = str(tmp_path / "q.bundle.msgpack")
    ref_bundle.save_bundle(path, ref_bundle.PolicyBundle(
        "qtable", "full", 5, {b"\x00" * 8: np.zeros(10, np.float32)}))
    for extra in ([], ["--round-replay"]):
        with pytest.raises(ValueError, match="host-side"):
            serve_fleet.main(["--bundle", path, "--cells", "4", "--rounds",
                              "1", "--device", "cpu"] + extra)
