"""The whole slice: the port's ``serve_stream`` against the reference's.

Same scenario, stream and key through ``repro.serve.serve_stream`` and
``repro_torch.serve.engine.serve_stream(device="cpu")``, with background
noise on, for the greedy baseline and a guarded DQN, uncoupled and under
each coupling: ``dropped``, ``served``, ``violated`` and ``action`` are
identical, ``wait_ms`` / ``service_ms`` / ``art_ms`` and every report
figure agree to 1e-5 (absolute, relative above 1).
"""
import jax
import numpy as np
import pytest
import torch

from repro.fleet.workload import poisson_round_trace
from repro.fleet.workload import random_fleet as ref_random_fleet
from repro.policy import adapters as ref_adapters
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import poisson_request_stream as ref_poisson_stream
from repro.serve import round_synchronous_stream
from repro.serve import serve_stream as ref_serve_stream
from repro.serve.engine import _tick_buckets as ref_tick_buckets
from repro.serve.stream import RequestStream as RefRequestStream
from repro.specs.observation import make_spec as ref_make_spec
from repro_torch import convert
from repro_torch.launch import serve_fleet
from repro_torch.fleet.workload import random_fleet
from repro_torch.policy import adapters
from repro_torch.policy.bundle import PolicyBundle, save_bundle
from repro_torch.serve.engine import (ServeConfig, _tick_buckets,
                                      make_serve_engine, serve_stream)
from repro_torch.serve.stream import poisson_request_stream
from repro_torch.specs.observation import make_spec

CPU = torch.device("cpu")
N_MAX, SPEC = 5, "full"
EXACT = ("dropped", "served", "violated", "action")
CLOSE = ("wait_ms", "service_ms", "art_ms")
FIGURES = ("n_requests", "served_requests", "dropped_requests",
           "deferred_requests", "slo_attainment", "violation_rate",
           "mean_latency_ms", "mean_wait_ms", "mean_service_ms",
           "mean_art_ms", "p50_latency_ms", "p95_latency_ms",
           "p99_latency_ms", "n_epochs", "n_ticks")


def _policies(kind):
    """(reference policy, reference params, port policy, port params)."""
    ref_spec, spec = ref_make_spec(SPEC, N_MAX), make_spec(SPEC, N_MAX)
    if kind == "greedy":
        ref_pol = ref_adapters.heuristic_greedy_policy(ref_spec)
        return (ref_pol, ref_pol.init(jax.random.PRNGKey(0)),
                adapters.heuristic_greedy_policy(spec), None)
    ref_dqn = ref_adapters.dqn_policy(ref_spec, hidden=(32,))
    ref_fb = ref_adapters.heuristic_greedy_policy(ref_spec)
    ref_params = ref_adapters.slo_guarded_params(
        ref_dqn.init(jax.random.PRNGKey(5)), ref_fb.init(None))
    pol = adapters.slo_guarded(adapters.dqn_policy(spec, hidden=(32,)), spec)
    params = convert.policy_params(jax.tree.map(np.asarray, ref_params), CPU)
    return (ref_adapters.slo_guarded(ref_dqn, ref_spec, ref_fb), ref_params,
            pol, params)


def _assert_reports_match(rep, ref):
    for k in EXACT:
        np.testing.assert_array_equal(rep["records"][k],
                                      np.asarray(ref["records"][k]), k)
    for k in CLOSE:
        np.testing.assert_allclose(rep["records"][k],
                                   np.asarray(ref["records"][k]),
                                   atol=1e-5, rtol=0, err_msg=k)
    for k in FIGURES:
        got, want = rep[k], ref[k]
        assert (got is None) == (want is None), (k, got, want)
        if want is not None:
            assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (k, got,
                                                                   want)


def _serve_both(kind, scn, stream, cfg_kw, key_seed):
    ref_pol, ref_params, pol, params = _policies(kind)
    ref_key = jax.random.PRNGKey(key_seed)
    ref = ref_serve_stream(ref_pol, ref_params, scn, stream,
                           RefServeConfig(**cfg_kw), key=ref_key)
    if params is None:
        params = pol.init(0, CPU)
    rep = serve_stream(pol, params, convert.fleet_scenario(scn, CPU),
                       convert.request_stream(stream), ServeConfig(**cfg_kw),
                       key=convert.key_from_data(np.asarray(ref_key), CPU),
                       device=CPU)
    return rep, ref


@pytest.mark.parametrize("kind,shared_cloud,shared_edge,queue_cap", [
    ("greedy", False, False, 64),
    ("greedy", True, False, 64),
    ("greedy", False, True, 3),      # small rings: overflow drops
    ("guarded-dqn", False, False, 64),
    ("guarded-dqn", True, False, 64),
    ("guarded-dqn", False, True, 64),
])
def test_serve_matches_reference(kind, shared_cloud, shared_edge, queue_cap):
    cells, rounds, seed = 20, 4, 3
    scn = ref_random_fleet(jax.random.PRNGKey(seed), cells, n_max=N_MAX,
                           cells_per_edge=4 if shared_edge else 1)
    cfg_kw = dict(n_max=N_MAX, obs_spec=SPEC, queue_cap=queue_cap,
                  shared_cloud=shared_cloud, shared_edge=shared_edge)
    round_ms = N_MAX * 50.0
    horizon = rounds * round_ms
    stream = ref_poisson_stream(jax.random.PRNGKey(seed + 1), scn, horizon,
                                rate=4.0, round_ms=round_ms,
                                epoch_ms=horizon / 2)
    rep, ref = _serve_both(kind, scn, stream, cfg_kw, seed + 2)
    _assert_reports_match(rep, ref)
    assert rep["served_requests"] > 0
    if queue_cap == 3:
        assert rep["dropped_requests"] > 0


def test_round_synchronous_stream_matches_reference():
    """The degenerate mode the reference's round↔request parity tests
    serve through: all arrivals on round boundaries."""
    scn = ref_random_fleet(jax.random.PRNGKey(11), 12, n_max=4)
    trace = poisson_round_trace(jax.random.PRNGKey(12), scn, 5, rate=2.0)
    cfg_kw = dict(n_max=4, obs_spec="base", quiet=True)
    stream = round_synchronous_stream(np.asarray(trace), 4 * 50.0)
    ref_pol = ref_adapters.heuristic_greedy_policy(4)
    ref = ref_serve_stream(ref_pol, ref_pol.init(None), scn, stream,
                           RefServeConfig(**cfg_kw),
                           key=jax.random.PRNGKey(13))
    pol = adapters.heuristic_greedy_policy(4)
    rep = serve_stream(pol, pol.init(0, CPU),
                       convert.fleet_scenario(scn, CPU),
                       convert.request_stream(stream), ServeConfig(**cfg_kw),
                       key=convert.key_from_data(
                           np.asarray(jax.random.PRNGKey(13)), CPU),
                       device=CPU)
    _assert_reports_match(rep, ref)
    assert rep["deferred_requests"] == 0 and rep["dropped_requests"] == 0


@pytest.mark.parametrize("tick_ms,epoch_ms", [(50.0, 250.0), (30.0, 1000.0)])
def test_tick_buckets_match_reference(tick_ms, epoch_ms):
    rng = np.random.default_rng(4)
    t = np.sort(rng.uniform(0.0, 1000.0, 700)).astype(np.float32)
    t[:40] = 0.0                      # a burst on the first tick
    stream = RefRequestStream(t, rng.integers(0, 30, 700).astype(np.int32),
                              np.full(700, 400.0, np.float32), 1000.0,
                              epoch_ms, 30)
    tpe = max(1, int(round(epoch_ms / tick_ms)))
    ids, now, live, n_ep = _tick_buckets(convert.request_stream(stream),
                                         tick_ms, tpe)
    r_ids, r_now, r_live, r_ep = ref_tick_buckets(stream, tick_ms, tpe)
    np.testing.assert_array_equal(ids, r_ids[:, 0])
    np.testing.assert_array_equal(now, r_now)
    np.testing.assert_array_equal(live, r_live)
    assert n_ep == r_ep


def test_later_slices_raise():
    with pytest.raises(NotImplementedError, match="telemetry"):
        ServeConfig(telemetry=True)
    with pytest.raises(NotImplementedError, match="economy"):
        ServeConfig(economy="spot")
    with pytest.raises(NotImplementedError, match="economy"):
        make_spec("full_economy", 5)
    pol = adapters.heuristic_greedy_policy(5)
    with pytest.raises(NotImplementedError, match="sharded"):
        make_serve_engine(pol, ServeConfig(), mesh=object())
    with pytest.raises(NotImplementedError, match="telemetry"):
        make_serve_engine(pol, ServeConfig(), live=object())


def test_cli_serves_greedy_and_a_guarded_bundle(tmp_path, capsys):
    rep = serve_fleet.main(["--greedy", "--cells", "8", "--rounds", "2",
                            "--shared-edge", "--cells-per-edge", "4",
                            "--device", "cpu"])
    assert rep["served_requests"] > 0 and rep["device"] == "cpu"
    spec = make_spec("full", 5)
    net = adapters.dqn_policy(spec, hidden=(16,)).init(1, CPU)
    path = str(tmp_path / "dqn.bundle.msgpack")
    save_bundle(path, PolicyBundle("dqn", "full", 5, net,
                                   meta={"shared_cloud": True}))
    rep = serve_fleet.serve(bundle=path, guard=True, cells=8, rounds=2,
                            device="cpu", verbose=False)
    assert rep["config"]["kind"] == "guarded-dqn"
    assert rep["config"]["shared_cloud"] is True
    assert rep["violation_rate"] == 0.0
    assert '"served_requests"' in capsys.readouterr().out.splitlines()[-1]


def test_on_epoch_runs_at_every_epoch_boundary():
    """The hot-swap hook runs once per epoch, and handing back the same
    params changes no outcome (the epoch split is not a serving knob)."""
    scn = random_fleet(0, 8, n_max=N_MAX, device=CPU)
    stream = poisson_request_stream(1, scn, 1000.0, epoch_ms=250.0)
    pol = adapters.heuristic_greedy_policy(make_spec(SPEC, N_MAX))
    cfg = ServeConfig(n_max=N_MAX, obs_spec=SPEC)
    seen = []
    rep = serve_stream(pol, pol.init(0, CPU), scn, stream, cfg, device=CPU,
                       on_epoch=lambda e, p: seen.append(e) or p)
    assert seen == list(range(rep["n_epochs"])) and rep["n_epochs"] > 1
    plain = serve_stream(pol, pol.init(0, CPU), scn,
                         stream._replace(epoch_ms=1000.0), cfg, device=CPU)
    for k in EXACT + CLOSE:
        np.testing.assert_array_equal(rep["records"][k],
                                      plain["records"][k], k)
