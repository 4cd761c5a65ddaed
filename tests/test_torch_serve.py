"""The whole slice: the port's ``serve_stream`` against the reference's.

Same scenario, stream and key through ``repro.serve.serve_stream`` and
``repro_torch.serve.engine.serve_stream(device="cpu")``, with background
noise on, for the greedy baseline and a guarded DQN, uncoupled and under
each coupling: ``dropped``, ``served``, ``violated`` and ``action`` are
identical, ``wait_ms`` / ``service_ms`` / ``art_ms`` and every report
figure agree to 1e-5 (absolute, relative above 1).  The Poisson request
stream is bit-equal to the reference's from the same key, and the serving
CLI's seed gives the reference CLI's fleet, stream and serving key.
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
from repro_torch import random as rnd
from repro_torch.economy import builtin_profile
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
    np.testing.assert_array_equal(ids, r_ids)
    np.testing.assert_array_equal(now, r_now)
    np.testing.assert_array_equal(live, r_live)
    assert n_ep == r_ep


def test_later_slices_raise():
    """Telemetry and the economy are in: both configurations build, with
    the reference's window default, and live export without telemetry is
    refused as the reference refuses it.  A mesh that is no cells group
    is refused (the sharded slice: ``tests/test_torch_sharded.py``)."""
    assert ServeConfig(telemetry=True).window_ms == \
        RefServeConfig(telemetry=True).window_ms == 1000.0
    spot = builtin_profile("spot")
    assert ServeConfig(economy=spot).fleet().economy is spot
    assert make_spec("full_economy", 5).dim == \
        ref_make_spec("full_economy", 5).dim
    both = ServeConfig(telemetry=True, economy=spot)
    assert both.telemetry and both.fleet().economy is spot
    with pytest.raises(TypeError, match="EconomyProfile"):
        ServeConfig(economy="spot")
    pol = adapters.heuristic_greedy_policy(5)
    with pytest.raises(TypeError, match="CellsGroup"):
        make_serve_engine(pol, ServeConfig(), mesh=object())
    with pytest.raises(ValueError, match="requires ServeConfig.telemetry"):
        make_serve_engine(pol, ServeConfig(), live=object())
    make_serve_engine(pol, ServeConfig(telemetry=True), live=object())


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
    scn = random_fleet(rnd.PRNGKey(0, CPU), 8, n_max=N_MAX)
    stream = poisson_request_stream(rnd.PRNGKey(1, CPU), scn, 1000.0,
                                    epoch_ms=250.0)
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


@pytest.mark.parametrize("cells,rate,rounds,per_cell", [
    (7, 3.0, 4, False), (300, 3.0, 50, False), (65_536, 3.0, 4, False),
    (200, 2.0, 6, True)])
def test_poisson_request_stream_matches_reference(cells, rate, rounds,
                                                  per_cell):
    """t, cell and slo bit-equal to the reference's stream from the same
    key: Poisson counts on both branches (lam 12 and 150 a cell, and a
    per-cell rate array that straddles 10), float32 uniform times."""
    key = jax.random.split(jax.random.PRNGKey(cells), 4)[1]
    scn = ref_random_fleet(jax.random.PRNGKey(2), cells, n_max=N_MAX)
    if per_cell:
        rate = np.random.default_rng(1).uniform(0.0, 4.0, cells)
    horizon = rounds * 250.0
    kw = dict(rate=rate, round_ms=250.0, epoch_ms=horizon / 2)
    want = ref_poisson_stream(key, scn, horizon, **kw)
    got = poisson_request_stream(convert.key_from_data(np.asarray(key), CPU),
                                 convert.fleet_scenario(scn, CPU), horizon,
                                 **kw)
    assert got.n_requests == want.n_requests > 0
    for name in ("t_ms", "cell", "slo_ms"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32),
                                      name)
    assert (got.horizon_ms, got.epoch_ms, got.n_cells) == (
        want.horizon_ms, want.epoch_ms, want.n_cells)


@pytest.mark.parametrize("seed,cells_per_edge,shared", [
    (0, 1, False), (7, 4, True)])
def test_cli_serves_the_reference_cli_draws(seed, cells_per_edge, shared):
    """``serve(greedy=True, seed=s)`` serves the records that the
    reference's ``serve_stream`` serves on its CLI's draws: ``k_fleet,
    k_trace, k_serve, k_guard = split(PRNGKey(s), 4)``, the fleet from
    ``k_fleet``, the stream from ``k_trace``, the serving noise from
    ``k_serve``."""
    cells, rounds, epochs, rate = 16, 4, 2, 3.0
    cfg_kw = dict(n_max=N_MAX, obs_spec=SPEC, shared_cloud=shared,
                  shared_edge=shared)
    k_fleet, k_trace, k_serve, _ = jax.random.split(jax.random.PRNGKey(seed),
                                                    4)
    scn = ref_random_fleet(k_fleet, cells, n_max=N_MAX,
                           cells_per_edge=cells_per_edge)
    ref_cfg = RefServeConfig(**cfg_kw)
    horizon = rounds * ref_cfg.round_ms
    stream = ref_poisson_stream(k_trace, scn, horizon, rate=rate,
                                round_ms=ref_cfg.round_ms,
                                epoch_ms=horizon / epochs)
    ref_pol = ref_adapters.heuristic_greedy_policy(ref_make_spec(SPEC, N_MAX))
    ref = ref_serve_stream(ref_pol, ref_pol.init(None), scn, stream, ref_cfg,
                           key=k_serve)
    rep = serve_fleet.serve(greedy=True, seed=seed, cells=cells, rate=rate,
                            rounds=rounds, epochs=epochs,
                            cells_per_edge=cells_per_edge,
                            shared_cloud=shared, shared_edge=shared,
                            device="cpu", verbose=False)
    _assert_reports_match(rep, ref)
    assert rep["served_requests"] > 0


def test_cli_quiet_tick_and_queue_options_serve_the_reference(tmp_path):
    """``--quiet --tick-ms 40 --queue-cap 16`` serve what the reference's
    ``serve_stream`` serves on its CLI's draws with those settings, and
    the report's config records them as the reference CLI does; ``--out``
    writes the report, and an unwritable ``--out`` exits before any
    work."""
    seed, cells, rounds, epochs, rate = 3, 16, 5, 2, 12.0
    cfg_kw = dict(n_max=N_MAX, obs_spec=SPEC, quiet=True, tick_ms=40.0,
                  queue_cap=16, shared_cloud=True, shared_edge=True)
    k_fleet, k_trace, k_serve, _ = jax.random.split(jax.random.PRNGKey(seed),
                                                    4)
    scn = ref_random_fleet(k_fleet, cells, n_max=N_MAX, cells_per_edge=4)
    ref_cfg = RefServeConfig(**cfg_kw)
    horizon = rounds * ref_cfg.round_ms
    stream = ref_poisson_stream(k_trace, scn, horizon, rate=rate,
                                round_ms=ref_cfg.round_ms,
                                epoch_ms=horizon / epochs)
    ref_pol = ref_adapters.heuristic_greedy_policy(ref_make_spec(SPEC, N_MAX))
    ref = ref_serve_stream(ref_pol, ref_pol.init(None), scn, stream, ref_cfg,
                           key=k_serve)
    out = tmp_path / "serve.json"
    rep = serve_fleet.main(["--greedy", "--seed", str(seed), "--cells",
                            str(cells), "--rate", str(rate), "--rounds",
                            str(rounds), "--epochs", str(epochs),
                            "--cells-per-edge", "4", "--shared-cloud",
                            "--shared-edge", "--quiet", "--tick-ms", "40",
                            "--queue-cap", "16", "--out", str(out),
                            "--device", "cpu"])
    _assert_reports_match(rep, ref)
    assert rep["dropped_requests"] > 0  # 16-request rings overflow
    assert {k: rep["config"][k] for k in ("quiet", "tick_ms", "queue_cap")} \
        == {"quiet": True, "tick_ms": 40.0, "queue_cap": 16}
    assert rep["tick_ms"] == 40.0
    import json
    written = json.loads(out.read_text())
    assert written["config"] == rep["config"]
    assert written["served_requests"] == rep["served_requests"]
    with pytest.raises(SystemExit, match="does not exist"):
        serve_fleet.main(["--greedy", "--out",
                          str(tmp_path / "missing" / "x.json"),
                          "--device", "cpu", "--cells", "4"])


def test_tick_calls_group_occupancy_three_times(monkeypatch):
    """Under shared_edge with the ``full`` spec a tick sums edge groups
    three times (its observe's coupling and group load, the transition's
    coupling) and builds no group index: ``serve_stream`` builds it once
    at set-up for a scenario that has none."""
    from repro_torch.fleet import latency, workload
    from repro_torch.kernels import orchestration as orch
    calls = {"group_occupancy": 0, "group_index": 0}

    def counted(name, fn):
        def wrapper(*args):
            calls[name] += 1
            return fn(*args)
        return wrapper

    scn = random_fleet(rnd.PRNGKey(4, CPU), 16, n_max=N_MAX,
                       cells_per_edge=4)._replace(group_index=None)
    monkeypatch.setattr(latency.orchestration, "group_occupancy",
                        counted("group_occupancy", orch.group_occupancy))
    monkeypatch.setattr(workload, "group_index",
                        counted("group_index", orch.group_index))
    cfg = ServeConfig(n_max=N_MAX, obs_spec=SPEC, shared_cloud=True,
                      shared_edge=True)
    horizon = 3 * cfg.round_ms
    stream = poisson_request_stream(rnd.PRNGKey(5, CPU), scn, horizon,
                                    rate=3.0, round_ms=cfg.round_ms,
                                    epoch_ms=horizon / 2)
    pol = adapters.heuristic_greedy_policy(make_spec(SPEC, N_MAX))
    rep = serve_stream(pol, pol.init(0, CPU), scn, stream, cfg, device=CPU)
    assert calls == {"group_occupancy": 3 * rep["n_ticks"],
                     "group_index": 1}
