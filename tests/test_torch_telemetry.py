"""The port's telemetry (``repro_torch.telemetry``) against
``repro.telemetry``, at the reference fixtures' sizes (8 cells, n_max 4).

* **Metric buffers.**  ``log_edges``, ``metrics_init``'s edges,
  ``observe_values``' histogram, the percentiles, by-name counters and
  gauges (a host or a device window index) and ``buffer_series`` equal
  the reference's on the same numpy inputs; ``window_of`` lands every
  float32 tick time, window edges included, where the reference's does.
* **Serving.**  The same scenario, stream and key through both packages'
  ``serve_stream`` with telemetry on, greedy and under the ``spot`` and
  ``serverless`` economies, background on and off, at the fixtures'
  500 ms and 400 ms windows and at a 40 ms tick with 333 ms windows:
  counters, economy counters, the histogram and its percentiles
  identical, gauges within 1e-5 with the same unwritten (None) windows,
  records as ``tests/test_torch_serve.py`` holds them.  Telemetry is
  observation only: the port's records are byte-identical with it off.
* **Training.**  From a carried reference state (telemetry on), 2
  epochs: the session counters and the |TD| histogram identical, the
  gauges within the trainer's 1e-5 bar, ``train_telemetry_report`` and
  ``TrainLiveEmitter``'s records the reference's.
* **Traces** built from either package's run are equal, sampled by the
  same id hash; ``validate_trace`` rejects the reference's corruptions.
* ``profiled`` on the CPU.
"""
import io
import json

import jax
import numpy as np
import pytest
import torch

from repro.economy import builtin_profile as ref_builtin_profile
from repro.fleet import FleetConfig as RefFleetConfig
from repro.fleet import random_fleet as ref_random_fleet
from repro.hltrain import FleetHLParams as RefParams
from repro.hltrain import make_hl_trainer as ref_make_hl_trainer
from repro.hltrain import train_telemetry_report as ref_train_report
from repro.policy import heuristic_greedy_policy as ref_greedy_policy
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import poisson_request_stream as ref_poisson_stream
from repro.serve import serve_stream as ref_serve_stream
from repro.telemetry import NdjsonSink as RefNdjsonSink
from repro.telemetry import TrainLiveEmitter as RefTrainLiveEmitter
from repro.telemetry import build_trace as ref_build_trace
from repro.telemetry import metrics as ref_metrics
from repro.telemetry import trace as ref_trace
from repro_torch import convert
from repro_torch.economy import builtin_profile
from repro_torch.fleet import FleetConfig, random_fleet
from repro_torch.hltrain import (FleetHLParams, make_hl_trainer,
                                 train_telemetry_report)
from repro_torch.policy import adapters
from repro_torch.serve import (ServeConfig, poisson_request_stream,
                               serve_stream)
from repro_torch.telemetry import (NdjsonSink, TrainLiveEmitter, build_trace,
                                   buffer_series, count_event,
                                   histogram_percentile,
                                   histogram_percentiles, metrics_init,
                                   observe_values, profiled, read_trace,
                                   set_gauge, validate_trace, write_trace)
from repro_torch.telemetry import metrics
from repro_torch.telemetry.trace import _sample_mask

CPU = torch.device("cpu")
N_MAX, CELLS = 4, 8
EXACT = ("dropped", "served", "violated", "action")
CLOSE = ("wait_ms", "service_ms", "art_ms")
GAUGE_BAR = 1e-5
# the trainer's float bar (tests/test_torch_trainer.py): buffers, metrics
TRAIN_BAR = 1e-5
TRAIN_HP = dict(epochs=2, n_direct=3, t_direct=6, n_world=6, n_suggest=2,
                t_suggest=3, n_plan=6, k_best=3, batch=16, direct_cap=512,
                world_cap=512, plan_cap=256, telemetry=True)
TRAIN_CFG = dict(n_max=N_MAX, obs_spec="full", shared_cloud=True,
                 shared_edge=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tensors this small gain nothing from intra-op threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key(seed):
    k = jax.random.PRNGKey(seed)
    return k, convert.key_from_data(np.asarray(k), CPU)


def _serve_both(*, window_ms=500.0, tick_ms=50.0, economy=None, quiet=True,
                rate=2.0, rounds=8, epochs=1, telemetry=True, queue_cap=64,
                ref_live=None, live=None):
    """The reference fixture's run (fleet key 3, stream key 4, serving key
    5, greedy) through both packages: (port report, reference report,
    reference stream, port stream)."""
    scn = ref_random_fleet(jax.random.PRNGKey(3), CELLS, n_max=N_MAX)
    kw = dict(n_max=N_MAX, quiet=quiet, telemetry=telemetry,
              window_ms=window_ms, tick_ms=tick_ms, queue_cap=queue_cap)
    ref_cfg = RefServeConfig(
        **kw, economy=ref_builtin_profile(economy) if economy else None)
    cfg = ServeConfig(**kw,
                      economy=builtin_profile(economy) if economy else None)
    horizon = rounds * ref_cfg.round_ms
    stream = ref_poisson_stream(jax.random.PRNGKey(4), scn, horizon,
                                rate=rate, round_ms=ref_cfg.round_ms,
                                epoch_ms=horizon / epochs)
    ref_pol = ref_greedy_policy(N_MAX)
    rk, pk = _key(5)
    ref = ref_serve_stream(ref_pol, ref_pol.init(jax.random.PRNGKey(0)), scn,
                           stream, ref_cfg, key=rk, live=ref_live)
    pol = adapters.heuristic_greedy_policy(N_MAX)
    p_stream = convert.request_stream(stream)
    rep = serve_stream(pol, pol.init(0, CPU), convert.fleet_scenario(scn, CPU),
                       p_stream, cfg, key=pk, device=CPU, live=live)
    return rep, ref, stream, p_stream


def _assert_records(rep, ref):
    for k in EXACT:
        np.testing.assert_array_equal(rep["records"][k],
                                      np.asarray(ref["records"][k]), k)
    for k in CLOSE:
        np.testing.assert_allclose(rep["records"][k],
                                   np.asarray(ref["records"][k]),
                                   atol=1e-5, rtol=0, err_msg=k)


def _gauge_array(values):
    return np.array([np.nan if v is None else v for v in values], np.float64)


def assert_telemetry_matches(got: dict, want: dict) -> None:
    """A ``telemetry_report``: counters, histogram, edges and percentiles
    identical; gauges and attainment within 1e-5, None where the
    reference's is None."""
    assert got.keys() == want.keys()
    assert got["series"].keys() == want["series"].keys()
    for k in want:
        if k != "series":
            assert got[k] == want[k], k
    for name, w in want["series"].items():
        g = got["series"][name]
        if all(isinstance(v, int) for v in w):
            assert g == w, name
        else:
            ga, wa = _gauge_array(g), _gauge_array(w)
            np.testing.assert_array_equal(np.isnan(ga), np.isnan(wa), name)
            np.testing.assert_allclose(ga, wa, atol=GAUGE_BAR, rtol=0,
                                       err_msg=name)


# ----------------------------------------------------------- metric buffers
@pytest.mark.parametrize("lo,hi,bins", [(1.0, 1e6, 256), (1e-3, 1e3, 128),
                                        (1.0, 1e3, 32), (0.5, 7.0, 3)])
def test_log_edges_and_init_match_reference(lo, hi, bins):
    np.testing.assert_array_equal(metrics.log_edges(lo, hi, bins),
                                  ref_metrics.log_edges(lo, hi, bins))
    buf = metrics_init(3, ("a", "b"), ("g",), lo=lo, hi=hi, bins=bins,
                       device=CPU)
    ref = ref_metrics.metrics_init(3, ("a", "b"), ("g",), lo=lo, hi=hi,
                                   bins=bins)
    np.testing.assert_array_equal(buf.edges.numpy(), np.asarray(ref.edges))
    assert buf.n_windows == ref.n_windows == 3
    assert buf.hist.dtype == torch.int32 and buf.snaps.isnan().all()


@pytest.mark.parametrize("seed,masked", [(0, False), (1, True), (2, True)])
def test_observe_values_matches_reference(seed, masked):
    """Values across and beyond the edges, the edges themselves and their
    float32 neighbours, masked or not: the same histogram."""
    rng = np.random.default_rng(seed)
    edges = ref_metrics.log_edges(1.0, 1e3, 32)
    v = np.concatenate([
        np.exp(rng.uniform(np.log(0.1), np.log(1e4), 500)),
        edges, np.nextafter(edges, np.float32(0)),
        np.nextafter(edges, np.float32(np.inf)), [0.0, 1e9]]).astype(
            np.float32)
    mask = rng.random(v.size) < 0.7 if masked else None
    ref = ref_metrics.observe_values(
        ref_metrics.metrics_init(1, lo=1.0, hi=1e3, bins=32), v, mask)
    buf = observe_values(metrics_init(1, lo=1.0, hi=1e3, bins=32,
                                      device=CPU),
                         torch.as_tensor(v),
                         None if mask is None else torch.as_tensor(mask))
    np.testing.assert_array_equal(buf.hist.numpy(), np.asarray(ref.hist))
    for p in (0.0, 1.0, 50.0, 95.0, 99.0, 100.0):
        assert histogram_percentile(buf.hist.numpy(), buf.edges.numpy(), p) \
            == ref_metrics.histogram_percentile(ref.hist, ref.edges, p)
    assert histogram_percentiles(buf.hist, buf.edges) == \
        ref_metrics.histogram_percentiles(ref.hist, ref.edges)


def test_histogram_percentile_empty_and_single():
    buf = metrics_init(1, lo=1.0, hi=1e3, bins=32, device=CPU)
    assert histogram_percentile(buf.hist, buf.edges, 50) is None
    observe_values(buf, np.array([37.0]))
    est = histogram_percentile(buf.hist, buf.edges, 50)
    edges = buf.edges.numpy()
    k = int(np.searchsorted(edges, 37.0, side="right") - 1)
    assert edges[k] <= est <= edges[k + 1]


@pytest.mark.parametrize("tick_ms,width,n", [(40.0, 333.0, 400),
                                             (33.3, 100.1, 400),
                                             (0.1, 0.7, 300),
                                             (50.0, 250.0, 100)])
def test_window_of_matches_reference(tick_ms, width, n):
    """Every float32 tick time ``k * tick_ms``, a tick later (the live
    closing test) and the window edges themselves land in the reference's
    window, clipped at the last."""
    W = 7
    buf = metrics_init(W, ("c",), device=CPU)
    ref = ref_metrics.metrics_init(W, ("c",))
    now = (np.arange(n, dtype=np.float64) * tick_ms).astype(np.float32)
    edges = (np.arange(W + 2) * np.float64(width)).astype(np.float32)
    times = np.concatenate([now, now + np.float32(tick_ms), edges,
                            np.nextafter(edges, np.float32(0))])
    want = np.asarray(jax.vmap(
        lambda t: ref_metrics.window_of(ref, t, width))(times))
    got = [metrics.window_of(buf, t, width) for t in times]
    np.testing.assert_array_equal(got, want)


def test_counters_and_gauges_by_name_match_reference():
    """``count_event`` / ``set_gauge`` at host and device window indices,
    then ``buffer_series``: the reference's series."""
    names_c, names_g = ("a", "b"), ("x", "y", "z")
    buf = metrics_init(4, names_c, names_g, device=CPU)
    ref = ref_metrics.metrics_init(4, names_c, names_g)
    ops = [("a", 0, 3), ("b", 2, 5), ("a", 0, 1), ("b", 3, 7), ("a", 3, 2)]
    for name, w, n in ops:
        ref = ref_metrics.count_event(ref, name, w, n)
        count_event(buf, name, w if w % 2 else torch.tensor(w), n)
    count_event(buf, "b", torch.tensor(1, dtype=torch.int32),
                torch.tensor(4))
    ref = ref_metrics.count_event(ref, "b", 1, 4)
    for name, w, v in [("x", 1, 2.5), ("y", 1, -1.0), ("x", 1, 3.25),
                       ("z", 3, 7.0)]:
        ref = ref_metrics.set_gauge(ref, name, w, v)
        set_gauge(buf, name, torch.tensor(w) if v > 0 else w,
                  torch.tensor(v) if w == 3 else v)
    got, want = buffer_series(buf), ref_metrics.buffer_series(ref)
    for part in ("counters", "gauges"):
        assert got[part].keys() == want[part].keys()
        for name, w in want[part].items():
            np.testing.assert_array_equal(got[part][name], w, name)
    np.testing.assert_array_equal(got["hist"], want["hist"])
    np.testing.assert_array_equal(got["edges"], want["edges"])
    assert got["hist_percentiles"] == want["hist_percentiles"]
    assert {n: v.tolist() for n, v in buf.counters.items()} == \
        {n: np.asarray(v).tolist() for n, v in ref.counters.items()}


# ----------------------------------------------------------------- serving
SERVE_CASES = [
    dict(window_ms=500.0),
    dict(window_ms=400.0, quiet=False, epochs=3),
    dict(window_ms=333.0, tick_ms=40.0, quiet=False, epochs=2),
    dict(window_ms=500.0, economy="spot", quiet=False, epochs=2),
    dict(window_ms=400.0, economy="serverless", tick_ms=40.0),
    dict(window_ms=250.0, queue_cap=2, rate=8.0, rounds=6),
]


@pytest.mark.parametrize("case", SERVE_CASES,
                         ids=lambda c: "-".join(f"{k}={v}"
                                                for k, v in c.items()))
def test_serve_telemetry_matches_reference(case):
    rep, ref, _, _ = _serve_both(**case)
    _assert_records(rep, ref)
    assert_telemetry_matches(rep["telemetry"], ref["telemetry"])
    tel = rep["telemetry"]
    assert tel["n_windows"] >= 2 and sum(tel["latency_hist"]) > 0
    if case.get("economy"):
        assert rep["economy"] == ref["economy"]
        s = tel["series"]
        assert sum(s["spend_uusd"]) == rep["economy"]["spend_uusd_total"]
        assert sum(s["cold_starts"]) == rep["economy"]["cold_starts"]
    if case.get("queue_cap") == 2:
        assert rep["dropped_requests"] > 0


def test_serve_histogram_matches_request_report():
    """The on-device latency histogram's percentiles sit within one bin
    of ``request_report``'s exact ones."""
    rep, _, _, _ = _serve_both()
    tel = rep["telemetry"]
    edges = np.asarray(tel["latency_hist_edges_ms"], np.float64)
    bin_of = lambda v: int(np.clip(np.searchsorted(edges, v, side="right")
                                   - 1, 0, len(edges) - 2))
    for p in (50, 95, 99):
        assert abs(bin_of(tel[f"hist_p{p}_latency_ms"])
                   - bin_of(rep[f"p{p}_latency_ms"])) <= 1, p


@pytest.mark.parametrize("economy", [None, "spot"])
def test_telemetry_is_observation_only(economy):
    """Records with telemetry on are byte-identical to telemetry off."""
    on, _, _, _ = _serve_both(economy=economy, quiet=False, epochs=2)
    off, ref_off, _, _ = _serve_both(economy=economy, quiet=False, epochs=2,
                                     telemetry=False)
    assert "telemetry" not in off and "telemetry" not in ref_off
    for k, v in off["records"].items():
        assert v.tobytes() == on["records"][k].tobytes(), k
    assert off.get("economy") == on.get("economy")


# ----------------------------------------------------------------- training
def _carried_trainers():
    kw = dict(TRAIN_HP)
    ref_tr = ref_make_hl_trainer(RefFleetConfig(**TRAIN_CFG), RefParams(**kw))
    ref_scn = ref_random_fleet(jax.random.PRNGKey(0), 16, n_max=N_MAX,
                               cells_per_edge=4)
    return ref_tr, ref_scn, convert.fleet_scenario(ref_scn, CPU)


def _mem_events(sink):
    return [json.loads(line) for line in
            sink._out.getvalue().strip().splitlines()]


def test_trainer_telemetry_from_a_carried_state_matches_reference():
    ref_tr, ref_scn, scn = _carried_trainers()
    ref_state = ref_tr.init(jax.random.PRNGKey(1), ref_scn)
    state = convert.hl_train_state(ref_state, CPU)
    tr = make_hl_trainer(FleetConfig(**TRAIN_CFG), FleetHLParams(**TRAIN_HP))
    for e in range(TRAIN_HP["epochs"]):
        ref_state, _ = ref_tr.run(ref_state, ref_scn, e, 1)
        state, _ = tr.run(state, scn, e, 1)
    got, want = train_telemetry_report(state), ref_train_report(ref_state)
    assert got.keys() == want.keys()
    for k in ("n_sessions", "direct_steps", "td_hist", "td_hist_edges",
              "td_p50", "td_p95", "td_p99"):
        assert got[k] == want[k], k
    for k in ("epsilon", "mean_reward", "q_loss"):
        np.testing.assert_allclose(got[k], want[k], atol=TRAIN_BAR, rtol=0,
                                   err_msg=k)
    assert got["n_sessions"] == int(state.sessions) > 0
    assert sum(got["direct_steps"]) == int(state.direct_steps)
    assert sum(got["td_hist"]) > 0
    # the whole buffer, unwritten windows included, in the reference layout
    tel = convert.hl_train_state_arrays(state)["tel"]
    np.testing.assert_array_equal(tel["hist"], np.asarray(ref_state.tel.hist))
    for part in ("counters", "gauges"):
        for name, w in getattr(ref_state.tel, part).items():
            np.testing.assert_allclose(tel[part][name], np.asarray(w),
                                       atol=TRAIN_BAR, rtol=0, err_msg=name)


def test_train_live_emitter_matches_reference():
    """One ``train_session`` record per active direct session, in the
    reference's order and fields; floats within the trainer's bar."""
    ref_tr, ref_scn, scn = _carried_trainers()
    ref_sink = RefNdjsonSink(io.StringIO())
    ref_tr = ref_make_hl_trainer(RefFleetConfig(**TRAIN_CFG),
                                 RefParams(**TRAIN_HP),
                                 live=RefTrainLiveEmitter(ref_sink))
    ref_state = ref_tr.init(jax.random.PRNGKey(1), ref_scn)
    state = convert.hl_train_state(ref_state, CPU)
    sink = NdjsonSink(io.StringIO())
    tr = make_hl_trainer(FleetConfig(**TRAIN_CFG), FleetHLParams(**TRAIN_HP),
                         live=TrainLiveEmitter(sink))
    ref_state, _ = ref_tr.run(ref_state, ref_scn, 0, TRAIN_HP["epochs"])
    state, _ = tr.run(state, scn, 0, TRAIN_HP["epochs"])
    got, want = _mem_events(sink), _mem_events(ref_sink)
    assert len(got) == len(want) == int(state.sessions)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in ("event", "epoch", "session"):
            assert g[k] == w[k], k
        for k in ("mean_reward", "q_loss", "epsilon"):
            assert (g[k] is None) == (w[k] is None), k
            if w[k] is not None:
                assert abs(g[k] - w[k]) <= TRAIN_BAR, (k, g[k], w[k])
    eps = [e["epsilon"] for e in got]
    assert eps == sorted(eps, reverse=True)


def test_trainer_telemetry_window_sums_one_cell():
    """``tests/test_telemetry.py``'s accounting on B/85%: the session
    series sums to the direct counter, ε decays, the histogram fills."""
    from repro_torch.fleet import from_table4
    scn = from_table4(names=("B",), constraints=("85%",), device=CPU)
    hp = FleetHLParams(epochs=2, n_direct=2, t_direct=8, n_world=4,
                       n_suggest=1, t_suggest=2, n_plan=4, batch=8,
                       telemetry=True)
    trainer = make_hl_trainer(FleetConfig(n_max=5), hp)
    state, _ = trainer.run(trainer.init(_key(0)[1], scn), scn, 0, hp.epochs)
    rep = train_telemetry_report(state)
    assert rep["n_sessions"] == int(state.sessions)
    assert sum(rep["direct_steps"]) == int(state.direct_steps)
    assert rep["epsilon"] == sorted(rep["epsilon"], reverse=True)
    assert sum(rep["td_hist"]) > 0


# ------------------------------------------------------------------- traces
@pytest.fixture(scope="module")
def served():
    return _serve_both(quiet=False, epochs=2)


@pytest.mark.parametrize("sample", [1.0, 0.5, 0.05, 0.0])
def test_trace_matches_reference(served, sample, tmp_path):
    rep, ref, ref_stream, stream = served
    tick = 50.0
    got = build_trace(stream, rep["records"], tick, sample=sample)
    want = ref_build_trace(ref_stream, {k: np.asarray(v) for k, v in
                                        ref["records"].items()}, tick,
                           sample=sample)
    assert got == want
    np.testing.assert_array_equal(_sample_mask(1000, sample),
                                  ref_trace._sample_mask(1000, sample))
    if got:
        path = str(tmp_path / "trace.jsonl")
        write_trace(path, got)
        assert read_trace(path) == json.loads(json.dumps(got))
        summary = validate_trace(path)
        assert summary == ref_trace.validate_trace(path)
        if sample == 1.0:
            assert summary["served"] == rep["served_requests"]
            assert summary["dropped"] == rep["dropped_requests"]
            assert summary["deferred"] == rep["deferred_requests"]


def test_validate_trace_rejects_corruption(served):
    rep, _, _, stream = served
    events = build_trace(stream, rep["records"], 50.0)
    with pytest.raises(ValueError, match="more than once"):
        validate_trace(events + [events[0]])
    bad = [dict(ev) for ev in events]
    victim = next(ev for ev in bad if ev["status"] == "served")
    victim["t_complete_ms"] = victim["t_arrival_ms"] - 100.0
    with pytest.raises(ValueError):
        validate_trace(bad)
    with pytest.raises(ValueError, match="empty"):
        validate_trace([])


# ---------------------------------------------------------------- profiling
def test_profiled_split_and_memory(tmp_path):
    with profiled("t", device="cpu") as prof:
        x = torch.arange(1000).sum()
        prof.split()
        x += torch.arange(1000).sum()
    rep = prof.report()
    assert rep["compile_time_s"] >= 0 and rep["run_time_s"] >= 0
    assert rep["total_time_s"] >= rep["compile_time_s"]
    assert rep["peak_memory_mb"] > 0 and rep["memory_source"] == "host_rss"
    with profiled("traced", trace_dir=str(tmp_path / "tr"),
                  device="cpu") as prof:
        torch.ones(64).cumsum(0)
    doc = json.loads((tmp_path / "tr" / "traced.json").read_text())
    assert doc["traceEvents"]


def test_profiled_without_split_is_all_run_time():
    with profiled("t", device="cpu") as prof:
        pass
    assert prof.compile_time_s == 0.0
    assert prof.run_time_s == prof.total_time_s
