"""The port's live ops plane against the reference's: streaming export,
burn-rate alerts, the invariant audit, canary diffs, the trace report and
``serve_fleet``'s telemetry options, at ``tests/test_ops.py``'s sizes
(8 cells, n_max 4, 400 ms windows).

* ``LiveEmitter``: the same run through both packages writes the same
  NDJSON, apart from the epochs' ``wall_s`` (host clocks): every window
  once, closed windows at the closing tick's clock, the last flushed at
  its end, alerts inline, then the summary.  Live without telemetry
  raises ``ValueError`` in both, before any work.
* ``BurnRateAlerter``: the port's and the reference's alerters return the
  same event for every window of the same sequences.
* The audits agree check by check on both packages' reports (real runs,
  a tampered series, a capacity breach, a corrupted trace, the economy's
  spend law, a trainer's report), and the audit CLI exits as the
  reference's.
* ``canary_diff`` / ``render_canary`` and ``report_data`` give the
  reference's documents on the same runs and trace.
* ``serve_fleet --telemetry --window-ms --trace-out --trace-sample --live
  --live-out --slo-target --canary`` on a bundle the port wrote serves
  what the reference CLI serves on the same ``--seed``: the report's
  telemetry, the live file and the trace file; its refusals are the
  reference's.
"""
import copy
import io
import json

import jax
import numpy as np
import pytest
import torch

from repro.economy import builtin_profile as ref_builtin_profile
from repro.fleet import random_fleet as ref_random_fleet
from repro.launch.serve_fleet import serve_bundle as ref_serve_bundle
from repro.policy import heuristic_greedy_policy as ref_greedy_policy
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import poisson_request_stream as ref_poisson_stream
from repro.serve import serve_stream as ref_serve_stream
from repro.serve.engine import ECON_COUNTERS as REF_ECON_COUNTERS
from repro.serve.engine import ECON_GAUGES as REF_ECON_GAUGES
from repro.serve.engine import TEL_COUNTERS as REF_TEL_COUNTERS
from repro.serve.engine import TEL_GAUGES as REF_TEL_GAUGES
from repro.telemetry import audit as ref_audit
from repro.telemetry import canary as ref_canary
from repro.telemetry import live as ref_live
from repro.telemetry import report as ref_report
from repro.telemetry import build_trace as ref_build_trace
from repro_torch import convert
from repro_torch.economy import builtin_profile
from repro_torch.launch import serve_fleet
from repro_torch.policy import adapters
from repro_torch.policy.bundle import PolicyBundle, save_bundle
from repro_torch.serve import ServeConfig, serve_stream
from repro_torch.serve.engine import (ECON_COUNTERS, ECON_GAUGES,
                                      TEL_COUNTERS, TEL_GAUGES,
                                      make_serve_engine)
from repro_torch.sharding import CellsGroup
from repro_torch.specs.observation import make_spec
from repro_torch.telemetry import (BurnRateAlerter, BurnRateConfig,
                                   LiveEmitter, NdjsonSink,
                                   audit_serve_report, audit_trace,
                                   audit_train_report, build_trace,
                                   canary_diff, render_canary, write_trace)
from repro_torch.telemetry import audit as audit_mod
from repro_torch.telemetry import report as report_mod
from test_torch_telemetry import assert_telemetry_matches

CPU = torch.device("cpu")
N_MAX, CELLS = 4, 8


def mem_sink(sink_cls):
    return sink_cls(io.StringIO())


def sink_events(sink) -> list:
    return [json.loads(line) for line in
            sink._out.getvalue().strip().splitlines()]


def strip_wall(events: list) -> list:
    return [{k: v for k, v in e.items() if k != "wall_s"} for e in events]


def run_live(window_ms=400.0, queue_cap=64, rate=2.0, rounds=8,
             economy=None, quiet=True, tick_ms=50.0, slo_target=0.9):
    """``tests/test_ops.py``'s live run through both packages: (stream,
    port report, port events, reference report, reference events)."""
    scn = ref_random_fleet(jax.random.PRNGKey(3), CELLS, n_max=N_MAX)
    kw = dict(n_max=N_MAX, quiet=quiet, telemetry=True, window_ms=window_ms,
              queue_cap=queue_cap, tick_ms=tick_ms)
    ref_cfg = RefServeConfig(
        **kw, economy=ref_builtin_profile(economy) if economy else None)
    cfg = ServeConfig(**kw,
                      economy=builtin_profile(economy) if economy else None)
    stream = ref_poisson_stream(
        jax.random.PRNGKey(4), scn, rounds * ref_cfg.round_ms, rate=rate,
        round_ms=ref_cfg.round_ms, epoch_ms=2 * ref_cfg.round_ms)
    alerter = BurnRateConfig(target=slo_target)
    ref_sink = mem_sink(ref_live.NdjsonSink)
    ref_em = ref_live.LiveEmitter(
        ref_sink, REF_TEL_COUNTERS + (REF_ECON_COUNTERS if economy else ()),
        REF_TEL_GAUGES + (REF_ECON_GAUGES if economy else ()),
        window_ms=window_ms,
        alerter=ref_live.BurnRateAlerter(
            ref_live.BurnRateConfig(target=slo_target)))
    ref_pol = ref_greedy_policy(N_MAX)
    k = jax.random.PRNGKey(5)
    ref = ref_serve_stream(ref_pol, ref_pol.init(jax.random.PRNGKey(0)), scn,
                           stream, ref_cfg, key=k, live=ref_em)
    sink = mem_sink(NdjsonSink)
    em = LiveEmitter(sink, TEL_COUNTERS + (ECON_COUNTERS if economy else ()),
                     TEL_GAUGES + (ECON_GAUGES if economy else ()),
                     window_ms=window_ms, alerter=BurnRateAlerter(alerter))
    pol = adapters.heuristic_greedy_policy(N_MAX)
    rep = serve_stream(pol, pol.init(0, CPU), convert.fleet_scenario(scn, CPU),
                       convert.request_stream(stream), cfg,
                       key=convert.key_from_data(np.asarray(k), CPU),
                       device=CPU, live=em)
    return stream, cfg, rep, sink_events(sink), ref, sink_events(ref_sink)


@pytest.fixture(scope="module")
def live_run():
    return run_live()


# ------------------------------------------------------ live streaming
@pytest.mark.parametrize("case", [
    dict(), dict(window_ms=333.0, tick_ms=40.0, quiet=False),
    dict(window_ms=150.0, economy="spot", quiet=False, slo_target=0.5),
    dict(window_ms=30.0, rounds=3)])
def test_live_ndjson_matches_reference(case, live_run):
    """Window records at the closing tick's clock (flushed ones at their
    end), alerts and epoch records in the reference's order and values;
    only the epochs' wall_s differ (host clocks)."""
    _, _, rep, events, ref, ref_events = (live_run if not case
                                          else run_live(**case))
    assert strip_wall(events) == strip_wall(ref_events)
    n = rep["telemetry"]["n_windows"]
    windows = [e for e in events if e["event"] == "window"]
    assert sorted(w["window"] for w in windows) == list(range(n))
    assert events[-1] == dict(ref_events[-1], event="summary")
    assert events[-1]["n_windows"] == n
    assert all("wall_s" in e for e in events if e["event"] == "epoch")


def test_live_counters_match_run_end_series(live_run):
    _, _, rep, events, _, _ = live_run
    series = rep["telemetry"]["series"]
    for w in (e for e in events if e["event"] == "window"):
        for name in TEL_COUNTERS:
            assert w[name] == int(series[name][w["window"]]), name
    epochs = [e for e in events if e["event"] == "epoch"]
    served = [e["served"] for e in epochs]
    assert served == sorted(served) and served[-1] == rep["served_requests"]
    assert len([e for e in events if e["event"] == "window"]) >= \
        len(epochs) - 1


def test_live_requires_telemetry():
    pol = adapters.heuristic_greedy_policy(N_MAX)
    em = LiveEmitter(mem_sink(NdjsonSink), TEL_COUNTERS, TEL_GAUGES,
                     window_ms=500.0)
    with pytest.raises(ValueError, match="telemetry"):
        make_serve_engine(pol, ServeConfig(n_max=N_MAX), live=em)
    with pytest.raises(ValueError, match="live"):
        make_serve_engine(pol, ServeConfig(n_max=N_MAX, telemetry=True),
                          live=em, mesh=CellsGroup(None, 0, 1,
                                                   torch.device("cpu"),
                                                   "gloo"))


# --------------------------------------------------- burn-rate alerter
@pytest.mark.parametrize("cfg,windows", [
    (dict(target=0.9, fast_windows=1, slow_windows=3, threshold=2.0),
     [(0, 100, 100, 0), (1, 100, 100, 0), (2, 100, 80, 0), (3, 100, 60, 0),
      (4, 100, 95, 0), (5, 0, 0, 0), (6, 40, 10, 20)]),
    (dict(target=0.9, fast_windows=1, slow_windows=1, threshold=2.0),
     [(0, 50, 50, 50), (1, 10, 10, 0)]),
    (dict(target=0.9, fast_windows=1, slow_windows=1, threshold=1.0),
     [(0, 0, 0, 0), (1, 10, 0, 0), (1, 10, 0, 0), (3, 5, 4, 1),
      (2, 7, 7, 0)]),
    (dict(target=0.5, fast_windows=2, slow_windows=6, threshold=1.2),
     [(w, 20, 20 - 3 * w, w) for w in range(8)]),
])
def test_alerter_matches_reference(cfg, windows):
    """Fast and slow burns must both reach the threshold; drops count as
    errors; duplicates and windows out of order count once."""
    ours = BurnRateAlerter(BurnRateConfig(**cfg))
    ref = ref_live.BurnRateAlerter(ref_live.BurnRateConfig(**cfg))
    fired = 0
    for w, served, attained, dropped in windows:
        got = ours.observe(w, served, attained, dropped)
        assert got == ref.observe(w, served, attained, dropped), w
        fired += got is not None
    assert fired > 0
    assert ours._ledger == ref._ledger


def test_alerter_rejects_degenerate_target():
    for t in (0.0, 1.0):
        with pytest.raises(ValueError):
            BurnRateAlerter(BurnRateConfig(target=t))


# ---------------------------------------------------- invariant audit
def _audits_agree(report, ref_report_, **kw):
    """The port's audit of the port's report equals the reference's audit
    of the reference's report, check by check; returns the port's."""
    got = audit_serve_report(report, **kw)
    want = ref_audit.audit_serve_report(ref_report_, **kw)
    assert [c["check"] for c in got.checks] == \
        [c["check"] for c in want.checks]
    assert [c["ok"] for c in got.checks] == [c["ok"] for c in want.checks]
    assert got.summary() == want.summary()
    return got


def _trace_both(stream, cfg, rep, ref):
    return (build_trace(convert.request_stream(stream), rep["records"],
                        cfg.tick_ms),
            ref_build_trace(stream, {k: np.asarray(v) for k, v in
                                     ref["records"].items()}, cfg.tick_ms))


def test_audit_passes_on_real_run(live_run):
    stream, cfg, rep, _, ref, _ = live_run
    trace, ref_trace = _trace_both(stream, cfg, rep, ref)
    assert trace == ref_trace
    kw = dict(n_cells=CELLS, n_max=N_MAX, queue_cap=cfg.queue_cap)
    res = _audits_agree(rep, ref, trace=trace, **kw)
    assert res.ok, res.render()
    res.raise_on_failure()
    assert res.render() == ref_audit.audit_serve_report(
        ref, trace=ref_trace, **kw).render()


@pytest.mark.parametrize("tamper,check", [
    (lambda s, cap: s["admitted"].__setitem__(0, s["admitted"][0] + 1),
     "arrival_conservation"),
    (lambda s, cap: s["queue_depth"].__setitem__(0, cap + 1.0),
     "queue_depth_capacity"),
    (lambda s, cap: s["served"].__setitem__(1, s["served"][1] + 2),
     "served_window_sum"),
    (lambda s, cap: s["occ_cloud"].__setitem__(0, 1e6),
     "tier_occupancy")])
def test_audit_fails_on_tampered_series(live_run, tamper, check):
    _, cfg, rep, _, ref, _ = live_run
    bad, ref_bad = dict(rep), dict(ref)
    for r in (bad, ref_bad):
        r["telemetry"] = copy.deepcopy(r["telemetry"])
        tamper(r["telemetry"]["series"], cfg.queue_cap)
    res = _audits_agree(bad, ref_bad, n_cells=CELLS, n_max=N_MAX,
                        queue_cap=cfg.queue_cap)
    assert not res.ok and check in res.summary()["failed"]
    with pytest.raises(AssertionError):
        res.raise_on_failure()


def test_audit_fails_on_corrupted_trace(live_run):
    stream, cfg, rep, _, ref, _ = live_run
    trace, _ = _trace_both(stream, cfg, rep, ref)
    bad = [dict(e) for e in trace]
    victim = next(e for e in bad if e["status"] == "served"
                  and e["attained"])
    victim["wait_ms"] += 10 * victim["slo_ms"]
    got, want = audit_trace(bad, report=rep), ref_audit.audit_trace(
        bad, report=ref)
    assert not got.ok and got.summary() == want.summary()
    dup = trace + [trace[0]]
    assert audit_trace(dup).summary() == ref_audit.audit_trace(dup).summary()
    assert not audit_trace(dup).ok


def test_audit_without_telemetry_or_capacity():
    got = audit_serve_report({"n_requests": 1})
    assert got.summary() == ref_audit.audit_serve_report(
        {"n_requests": 1}).summary()
    assert not got.ok


def test_queue_overflow_counters_agree():
    """A tiny queue cap forces drops: the window counters, the request
    report, the trace and the live stream count the same drops."""
    stream, cfg, rep, events, ref, ref_events = run_live(
        queue_cap=2, rate=8.0, rounds=6)
    assert strip_wall(events) == strip_wall(ref_events)
    n_dropped = int(rep["dropped_requests"])
    assert n_dropped > 0
    assert int(np.sum(rep["telemetry"]["series"]["dropped"])) == n_dropped
    trace, _ = _trace_both(stream, cfg, rep, ref)
    assert sum(e["status"] == "dropped" for e in trace) == n_dropped
    assert sum(e["dropped"] for e in events
               if e["event"] == "window") == n_dropped
    res = _audits_agree(rep, ref, trace=trace, n_cells=CELLS, n_max=N_MAX,
                        queue_cap=cfg.queue_cap)
    assert res.ok, res.render()


def test_audit_economy_spend_law():
    """Under spot the economy's four conservation laws hold on the
    port's report; a tampered spend window breaks the spend law in both
    audits, and a report without the economy series says so."""
    _, cfg, rep, _, ref, _ = run_live(economy="spot", quiet=False,
                                      window_ms=200.0)
    kw = dict(n_cells=CELLS, n_max=N_MAX, queue_cap=cfg.queue_cap)
    res = _audits_agree(rep, ref, **kw)
    assert res.ok, res.render()
    names = [c["check"] for c in res.checks]
    for law in ("spend_conservation", "energy_conservation",
                "cold_start_conservation", "preemption_conservation",
                "tier_state_capacity"):
        assert law in names
    bad, ref_bad = dict(rep), dict(ref)
    for r in (bad, ref_bad):
        r["telemetry"] = copy.deepcopy(r["telemetry"])
        r["telemetry"]["series"]["spend_uusd"][0] += 1
    res = _audits_agree(bad, ref_bad, **kw)
    assert res.summary()["failed"] == ["spend_conservation"]
    for r in (bad, ref_bad):
        del r["telemetry"]["series"]["energy_mj"]
    assert "economy_series_present" in _audits_agree(
        bad, ref_bad, **kw).summary()["failed"]


@pytest.mark.parametrize("tamper", [None, "steps", "epsilon", "gap"])
def test_audit_train_report_matches_reference(tamper):
    rep = {"n_sessions": 3, "direct_steps": [60, 60, 60],
           "epsilon": [0.9, 0.8, 0.8], "mean_reward": [-1.0, -0.5, -0.4],
           "q_loss": [None, 0.2, 0.1], "td_hist": [1, 2]}
    if tamper == "steps":
        rep["direct_steps"][0] += 1
    elif tamper == "epsilon":
        rep["epsilon"][2] = 0.95
    elif tamper == "gap":
        rep["mean_reward"][1] = None
    got = audit_train_report(rep, direct_steps=180, sessions=3)
    want = ref_audit.audit_train_report(rep, direct_steps=180, sessions=3)
    assert got.checks == want.checks
    assert got.ok == (tamper is None)


# -------------------------------------------------------------- canary
@pytest.fixture(scope="module")
def canary_pair(live_run):
    """The live run's stream served again through a DQN from one set of
    weights in both packages (the reference's, carried across)."""
    from repro.policy import dqn_policy as ref_dqn_policy
    stream, cfg, _, _, _, _ = live_run
    scn = ref_random_fleet(jax.random.PRNGKey(3), CELLS, n_max=N_MAX)
    ref_cfg = RefServeConfig(n_max=N_MAX, quiet=True)
    ref_pol = ref_dqn_policy(ref_cfg.fleet().spec(), hidden=(8,))
    ref_params = ref_pol.init(jax.random.PRNGKey(1))
    k = jax.random.PRNGKey(5)
    ref = ref_serve_stream(ref_pol, ref_params, scn, stream, ref_cfg, key=k)
    pol = adapters.dqn_policy(make_spec("base", N_MAX), hidden=(8,))
    rep = serve_stream(pol, convert.policy_params(
        jax.tree.map(np.asarray, ref_params), CPU),
        convert.fleet_scenario(scn, CPU), convert.request_stream(stream),
        ServeConfig(n_max=N_MAX, quiet=True),
        key=convert.key_from_data(np.asarray(k), CPU), device=CPU)
    return rep, ref


def _assert_diff_matches(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, w in want.items():
        if k == "windows":
            for gr, wr in zip(got[k], w, strict=True):
                assert gr.keys() == wr.keys()
                for f, v in wr.items():
                    if isinstance(v, float):
                        assert abs(gr[f] - v) <= 1e-5 * max(1.0, abs(v)), f
                    else:
                        assert gr[f] == v, f
        elif isinstance(w, float):
            assert abs(got[k] - w) <= 1e-5 * max(1.0, abs(w)), k
        else:
            assert got[k] == w, k


def test_canary_diff_matches_reference(live_run, canary_pair):
    stream, cfg, rep, _, ref, _ = live_run
    other, ref_other = canary_pair
    p_stream = convert.request_stream(stream)
    for a, b, ra, rb in ((rep, rep, ref, ref), (rep, other, ref, ref_other),
                         (other, rep, ref_other, ref)):
        got = canary_diff(p_stream, a, b, cfg.window_ms)
        want = ref_canary.canary_diff(
            stream, {**ra, "records": {k: np.asarray(v) for k, v in
                                       ra["records"].items()}},
            {**rb, "records": {k: np.asarray(v) for k, v in
                               rb["records"].items()}}, cfg.window_ms)
        _assert_diff_matches(got, want)
        assert json.dumps(got)
        assert render_canary(got).splitlines()[0] == \
            ref_canary.render_canary(want).splitlines()[0]
    same = canary_diff(p_stream, rep, rep, cfg.window_ms)
    assert same["d_dropped"] == 0 and same["d_p99_ms"] in (None, 0.0)
    assert all(not v for v in same["sign_flip_windows"].values())
    with pytest.raises(ValueError, match="records"):
        canary_diff(p_stream, {k: v for k, v in rep.items()
                               if k != "records"}, rep, cfg.window_ms)


# ------------------------------------------------------ report --json
def test_report_data_matches_reference(live_run, tmp_path, capsys):
    stream, cfg, rep, _, ref, _ = live_run
    path = str(tmp_path / "trace.jsonl")
    write_trace(path, _trace_both(stream, cfg, rep, ref)[0])
    for window_ms in (cfg.window_ms, 1000.0):
        got = report_mod.report_data(path, window_ms=window_ms)
        assert got == ref_report.report_data(path, window_ms=window_ms)
    assert got["summary"]["served"] == rep["served_requests"]
    assert report_mod.render(path, window_ms=400.0, top=3) == \
        ref_report.render(path, window_ms=400.0, top=3)
    report_mod.main([path, "--json"])
    assert json.loads(capsys.readouterr().out) == got


# ------------------------------------------------- serve_fleet surface
def _bundle(path, kind):
    """A bundle the port writes and both CLIs load: the greedy baseline
    (no weights) or a small DQN, at ``full`` with n_max 4."""
    spec = make_spec("full", N_MAX)
    params = (adapters.heuristic_greedy_policy(spec).init(0, CPU)
              if kind == "greedy" else
              adapters.dqn_policy(spec, hidden=(8,)).init(1, CPU))
    save_bundle(str(path), PolicyBundle(kind, "full", N_MAX, params))


def test_require_writable_and_refusals(tmp_path):
    bad = str(tmp_path / "no" / "such" / "t.jsonl")
    with pytest.raises(SystemExit, match="does not exist"):
        serve_fleet.require_writable(bad, "--trace-out")
    for path in (str(tmp_path / "ok.jsonl"), None, "-"):
        serve_fleet.require_writable(path, "--live-out")
    cases = [(["--live"], "telemetry"),
             (["--round-replay", "--canary", "x.msgpack"], "round-replay"),
             (["--round-replay", "--telemetry"], "round-replay"),
             (["--round-replay", "--trace-out",
               str(tmp_path / "t.jsonl")], "round-replay"),
             (["--trace-out", bad], "parent directory"),
             (["--telemetry", "--live", "--live-out", bad],
              "parent directory")]
    for argv, match in cases:
        with pytest.raises(SystemExit, match=match):
            serve_fleet.main(["--greedy", "--device", "cpu", "--cells", "4"]
                             + argv)


@pytest.mark.parametrize("economy", [None, "spot"])
def test_cli_telemetry_options_match_reference_cli(tmp_path, capsys,
                                                   economy):
    """The port CLI's report, live file and trace against the reference
    CLI's ``serve_bundle`` on the same bundle and ``--seed``."""
    primary, other = tmp_path / "a.msgpack", tmp_path / "b.msgpack"
    _bundle(primary, "greedy")
    _bundle(other, "dqn")
    kw = dict(rounds=6, cells=6, rate=2.0, seed=2, epochs=3,
              telemetry=True, window_ms=400.0, trace_sample=0.5,
              live=True, slo_target=0.8, canary=str(other), economy=economy)
    out = {side: {f: str(tmp_path / f"{side}.{f}") for f in
                  ("live", "trace", "json")} for side in ("ref", "port")}
    ref = ref_serve_bundle(str(primary), live_out=out["ref"]["live"],
                           trace_out=out["ref"]["trace"], verbose=False,
                           **kw)
    argv = ["--bundle", str(primary), "--rounds", "6", "--cells", "6",
            "--rate", "2.0", "--seed", "2", "--epochs", "3", "--telemetry",
            "--window-ms", "400", "--trace-sample", "0.5", "--live",
            "--live-out", out["port"]["live"], "--slo-target", "0.8",
            "--canary", str(other), "--trace-out", out["port"]["trace"],
            "--out", out["port"]["json"], "--device", "cpu"]
    if economy:
        argv += ["--economy", economy]
    rep = serve_fleet.main(argv)
    printed = capsys.readouterr().out
    assert "canary diff" in printed and "wrote" in printed
    assert_telemetry_matches(rep["telemetry"], ref["telemetry"])
    for k in ("served_requests", "dropped_requests", "n_ticks"):
        assert rep[k] == ref[k], k
    for k in ("telemetry", "window_ms", "trace_sample", "live", "slo_target",
              "canary", "economy"):
        assert rep["config"][k] == ref["config"][k], k
    read = lambda p: [json.loads(line) for line in open(p)]
    assert strip_wall(read(out["port"]["live"])) == \
        strip_wall(read(out["ref"]["live"]))
    assert read(out["port"]["trace"]) == read(out["ref"]["trace"])
    assert 0 < len(read(out["port"]["trace"])) < rep["n_requests"]
    want = ref["canary"]
    got = rep["canary"]
    assert (got["bundle"], got["kind"]) == (want["bundle"], want["kind"])
    _assert_diff_matches(got, want)
    written = json.loads(open(out["port"]["json"]).read())
    assert written["telemetry"] == rep["telemetry"]
    # the audit CLI on the written report and trace exits as the
    # reference's, and fails on a tampered report
    args = [out["port"]["json"], "--trace", out["port"]["trace"]]
    assert audit_mod.main(args) == 0 == ref_audit.main(args)
    written["telemetry"]["series"]["served"][0] += 1
    with open(out["port"]["json"], "w") as f:
        json.dump(written, f)
    assert audit_mod.main(args + ["--json"]) == 1 == ref_audit.main(args)
    assert "served_window_sum" in capsys.readouterr().out
