"""Invariant auditor: conservation laws over metric windows and traces
(counterpart of ``repro.telemetry.audit``).

The telemetry layer reports *numbers*; this module checks that the
numbers could possibly be true.  The serving engine maintains several
accounting identities by construction — every arrival is admitted or
dropped, every admitted request is served or still queued/in-flight at
the horizon, occupancy cannot exceed capacity, a served request's
end-to-end latency is exactly its wait plus its service time — and the
auditor re-derives each one from the *reported* MetricBuffer window
series, run totals, and lifecycle trace, failing loudly when any pair
of instruments disagrees.  A run that passes the audit has
self-consistent telemetry; a run that fails has a bug in the engine,
the metrics, or the trace writer — exactly the class of silent error a
dashboard happily plots.

Checks over a ``serve_stream`` report with telemetry:

  * arrival conservation    Σ admitted + Σ dropped == n_requests
  * admit conservation      Σ admitted == served + deferred (everything
                            admitted is served or still queued/in-flight
                            when the horizon closes)
  * window/total agreement  Σ served windows == served_requests,
                            Σ dropped windows == dropped_requests,
                            histogram mass == served_requests
  * attainment              per-window attained ≤ served; Σ attained
                            == the report's attained count (a one-count
                            float32-vs-float64 deadline-boundary slack
                            is tolerated and noted)
  * violations              per-window violated ≤ served
  * capacity                backlog ≤ C·queue_cap, queue depth ≤
                            queue_cap, in-flight ≤ C·n_max, and per-tier
                            occupancy sums ≤ in-flight, per window
  * economy conservation    when the run was served with a tier-economy
                            profile (``repro_torch.economy``): Σ per-window
                            spend (µ$) == the run's lifetime spend, and
                            likewise for energy (mJ), cold starts, and
                            preemptions — exact integer identities, the
                            engine adds the same rounded integers to
                            both instruments; warm+warming tier gauges
                            stay ≤ 3·C

Checks over a JSONL lifecycle trace (optionally cross-checked against
the report when the trace is unsampled):

  * ``validate_trace`` round-trip (unique rids, monotone timestamps,
    wait + service == completion − arrival)
  * the ``attained`` flag equals ``wait + service ≤ slo``
  * served events carry a valid action; per-status counts match the
    report's served/dropped/deferred totals

Entry points: :func:`audit_serve_report` (library; ``chip_smoke.py``
runs it on the deployment), :func:`audit_train_report` (the trainer's
window sums vs its run totals), and the CLI

    PYTHONPATH=src python -m repro_torch.telemetry.audit serve.json \
        [--trace trace.jsonl] [--json]

which reads a ``serve_fleet --telemetry --out`` report (capacity bounds
come from its recorded ``config``), prints every check, and exits
non-zero on the first broken invariant.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import NamedTuple, Optional

import numpy as np

from repro_torch.telemetry.trace import read_trace, validate_trace

__all__ = ["AuditResult", "audit_serve_report", "audit_trace",
           "audit_train_report"]


class AuditResult(NamedTuple):
    """Outcome of an audit: one dict per check (``check``, ``ok``,
    ``detail``).  ``ok`` is the conjunction; ``render()`` is the
    human-readable table; ``raise_on_failure()`` turns a broken
    invariant into a hard error for checking scripts."""
    checks: list

    @property
    def ok(self) -> bool:
        return all(c["ok"] for c in self.checks)

    @property
    def failed(self) -> list:
        return [c for c in self.checks if not c["ok"]]

    def render(self) -> str:
        lines = []
        for c in self.checks:
            mark = "ok  " if c["ok"] else "FAIL"
            lines.append(f"  {mark}  {c['check']:<28s}  {c['detail']}")
        n_bad = len(self.failed)
        lines.append(f"audit: {len(self.checks)} checks, "
                     + ("all passed" if not n_bad
                        else f"{n_bad} FAILED"))
        return "\n".join(lines)

    def raise_on_failure(self) -> "AuditResult":
        if not self.ok:
            names = ", ".join(c["check"] for c in self.failed)
            raise AssertionError(
                f"telemetry invariant audit failed: {names}\n"
                + self.render())
        return self

    def summary(self) -> dict:
        return {"ok": self.ok, "n_checks": len(self.checks),
                "failed": [c["check"] for c in self.failed]}


def _check(checks: list, name: str, ok, detail: str) -> None:
    checks.append({"check": name, "ok": bool(ok), "detail": detail})


def audit_serve_report(report: dict, *, trace=None,
                       n_cells: Optional[int] = None,
                       n_max: Optional[int] = None,
                       queue_cap: Optional[int] = None) -> AuditResult:
    """Audit a ``serve_stream`` report (must carry ``"telemetry"``).

    Capacity bounds (``n_cells``, ``n_max``, ``queue_cap``) default to
    the report's recorded ``config`` (present on every ``serve_fleet``
    report); capacity checks are skipped when neither supplies them.
    ``trace`` (events list or JSONL path) appends the trace checks."""
    checks: list = []
    tel = report.get("telemetry")
    if tel is None:
        _check(checks, "telemetry_present", False,
               "report has no 'telemetry' section — serve with "
               "ServeConfig.telemetry / --telemetry")
        return AuditResult(checks)
    cfg = report.get("config", {})
    n_cells = cfg.get("cells") if n_cells is None else n_cells
    n_max = cfg.get("n_max") if n_max is None else n_max
    queue_cap = cfg.get("queue_cap") if queue_cap is None else queue_cap

    s = tel["series"]
    admitted = np.asarray(s["admitted"], np.int64)
    dropped = np.asarray(s["dropped"], np.int64)
    served = np.asarray(s["served"], np.int64)
    attained = np.asarray(s["attained"], np.int64)
    violated = np.asarray(s["violated"], np.int64)
    n = int(report["n_requests"])
    n_served = int(report["served_requests"])
    n_dropped = int(report["dropped_requests"])
    n_deferred = int(report["deferred_requests"])

    _check(checks, "arrival_conservation",
           admitted.sum() + dropped.sum() == n,
           f"Σadmitted {admitted.sum()} + Σdropped {dropped.sum()} "
           f"vs {n} arrivals")
    _check(checks, "admit_conservation",
           admitted.sum() == n_served + n_deferred,
           f"Σadmitted {admitted.sum()} vs served {n_served} + "
           f"still-queued/in-flight {n_deferred}")
    _check(checks, "served_window_sum", served.sum() == n_served,
           f"Σserved windows {served.sum()} vs run total {n_served}")
    _check(checks, "dropped_window_sum", dropped.sum() == n_dropped,
           f"Σdropped windows {dropped.sum()} vs run total {n_dropped}")
    _check(checks, "hist_mass",
           sum(tel["latency_hist"]) == n_served,
           f"histogram mass {sum(tel['latency_hist'])} vs "
           f"{n_served} served")
    _check(checks, "attained_within_served",
           bool((attained <= served).all()),
           f"per-window attained ≤ served "
           f"(max excess {int((attained - served).max(initial=0))})")
    _check(checks, "violated_within_served",
           bool((violated <= served).all()),
           f"per-window violated ≤ served "
           f"(max excess {int((violated - served).max(initial=0))})")
    # the engine compares float32 wait+service against the deadline, the
    # report float64 — a request landing exactly on its deadline can
    # flip between the two instruments; allow that one-count slack
    att_report = round(float(report["slo_attainment"]) * n)
    _check(checks, "attainment_total",
           abs(int(attained.sum()) - att_report) <= max(1, n // 1000),
           f"Σattained windows {attained.sum()} vs report "
           f"{att_report} (slack {max(1, n // 1000)})")

    gauges = {g: [v for v in s[g] if v is not None]
              for g in ("backlog", "queue_depth", "inflight",
                        "occ_local", "occ_edge", "occ_cloud")
              if g in s}
    if n_cells and n_max and queue_cap:
        _check(checks, "backlog_capacity",
               all(v <= n_cells * queue_cap + 1e-6
                   for v in gauges.get("backlog", [])),
               f"backlog ≤ {n_cells}·{queue_cap}")
        _check(checks, "queue_depth_capacity",
               all(v <= queue_cap + 1e-6
                   for v in gauges.get("queue_depth", [])),
               f"mean queue depth ≤ {queue_cap}")
        _check(checks, "inflight_capacity",
               all(v <= n_cells * n_max + 1e-6
                   for v in gauges.get("inflight", [])),
               f"in-flight ≤ {n_cells}·{n_max}")
        occ = [sum(t) for t in zip(*(gauges.get(g, [])
                                     for g in ("occ_local", "occ_edge",
                                               "occ_cloud")))]
        infl = gauges.get("inflight", [])
        _check(checks, "tier_occupancy",
               all(o <= i + 1e-6 for o, i in zip(occ, infl)),
               "Σ per-tier occupancy ≤ in-flight, per window")
    else:
        _check(checks, "capacity_bounds", True,
               "skipped (no n_cells/n_max/queue_cap in report config "
               "or arguments)")

    eco = report.get("economy")
    if eco is not None:
        # the engine bills in integers (µ$ / mJ) and adds the *same*
        # rounded per-tick integers to the per-window counters and the
        # lifetime per-cell totals, so these identities are exact
        missing = [c for c in ("spend_uusd", "energy_mj", "cold_starts",
                               "preemptions") if c not in s]
        if missing:
            _check(checks, "economy_series_present", False,
                   f"report has 'economy' but the telemetry series lack "
                   f"{missing} — the run predates the economy counters "
                   f"or the buffer was tampered with")
        else:
            for win, run, name in (
                    ("spend_uusd", "spend_uusd_total",
                     "spend_conservation"),
                    ("energy_mj", "energy_j_total",
                     "energy_conservation"),
                    ("cold_starts", "cold_starts",
                     "cold_start_conservation"),
                    ("preemptions", "preemptions",
                     "preemption_conservation")):
                wsum = int(np.asarray(s[win], np.int64).sum())
                total = (round(float(eco[run]) * 1e3)
                         if run == "energy_j_total" else int(eco[run]))
                _check(checks, name, wsum == total,
                       f"Σ {win} windows {wsum} vs run total {total}")
        if n_cells:
            tiers = [v for g in ("warm_tiers", "warming_tiers")
                     for v in s.get(g, []) if v is not None]
            _check(checks, "tier_state_capacity",
                   all(v <= 3 * n_cells + 1e-6 for v in tiers),
                   f"warm/warming tier counts ≤ 3·{n_cells}")

    if trace is not None:
        checks.extend(audit_trace(trace, report=report).checks)
    return AuditResult(checks)


def audit_trace(events_or_path, *, report: Optional[dict] = None
                ) -> AuditResult:
    """Audit a lifecycle trace: the ``validate_trace`` round-trip plus
    semantic checks (attained flag matches the deadline arithmetic,
    served events carry actions).  With ``report`` given and the trace
    unsampled (event count == n_requests), per-status totals must match
    the report's."""
    checks: list = []
    events = (read_trace(events_or_path)
              if isinstance(events_or_path, str) else events_or_path)
    try:
        summary = validate_trace(events)
        _check(checks, "trace_roundtrip", True,
               f"{summary['n_events']} events "
               f"({summary['served']} served, {summary['dropped']} "
               f"dropped, {summary['deferred']} deferred)")
    except ValueError as e:
        _check(checks, "trace_roundtrip", False, str(e))
        return AuditResult(checks)

    bad_att = [ev["rid"] for ev in events if ev["status"] == "served"
               and bool(ev["attained"]) != bool(
                   ev["wait_ms"] + ev["service_ms"]
                   <= ev["slo_ms"] + 1e-6)]
    _check(checks, "trace_attained_flag", not bad_att,
           "attained == (wait + service ≤ slo) for every served event"
           + (f"; first offenders {bad_att[:5]}" if bad_att else ""))
    bad_act = [ev["rid"] for ev in events
               if ev["status"] == "served"
               and (ev["action"] is None or ev["action"] < 0)]
    _check(checks, "trace_served_actions", not bad_act,
           "every served event records its round action"
           + (f"; first offenders {bad_act[:5]}" if bad_act else ""))

    if report is not None:
        if summary["n_events"] == int(report["n_requests"]):
            ok = (summary["served"] == int(report["served_requests"])
                  and summary["dropped"] == int(
                      report["dropped_requests"])
                  and summary["deferred"] == int(
                      report["deferred_requests"]))
            _check(checks, "trace_counts_vs_report", ok,
                   f"trace served/dropped/deferred "
                   f"{summary['served']}/{summary['dropped']}/"
                   f"{summary['deferred']} vs report "
                   f"{report['served_requests']}/"
                   f"{report['dropped_requests']}/"
                   f"{report['deferred_requests']}")
        else:
            _check(checks, "trace_counts_vs_report", True,
                   f"skipped (sampled trace: {summary['n_events']} of "
                   f"{report['n_requests']} requests)")
    return AuditResult(checks)


def audit_train_report(rep: dict, *, direct_steps: Optional[int] = None,
                       sessions: Optional[int] = None) -> AuditResult:
    """Audit a ``train_telemetry_report`` dict against the trainer's own
    run totals: window (= per-session) sums must equal the counter
    totals, the ε-schedule must be non-increasing, and every run session
    must have written its gauges."""
    checks: list = []
    series = rep["direct_steps"]
    n = int(rep["n_sessions"])
    if sessions is not None:
        _check(checks, "session_count", n == int(sessions),
               f"report sessions {n} vs trainer counter {sessions}")
    if direct_steps is not None:
        _check(checks, "direct_step_window_sum",
               sum(series) == int(direct_steps),
               f"Σ per-session direct steps {sum(series)} vs trainer "
               f"counter {direct_steps}")
    eps = rep.get("epsilon", [])
    _check(checks, "epsilon_monotone",
           all(e is not None for e in eps)
           and all(a >= b - 1e-9 for a, b in zip(eps, eps[1:])),
           "ε gauge present and non-increasing across sessions")
    missing = [g for g in ("epsilon", "mean_reward")
               if any(v is None for v in rep.get(g, []))]
    _check(checks, "gauges_written", not missing,
           "every run session wrote its gauges"
           + (f"; gaps in {missing}" if missing else ""))
    return AuditResult(checks)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Audit telemetry invariants of a served run")
    ap.add_argument("report",
                    help="JSON report from serve_fleet --telemetry --out")
    ap.add_argument("--trace", default=None,
                    help="JSONL lifecycle trace to cross-check "
                         "(serve_fleet --trace-out)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output (the checks list)")
    args = ap.parse_args(argv)
    with open(args.report) as f:
        report = json.load(f)
    result = audit_serve_report(report, trace=args.trace)
    if args.json:
        print(json.dumps({**result.summary(), "checks": result.checks},
                         indent=2))
    else:
        print(result.render())
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
