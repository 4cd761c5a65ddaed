"""Render a served run's JSONL lifecycle trace as a human summary
(counterpart of ``repro.telemetry.report``).

    PYTHONPATH=src python -m repro_torch.telemetry.report trace.jsonl \
        [--window-ms 1000] [--top 8] [--json]

Validates the trace first (``validate_trace`` — unique request ids,
known statuses, monotone lifecycle timestamps), then prints

* a windowed time-series table (arrivals / served / dropped / attainment
  / p95 latency per ``--window-ms`` window of arrival time),
* a tail-latency breakdown by cell (the ``--top`` worst cells by p99),
* a tail-latency breakdown by chosen action (local / edge / cloud tier).

Reads nothing but the trace file, so it can be pointed at any JSONL
written by ``serve_fleet --trace-out`` — including traces from other
machines.  ``--json`` emits the same figures as one
machine-readable document (``summary`` / ``windows`` / ``by_tier`` /
``by_cell``) for dashboards and scripted gates.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.fleet import latency
from repro_torch.telemetry.trace import read_trace, validate_trace


def _pct(xs, p):
    return float(np.percentile(np.asarray(xs, np.float64), p)) if len(xs) \
        else None


def _fmt(v, nd=1):
    return "-" if v is None else f"{v:.{nd}f}"


def _latency(ev):
    return ev["wait_ms"] + ev["service_ms"]


def windowed_series(events: list[dict], window_ms: float) -> list[dict]:
    """Per-arrival-window counts and tails, one dict per window."""
    t0 = min(ev["t_arrival_ms"] for ev in events)
    rows = {}
    for ev in events:
        w = int((ev["t_arrival_ms"] - t0) // window_ms)
        r = rows.setdefault(w, dict(window=w, arrivals=0, served=0,
                                    dropped=0, deferred=0, attained=0,
                                    lat=[]))
        r["arrivals"] += 1
        r[ev["status"]] += 1
        if ev["status"] == "served":
            r["attained"] += bool(ev["attained"])
            r["lat"].append(_latency(ev))
    out = []
    for w in sorted(rows):
        r = rows[w]
        out.append(dict(window=w, arrivals=r["arrivals"],
                        served=r["served"], dropped=r["dropped"],
                        deferred=r["deferred"],
                        attainment=(r["attained"] / r["served"]
                                    if r["served"] else None),
                        p50_ms=_pct(r["lat"], 50),
                        p95_ms=_pct(r["lat"], 95)))
    return out


def breakdown(events: list[dict], key) -> list[dict]:
    """Tail-latency breakdown of served events grouped by ``key(ev)``."""
    groups = {}
    for ev in events:
        if ev["status"] != "served":
            continue
        groups.setdefault(key(ev), []).append(_latency(ev))
    out = []
    for g in sorted(groups):
        lat = groups[g]
        out.append(dict(group=g, served=len(lat),
                        p50_ms=_pct(lat, 50), p95_ms=_pct(lat, 95),
                        p99_ms=_pct(lat, 99)))
    return out


def action_tier(ev) -> str:
    """Execution tier of a round action: the first ``latency.N_MODELS``
    actions run the model locally, then one edge and one cloud action."""
    a = ev["action"]
    if a is None:
        return "?"
    if a < latency.N_MODELS:
        return "local"
    return "edge" if a == latency.A_EDGE else "cloud"


def report_data(path: str, *, window_ms: float = 1000.0) -> dict:
    """The report's figures as one JSON-serializable document: the
    ``validate_trace`` summary, the windowed time series, and the tier /
    cell tail-latency breakdowns (cells sorted worst-p99-first)."""
    events = read_trace(path)
    summary = validate_trace(events)
    served = [ev for ev in events if ev["status"] == "served"]
    by_cell = breakdown(served, lambda ev: ev["cell"])
    by_cell.sort(key=lambda r: -(r["p99_ms"] or 0.0))
    return {"trace": path, "window_ms": float(window_ms),
            "summary": summary,
            "windows": windowed_series(events, window_ms),
            "by_tier": breakdown(served, action_tier),
            "by_cell": by_cell}


def render(path: str, *, window_ms: float = 1000.0, top: int = 8) -> str:
    events = read_trace(path)
    summary = validate_trace(events)
    lines = [f"trace {path}: {summary['n_events']} events "
             f"({summary['served']} served, {summary['dropped']} dropped, "
             f"{summary['deferred']} deferred)", ""]

    lines.append(f"time series ({window_ms:g} ms windows of arrival time)")
    lines.append("  win  arrivals  served  dropped  attain   p50ms   p95ms")
    for r in windowed_series(events, window_ms):
        att = "-" if r["attainment"] is None else f"{r['attainment']:.0%}"
        lines.append(f"  {r['window']:3d}  {r['arrivals']:8d}  "
                     f"{r['served']:6d}  {r['dropped']:7d}  {att:>6}  "
                     f"{_fmt(r['p50_ms']):>6}  {_fmt(r['p95_ms']):>6}")

    served = [ev for ev in events if ev["status"] == "served"]
    if served:
        lines.append("")
        lines.append("tail latency by action tier")
        lines.append("  tier    served   p50ms   p95ms   p99ms")
        for r in breakdown(served, action_tier):
            lines.append(f"  {r['group']:<6}  {r['served']:6d}  "
                         f"{_fmt(r['p50_ms']):>6}  {_fmt(r['p95_ms']):>6}  "
                         f"{_fmt(r['p99_ms']):>6}")

        by_cell = breakdown(served, lambda ev: ev["cell"])
        by_cell.sort(key=lambda r: -(r["p99_ms"] or 0.0))
        lines.append("")
        lines.append(f"worst {min(top, len(by_cell))} cells by p99 latency"
                     f" (of {len(by_cell)})")
        lines.append("  cell    served   p50ms   p95ms   p99ms")
        for r in by_cell[:top]:
            lines.append(f"  {r['group']:<6}  {r['served']:6d}  "
                         f"{_fmt(r['p50_ms']):>6}  {_fmt(r['p95_ms']):>6}  "
                         f"{_fmt(r['p99_ms']):>6}")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("trace", help="JSONL trace from serve_fleet --trace-out")
    ap.add_argument("--window-ms", type=float, default=1000.0)
    ap.add_argument("--top", type=int, default=8,
                    help="worst-cells table length")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output (summary / windows / "
                         "by_tier / by_cell)")
    args = ap.parse_args(argv)
    if args.json:
        print(json.dumps(report_data(args.trace,
                                     window_ms=args.window_ms), indent=2))
    else:
        print(render(args.trace, window_ms=args.window_ms, top=args.top))


if __name__ == "__main__":
    main()
