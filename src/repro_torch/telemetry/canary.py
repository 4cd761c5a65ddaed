"""Canary comparison: two policies on the bit-identical arrival stream
(counterpart of ``repro.telemetry.canary``).

A canary deploy answers one question — *is the new bundle better or
worse than the incumbent, on the same traffic?* — and the only honest
way to answer it in simulation is a paired experiment: serve the exact
same ``RequestStream`` (same arrival timestamps, cells, SLO budgets,
same engine config and serving key) through both policies and difference
the outcomes per window.  ``serve_fleet --canary other.bundle`` does the
serving; this module does the pairing:

    diff = canary_diff(stream, primary_report, canary_report, window_ms)

Per arrival-time window it reports served / dropped / attainment / p99
for both sides and the canary-minus-primary deltas; the summary carries
the run-level Δp99 / Δattainment / Δdrops and, per metric, the
**sign-flip windows** — windows whose delta points the opposite way
from the overall delta.  A canary that wins on average but loses every
third window is not a clean win: sign-flips localize *when* the new
policy regresses (a burst phase, a drained-queue phase), which a single
aggregate would average away.

Both reports must come from ``serve_stream`` with ``"records"`` intact
(the per-request arrays are the diff's input; no telemetry required).
"""
from __future__ import annotations

import numpy as np

__all__ = ["canary_diff", "render_canary"]

_EPS = 1e-9


def _window_stats(stream, records: dict, window_ms: float,
                  n_windows: int) -> list[dict]:
    t = np.asarray(stream.t_ms, np.float64)
    slo = np.asarray(stream.slo_ms, np.float64)
    served = np.asarray(records["served"], bool)
    dropped = np.asarray(records["dropped"], bool)
    e2e = (np.asarray(records["wait_ms"], np.float64)
           + np.asarray(records["service_ms"], np.float64))
    w = np.minimum((t // window_ms).astype(np.int64), n_windows - 1)
    rows = []
    for i in range(n_windows):
        m = w == i
        ms = m & served
        lat = e2e[ms]
        n_srv = int(ms.sum())
        rows.append({
            "arrivals": int(m.sum()),
            "served": n_srv,
            "dropped": int((m & dropped).sum()),
            "attained": int((ms & (e2e <= slo + 1e-6)).sum()),
            "attainment": (float((ms & (e2e <= slo + 1e-6)).sum())
                           / n_srv if n_srv else None),
            "p99_ms": (float(np.percentile(lat, 99.0)) if n_srv
                       else None),
        })
    return rows


def _delta(a, b):
    if a is None or b is None:
        return None
    return float(b) - float(a)


def _sign_flips(deltas: list, overall) -> list[int]:
    """Windows whose delta opposes the overall delta's direction."""
    if overall is None or abs(overall) <= _EPS:
        return []
    sign = 1.0 if overall > 0 else -1.0
    return [w for w, d in enumerate(deltas)
            if d is not None and abs(d) > _EPS and d * sign < 0]


def canary_diff(stream, primary: dict, canary: dict,
                window_ms: float, *,
                labels=("primary", "canary")) -> dict:
    """Paired per-window diff of two ``serve_stream`` reports produced
    on the *same* stream.  Deltas are canary − primary, so a negative
    Δp99 / Δdrops and a positive Δattainment mean the canary wins."""
    for name, rep in zip(labels, (primary, canary)):
        if "records" not in rep:
            raise ValueError(f"{name} report has no 'records' — pass "
                             "the in-process serve_stream report")
    n_windows = max(1, int(float(stream.horizon_ms) // window_ms)
                    + (1 if float(stream.horizon_ms) % window_ms else 0))
    a = _window_stats(stream, primary["records"], window_ms, n_windows)
    b = _window_stats(stream, canary["records"], window_ms, n_windows)
    rows = []
    for w, (ra, rb) in enumerate(zip(a, b)):
        rows.append({
            "window": w, "arrivals": ra["arrivals"],
            f"served_{labels[0]}": ra["served"],
            f"served_{labels[1]}": rb["served"],
            f"p99_{labels[0]}": ra["p99_ms"],
            f"p99_{labels[1]}": rb["p99_ms"],
            "d_p99_ms": _delta(ra["p99_ms"], rb["p99_ms"]),
            "d_attainment": _delta(ra["attainment"], rb["attainment"]),
            "d_dropped": rb["dropped"] - ra["dropped"],
        })
    d_p99 = _delta(primary.get("p99_latency_ms"),
                   canary.get("p99_latency_ms"))
    d_att = _delta(primary.get("slo_attainment"),
                   canary.get("slo_attainment"))
    d_drop = (int(canary["dropped_requests"])
              - int(primary["dropped_requests"]))
    return {
        "labels": list(labels),
        "window_ms": float(window_ms),
        "n_windows": n_windows,
        "windows": rows,
        "d_p99_ms": None if d_p99 is None else round(d_p99, 3),
        "d_attainment": None if d_att is None else round(d_att, 4),
        "d_dropped": d_drop,
        "d_violation_rate": _delta(primary.get("violation_rate"),
                                   canary.get("violation_rate")),
        "sign_flip_windows": {
            "p99": _sign_flips([r["d_p99_ms"] for r in rows], d_p99),
            "attainment": _sign_flips([r["d_attainment"] for r in rows],
                                      d_att),
            "dropped": _sign_flips([float(r["d_dropped"]) for r in rows],
                                   float(d_drop)),
        },
    }


def _fmt(v, nd=1):
    return "-" if v is None else f"{v:+.{nd}f}" if isinstance(v, float) \
        else str(v)


def render_canary(diff: dict) -> str:
    la, lb = diff["labels"]
    lines = [f"canary diff ({lb} − {la}, "
             f"{diff['window_ms']:g} ms windows)",
             "  win  arrivals    Δp99ms   Δattain   Δdrops"]
    for r in diff["windows"]:
        da = r["d_attainment"]
        lines.append(
            f"  {r['window']:3d}  {r['arrivals']:8d}  "
            f"{_fmt(r['d_p99_ms']):>8}  "
            f"{'-' if da is None else f'{da:+.1%}':>8}  "
            f"{r['d_dropped']:+7d}")
    flips = diff["sign_flip_windows"]
    lines.append(
        f"overall: Δp99 {_fmt(diff['d_p99_ms'])} ms, Δattainment "
        + ("-" if diff["d_attainment"] is None
           else f"{diff['d_attainment']:+.1%}")
        + f", Δdrops {diff['d_dropped']:+d}")
    lines.append(
        f"sign-flip windows: p99 {flips['p99'] or '—'}, attainment "
        f"{flips['attainment'] or '—'}, drops {flips['dropped'] or '—'}")
    return "\n".join(lines)
