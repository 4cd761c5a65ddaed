"""Per-request serving metrics (counterpart of ``repro.serve.metrics``).

    end-to-end latency  queueing wait (arrival → round start) + service
    SLO attained        served AND end-to-end ≤ the request's ``slo_ms``
    attainment          attained / all arrived requests — dropped and
                        deferred requests count against it
    dropped             rejected at admission (queue overflow)
    deferred            arrived but unfinished when the horizon closed
    violation_rate      accuracy-constraint violations among served
                        requests, request-weighted
    mean_art_ms         served requests' round-ART average
"""
from __future__ import annotations

import numpy as np

from repro_torch.serve.stream import RequestStream

PERCENTILES = (50.0, 95.0, 99.0)


def request_report(stream: RequestStream, records: dict) -> dict:
    """Reduce per-request ``records`` (numpy arrays of length N: wait_ms,
    service_ms, art_ms, served, dropped, violated) into the report."""
    n = stream.n_requests
    served = np.asarray(records["served"], bool)
    dropped = np.asarray(records["dropped"], bool)
    wait = np.asarray(records["wait_ms"], np.float64)
    service = np.asarray(records["service_ms"], np.float64)
    e2e = wait + service
    n_served = int(served.sum())
    n_dropped = int(dropped.sum())
    attained = served & (e2e <= np.asarray(stream.slo_ms, np.float64)
                         + 1e-6)

    def pct(p):
        if n_served == 0:
            return None
        return float(np.percentile(e2e[served], p))

    report = {
        "n_requests": n,
        "served_requests": n_served,
        "dropped_requests": n_dropped,
        "deferred_requests": n - n_served - n_dropped,
        "slo_attainment": float(attained.sum() / n) if n else 1.0,
        "violation_rate": (float(np.asarray(records["violated"],
                                            bool)[served].mean())
                           if n_served else 0.0),
        "mean_latency_ms": float(e2e[served].mean()) if n_served else None,
        "mean_wait_ms": float(wait[served].mean()) if n_served else None,
        "mean_service_ms": (float(service[served].mean())
                            if n_served else None),
        "mean_art_ms": (float(np.asarray(records["art_ms"],
                                         np.float64)[served].mean())
                        if n_served else None),
    }
    for p in PERCENTILES:
        report[f"p{p:g}_latency_ms"] = pct(p)
    return report
