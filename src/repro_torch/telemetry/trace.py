"""Per-request lifecycle traces (counterpart of ``repro.telemetry.trace``).

``build_trace`` turns a served run's raw per-request record arrays (the
``"records"`` entry of a ``serve_stream`` report) into one event dict per
request covering its whole lifecycle

    arrival -> admit | drop -> round start -> completion

with the serving breakdown (queueing wait, service time, its round's
chosen action) and outcome flags (served / dropped / deferred, SLO
attained, accuracy violated).  Timestamps are reconstructed from the
engine's tick discretization: a request arriving at ``t`` is admitted at
the first tick boundary ``>= t``, starts service when its round forms,
and completes ``service_ms`` later — so every trace line's timestamps
are monotone by construction, which ``validate_trace`` re-checks.

Sampling is deterministic in the request id (a splitmix-style hash), so
the same run always traces the same subset regardless of rate ordering,
and a sampled trace can be diffed across code changes.

The JSONL schema (one request per line, keys stable):

    rid cell action status t_arrival_ms t_admit_ms t_round_start_ms
    t_complete_ms wait_ms service_ms slo_ms attained violated
"""
from __future__ import annotations

import json

import numpy as np

TRACE_STATUSES = ("served", "dropped", "deferred")
_REQUIRED_KEYS = ("rid", "cell", "status", "t_arrival_ms", "slo_ms")


def _sample_mask(n: int, sample: float) -> np.ndarray:
    """Deterministic id-hash sampling: request i is traced iff
    hash(i) / 2^64 < sample.  Independent of run ordering and seed."""
    if sample >= 1.0:
        return np.ones(n, bool)
    if sample <= 0.0:
        return np.zeros(n, bool)
    x = np.arange(n, dtype=np.uint64)
    # splitmix64 finalizer — well-distributed for sequential ids
    x = (x + np.uint64(0x9E3779B97F4A7C15))
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    x = x ^ (x >> np.uint64(31))
    return (x.astype(np.float64) / 2.0 ** 64) < sample


def build_trace(stream, records: dict, tick_ms: float, *,
                sample: float = 1.0) -> list[dict]:
    """One lifecycle dict per (sampled) request, in request-id order."""
    n = stream.n_requests
    served = np.asarray(records["served"], bool)
    dropped = np.asarray(records["dropped"], bool)
    wait = np.asarray(records["wait_ms"], np.float64)
    service = np.asarray(records["service_ms"], np.float64)
    action = np.asarray(records.get("action",
                                    np.full(n, -1, np.int32)), np.int64)
    violated = np.asarray(records["violated"], bool)
    t = np.asarray(stream.t_ms, np.float64)
    slo = np.asarray(stream.slo_ms, np.float64)
    # admission happens at the first tick whose wall clock reaches t
    t_admit = np.ceil(t / tick_ms) * tick_ms
    pick = _sample_mask(n, sample)

    out = []
    for i in np.nonzero(pick)[0]:
        if dropped[i]:
            status = "dropped"
        elif served[i]:
            status = "served"
        else:
            status = "deferred"
        ev = {
            "rid": int(i),
            "cell": int(stream.cell[i]),
            "action": int(action[i]) if served[i] else None,
            "status": status,
            "t_arrival_ms": round(float(t[i]), 3),
            "t_admit_ms": (None if dropped[i]
                           else round(float(t_admit[i]), 3)),
            "t_round_start_ms": (round(float(t[i] + wait[i]), 3)
                                 if served[i] else None),
            "t_complete_ms": (round(float(t[i] + wait[i] + service[i]), 3)
                              if served[i] else None),
            "wait_ms": round(float(wait[i]), 3) if served[i] else None,
            "service_ms": (round(float(service[i]), 3)
                           if served[i] else None),
            "slo_ms": round(float(slo[i]), 3),
            "attained": bool(served[i]
                             and wait[i] + service[i] <= slo[i] + 1e-6),
            "violated": bool(violated[i]) if served[i] else None,
        }
        out.append(ev)
    return out


def write_trace(path: str, events: list[dict]) -> None:
    with open(path, "w") as f:
        for ev in events:
            f.write(json.dumps(ev) + "\n")


def read_trace(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def validate_trace(events_or_path) -> dict:
    """Round-trip schema check: every traced request id appears exactly
    once, required keys are present, statuses are known, and lifecycle
    timestamps are monotone (arrival <= admit <= round start <=
    completion, with completion = round start + service).  Raises
    ``ValueError`` on the first violation; returns a summary dict
    (counts by status) on success."""
    events = (read_trace(events_or_path)
              if isinstance(events_or_path, str) else events_or_path)
    if not events:
        raise ValueError("empty trace")
    seen = set()
    by_status = {s: 0 for s in TRACE_STATUSES}
    for ev in events:
        for k in _REQUIRED_KEYS:
            if k not in ev:
                raise ValueError(f"trace line missing {k!r}: {ev}")
        rid = ev["rid"]
        if rid in seen:
            raise ValueError(f"request id {rid} appears more than once")
        seen.add(rid)
        status = ev["status"]
        if status not in by_status:
            raise ValueError(f"unknown status {status!r} for rid {rid}")
        by_status[status] += 1
        ts = [ev["t_arrival_ms"], ev.get("t_admit_ms"),
              ev.get("t_round_start_ms"), ev.get("t_complete_ms")]
        present = [x for x in ts if x is not None]
        if any(b < a - 1e-6 for a, b in zip(present, present[1:])):
            raise ValueError(
                f"non-monotone lifecycle timestamps for rid {rid}: {ts}")
        if status == "served":
            if ev.get("t_complete_ms") is None:
                raise ValueError(f"served rid {rid} has no completion")
            e2e = ev["t_complete_ms"] - ev["t_arrival_ms"]
            if abs(e2e - (ev["wait_ms"] + ev["service_ms"])) > 1e-3:
                raise ValueError(
                    f"rid {rid}: wait+service != completion-arrival")
        elif ev.get("t_complete_ms") is not None:
            raise ValueError(f"{status} rid {rid} has a completion time")
    return {"n_events": len(events), **by_status}
