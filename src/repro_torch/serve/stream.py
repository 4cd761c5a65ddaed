"""Continuous-time request streams — the serving workload unit.

Counterpart of ``repro.serve.stream``: a flat, arrival-time-sorted
sequence of requests (timestamp, cell, SLO budget) with no ``[1, n_max]``
clipping — bursts queue, idle cells idle.  Streams are host-side numpy;
the engine ships them to the device once per run.
``poisson_request_stream`` draws from a numpy ``Generator`` and matches
the reference in distribution; ``repro_torch.convert`` carries a
reference stream over exactly.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.fleet.workload import FleetScenario


class RequestStream(NamedTuple):
    """Arrival-time-sorted per-request arrays (length N).  ``slo_ms`` is
    the relative latency budget (met iff wait + service ≤ slo);
    ``horizon_ms`` bounds the serving window and ``epoch_ms`` marks the
    param-refresh boundaries, which cannot change any outcome."""
    t_ms: np.ndarray       # (N,) float32 — arrival timestamps, ascending
    cell: np.ndarray       # (N,) int32   — destination cell
    slo_ms: np.ndarray     # (N,) float32 — relative deadline budget
    horizon_ms: float
    epoch_ms: float
    n_cells: int

    @property
    def n_requests(self) -> int:
        return int(self.t_ms.shape[0])


def _sorted_stream(t, cell, slo, horizon_ms, epoch_ms, n_cells
                   ) -> RequestStream:
    t = np.asarray(t, np.float32)
    order = np.argsort(t, kind="stable")
    return RequestStream(t[order], np.asarray(cell, np.int32)[order],
                         np.asarray(slo, np.float32)[order],
                         float(horizon_ms), float(epoch_ms), int(n_cells))


def poisson_request_stream(rng, scenario: FleetScenario, horizon_ms: float,
                           *, rate: float | np.ndarray = 3.0,
                           round_ms: float = 250.0,
                           slo_ms: float | np.ndarray | None = None,
                           epoch_ms: float | None = None) -> RequestStream:
    """Per-cell homogeneous Poisson processes over ``[0, horizon_ms)``.

    ``rng`` is a ``numpy.random.Generator`` or a seed.  ``rate`` is mean
    arrivals per cell per ``round_ms`` (scalar or per-cell ``(C,)``);
    counts are exact Poisson and arrival times i.i.d. uniform given the
    count.  SLO budgets default to each cell's latency target;
    ``epoch_ms`` defaults to the whole horizon."""
    rng = np.random.default_rng(rng)
    n_cells = scenario.n_cells
    lam = np.broadcast_to(np.asarray(rate, np.float64), (n_cells,))
    counts = rng.poisson(lam * (float(horizon_ms) / float(round_ms)))
    cell = np.repeat(np.arange(n_cells, dtype=np.int32), counts)
    t = rng.uniform(0.0, float(horizon_ms), int(counts.sum()))
    if slo_ms is None:
        slo = scenario.latency_targets().cpu().numpy()[cell]
    else:
        slo = np.broadcast_to(np.asarray(slo_ms, np.float32),
                              (n_cells,))[cell]
    return _sorted_stream(t, cell, slo, horizon_ms,
                         horizon_ms if epoch_ms is None else epoch_ms,
                         n_cells)
