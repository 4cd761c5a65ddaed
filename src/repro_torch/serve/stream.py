"""Continuous-time request streams — the serving workload unit.

Counterpart of ``repro.serve.stream``: a flat, arrival-time-sorted
sequence of requests (timestamp, cell, SLO budget) with no ``[1, n_max]``
clipping — bursts queue, idle cells idle.  Streams are host-side numpy;
the engine ships them to the device once per run.

    poisson_request_stream    per-cell Poisson processes in continuous
                              time, drawn with the port's threefry keys
                              (``repro_torch.random``) as the reference
                              does, on the CPU: one key gives the
                              reference's stream bit for bit
    round_synchronous_stream  a (T, C) round trace as a stream whose
                              arrivals all land on round boundaries — the
                              degenerate mode in which the engine must
                              reproduce the round gateway
                              (``serve.compat.replay_trace``)
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import random as rnd
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


def poisson_request_stream(key, scenario: FleetScenario, horizon_ms: float,
                           *, rate: float | np.ndarray = 3.0,
                           round_ms: float = 250.0,
                           slo_ms: float | np.ndarray | None = None,
                           epoch_ms: float | None = None) -> RequestStream:
    """Per-cell homogeneous Poisson processes over ``[0, horizon_ms)``,
    drawn as the reference draws them from the same (2,) threefry
    ``key``: ``k_count, k_time = split(key)``, the counts ``poisson(
    k_count, float32 mean counts, (C,))`` and the arrival times float32
    ``uniform(k_time, (total,), 0, horizon_ms)``, in cell order before
    the stable sort by time.  The draws run on the CPU whatever the key's
    device: the card's ``log`` and ``lgamma`` round apart from the
    CPU's.

    ``rate`` is mean arrivals per cell per ``round_ms`` (scalar or
    per-cell ``(C,)``).  SLO budgets default to each cell's latency
    target; ``epoch_ms`` defaults to the whole horizon."""
    n_cells = scenario.n_cells
    lam = np.broadcast_to(np.asarray(rate, np.float64), (n_cells,))
    mean_counts = lam * (float(horizon_ms) / float(round_ms))
    k_count, k_time = rnd.split(key.cpu(), 2)
    counts = rnd.poisson(k_count, torch.as_tensor(mean_counts),
                         (n_cells,)).numpy().astype(np.int64)
    cell = np.repeat(np.arange(n_cells, dtype=np.int32), counts)
    t = rnd.uniform(k_time, (int(counts.sum()),), 0.0,
                    float(horizon_ms)).numpy()
    if slo_ms is None:
        slo = scenario.latency_targets().cpu().numpy()[cell]
    else:
        slo = np.broadcast_to(np.asarray(slo_ms, np.float32),
                              (n_cells,))[cell]
    return _sorted_stream(t, cell, slo, horizon_ms,
                         horizon_ms if epoch_ms is None else epoch_ms,
                         n_cells)


def round_synchronous_stream(trace, round_ms: float, *,
                             slo_ms: float | np.ndarray | None = None,
                             epoch_ms: float | None = None
                             ) -> RequestStream:
    """A (T, C) per-round arrival-count trace (array or tensor) as a
    stream: the ``trace[t, c]`` requests of round t arrive at ``t *
    round_ms`` with ``slo_ms = round_ms`` unless given.  Counts from
    ``poisson_round_trace`` lie in [1, n_max], so every round drains in
    its own window and the engine serves round by round.  Requests come
    in round, then cell order, as the reference lists them."""
    trace = (trace.cpu().numpy() if isinstance(trace, torch.Tensor)
             else np.asarray(trace))
    horizon, n_cells = trace.shape
    counts = trace.reshape(-1).astype(np.int64)
    t = np.repeat(np.repeat(np.arange(horizon) * float(round_ms), n_cells),
                  counts).astype(np.float32)
    cell = np.repeat(np.tile(np.arange(n_cells, dtype=np.int32), horizon),
                     counts)
    if slo_ms is None:
        slo = np.full(t.shape, float(round_ms), np.float32)
    else:
        slo = np.broadcast_to(np.asarray(slo_ms, np.float32),
                              (n_cells,))[cell]
    horizon_ms = horizon * float(round_ms)
    return _sorted_stream(t, cell, slo, horizon_ms,
                          horizon_ms if epoch_ms is None else epoch_ms,
                          n_cells)
