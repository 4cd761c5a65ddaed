"""Per-window metric accumulators on device tensors.

Counterpart of ``repro.telemetry.metrics``.  A :class:`MetricBuffer`
rides in the serving engine's state and in the trainer's carry, so
windowed series (queue depth, backlog, per-tier occupancy, TD error, ...)
accumulate on the device with no host sync inside a tick or a session:

    counts  (W, K) int64    per-window event counts, one column a counter
    snaps   (W, G) float32  per-window gauge snapshots, the last write in a
                            window wins (= the window-end value); NaN means
                            "not written"
    hist    (B,) int32      a run-level histogram over log-spaced bins

The counters and gauges are matrices with their names beside them, so a
tick adds its K counts (``count_events``) and writes its G gauges
(``set_gauges``) in one launch each; ``counters`` / ``gauges`` give the
by-name views of the reference's dicts.  The mutators write the buffer in
place (as the engine writes its rings) and return it.  A window index is
a host int (the serving tick's, from ``window_of``) or a 0-d device
tensor (the trainer's session index), written through ``index_add_`` /
``index_copy_`` with no sync.  ``buffer_series`` is the host-side exit.

The counts are int64 where the reference's are int32: at the 65,536-cell
deployment under the ``spot`` economy one 250 ms window bills ~3.6e9 µ$,
past int32, and the audit's spend law (Σ windows == the run's total)
must hold there too.  Below 2**31 a window the integers are the
reference's.

Bin edges are the reference's: ``np.geomspace`` in float64, cast to
float32; a value's bin is ``searchsorted(edges, v, right=True) - 1``,
clamped into range.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# default latency range: 1 ms .. 1000 s; values outside are clamped into
# the end bins
LAT_LO_MS = 1.0
LAT_HI_MS = 1e6
LAT_BINS = 256


class MetricBuffer(NamedTuple):
    edges: torch.Tensor   # (B+1,) float32 log-spaced histogram bin edges
    hist: torch.Tensor    # (B,) int32 run-level histogram counts
    counts: torch.Tensor  # (W, K) int64, columns in counter_names order
    snaps: torch.Tensor   # (W, G) float32, columns in gauge_names order
    counter_names: tuple
    gauge_names: tuple

    @property
    def n_windows(self) -> int:
        return int(self.counts.shape[0])

    @property
    def counters(self) -> dict:
        """name -> (W,) int64 view."""
        return {n: self.counts[:, i] for i, n in enumerate(self.counter_names)}

    @property
    def gauges(self) -> dict:
        """name -> (W,) float32 view."""
        return {n: self.snaps[:, i] for i, n in enumerate(self.gauge_names)}


def log_edges(lo: float, hi: float, bins: int) -> np.ndarray:
    return np.geomspace(float(lo), float(hi), bins + 1).astype(np.float32)


def metrics_init(n_windows: int, counters=(), gauges=(), *,
                 lo: float = LAT_LO_MS, hi: float = LAT_HI_MS,
                 bins: int = LAT_BINS, device) -> MetricBuffer:
    """A zeroed buffer of ``n_windows`` windows (at least one) on
    ``device``; ``counters`` and ``gauges`` are the metric names."""
    W = max(1, int(n_windows))
    dev = torch.device(device)
    return MetricBuffer(
        edges=torch.as_tensor(log_edges(lo, hi, bins), device=dev),
        hist=torch.zeros(bins, dtype=torch.int32, device=dev),
        counts=torch.zeros((W, len(counters)), dtype=torch.int64,
                           device=dev),
        snaps=torch.full((W, len(gauges)), float("nan"),
                         dtype=torch.float32, device=dev),
        counter_names=tuple(counters), gauge_names=tuple(gauges))


def window_of(buf: MetricBuffer, t, width) -> int:
    """Window index of host time ``t`` under window width ``width``,
    clipped into range (the last window absorbs any overhang).  Computed
    in float32, as the reference computes it on the device: a tick on a
    window edge lands where the reference puts it."""
    w = int(np.floor(np.float32(t) / np.float32(width)))
    return min(max(w, 0), buf.n_windows - 1)


def _write(table: torch.Tensor, w, col: int, value, add: bool) -> None:
    """``table[w, col] (+)= value``; ``w`` a host int or a 0-d device
    tensor, ``value`` a number or a 0-d tensor."""
    if isinstance(w, torch.Tensor):
        if isinstance(value, torch.Tensor):
            src = value.reshape(1).to(table.dtype)
        else:
            src = torch.full((1,), value, dtype=table.dtype,
                             device=table.device)
        column, idx = table[:, col], w.reshape(1).long()
        if add:
            column.index_add_(0, idx, src)
        else:
            column.index_copy_(0, idx, src)
    elif add:
        table[w, col].add_(value)
    elif isinstance(value, torch.Tensor):
        table[w, col].copy_(value)
    else:
        table[w, col].fill_(value)


def count_event(buf: MetricBuffer, name: str, w, n) -> MetricBuffer:
    """Add ``n`` events to counter ``name`` in window ``w``."""
    _write(buf.counts, w, buf.counter_names.index(name), n, add=True)
    return buf


def set_gauge(buf: MetricBuffer, name: str, w, value) -> MetricBuffer:
    """Record gauge ``name`` in window ``w`` (last write wins)."""
    _write(buf.snaps, w, buf.gauge_names.index(name), value, add=False)
    return buf


def count_events(buf: MetricBuffer, w: int, values: dict) -> MetricBuffer:
    """Add every counter's events of window ``w`` (a host int) at once:
    ``values`` maps each counter name to a 0-d tensor."""
    buf.counts[w].add_(torch.stack([values[n] for n in buf.counter_names]))
    return buf


def set_gauges(buf: MetricBuffer, w: int, values: dict) -> MetricBuffer:
    """Write every gauge of window ``w`` (a host int) at once."""
    buf.snaps[w].copy_(torch.stack([values[n] for n in buf.gauge_names]))
    return buf


def observe_values(buf: MetricBuffer, values, mask=None) -> MetricBuffer:
    """Add masked ``values`` to the log-spaced histogram.  Values below
    or above the edges land in the first or last bin (clamped, never
    dropped, so totals stay consistent with the counters)."""
    values = torch.as_tensor(values, dtype=torch.float32,
                             device=buf.hist.device).reshape(-1)
    idx = torch.searchsorted(buf.edges, values, right=True).sub_(1)
    idx.clamp_(0, buf.hist.shape[0] - 1)
    if mask is None:
        add = torch.ones(idx.shape, dtype=torch.int32, device=idx.device)
    else:
        add = torch.as_tensor(mask, device=idx.device).reshape(-1).to(
            torch.int32)
    buf.hist.index_add_(0, idx, add)
    return buf


def merge_shard_buffers(buf: MetricBuffer, gauge_reduce=None) -> MetricBuffer:
    """Collapse a buffer whose ``hist``, ``counts`` and ``snaps`` carry a
    leading shard axis — one copy per rank of a cells group, stacked —
    into one buffer of the whole fleet.

    Counters and the histogram are counts: the shards partition the
    events, so they sum.  Gauges follow ``gauge_reduce[name] -> "sum" |
    "mean"`` (default "sum"): extensive gauges (backlog, in-flight
    requests, per-tier occupancy) sum across shards, intensive ones (the
    mean queue depth over cells) average, which is exact because shards
    hold equally many cells.  A window where no shard wrote (all NaN)
    stays NaN; the shards that wrote are reduced ignoring the NaNs.
    Gauges add shard by shard, in the reference's order."""
    gauge_reduce = gauge_reduce or {}
    snaps = buf.snaps
    written = ~torch.isnan(snaps)
    values = torch.where(written, snaps, 0.0)
    total = values[0]
    for v in values[1:]:
        total = total + v
    mean = total / written.sum(0)
    by_mean = torch.tensor([gauge_reduce.get(n, "sum") == "mean"
                            for n in buf.gauge_names], device=snaps.device)
    merged = torch.where(by_mean, mean, total)
    return buf._replace(
        hist=buf.hist.sum(0, dtype=buf.hist.dtype),
        counts=buf.counts.sum(0),
        snaps=torch.where(written.any(0), merged, float("nan")))


# ------------------------------------------------------------- host side
def histogram_percentile(hist, edges, p: float) -> float | None:
    """Nearest-rank percentile from histogram counts: the order statistic
    ``ceil(p/100 * n)`` is located by cumulative count and reported as
    its bin's geometric midpoint.  None on an empty histogram."""
    hist = np.asarray(hist, np.int64)
    edges = np.asarray(edges, np.float64)
    total = int(hist.sum())
    if total == 0:
        return None
    rank = min(max(1, int(np.ceil(p / 100.0 * total))), total)
    b = int(np.searchsorted(np.cumsum(hist), rank))
    return float(np.sqrt(edges[b] * edges[b + 1]))


def histogram_percentiles(hist, edges, ps=(50.0, 95.0, 99.0)) -> dict:
    return {f"p{p:g}": histogram_percentile(hist, edges, p) for p in ps}


def buffer_series(buf: MetricBuffer) -> dict:
    """The buffer on the host: numpy per-window series by name, the
    histogram (counts and edges) and its p50/p95/p99."""
    counts = buf.counts.cpu().numpy()
    snaps = buf.snaps.cpu().numpy().astype(np.float64)
    out = {"counters": {n: counts[:, i]
                        for i, n in enumerate(buf.counter_names)},
           "gauges": {n: snaps[:, i] for i, n in enumerate(buf.gauge_names)},
           "hist": buf.hist.cpu().numpy().astype(np.int64),
           "edges": buf.edges.cpu().numpy().astype(np.float64)}
    out["hist_percentiles"] = histogram_percentiles(out["hist"],
                                                    out["edges"])
    return out
