"""Live streaming telemetry: NDJSON window records and SLO burn-rate alerts.

Counterpart of ``repro.telemetry.live``.  A host-side :class:`LiveEmitter`
receives each telemetry window from the serving engine on the tick that
closes it (one device-to-host copy of that window's row), so windowed
metrics stream out as NDJSON while the run executes:

    {"event": "window", "window": 3, "t_ms": 1999.0, "admitted": 41, ...}
    {"event": "alert", "window": 7, "fast_burn": 4.2, "slow_burn": 2.8, ...}
    {"event": "epoch", "epoch": 2, "served": 311, "backlog": 12, ...}

``window`` records carry every engine counter and gauge of the closed
window and the derived attainment; ``epoch`` records are written by the
host loop (``serve_stream``) at epoch boundaries (the bundle hot-swap
points).  Events go to any :class:`NdjsonSink`: a file, stdout
(``serve_fleet --live``) or an in-memory buffer in tests.

**Alert semantics** (:class:`BurnRateAlerter`): the multi-window SLO
burn-rate rule.  With an attainment objective ``target`` the error
budget is ``1 - target`` per exposed request; a window's *burn rate* is
its observed error fraction over that budget, where errors are
``(served - attained) + dropped`` and exposure is ``served + dropped``
(drops page: shedding load must not silence the alert).  An ``alert``
event is written for every window where both the trailing
``fast_windows``-window burn and the trailing ``slow_windows``-window
burn reach ``threshold``.

Records are deduplicated by window index and the alerter keeps its own
per-window ledger, so a repeated window is never counted twice.  The
engine reports a window once its last tick has run, and the final
``finish()`` call flushes the windows no tick closed (always the final one)
from the run-end report, so every window is written exactly once: closed
windows carry ``t_ms`` = the closing tick's clock, flushed ones
``(w + 1) * window_ms``.

Training streams through the same sinks: :class:`TrainLiveEmitter` gets
one call per epoch, after its direct sessions, and writes a
``train_session`` record per active direct session (epsilon, mean
reward, TD loss: the gauges the trainer's buffer accumulates).

The engine and the trainer reach their emitter through one small *host
lane* function each (``serve.engine._emit_window``,
``hltrain.trainer._emit_epoch``), which holds the lane's one
device-to-host copy.  :func:`host_lane` registers such a function under
the emitter method it feeds; ``repro_torch.analysis`` attributes every
device-to-host copy to the lane on its Python stack and fails any copy
outside the lanes of :data:`CALLBACK_WHITELIST`.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from typing import Optional

import numpy as np

__all__ = [
    "NdjsonSink", "open_sink", "BurnRateConfig", "BurnRateAlerter",
    "LiveEmitter", "TrainLiveEmitter", "CALLBACK_WHITELIST", "HOST_LANES",
    "host_lane",
]

# The only emitter methods a tick or a training epoch may hand device
# data to (the reference's io_callback whitelist): the live-emitter
# window and epoch lanes below.  repro_torch.analysis runs every
# registered entry point and fails its contract check on a device-to-host
# copy outside a lane named here -- add a name (and a lane that deserves
# it) before wiring a new host copy into the tick or the trainer.
CALLBACK_WHITELIST = frozenset({"on_window", "on_epoch"})

# code object of each host-lane function -> the emitter method it feeds
HOST_LANES = {}


def host_lane(name: str):
    """Register the decorated function as the host lane that feeds the
    emitter method ``name``.  The function is returned unchanged, so the
    analysis finds its frame on the stack of the copies it makes."""
    def register(fn):
        HOST_LANES[fn.__code__] = name
        return fn
    return register

class NdjsonSink:
    """Newline-delimited JSON event writer over any text stream.

    Events are flushed per line — a tail of the sink file (or the
    terminal) always shows the run's current state."""

    def __init__(self, out=None, *, close: bool = False):
        self._out = sys.stdout if out is None else out
        self._close = close
        self.n_events = 0

    def write(self, event: dict) -> None:
        self._out.write(json.dumps(event) + "\n")
        self._out.flush()
        self.n_events += 1

    def close(self) -> None:
        if self._close:
            self._out.close()


def open_sink(path: Optional[str]) -> NdjsonSink:
    """``None`` or ``"-"`` -> stdout; anything else -> that file."""
    if path is None or path == "-":
        return NdjsonSink(sys.stdout)
    return NdjsonSink(open(path, "w"), close=True)


@dataclasses.dataclass(frozen=True)
class BurnRateConfig:
    """Multi-window burn-rate alert policy over the attainment counters.

    ``target`` is the SLO attainment objective (error budget =
    ``1 - target``); an alert fires when both the fast and the slow
    trailing-window burn rates reach ``threshold`` × budget."""
    target: float = 0.9
    fast_windows: int = 1
    slow_windows: int = 6
    threshold: float = 2.0


class BurnRateAlerter:
    """Stateful fast/slow-window burn-rate evaluator.

    ``observe(window, served, attained, dropped)`` records one closed
    window and returns an alert event dict when the rule fires, else
    ``None``.  Windows may arrive out of order; each is counted once and
    burn is always evaluated over the trailing windows of the sorted
    ledger."""

    def __init__(self, cfg: BurnRateConfig = BurnRateConfig()):
        if not 0.0 < cfg.target < 1.0:
            raise ValueError(f"target must be in (0, 1): {cfg.target}")
        self.cfg = cfg
        self._ledger = {}  # window -> (errors, exposure)

    def _burn(self, n: int) -> Optional[float]:
        """Burn rate over the trailing ``n`` recorded windows (None when
        nothing was exposed there — no traffic is not an outage)."""
        tail = sorted(self._ledger)[-n:]
        err = sum(self._ledger[w][0] for w in tail)
        exp = sum(self._ledger[w][1] for w in tail)
        if exp == 0:
            return None
        budget = 1.0 - self.cfg.target
        return (err / exp) / budget

    def observe(self, window: int, served: int, attained: int,
                dropped: int = 0) -> Optional[dict]:
        if window in self._ledger:  # duplicate delivery — already counted
            return None
        errors = max(0, int(served) - int(attained)) + int(dropped)
        self._ledger[window] = (errors, int(served) + int(dropped))
        fast = self._burn(self.cfg.fast_windows)
        slow = self._burn(self.cfg.slow_windows)
        if fast is None or slow is None:
            return None
        if fast >= self.cfg.threshold and slow >= self.cfg.threshold:
            return {"event": "alert", "window": int(window),
                    "fast_burn": round(fast, 3),
                    "slow_burn": round(slow, 3),
                    "target": self.cfg.target,
                    "threshold": self.cfg.threshold}
        return None


class LiveEmitter:
    """Host side of the serve engine's live export.

    The engine calls :meth:`on_window` on the tick that closes a window
    (``closed`` true) with that window's counter and gauge values; the
    emitter writes each closed window exactly once (dedup by index),
    derives attainment and runs the alerter inline.  ``serve_stream`` calls
    :meth:`epoch` at epoch boundaries and :meth:`finish` once, with the
    run-end telemetry report, to flush the final partial window."""

    def __init__(self, sink: NdjsonSink, counters, gauges, *,
                 window_ms: float,
                 alerter: Optional[BurnRateAlerter] = None):
        self.sink = sink
        self.counter_names = tuple(counters)
        self.gauge_names = tuple(gauges)
        self.window_ms = float(window_ms)
        self.alerter = BurnRateAlerter() if alerter is None else alerter
        self._emitted = set()
        self.n_alerts = 0

    # ---- engine lane: (w, closed, now, counter_vals, gauge_vals)
    def on_window(self, w, closed, now, counter_vals, gauge_vals) -> None:
        w = int(w)
        if not bool(closed) or w in self._emitted:
            return
        counters = {n: int(v) for n, v in
                    zip(self.counter_names, np.asarray(counter_vals))}
        gauges = {n: (None if np.isnan(v) else round(float(v), 4))
                  for n, v in zip(self.gauge_names,
                                  np.asarray(gauge_vals))}
        self._emit(w, float(now), counters, gauges)

    def _emit(self, w: int, t_ms: float, counters: dict,
              gauges: dict) -> None:
        self._emitted.add(w)
        served = counters.get("served", 0)
        attained = counters.get("attained", 0)
        dropped = counters.get("dropped", 0)
        event = {"event": "window", "window": w,
                 "t_ms": round(t_ms, 3), "window_ms": self.window_ms,
                 **counters, **gauges,
                 "attainment": (round(attained / served, 4)
                                if served else None)}
        self.sink.write(event)
        alert = self.alerter.observe(w, served, attained, dropped)
        if alert is not None:
            self.n_alerts += 1
            self.sink.write({**alert, "t_ms": round(t_ms, 3)})

    # ---- host-loop events
    def epoch(self, epoch: int, **payload) -> None:
        self.sink.write({"event": "epoch", "epoch": int(epoch),
                         **{k: (int(v) if isinstance(v, (bool, np.bool_))
                                or np.issubdtype(type(v), np.integer)
                                else v) for k, v in payload.items()}})

    def finish(self, telemetry_report: dict) -> None:
        """Flush windows the tick stream never closed (always at least
        the final one) from the run-end series, then close the sink."""
        series = telemetry_report["series"]
        n_windows = int(telemetry_report["n_windows"])
        for w in range(n_windows):
            if w in self._emitted:
                continue
            counters = {n: int(series[n][w]) for n in self.counter_names}
            gauges = {n: (None if series[n][w] is None
                          else round(float(series[n][w]), 4))
                      for n in self.gauge_names}
            self._emit(w, (w + 1) * self.window_ms, counters, gauges)
        self.sink.write({"event": "summary",
                         "n_windows": n_windows,
                         "n_alerts": self.n_alerts,
                         "hist_p50_latency_ms":
                             telemetry_report["hist_p50_latency_ms"],
                         "hist_p95_latency_ms":
                             telemetry_report["hist_p95_latency_ms"],
                         "hist_p99_latency_ms":
                             telemetry_report["hist_p99_latency_ms"]})
        self.sink.close()


class TrainLiveEmitter:
    """Live export for the trainer's session loop: one ``train_session``
    NDJSON record per *active* direct session (the trainer calls
    :meth:`on_epoch` once per epoch, after its direct sessions, with
    their metric lanes)."""

    def __init__(self, sink: NdjsonSink):
        self.sink = sink
        self._emitted = set()

    # ---- trainer lane
    def on_epoch(self, epoch, n_active, session0, mean_reward, q_loss,
                 epsilon) -> None:
        mean_reward = np.asarray(mean_reward)
        q_loss = np.asarray(q_loss)
        for i in range(int(n_active)):
            s = int(session0) + i
            if s in self._emitted:  # duplicate delivery
                continue
            self._emitted.add(s)
            r, q = float(mean_reward[i]), float(q_loss[i])
            self.sink.write({
                "event": "train_session", "epoch": int(epoch),
                "session": s,
                "mean_reward": None if np.isnan(r) else round(r, 6),
                "q_loss": None if np.isnan(q) else round(q, 6),
                "epsilon": round(float(epsilon), 6)})

    def finish(self) -> None:
        self.sink.write({"event": "summary",
                         "n_sessions": len(self._emitted)})
        self.sink.close()
