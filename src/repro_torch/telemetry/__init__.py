"""Observability for fleet serving and training (counterpart of
``repro.telemetry``).

    metrics    MetricBuffer: per-window counters and gauges and a
               log-spaced histogram on device tensors, carried by the
               serving engine's state and the trainer's carry and
               written with no host sync inside a tick or a session
    trace      sampled per-request lifecycle traces (arrival → admit /
               drop → round start → completion) as JSONL, with a
               round-trip validator
    report     CLI that renders a served run from a trace file: windowed
               series and tail latency by cell and by action
               (``python -m repro_torch.telemetry.report``)
    profiling  ``profiled()``: first-call vs steady wall clock (device
               synchronized), peak memory, optional ``torch.profiler``
               trace
    live       NDJSON export while a run executes: ``LiveEmitter`` gets
               each closed window from the serving tick, with
               multi-window SLO burn-rate alerts (``serve_fleet
               --live``); ``TrainLiveEmitter`` does the same for the
               trainer's direct sessions
    audit      invariant auditor: conservation laws over the windows and
               the lifecycle trace (admits == serves + drops + still
               queued, occupancy ≤ capacity, window sums == run totals,
               the economy's spend law), library and CLI
               (``python -m repro_torch.telemetry.audit``)
    canary     paired per-window diff of two policies served on the
               bit-identical arrival stream (``serve_fleet --canary``)

``merge_shard_buffers`` collapses the per-rank buffers of a cells group
(``repro_torch.sharding``) into the fleet's.
"""
from repro_torch.telemetry.metrics import (MetricBuffer, metrics_init,
                                           count_event, set_gauge,
                                           observe_values, buffer_series,
                                           histogram_percentile,
                                           histogram_percentiles,
                                           merge_shard_buffers)
from repro_torch.telemetry.trace import (build_trace, write_trace,
                                         read_trace, validate_trace)
from repro_torch.telemetry.profiling import Profile, profiled
from repro_torch.telemetry.live import (NdjsonSink, open_sink,
                                        BurnRateConfig, BurnRateAlerter,
                                        LiveEmitter, TrainLiveEmitter)
from repro_torch.telemetry.audit import (AuditResult, audit_serve_report,
                                         audit_trace, audit_train_report)
from repro_torch.telemetry.canary import canary_diff, render_canary

__all__ = [
    "MetricBuffer", "metrics_init", "count_event", "set_gauge",
    "observe_values", "buffer_series", "histogram_percentile",
    "histogram_percentiles", "merge_shard_buffers",
    "build_trace", "write_trace", "read_trace", "validate_trace",
    "Profile", "profiled",
    "NdjsonSink", "open_sink", "BurnRateConfig", "BurnRateAlerter",
    "LiveEmitter", "TrainLiveEmitter",
    "AuditResult", "audit_serve_report", "audit_trace",
    "audit_train_report",
    "canary_diff", "render_canary",
]
