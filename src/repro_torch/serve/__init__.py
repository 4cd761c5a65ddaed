"""Request-level serving, and the round gateway beside it.

    stream    RequestStream traces: Poisson request streams, and round
              traces as round-synchronous streams
    engine    the request-level tick over per-cell ring queues, with
              the tier economy of ``ServeConfig.economy`` and the
              per-window telemetry of ``ServeConfig.telemetry``
    metrics   per-request accounting: latency percentiles, SLO
              attainment, drop / defer counts
    compat    the round-synchronous replay gateway (``replay_trace``)
    sharded   serving over a cells group of spawned ranks
              (``serve_sharded``; ``serve_stream(mesh=)`` is one rank's
              part of it)
"""
from repro_torch.serve.stream import (RequestStream, poisson_request_stream,
                                      round_synchronous_stream)
from repro_torch.serve.engine import (EngineState, RequestRecords,
                                      ServeConfig, ServeEngine,
                                      make_serve_engine, serve_stream,
                                      telemetry_report)
from repro_torch.serve.metrics import request_report
from repro_torch.serve.compat import make_gateway, replay_trace
from repro_torch.serve.sharded import ServeJob, serve_sharded

__all__ = [
    "RequestStream", "poisson_request_stream", "round_synchronous_stream",
    "EngineState", "RequestRecords", "ServeConfig", "ServeEngine",
    "make_serve_engine", "serve_stream", "telemetry_report",
    "request_report",
    "make_gateway", "replay_trace",
    "ServeJob", "serve_sharded",
]
