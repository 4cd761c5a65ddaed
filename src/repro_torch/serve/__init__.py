"""Request-level serving, and the round gateway beside it.

    stream    RequestStream traces: Poisson request streams, and round
              traces as round-synchronous streams
    engine    the request-level tick over per-cell ring queues
    metrics   per-request accounting: latency percentiles, SLO
              attainment, drop / defer counts
    compat    the round-synchronous replay gateway (``replay_trace``)
"""
from repro_torch.serve.stream import (RequestStream, poisson_request_stream,
                                      round_synchronous_stream)
from repro_torch.serve.engine import (EngineState, RequestRecords,
                                      ServeConfig, ServeEngine,
                                      make_serve_engine, serve_stream)
from repro_torch.serve.metrics import request_report
from repro_torch.serve.compat import make_gateway, replay_trace

__all__ = [
    "RequestStream", "poisson_request_stream", "round_synchronous_stream",
    "EngineState", "RequestRecords", "ServeConfig", "ServeEngine",
    "make_serve_engine", "serve_stream", "request_report",
    "make_gateway", "replay_trace",
]
