"""Request-level serving: streams, engine, metrics."""
