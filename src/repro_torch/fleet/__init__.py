"""Fleet-scale vectorized simulation: latency model, scenarios, env."""
