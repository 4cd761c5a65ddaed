"""The round-synchronous replay gateway (counterpart of
``repro.serve.compat``).

``replay_trace`` serves a (T, C) ``poisson_round_trace`` row by row, with
round-mean metrics beside the exact solver oracle.  It keeps the round
abstraction's two distortions — burst mass beyond ``n_max`` is clipped
and empty rounds hold one request (pass the trace's ``with_stats`` dict
as ``trace_stats`` to label the report) — and accounts latency as a
per-round mean, never per request.  On a ``round_synchronous_stream`` of
the same trace, quiet and uncoupled, the request-level engine reproduces
its request-weighted ART and violation rate
(``tests/test_torch_compat.py``).  New serving code uses
``repro_torch.serve.engine.serve_stream``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch.device import resolve_device, synchronize
from repro_torch.fleet.env import REWARD_SCALE, FleetConfig, make_fleet_env
from repro_torch.fleet.evaluate import run_policy_round
from repro_torch.fleet.solver import host
from repro_torch.fleet.workload import FleetScenario
from repro_torch.hltrain.metrics import reward_from_round
from repro_torch.policy.adapters import solve_oracle
from repro_torch.policy.api import (Policy, params_to, refresh_params,
                                    require_device_side)


def make_gateway(policy: Policy, cfg: FleetConfig):
    """``(env, serve_round)``: ``serve_round(params, scenario, state,
    key) -> (state', info)`` aborts in-flight rounds (the trace swapped
    ``n_users``), then takes ``n_max`` fleet-wide decisions through
    ``policy.act``; ``info`` holds each cell's first completed round
    (art / acc / violated, (C,) tensors)."""
    require_device_side(policy, "the round gateway")
    env = make_fleet_env(cfg)

    def serve_round(params, scenario: FleetScenario, state, key):
        return run_policy_round(env, policy, cfg, params, scenario,
                                env.reset_rounds(state), key)

    return env, serve_round


def replay_trace(policy: Policy, params, scenario: FleetScenario, trace,
                 cfg: FleetConfig, *, key=None, oracle: dict | None = None,
                 trace_stats: dict | None = None, device="cuda") -> dict:
    """Open-loop replay of a (T, C) per-round arrival trace on
    ``device``.  Returns ``{"rounds": [per-round dicts], **summary}``.
    Pass precomputed ``solve_oracle(scenario)`` tables to skip solving,
    and the trace's ``with_stats`` dict as ``trace_stats``.  ``key`` is a
    threefry key (default ``PRNGKey(0)``).

    Latency and violations are request-weighted.  Each round is timed on
    the host clock between two device synchronisations; round 0 (which
    builds or loads the kernels) stays out of ``decisions_per_s``, which
    is None without a later round.  Each round's info comes to the host
    once."""
    dev = resolve_device(device)
    env, serve_round = make_gateway(policy, cfg)
    scenario = scenario.to(dev)  # with its group index, built once here
    params = params_to(params, dev)
    key = rnd.PRNGKey(0, dev) if key is None else key.to(dev)
    if oracle is None:
        oracle = solve_oracle(scenario)
    opt_art_table = np.asarray(oracle["art"])     # (C, n_max)
    constraint = host(scenario.constraint)
    cells = np.arange(scenario.n_cells)
    trace = host(trace)

    k_env, key = rnd.split(key)
    state = env.init(k_env, scenario)
    rounds = []
    decisions = 0
    wall_serving = 0.0
    for t in range(trace.shape[0]):
        n_t = trace[t]
        scn_t = scenario._replace(n_users=torch.as_tensor(
            n_t, dtype=torch.int32, device=dev))
        params_t = refresh_params(policy, params, scn_t)
        key, k_round = rnd.split(key)
        synchronize(dev)
        t0 = time.perf_counter()
        state, info = serve_round(params_t, scn_t, state, k_round)
        synchronize(dev)
        dt = time.perf_counter() - t0
        if t > 0:
            wall_serving += dt
            decisions += scenario.n_cells * cfg.n_max
        art, acc, violated = (host(info[k])
                              for k in ("art", "acc", "violated"))
        served = int(n_t.sum())
        opt_art = opt_art_table[cells, n_t - 1]
        reward = reward_from_round(art, acc, constraint)
        rounds.append({
            "round": t, "served_requests": served,
            "mean_art_ms": float((art * n_t).sum() / served),
            "opt_art_ms": float((opt_art * n_t).sum() / served),
            "violation_rate": float((violated * n_t).sum() / served),
            "mean_reward": float(reward.mean()),   # per cell-round
            "opt_reward": float((-opt_art / REWARD_SCALE).mean()),
        })

    served_total = int(trace.sum())
    wmean = lambda k: float(sum(r[k] * r["served_requests"]
                                for r in rounds) / served_total)
    mean = lambda k: float(np.mean([r[k] for r in rounds]))
    report = {
        "rounds": rounds,
        "n_rounds": len(rounds),
        "n_cells": scenario.n_cells,
        "served_requests": served_total,
        "mean_art_ms": wmean("mean_art_ms"),
        "opt_art_ms": wmean("opt_art_ms"),
        "violation_rate": wmean("violation_rate"),
        "mean_reward": mean("mean_reward"),
        "opt_reward": mean("opt_reward"),
        "decisions_per_s": (decisions / wall_serving
                            if decisions and wall_serving > 0 else None),
    }
    if trace_stats is not None:
        report["trace_stats"] = dict(trace_stats)
    return report
