"""Fleet serving CLI of the port — a thin shell over ``serve_stream``.

    PYTHONPATH=src python -m repro_torch.launch.serve_fleet \
        (--bundle hl.bundle.msgpack | --greedy) [--guard] \
        [--cells 64] [--rate 3.0] [--rounds 50] [--seed 0] [--epochs 5] \
        [--cells-per-edge 1] [--shared-cloud] [--shared-edge] \
        [--device cuda]

Serves ``rounds`` round-durations of open-loop Poisson traffic from a
random fleet through a PolicyBundle's policy (``--bundle``, written by
either package) or the latency-greedy baseline (``--greedy``, at the
``full`` spec with n_max = 5), request-level, on one device.  ``--guard``
wraps the policy in the ``slo_guarded`` combinator.  A bundle's recorded
coupling regime (``shared_cloud`` / ``shared_edge`` / ``cells_per_edge``
in its metadata) applies unless the flags set it.  The last line printed
is the report as JSON (records left out).
"""
from __future__ import annotations

import argparse
import json

from repro_torch import random as rnd
from repro_torch.device import resolve_device
from repro_torch.fleet.workload import random_fleet
from repro_torch.policy.adapters import (heuristic_greedy_policy,
                                         slo_guarded, slo_guarded_params)
from repro_torch.policy.bundle import load_bundle, policy_from_bundle
from repro_torch.serve.engine import ServeConfig, serve_stream
from repro_torch.serve.stream import poisson_request_stream
from repro_torch.specs.observation import make_spec

# the baseline's serving configuration when no bundle names one
GREEDY_SPEC, GREEDY_N_MAX = "full", 5


def serve(*, bundle: str | None = None, greedy: bool = False,
          guard: bool = False, cells: int = 64, rate: float = 3.0,
          rounds: int = 50, seed: int = 0, epochs: int = 5,
          cells_per_edge: int | None = None, shared_cloud: bool = False,
          shared_edge: bool = False, device="cuda",
          verbose: bool = True) -> dict:
    """Serve one run and return its report (raw per-request arrays under
    ``"records"``).  Keys as the reference CLI's: ``k_fleet, k_trace,
    k_serve, k_guard = split(PRNGKey(seed), 4)`` draw the fleet, the
    request stream and the serving noise (the guard's greedy fallback
    draws nothing from ``k_guard``), so a seed serves the reference's
    fleet and stream."""
    if (bundle is None) == (not greedy):
        raise SystemExit("give exactly one of --bundle or --greedy")
    dev = resolve_device(device)
    meta = {}
    if bundle is not None:
        b = load_bundle(bundle)
        meta = b.meta
        spec = b.spec()
        policy, params = policy_from_bundle(b, dev)
    else:
        spec = make_spec(GREEDY_SPEC, GREEDY_N_MAX)
        policy = heuristic_greedy_policy(spec)
        params = policy.init(seed, dev)
    if guard:
        fallback = heuristic_greedy_policy(spec)
        params = slo_guarded_params(params, fallback.init(seed, dev), dev)
        policy = slo_guarded(policy, spec, fallback)
    shared_cloud = shared_cloud or bool(meta.get("shared_cloud", False))
    shared_edge = shared_edge or bool(meta.get("shared_edge", False))
    if cells_per_edge is None:
        cells_per_edge = int(meta.get("cells_per_edge", 1))

    k_fleet, k_trace, k_serve, _ = rnd.split(rnd.PRNGKey(seed, dev), 4)
    scenario = random_fleet(k_fleet, cells, n_max=spec.n_max,
                            cells_per_edge=cells_per_edge)
    cfg = ServeConfig(n_max=spec.n_max, obs_spec=spec.name,
                      shared_cloud=shared_cloud, shared_edge=shared_edge)
    horizon_ms = rounds * cfg.round_ms
    stream = poisson_request_stream(
        k_trace, scenario, horizon_ms, rate=rate, round_ms=cfg.round_ms,
        epoch_ms=horizon_ms / max(1, epochs))
    config = dict(bundle=bundle, greedy=greedy, guard=guard, cells=cells,
                  rate=rate, rounds=rounds, seed=seed, epochs=epochs,
                  cells_per_edge=cells_per_edge, shared_cloud=shared_cloud,
                  shared_edge=shared_edge, device=str(dev),
                  obs_spec=spec.name, n_max=spec.n_max, kind=policy.kind)
    if verbose:
        print("config: " + " ".join(f"{k}={v}"
                                    for k, v in sorted(config.items())))
        print(f"serving {stream.n_requests:,} requests to {cells} cells "
              f"over {horizon_ms:.0f} ms")
    report = serve_stream(policy, params, scenario, stream, cfg,
                          key=k_serve, verbose=verbose, device=dev)
    report["horizon_ms"] = horizon_ms
    report["config"] = config
    if verbose:
        tail = (f"latency p50/p95/p99 {report['p50_latency_ms']:.0f}/"
                f"{report['p95_latency_ms']:.0f}/"
                f"{report['p99_latency_ms']:.0f} ms, "
                if report["served_requests"] else "")
        mpt = report["ms_per_tick"]
        print(f"served {report['served_requests']:,}/"
              f"{report['n_requests']:,} requests "
              f"({report['dropped_requests']} dropped, "
              f"{report['deferred_requests']} deferred): " + tail
              + f"SLO attainment {report['slo_attainment']:.1%}, accuracy "
              f"violations {report['violation_rate']:.1%}"
              + (f", {mpt:.2f} ms per steady tick" if mpt else ""))
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--bundle", help="PolicyBundle checkpoint to serve")
    src.add_argument("--greedy", action="store_true",
                     help="serve the latency-greedy baseline")
    ap.add_argument("--guard", action="store_true",
                    help="wrap the policy in the slo_guarded combinator")
    ap.add_argument("--cells", type=int, default=64)
    ap.add_argument("--rate", type=float, default=3.0,
                    help="mean arrivals per cell per round")
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--epochs", type=int, default=5,
                    help="param-refresh epochs over the horizon")
    ap.add_argument("--cells-per-edge", type=int, default=None)
    ap.add_argument("--shared-cloud", action="store_true")
    ap.add_argument("--shared-edge", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    report = serve(bundle=args.bundle, greedy=args.greedy, guard=args.guard,
                   cells=args.cells, rate=args.rate, rounds=args.rounds,
                   seed=args.seed, epochs=args.epochs,
                   cells_per_edge=args.cells_per_edge,
                   shared_cloud=args.shared_cloud,
                   shared_edge=args.shared_edge, device=args.device)
    print(json.dumps({k: v for k, v in report.items() if k != "records"}))
    return report


if __name__ == "__main__":
    main()
