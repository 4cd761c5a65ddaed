"""Fleet serving CLI of the port — request-level by default, round
replay as compat.

    PYTHONPATH=src python -m repro_torch.launch.serve_fleet \
        (--bundle hl.bundle.msgpack | --greedy) [--guard] \
        [--cells 64] [--rate 3.0] [--rounds 50] [--seed 0] [--epochs 5] \
        [--cells-per-edge 1] [--shared-cloud] [--shared-edge] \
        [--quiet] [--tick-ms 50] [--queue-cap 64] \
        [--telemetry] [--window-ms 1000] \
        [--trace-out trace.jsonl] [--trace-sample 1.0] \
        [--live] [--live-out live.ndjson] [--slo-target 0.9] \
        [--canary other.bundle.msgpack] \
        [--economy local|serverless|spot] [--round-replay] \
        [--mesh-cells N] [--out serve.json] [--device cuda]

Serves ``rounds`` round-durations of open-loop Poisson traffic from a
random fleet through a PolicyBundle's policy (``--bundle``, written by
either package) or the latency-greedy baseline (``--greedy``, at the
``full`` spec with n_max = 5), on one device:

* default: a continuous-time request stream through the request-level
  engine (``serve_stream``), with per-request latency, SLO attainment
  and drop / defer counts;
* ``--round-replay``: the round-synchronous gateway
  (``serve.compat.replay_trace``) over a ``poisson_round_trace`` of
  ``rounds`` rows, with round-mean ART beside the exact solver oracle and
  the share of burst mass the round abstraction clipped.  ``--epochs``
  does not apply to it.

``--quiet`` turns the background fluctuations off (both paths);
``--tick-ms`` and ``--queue-cap`` set the request-level engine's decision
tick and per-cell ring capacity.  ``--economy <profile>`` (``local`` /
``serverless`` / ``spot``, see ``repro_torch.economy``) gives every tier
a price, an energy cost and a warm/cold/warming startup state machine
advanced every tick: cold starts and spot preemptions delay recorded
service, and the report gains ``"economy"`` (spend, joules, cost per 1k
requests, joules per request, cold starts, preemptions).  It serves the
policy the user names (a ``cost_greedy`` bundle routes on the economy
block; ``--greedy`` ignores it) and is request-level only: with
``--round-replay`` it exits before any work.  ``--out`` writes the
report as JSON (records left out); its directory is checked for
writability before any work.

Observability (request-level only: with ``--round-replay`` they exit
before any work): ``--telemetry`` carries a ``repro_torch.telemetry``
metric buffer through the tick (per-``--window-ms`` counters, window-end
gauges and a latency histogram, under ``"telemetry"`` in the report; the
economy's spend, energy, cold-start and preemption counters ride in it
under ``--economy``).  ``--trace-out`` writes a per-request lifecycle
trace as JSONL (``--trace-sample``: the deterministic id-hash sampling
rate), which ``python -m repro_torch.telemetry.report`` renders and
``python -m repro_torch.telemetry.audit --trace`` checks beside the
``--out`` report.  ``--live`` (requires ``--telemetry``) streams each
closed window as NDJSON while the run executes, to stdout or
``--live-out``, with SLO burn-rate ``alert`` events against the
``--slo-target`` attainment objective.  ``--canary other.bundle`` serves
a second bundle on the bit-identical stream (same fleet, stream and
serving key) and adds the paired per-window diff under ``"canary"``.
The trace and live paths are checked for writability before any work.

``--mesh-cells N`` shards the request-level engine over a cells group of
N spawned ranks (``repro_torch.sharding``): rank r serves cells
``[r·C/N, (r+1)·C/N)`` on ``cuda:(r % device_count)`` (or the CPU), over
NCCL when every rank has a card of its own and gloo otherwise.  Each rank
draws the fleet and the stream from ``--seed``; the report is the one a
single device gives (records identical, floats within 1e-5), with
``mesh_cells``, the group's backend and collectives under
``cells_group``, and each rank's kernel launches and collectives under
``ranks``.  Rank 0 alone prints and writes the trace; the parent writes
``--out``.  ``--cells`` must divide by N; ``--round-replay`` and
``--live`` refuse it.

``--guard`` wraps the policy in the ``slo_guarded`` combinator.  A
bundle's recorded coupling regime (``shared_cloud`` / ``shared_edge`` /
``cells_per_edge`` in its metadata) applies unless the flags set it.
``oracle`` bundles hold one fleet's action table; ``qtable`` bundles are
host-side and both paths refuse them.  The last line printed is the
report as JSON (records left out).
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch import random as rnd
from repro_torch.device import resolve_device
from repro_torch.economy import PROFILE_NAMES, builtin_profile
from repro_torch.fleet.env import FleetConfig
from repro_torch.fleet.workload import poisson_round_trace, random_fleet
from repro_torch.kernels import orchestration
from repro_torch.policy.adapters import (heuristic_greedy_policy,
                                         slo_guarded, slo_guarded_params,
                                         solve_oracle)
from repro_torch.policy.bundle import load_bundle, policy_from_bundle
from repro_torch.serve.compat import replay_trace
from repro_torch.serve.engine import (ECON_COUNTERS, ECON_GAUGES,
                                      TEL_COUNTERS, TEL_GAUGES, ServeConfig,
                                      serve_stream)
from repro_torch.serve.sharded import rank_counts
from repro_torch.serve.stream import poisson_request_stream
from repro_torch.sharding.runtime import (get_mesh_info,
                                          reset_collective_counts,
                                          set_mesh_info, spawn_cells)
from repro_torch.specs.observation import make_spec
from repro_torch.telemetry import (BurnRateAlerter, BurnRateConfig,
                                   LiveEmitter, build_trace, canary_diff,
                                   open_sink, render_canary, write_trace)

# the baseline's serving configuration when no bundle names one
GREEDY_SPEC, GREEDY_N_MAX = "full", 5


def require_writable(path, flag: str) -> None:
    """Fail fast on an output path whose parent directory does not exist
    or is not writable, before any work.  ``None`` and ``"-"`` (stdout)
    pass."""
    if path is None or path == "-":
        return
    parent = os.path.dirname(os.path.abspath(path))
    if not os.path.isdir(parent):
        raise SystemExit(f"{flag} {path!r}: parent directory {parent!r} "
                         "does not exist")
    if not os.access(parent, os.W_OK):
        raise SystemExit(f"{flag} {path!r}: parent directory {parent!r} "
                         "is not writable")


def guarded(policy, params, spec, seed: int, dev) -> tuple:
    """(policy, params) wrapped in the ``slo_guarded`` combinator with
    the latency-greedy fallback."""
    fallback = heuristic_greedy_policy(spec)
    return (slo_guarded(policy, spec, fallback),
            slo_guarded_params(params, fallback.init(seed, dev), dev))


def serve(*, bundle: str | None = None, greedy: bool = False,
          guard: bool = False, cells: int = 64, rate: float = 3.0,
          rounds: int = 50, seed: int = 0, epochs: int = 5,
          cells_per_edge: int | None = None, shared_cloud: bool = False,
          shared_edge: bool = False, quiet: bool = False,
          tick_ms: float = 50.0, queue_cap: int = 64,
          telemetry: bool = False, window_ms: float = 1000.0,
          trace_out: str | None = None, trace_sample: float = 1.0,
          live: bool = False, live_out: str | None = None,
          slo_target: float = 0.9, canary: str | None = None,
          economy: str | None = None, round_replay: bool = False,
          mesh_cells: int = 0, device="cuda",
          verbose: bool = True) -> dict:
    """Serve one run and return its report (request-level: raw
    per-request arrays under ``"records"``; round replay: per-round rows
    under ``"rounds"``).  Keys as the reference CLI's: ``k_fleet,
    k_trace, k_serve, k_guard = split(PRNGKey(seed), 4)`` draw the fleet,
    the request stream or round trace and the serving noise (the guard's
    greedy fallback draws nothing from ``k_guard``), so a seed serves the
    reference's fleet and traffic.  ``canary`` serves a second bundle on
    the same stream and key and adds the paired diff under ``"canary"``.
    ``mesh_cells > 0`` serves over that many spawned ranks of a cells
    group and returns rank 0's report."""
    if (bundle is None) == (not greedy):
        raise SystemExit("give exactly one of --bundle or --greedy")
    # output paths and flag combinations fail before any work
    require_writable(trace_out, "--trace-out")
    require_writable(live_out, "--live-out")
    if live and not telemetry:
        raise SystemExit("--live streams the telemetry windows; "
                         "add --telemetry")
    if round_replay and canary:
        raise SystemExit("--canary is a request-level feature; drop "
                         "--round-replay to use it")
    if round_replay and (trace_out or telemetry):
        raise SystemExit("--telemetry/--trace-out are request-level "
                         "features; drop --round-replay to use them")
    profile = None
    if economy:
        if round_replay:
            raise SystemExit("--economy prices the request-level tick "
                             "clock (cold starts, preemptions, per-tick "
                             "billing); the round gateway has none: drop "
                             "--round-replay to use it")
        try:
            profile = builtin_profile(economy)
        except ValueError as e:
            raise SystemExit(str(e))
    if mesh_cells:
        if round_replay:
            raise SystemExit("--mesh-cells shards the request-level "
                             "engine; drop --round-replay to use it")
        if live:
            raise SystemExit("--live is not supported under a cells "
                             "group; drop --mesh-cells or --live")
        if mesh_cells < 0 or cells % mesh_cells:
            raise SystemExit(f"--cells {cells} must divide evenly over "
                             f"--mesh-cells {mesh_cells}")
        kw = dict(bundle=bundle, greedy=greedy, guard=guard, cells=cells,
                  rate=rate, rounds=rounds, seed=seed, epochs=epochs,
                  cells_per_edge=cells_per_edge, shared_cloud=shared_cloud,
                  shared_edge=shared_edge, quiet=quiet, tick_ms=tick_ms,
                  queue_cap=queue_cap, telemetry=telemetry,
                  window_ms=window_ms, trace_out=trace_out,
                  trace_sample=trace_sample, slo_target=slo_target,
                  canary=canary, economy=economy, verbose=verbose)
        ranks = spawn_cells(_serve_rank, mesh_cells, resolve_device(device),
                            kw)
        report = ranks[0][0]
        report["ranks"] = [counts for _, counts in ranks]
        return report
    # a rank of a cells group (registered by _serve_rank) serves its block
    # on its own device
    info = get_mesh_info()
    group = None if info is None else info.group
    dev = resolve_device(device) if group is None else group.device
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
        policy, params = guarded(policy, params, spec, seed, dev)
    shared_cloud = shared_cloud or bool(meta.get("shared_cloud", False))
    shared_edge = shared_edge or bool(meta.get("shared_edge", False))
    if cells_per_edge is None:
        cells_per_edge = int(meta.get("cells_per_edge", 1))

    k_fleet, k_trace, k_serve, _ = rnd.split(rnd.PRNGKey(seed, dev), 4)
    scenario = random_fleet(k_fleet, cells, n_max=spec.n_max,
                            cells_per_edge=cells_per_edge)
    config = dict(bundle=bundle, greedy=greedy, guard=guard, cells=cells,
                  rate=rate, rounds=rounds, seed=seed, epochs=epochs,
                  cells_per_edge=cells_per_edge, shared_cloud=shared_cloud,
                  shared_edge=shared_edge, quiet=quiet, tick_ms=tick_ms,
                  queue_cap=queue_cap, telemetry=telemetry,
                  window_ms=window_ms, trace_sample=trace_sample, live=live,
                  live_out=live_out, slo_target=slo_target, canary=canary,
                  economy=economy, round_replay=round_replay,
                  mesh_cells=(0 if group is None else group.size),
                  device=str(dev), obs_spec=spec.name, n_max=spec.n_max, kind=policy.kind)
    if verbose:
        print("config: " + " ".join(f"{k}={v}"
                                    for k, v in sorted(config.items())))
    if round_replay:
        cfg = FleetConfig(n_max=spec.n_max, obs_spec=spec.name,
                          quiet=quiet, shared_cloud=shared_cloud,
                          shared_edge=shared_edge)
        trace, stats = poisson_round_trace(k_trace, scenario, rounds,
                                           rate=rate, with_stats=True)
        report = replay_trace(policy, params, scenario, trace, cfg,
                              key=k_serve, oracle=solve_oracle(scenario),
                              trace_stats=stats, device=dev)
        report["config"] = config
        if verbose:
            for r in report["rounds"]:
                print(f"  round {r['round']:3d}: "
                      f"{r['served_requests']:6d} req, ART "
                      f"{r['mean_art_ms']:7.1f} ms (opt "
                      f"{r['opt_art_ms']:7.1f}), violations "
                      f"{r['violation_rate']:6.1%}")
            dps = report["decisions_per_s"]
            print(f"round replay served {report['served_requests']:,} "
                  f"requests ({stats['clipped_fraction']:.1%} of the raw "
                  f"burst mass clipped): ART {report['mean_art_ms']:.1f} "
                  f"ms vs solver-optimal {report['opt_art_ms']:.1f} ms, "
                  f"violation rate {report['violation_rate']:.1%}"
                  + (f", {dps:,.0f} decisions/s" if dps else ""))
        return report

    cfg = ServeConfig(n_max=spec.n_max, obs_spec=spec.name, quiet=quiet,
                      tick_ms=tick_ms, queue_cap=queue_cap,
                      shared_cloud=shared_cloud, shared_edge=shared_edge,
                      telemetry=telemetry, window_ms=window_ms,
                      economy=profile)
    horizon_ms = rounds * cfg.round_ms
    stream = poisson_request_stream(
        k_trace, scenario, horizon_ms, rate=rate, round_ms=cfg.round_ms,
        epoch_ms=horizon_ms / max(1, epochs))
    if verbose:
        print(f"serving {stream.n_requests:,} requests to {cells} cells "
              f"over {horizon_ms:.0f} ms")
    emitter = None
    if live:
        # the names of the engine's buffer: the economy's ride in it
        emitter = LiveEmitter(
            open_sink(live_out),
            TEL_COUNTERS + (ECON_COUNTERS if profile else ()),
            TEL_GAUGES + (ECON_GAUGES if profile else ()),
            window_ms=window_ms,
            alerter=BurnRateAlerter(BurnRateConfig(target=slo_target)))
    report = serve_stream(policy, params, scenario, stream, cfg,
                          key=k_serve, verbose=verbose, device=dev,
                          live=emitter)
    report["horizon_ms"] = horizon_ms
    report["config"] = config
    if canary:
        c_bundle = load_bundle(canary, expect_spec=spec.name,
                               expect_n_max=spec.n_max)
        c_policy, c_params = policy_from_bundle(c_bundle, dev)
        if guard:
            c_policy, c_params = guarded(c_policy, c_params, spec, seed, dev)
        c_report = serve_stream(c_policy, c_params, scenario, stream, cfg,
                                key=k_serve, device=dev)
        report["canary"] = dict(
            canary_diff(stream, report, c_report, window_ms),
            bundle=canary, kind=c_bundle.kind)
        if verbose:
            print(render_canary(report["canary"]))
    if trace_out and (group is None or group.rank == 0):
        events = build_trace(stream, report["records"], tick_ms,
                             sample=trace_sample)
        write_trace(trace_out, events)
        if verbose:
            print(f"wrote {len(events)} trace events "
                  f"(sample={trace_sample:g}) to {trace_out}")
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
        if profile is not None:
            eco = report["economy"]
            c1k = eco["cost_per_1k_requests"]
            jpr = eco["joules_per_request"]
            print(f"economy [{eco['profile']}]: "
                  f"${eco['cost_usd_total']:.4f} total"
                  + (f" (${c1k:.4f}/1k req)" if c1k is not None else "")
                  + f", {eco['energy_j_total']:.0f} J"
                  + (f" ({jpr:.2f} J/req)" if jpr is not None else "")
                  + f", {eco['cold_starts']} cold starts, "
                  f"{eco['preemptions']} preemptions")
    return report


def _serve_rank(group, kw: dict) -> tuple:
    """One rank of ``serve(mesh_cells=N)``: the run with ``group``
    registered, so each ``serve_stream`` serves this rank's block; rank 0
    alone prints and writes the trace.  Returns rank 0's report (None on
    the others) and this rank's kernel launches and collectives."""
    set_mesh_info(group)
    try:
        orchestration.reset_launch_counts()
        reset_collective_counts()
        report = serve(**dict(kw, verbose=kw["verbose"] and group.rank == 0))
        return report if group.rank == 0 else None, rank_counts()
    finally:
        set_mesh_info(None)


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
    ap.add_argument("--quiet", action="store_true",
                    help="disable background fluctuations")
    ap.add_argument("--tick-ms", type=float, default=50.0)
    ap.add_argument("--queue-cap", type=int, default=64)
    ap.add_argument("--telemetry", action="store_true",
                    help="carry a repro_torch.telemetry metric buffer "
                         "through the tick (windowed series and a latency "
                         "histogram under 'telemetry' in the report)")
    ap.add_argument("--window-ms", type=float, default=1000.0,
                    help="telemetry aggregation window")
    ap.add_argument("--trace-out", default=None,
                    help="write a sampled per-request lifecycle trace as "
                         "JSONL (render with repro_torch.telemetry.report)")
    ap.add_argument("--trace-sample", type=float, default=1.0,
                    help="deterministic id-hash trace sampling rate")
    ap.add_argument("--live", action="store_true",
                    help="stream closed telemetry windows as NDJSON while "
                         "the run executes (requires --telemetry), with "
                         "SLO burn-rate alerts inline")
    ap.add_argument("--live-out", default=None,
                    help="NDJSON sink for --live ('-' or unset: stdout)")
    ap.add_argument("--slo-target", type=float, default=0.9,
                    help="attainment objective of the burn-rate alerter")
    ap.add_argument("--canary", default=None,
                    help="second PolicyBundle to serve on the "
                         "bit-identical stream; adds the paired "
                         "per-window diff under 'canary'")
    ap.add_argument("--economy", default=None, choices=PROFILE_NAMES,
                    help="tier-economy profile (repro_torch.economy): "
                         "per-tier prices, energy, cold starts, "
                         "preemption, scale-to-zero; the report gains "
                         "spend and joules (request-level only)")
    ap.add_argument("--mesh-cells", type=int, default=0,
                    help="shard the request-level engine over a cells "
                         "group of N spawned ranks (--cells must divide "
                         "by N; NCCL when every rank has a card, else "
                         "gloo)")
    ap.add_argument("--round-replay", action="store_true",
                    help="round-synchronous trace replay with round-mean "
                         "metrics beside the solver oracle")
    ap.add_argument("--out", default=None,
                    help="write the report as JSON (records left out)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    require_writable(args.out, "--out")
    report = serve(bundle=args.bundle, greedy=args.greedy, guard=args.guard,
                   cells=args.cells, rate=args.rate, rounds=args.rounds,
                   seed=args.seed, epochs=args.epochs,
                   cells_per_edge=args.cells_per_edge,
                   shared_cloud=args.shared_cloud,
                   shared_edge=args.shared_edge, quiet=args.quiet,
                   tick_ms=args.tick_ms, queue_cap=args.queue_cap,
                   telemetry=args.telemetry, window_ms=args.window_ms,
                   trace_out=args.trace_out, trace_sample=args.trace_sample,
                   live=args.live, live_out=args.live_out,
                   slo_target=args.slo_target, canary=args.canary,
                   economy=args.economy, round_replay=args.round_replay,
                   mesh_cells=args.mesh_cells, device=args.device)
    text = json.dumps({k: v for k, v in report.items() if k != "records"})
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return report


if __name__ == "__main__":
    main()
