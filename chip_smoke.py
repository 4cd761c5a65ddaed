#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernels are built for sm_90a) and the
CUDA toolkit's nvcc.  Phases, each printing one JSON line:

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: every ``csrc/*.cu`` of the port compiled from source (one nvcc
   per file, started together), with ``-Xptxas -v`` register and
   shared-memory lines;
3. kernels: each kernel against its plain PyTorch version on the card at
   the serving deployment's shapes (C = 65,536 cells, Q = 64, the busiest
   tick's arrival burst from the real bucketer) — bit-exact on integer
   inputs — and timed with CUDA events after warm-up beside its plain
   version, a one-call PyTorch yardstick where one exists, and its bound
   (bytes at 3.35 TB/s, each input read once and each output written
   once, counted from this run's data);
4. serve: the deployment — 65,536 cells, 4 cells per edge server, shared
   cloud and edge, Poisson rate 3 per cell per 250 ms round over 4 rounds
   — through ``repro_torch.launch.serve_fleet``, greedy and then a
   guarded DQN from a bundle the port wrote and read back (weights from a
   ``torch.Generator``), with launch counts per kernel read around each
   run, and device-busy time per tick from ``torch.profiler``;
5. parity: a small configuration served on the CPU and on the card —
   integer records identical, float records within 1e-5.

Any failed check raises, so the exit code is non-zero.  Ends with the
``nvidia-smi`` line, the kernels' JSON summary and, last,
``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
# device spin before timed calls: ~10 ms at H100 clocks, longer than the
# host takes to enqueue them (checked per measurement)
SLEEP_CYCLES = 20_000_000

# the serving deployment: the 65,536-cell row of the cells sweep
CELLS, CELLS_PER_EDGE, RATE, ROUNDS, EPOCHS, SEED = 65536, 4, 3.0, 4, 2, 0
SERVE_KW = dict(cells=CELLS, rate=RATE, rounds=ROUNDS, seed=SEED,
                epochs=EPOCHS, cells_per_edge=CELLS_PER_EDGE,
                shared_cloud=True, shared_edge=True)
ORCH_CU = "src/repro_torch/kernels/csrc/orchestration.cu"
REPLACES = {"queue_admit": "src/repro/kernels/orchestration.py:114",
            "group_occupancy": "src/repro/kernels/orchestration.py:55"}

results: dict = {}


def emit(phase: str, **fields) -> None:
    results[phase] = fields
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def bound_ms(n_bytes: float) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


def cuda_ms(torch, fn, reset=None, iters=10, per=1, warmup=3) -> dict:
    """Time ``fn`` with CUDA events after warm-up; ``reset`` (untimed)
    restores inputs an in-place kernel changed.

    ``ms``: device time per call.  The card first spins in
    ``torch.cuda._sleep`` while the host enqueues ``per`` calls between
    the two events, so the events bracket device work only;
    ``blocker_held`` says the spin outlasted every enqueue (a version
    that synchronises inside, like the plain ``queue_admit``, waits the
    spin out and is timed from the start event on, host gaps included).
    ``call_ms``: one call with a synchronise around it — what a caller
    pays, launch overhead included."""
    ev = lambda: torch.cuda.Event(enable_timing=True)
    for _ in range(warmup):
        if reset:
            reset()
        fn()
    torch.cuda.synchronize()
    dev_total, call_total, held = 0.0, 0.0, True
    for _ in range(iters):
        if reset:
            reset()
        e0, start, end = ev(), ev(), ev()
        e0.record()
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        t0 = time.perf_counter()
        for _ in range(per):
            fn()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        held = held and host_ms < e0.elapsed_time(start)
        dev_total += start.elapsed_time(end) / per
        if reset:
            reset()
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        end.synchronize()
        call_total += start.elapsed_time(end)
    return dict(ms=dev_total / iters, call_ms=call_total / iters,
                blocker_held=held)


# ------------------------------------------------------------------ phases
def phase_card(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    emit("card", nvidia_smi=card, name=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda,
         capability=list(torch.cuda.get_device_capability(0)))
    return card


def phase_build() -> None:
    from repro_torch.kernels import _build
    sources = sorted(_build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        built = list(pool.map(lambda s: _build.build(s, force=True),
                              sources))
    seconds = time.perf_counter() - t0
    ptxas = [ln.strip() for _, log in built for ln in log.splitlines()
             if "Compiling entry" in ln or "Used" in ln]
    emit("build", seconds=seconds, sources=[s.name for s in sources],
         ptxas=ptxas)


def deployment_burst(torch, dev):
    """The deployment's scenario and stream, and the busiest tick's
    arrival lanes from the engine's own bucketer."""
    import numpy as np
    from repro_torch.fleet.workload import random_fleet
    from repro_torch.serve.engine import ServeConfig, _tick_buckets
    from repro_torch.serve.stream import poisson_request_stream
    scn = random_fleet(SEED, CELLS, n_max=5, cells_per_edge=CELLS_PER_EDGE,
                       device=dev)
    cfg = ServeConfig(n_max=5, obs_spec="full")
    horizon = ROUNDS * cfg.round_ms
    stream = poisson_request_stream(np.random.default_rng(SEED), scn,
                                    horizon, rate=RATE,
                                    round_ms=cfg.round_ms,
                                    epoch_ms=horizon / EPOCHS)
    ids, _, _, _ = _tick_buckets(stream, cfg.tick_ms, 10)
    row = ids[int((ids >= 0).sum(1).argmax())]
    rid = torch.as_tensor(row, device=dev)
    cell = torch.as_tensor(stream.cell[np.maximum(row, 0)], device=dev)
    return scn, stream, rid, cell, rid >= 0


def phase_kernels(torch, dev) -> dict:
    from repro_torch.kernels import orchestration as orch
    scn, stream, rid, cell, valid = deployment_burst(torch, dev)
    C, Q, A = CELLS, 64, rid.shape[0]
    g = torch.Generator(device=dev).manual_seed(SEED)
    q_ids0 = torch.randint(0, stream.n_requests, (C, Q), generator=g,
                           device=dev, dtype=torch.int32)
    q_head0 = torch.randint(0, Q, (C,), generator=g, device=dev,
                            dtype=torch.int32)
    # ring fills over the whole range, so the burst also overflows
    q_len0 = torch.randint(0, Q + 1, (C,), generator=g, device=dev,
                           dtype=torch.int32)
    out = {}

    # queue_admit: bit-exact against the plain version, then timed
    def admit_on(fn, q_ids, q_len):
        return fn(q_ids, q_head0, q_len, rid, cell, valid)

    k_ids, k_len = q_ids0.clone(), q_len0.clone()
    _, _, k_adm = admit_on(orch.queue_admit, k_ids, k_len)
    p_ids, p_len = q_ids0.clone(), q_len0.clone()
    _, _, p_adm = admit_on(orch.queue_admit_plain, p_ids, p_len)
    torch.cuda.synchronize()
    err = max(int((k_ids - p_ids).abs().max()),
              int((k_len - p_len).abs().max()),
              int((k_adm != p_adm).sum()))
    check(err == 0, f"queue_admit differs from its plain version ({err})")
    n_adm, n_drop = int(k_adm.sum()), int((valid & ~k_adm).sum())
    check(n_adm > 0 and n_drop > 0, "burst exercises admits and drops")
    # adversarial lane orders on the card: one cell's burst past Q, and
    # interleaved cells
    for name, cells_ in (("one_cell", torch.full_like(cell, 7)),
                         ("interleaved", (torch.arange(
                             A, device=dev, dtype=torch.int32) % 3))):
        a_ids, a_len = q_ids0.clone(), q_len0.clone()
        b_ids, b_len = q_ids0.clone(), q_len0.clone()
        ka = orch.queue_admit(a_ids, q_head0, a_len, rid, cells_, valid)[2]
        pa = orch.queue_admit_plain(b_ids, q_head0, b_len, rid, cells_,
                                    valid)[2]
        check(torch.equal(a_ids, b_ids) and torch.equal(a_len, b_len)
              and torch.equal(ka, pa), f"queue_admit {name} burst")
    ws_ids, ws_len = q_ids0.clone(), q_len0.clone()

    def reset():
        ws_ids.copy_(q_ids0)
        ws_len.copy_(q_len0)

    touched = int(torch.unique(cell[valid]).numel())
    kern = cuda_ms(torch, lambda: admit_on(orch.queue_admit, ws_ids, ws_len),
                   reset, iters=20)
    plain = cuda_ms(torch, lambda: admit_on(orch.queue_admit_plain, ws_ids,
                                            ws_len), reset, iters=20)
    out["queue_admit"] = dict(
        name="queue_admit", route="cuda", source=ORCH_CU,
        replaces=REPLACES["queue_admit"], max_abs_err=err,
        ms=kern["ms"], plain_ms=plain["ms"],
        # rid, cell, valid in and admitted out per lane; head and length
        # in, length out per touched cell; one ring slot per admit
        bound_ms=bound_ms(10 * A + 12 * touched + 4 * n_adm),
        bound_by="bytes", library_ms=None,
        call_ms=kern["call_ms"], plain_call_ms=plain["call_ms"],
        blocker_held=kern["blocker_held"],
        shape=dict(C=C, Q=Q, A=A, valid=int(valid.sum()), admitted=n_adm,
                   dropped=n_drop, touched_cells=touched))

    # group_occupancy on the deployment's edge groups
    groups = scn.edge_groups()
    own = torch.randint(0, 6, (C,), generator=g, device=dev,
                        dtype=torch.int32)
    k_out = orch.group_occupancy(own, groups)
    p_out = orch.group_occupancy_plain(own, groups)
    lib = lambda: torch.zeros(C, dtype=own.dtype, device=dev).index_add_(
        0, groups, own)[groups]
    torch.cuda.synchronize()
    err = int((k_out - p_out).abs().max())
    check(err == 0, "group_occupancy differs from its plain version")
    check(torch.equal(lib(), p_out), "index_add_ yardstick agrees")
    f_out = orch.group_occupancy(own.float(), groups)
    f_err = float((f_out - p_out.float()).abs().max())
    check(f_err <= 1e-5, f"group_occupancy float32 within 1e-5 ({f_err})")
    kern, plain, library = (
        cuda_ms(torch, fn, per=20)
        for fn in (lambda: orch.group_occupancy(own, groups),
                   lambda: orch.group_occupancy_plain(own, groups), lib))
    out["group_occupancy"] = dict(
        name="group_occupancy", route="cuda", source=ORCH_CU,
        replaces=REPLACES["group_occupancy"], max_abs_err=err,
        ms=kern["ms"], plain_ms=plain["ms"],
        bound_ms=bound_ms(12 * C), bound_by="bytes",
        library_ms=library["ms"], call_ms=kern["call_ms"],
        plain_call_ms=plain["call_ms"], library_call_ms=library["call_ms"],
        blocker_held=all(x["blocker_held"] for x in (kern, plain, library)),
        float32_max_abs_err=f_err, shape=dict(C=C, groups=C // 4))
    emit("kernels", **out)
    return out


def _summary(report: dict) -> dict:
    keys = ("n_requests", "served_requests", "dropped_requests",
            "deferred_requests", "slo_attainment", "violation_rate",
            "p50_latency_ms", "p95_latency_ms", "p99_latency_ms",
            "mean_art_ms", "n_epochs", "n_ticks", "steady_ticks",
            "ms_per_tick", "compile_time_s", "run_time_s",
            "decisions_per_s")
    return {k: report[k] for k in keys}


def serve_counted(orch, serve_fleet, **kw) -> tuple[dict, dict]:
    """One main-path run with the launch counts zeroed just before it
    and read just after."""
    orch.reset_launch_counts()
    report = serve_fleet.serve(device="cuda", verbose=False, **kw)
    launches = dict(orch.LAUNCHES)
    for name, n in launches.items():
        check(n > 0, f"{name} launched during the serving run")
    return report, launches


def phase_serve(torch) -> dict:
    from repro_torch.kernels import orchestration as orch
    from repro_torch.launch import serve_fleet
    from repro_torch.policy.adapters import dqn_policy
    from repro_torch.policy.bundle import (PolicyBundle, load_bundle,
                                           save_bundle)
    from repro_torch.specs.observation import make_spec

    greedy, g_launch = serve_counted(orch, serve_fleet, greedy=True,
                                     **SERVE_KW)
    spec = make_spec("full", 5)
    path = OUT / "chip_smoke_dqn.bundle.msgpack"
    meta = {"shared_cloud": True, "shared_edge": True,
            "cells_per_edge": CELLS_PER_EDGE}
    save_bundle(str(path), PolicyBundle(
        "dqn", "full", 5, dqn_policy(spec).init(SEED, "cpu"), meta=meta))
    check(load_bundle(str(path), expect_spec="full").kind == "dqn",
          "bundle reads back")
    guarded, q_launch = serve_counted(orch, serve_fleet, bundle=str(path),
                                      guard=True, **SERVE_KW)
    check(guarded["violation_rate"] == 0.0, "guarded run never violates")

    # device-busy share of a tick: profile a short run of the deployment
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        short = serve_fleet.serve(greedy=True, device="cuda", verbose=False,
                                  **dict(SERVE_KW, rounds=1, epochs=1))
    dev_events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
    # every tick opens with its admission kernel: count from the first
    # one on, so set-up copies before the ticks stay out
    first = min((e.time_range.start for e in dev_events
                 if "queue_admit_kernel" in e.name), default=None)
    check(first is not None, "profiler saw the admission kernel")
    dev_events = [e for e in dev_events if e.time_range.start >= first]
    busy_us = sum(e.time_range.elapsed_us() for e in dev_events)
    (OUT / "chip_smoke_profile.txt").write_text(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=40))
    prof_ticks = short["n_ticks"]

    out = {}
    for name, rep, launches in (("greedy", greedy, g_launch),
                                ("guarded_dqn", guarded, q_launch)):
        out[name] = dict(_summary(rep), launches=launches,
                         launches_per_tick={k: v / rep["n_ticks"]
                                            for k, v in launches.items()})
    busy_ms = busy_us / 1e3 / prof_ticks
    out["profile"] = dict(
        ticks=prof_ticks, device_events=len(dev_events),
        device_events_per_tick=len(dev_events) / prof_ticks,
        device_busy_ms_per_tick=busy_ms,
        wall_ms_per_tick_unprofiled=greedy["ms_per_tick"],
        device_busy_share=busy_ms / greedy["ms_per_tick"])
    emit("serve", **out)
    return out


def phase_parity() -> None:
    import numpy as np
    from repro_torch.launch import serve_fleet
    small = dict(cells=64, rounds=4, seed=1, epochs=2, cells_per_edge=4,
                 shared_cloud=True, shared_edge=True, verbose=False)
    path = str(OUT / "chip_smoke_dqn.bundle.msgpack")
    worst = {}
    for name, kw in (("greedy", dict(greedy=True)),
                     ("guarded_dqn", dict(bundle=path, guard=True))):
        cpu = serve_fleet.serve(device="cpu", **kw, **small)["records"]
        gpu = serve_fleet.serve(device="cuda", **kw, **small)["records"]
        for k in ("dropped", "served", "violated", "action"):
            check(np.array_equal(cpu[k], gpu[k]), f"{name} {k} identical")
        errs = {k: float(np.abs(cpu[k] - gpu[k]).max())
                for k in ("wait_ms", "service_ms", "art_ms")}
        check(max(errs.values()) <= 1e-5, f"{name} floats within 1e-5")
        worst[name] = dict(errs, n_served=int(cpu["served"].sum()))
    emit("parity", **worst)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    OUT.mkdir(exist_ok=True)
    dev = torch.device("cuda")
    card = phase_card(torch)
    phase_build()
    kernels = phase_kernels(torch, dev)
    serve = phase_serve(torch)
    phase_parity()
    for name, k in kernels.items():
        k["launches"] = serve["greedy"]["launches"][name]
    summary = {"kernels": [
        {key: k[key] for key in ("name", "route", "source", "replaces",
                                 "launches", "max_abs_err", "ms",
                                 "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")}
        for k in kernels.values()]}
    (OUT / "chip_smoke.json").write_text(json.dumps(
        dict(results, summary=summary), indent=1))
    print(card)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
